"""Carried channel widths (models/blocks.py `carried`): every activation the
networks build and feed to a conv is a multiple of 8 channels wide, the
channels past the reference's width zeros, and nothing else changes.

At the benchmark's three configurations (their options as BENCHMARK.json
runs them, the widths cut to 8 / 32 and the depth to 3 blocks, 32^2
frames): the convs' widths, the zero channels in eval and in a Trainer
step, the parameters against a state_dict the networks saved before
widths were carried (tests/fixtures/channel_pad_parent_state.pt), and
outputs and gradients against the same networks built with nothing carried
(`blocks.ALIGN` 1).
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from monkeynet_tpu_torch.models import blocks
from monkeynet_tpu_torch.models.blocks import Conv3D, ResBlock, SyncBatchNorm
from monkeynet_tpu_torch.models.dense_motion import _LeakyReluCarried
from monkeynet_tpu_torch.tasks.build import build_train_models
from monkeynet_tpu_torch.tasks.train import Trainer

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "channel_pad_parent_state.pt"
CONFIGS = ("taichi64", "vox256", "moving-gif128")
HW = 32

# convs that keep the reference's widths: on raw frames, grouped, or a head
RAW_FRAME = ("generator.appearance_encoder.down_blocks.0.conv",
             "kp_detector.predictor.encoder.down_blocks.0.conv")
HEADS = ("generator.refinement_module.conv-last", "generator.dense_motion_module.hourglass"
         ".decoder.conv", "kp_detector.predictor.decoder.conv", "discriminator.conv")


def small_config(name):
    """The benchmark's configuration `name` at the tests' widths."""
    config = json.loads((REPO / "benchmarks" / "configs" / f"{name}.json").read_text())
    mp = config["model_params"]
    gen = mp["generator_params"]
    for part in (mp["kp_detector_params"], gen, gen["dense_motion_params"],
                 mp["discriminator_params"]):
        part.update(block_expansion=8, max_features=32, num_blocks=min(part["num_blocks"], 3))
    tp = dict(config["train_params"], compute_dtype=None, remat=False)
    depth = mp["discriminator_params"]["num_blocks"] + 1
    tp["loss_weights"] = dict(tp["loss_weights"],
                              reconstruction=tp["loss_weights"]["reconstruction"][:depth])
    return {"model_params": mp, "train_params": tp}


def models_for(name, seed=7, align=None, monkeypatch=None):
    if align is not None:
        monkeypatch.setattr(blocks, "ALIGN", align)
    models = build_train_models(small_config(name), device="cpu", seed=seed)
    if align is not None:
        monkeypatch.undo()
    return models


def batch(seed=0, frames=2):
    gen = torch.Generator().manual_seed(seed)
    video = torch.rand(2, frames, HW, HW, 3, generator=gen)
    return {"source": video[:, :1].clone(), "video": video}


def named_modules(models, kind):
    return [(f"{net}.{name}", m) for net, model in models.items()
            for name, m in model.named_modules() if isinstance(m, kind)]


def forward_all(models, data):
    """The transfer path and the discriminator, in each network's mode."""
    gen, kp_det, disc = models["generator"], models["kp_detector"], models["discriminator"]
    kp = kp_det(torch.cat([data["source"], data["video"]], dim=1))
    kp_source = {k: v[:, :1] for k, v in kp.items()}
    kp_driving = {k: v[:, 1:] for k, v in kp.items()}
    out = gen(data["source"], kp_driving, kp_source)
    maps = disc(out["video_prediction"], kp_driving, kp_source)
    return kp, out, maps


class Watch:
    """Forward hooks that record every Conv3D's widths and assert that each
    carried channel is exactly 0 where it enters or leaves a module (a conv
    given a norm leaves with the norm applied)."""

    def __init__(self, models):
        self.widths, self.checked, self.handles = {}, 0, []
        for name, m in named_modules(models, (Conv3D, SyncBatchNorm, ResBlock)):
            self.handles.append(m.register_forward_hook(self._hook(name)))

    def _hook(self, name):
        def hook(module, inputs, out):
            x = inputs[0]
            if isinstance(module, Conv3D):
                self.widths[name] = (x.shape[-1], out.shape[-1])
                self._zero(name, x, module.weight.shape[1] * module.groups)
                self._zero(name, out, module.weight.shape[0])
            elif isinstance(module, SyncBatchNorm):
                self._zero(name, out, module.features)
            else:
                self._zero(name, out, module.conv1.weight.shape[0])
        return hook

    def _zero(self, name, t, features):
        if t.shape[-1] > features:
            assert torch.count_nonzero(t[..., features:]) == 0, name
            self.checked += 1

    def close(self):
        for h in self.handles:
            h.remove()


@pytest.mark.parametrize("name", CONFIGS)
def test_every_conv_takes_and_emits_a_multiple_of_8(name):
    models = models_for(name)
    for m in models.values():
        m.eval()
    watch = Watch(models)
    with torch.no_grad():
        forward_all(models, batch())
    watch.close()
    grouped = {n for n, m in named_modules(models, Conv3D) if m.groups > 1}
    assert len(grouped) == 2 and len(watch.widths) == len(named_modules(models, Conv3D))
    for conv, (cin, cout) in watch.widths.items():
        if conv not in RAW_FRAME and conv not in grouped:
            assert cin % 8 == 0, (conv, cin)
        if conv not in HEADS and conv not in grouped:
            assert cout % 8 == 0, (conv, cout)
    # what is carried: the 10-channel embedding on every generator skip,
    # 3 + 10 on the discriminator's frames, the 45-like refinement chain, the
    # dense motion's grouped output and the decoders' last concats
    embed = 66 if name == "moving-gif128" else 44
    assert watch.widths["generator.dense_motion_module.hourglass.encoder.down_blocks.0.conv"] \
        == (blocks.carried(embed), 16)
    assert watch.widths["generator.refinement_module.r0.conv1"] == (24, 24)  # 8 + 3 + 10
    assert watch.widths["generator.refinement_module.conv-last"] == (24, 3)
    assert watch.widths["kp_detector.predictor.decoder.conv"] == (16, 10)  # 8 + 3
    assert watch.widths["discriminator.down_blocks.0.conv"][0] == 16  # 3 + 10


@pytest.mark.parametrize("name", CONFIGS)
def test_carried_channels_stay_zero_in_eval(name):
    models = models_for(name)
    for m in models.values():
        m.eval()
    watch = Watch(models)
    with torch.no_grad():
        forward_all(models, batch())
        forward_all(models, batch(1))  # the kept padded weights
    watch.close()
    # each carried conv input and output, norm1 and block output, twice; a
    # ResBlock's norm2 runs inside conv1 (folded), so conv1's output is its
    assert watch.checked == 2 * 32


@pytest.mark.parametrize("name", CONFIGS)
def test_carried_channels_stay_zero_in_a_train_step(name):
    config = small_config(name)
    models = models_for(name)
    trainer = Trainer(models, config["train_params"], device="cpu")
    watch = Watch(models)
    for seed in range(2):
        metrics = trainer.step(batch(seed))["metrics"]
        assert torch.isfinite(metrics).all()
    watch.close()
    # the generator and the detector once a step, the discriminator four times
    assert watch.checked == 2 * 39
    # the running statistics keep the reference's widths and stay finite
    for _, bn in named_modules(models, SyncBatchNorm):
        assert bn.running_mean.shape == (bn.features,)
        assert torch.isfinite(bn.running_var).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_keys_and_shapes_are_the_uncarried_ones(name):
    want = torch.load(FIXTURE)["shapes"][name]
    models = models_for(name)
    got = {net: {k: list(v.shape) for k, v in m.state_dict().items()}
           for net, m in models.items()}
    assert got == want


def test_a_state_dict_saved_before_widths_were_carried_loads(monkeypatch):
    """The fixture's networks (bf16 values) load strictly into the carried
    networks and animate as the same networks built with nothing carried."""
    saved = torch.load(FIXTURE)["moving-gif128"]
    outs = []
    for align in (None, 1):
        models = models_for("moving-gif128", seed=1, align=align, monkeypatch=monkeypatch)
        for net, model in models.items():
            model.load_state_dict(saved[net], strict=True)
            model.eval()
        with torch.no_grad():
            outs.append(forward_all(models, batch()))
    (kp, out, maps), (kp_ref, out_ref, maps_ref) = outs
    for k in kp:
        torch.testing.assert_close(kp[k], kp_ref[k], rtol=1e-5, atol=1e-6)
    for k in out:
        torch.testing.assert_close(out[k], out_ref[k], rtol=1e-5, atol=1e-6)
    for a, b in zip(maps, maps_ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_gradients_equal_the_uncarried_networks(name, monkeypatch):
    config = small_config(name)
    state, runs = None, []
    for align in (None, 1):
        models = models_for(name, align=align, monkeypatch=monkeypatch)
        if state is None:
            state = {net: m.state_dict() for net, m in models.items()}
        else:
            for net, m in models.items():
                m.load_state_dict(state[net])
        trainer = Trainer(models, config["train_params"], device="cpu")
        loss, metrics, generated, _ = trainer.objective(batch())
        loss.backward()
        grads = {f"{net}.{k}": p.grad for net, m in models.items()
                 for k, p in m.named_parameters()}
        runs.append((metrics.detach(), generated["video_prediction"].detach(), grads))
    (metrics, pred, grads), (metrics_ref, pred_ref, grads_ref) = runs
    torch.testing.assert_close(metrics, metrics_ref, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(pred, pred_ref, rtol=1e-5, atol=1e-6)
    assert grads.keys() == grads_ref.keys()
    for k, g in grads.items():
        ref = grads_ref[k]
        assert (g is None) == (ref is None), k
        if g is not None:
            assert g.shape == ref.shape, k
            scale = ref.abs().max().item()
            torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-5 * scale + 1e-12, msg=k)


def test_eval_keeps_the_padded_weights_until_a_parameter_changes():
    models = models_for("vox256")
    gen = models["generator"].eval()
    conv = gen.refinement_module[0].conv1
    bn = gen.refinement_module[0].norm1
    assert conv._pad == (3, 3) and bn.carried == 24 and bn.features == 21
    x = torch.randn(1, 1, 4, 4, 21)
    x = torch.cat([x, torch.zeros(1, 1, 4, 4, 3)], dim=-1)
    with torch.no_grad():
        first = conv(x)
        kept = conv._carry
        assert conv(x).equal(first) and conv._carry is kept
        conv.weight.mul_(2.0)  # in place: the version moves
        assert torch.allclose(conv(x)[..., :21], 2 * first[..., :21] - conv.bias, atol=1e-5)
        assert conv._carry is not kept
        bn(x)
        assert bn._carry is not None
    gen.to(torch.float64)  # moved or cast: nothing kept
    assert conv._carry is None and bn._carry is None
    # autograd on: padded at the call, the gradient sliced back
    y = conv(x.double().requires_grad_())
    assert conv._carry is None
    y.sum().backward()
    assert conv.weight.grad.shape == conv.weight.shape


def test_leaky_relu_writes_into_the_carried_buffer():
    x = torch.randn(2, 1, 3, 3, 44, dtype=torch.float64, requires_grad=True)
    out = _LeakyReluCarried.apply(x, 0.2, 48)
    assert out.shape[-1] == 48 and torch.count_nonzero(out[..., 44:]) == 0
    torch.testing.assert_close(out[..., :44], torch.nn.functional.leaky_relu(x, 0.2))
    assert torch.autograd.gradcheck(lambda t: _LeakyReluCarried.apply(t, 0.2, 48), (x,))
