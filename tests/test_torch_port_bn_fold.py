"""Eval batch norms as one per-channel affine (models/blocks.py): folded into
the conv before them (`Conv3D(x, norm)`: DownBlock, UpBlock, SameBlock,
ResBlock's conv1 -> norm2) or run as one multiply-add (ResBlock's norm1).

"Unfolded" is the same module with `blocks._keeps` False: every norm then
runs as three passes over the activation, as in training and under
autograd. On the CPU at tiny widths and 16^2-32^2 frames.
"""

from __future__ import annotations

import pytest
import torch

from monkeynet_tpu_torch.models import blocks
from monkeynet_tpu_torch.models.blocks import (
    Conv3D, DownBlock, ResBlock, SameBlock, SyncBatchNorm, UpBlock,
)
from monkeynet_tpu_torch.tasks.train import Trainer

from .test_torch_port_channel_pad import CONFIGS, batch, forward_all, models_for, small_config


def randomise_norms(model: torch.nn.Module, seed: int = 3) -> torch.nn.Module:
    """Eval statistics and affine parameters far from the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SyncBatchNorm):
                f = m.features
                m.weight.copy_(1.0 + 0.5 * torch.randn(f, generator=gen))
                m.bias.copy_(0.3 * torch.randn(f, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(f, generator=gen))
                m.running_var.copy_(0.2 + torch.rand(f, generator=gen) * 2.0)
    return model


def unfolded(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(blocks, "_keeps", lambda module, t: False)
        return fn()


def block_and_input(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "down":
        block, x = DownBlock(8, 16), torch.rand(2, 2, 16, 16, 8, generator=gen)
    elif kind == "up":
        block, x = UpBlock(16, 8), torch.rand(2, 2, 8, 8, 16, generator=gen)
    elif kind == "same_grouped":
        block = SameBlock(12, 12, groups=3, kernel_size=(1, 1, 1), padding=(0, 0, 0))
        x = torch.rand(2, 2, 16, 16, 12, generator=gen)
    else:  # a ResBlock of 21 channels carried at 24, as the refinement chain
        block = ResBlock(21, blocks.carried(21))
        x = torch.cat([torch.randn(2, 2, 16, 16, 21, generator=gen),
                       torch.zeros(2, 2, 16, 16, 3)], dim=-1)
    blocks.init_parameters(block, torch.Generator().manual_seed(1))
    return randomise_norms(block).eval(), x


@pytest.mark.parametrize("kind", ["down", "up", "same_grouped", "res_carried"])
def test_folded_eval_equals_the_unfolded_block(kind, monkeypatch):
    block, x = block_and_input(kind)
    with torch.no_grad():
        want = unfolded(monkeypatch, lambda: block(x))
        got = block(x)
        again = block(x)  # from the kept affine
    convs = [m for m in block.modules() if isinstance(m, Conv3D)]
    assert any(c._fold is not None for c in convs)  # the fold engaged
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert again.equal(got)
    if kind == "res_carried":
        assert block.norm1._carry is not None  # norm1 ran as one multiply-add
        assert block.norm2._carry is None  # norm2 never ran on its own
        assert torch.count_nonzero(got[..., 21:]) == 0


def test_the_kept_affine_follows_in_place_changes_and_load_state_dict(monkeypatch):
    block, x = block_and_input("res_carried")
    other, _ = block_and_input("res_carried")
    randomise_norms(other, seed=11)
    with torch.no_grad():
        other.conv1.weight.mul_(0.5)

    def check():
        with torch.no_grad():
            got = block(x)
            torch.testing.assert_close(got, unfolded(monkeypatch, lambda: block(x)),
                                       rtol=1e-5, atol=1e-5)
        return got

    first = check()
    kept = block.conv1._fold, block.norm1._carry
    with torch.no_grad():
        block.norm2.running_var.mul_(4.0)  # a buffer of the folded norm
    second = check()
    assert block.conv1._fold is not kept[0] and not second.equal(first)
    with torch.no_grad():
        block.norm1.weight.add_(0.25)  # a parameter of the one-pass norm
    third = check()
    assert block.norm1._carry is not kept[1] and not third.equal(second)
    block.load_state_dict(other.state_dict())
    fourth = check()
    with torch.no_grad():
        torch.testing.assert_close(fourth, other(x), rtol=0, atol=0)


def test_train_grad_mode_and_remat_never_use_the_affine(monkeypatch):
    """A remat train step (its recompute included) and an eval forward under
    autograd make no affine, keep nothing, and give bit-identical outputs
    and gradients to the unfolded code."""
    name = "vox256"
    config = small_config(name)
    config["train_params"]["remat"] = True

    def never(*args):
        raise AssertionError("the eval affine was made")

    runs = []
    for fold in (True, False):
        models = models_for(name)
        for m in models.values():
            randomise_norms(m)

        def step():
            trainer = Trainer(models, config["train_params"], device="cpu")
            out = trainer.step(batch())
            # eval under autograd: the detector's hourglass, a refinement block
            video = batch(1)["video"].requires_grad_()
            models["kp_detector"].eval().predictor(video).sum().backward()
            res = models["generator"].eval().refinement_module[0]
            x = torch.randn(2, 1, 8, 8, res.conv1.carried_in, generator=torch.Generator()
                            .manual_seed(5)).requires_grad_()
            res(x).square().sum().backward()
            return out, (video.grad, x.grad), {f"{n}.{k}": p.detach().clone()
                                               for n, m in models.items()
                                               for k, p in m.named_parameters()}

        if fold:
            with monkeypatch.context() as m:
                m.setattr(SyncBatchNorm, "affine", never)
                runs.append(step())
        else:
            runs.append(unfolded(monkeypatch, step))
        for model in models.values():
            for m in model.modules():
                if isinstance(m, (Conv3D, SyncBatchNorm)):
                    assert m._fold is None and m._carry is None
    (out, dins, params), (out_ref, dins_ref, params_ref) = runs
    assert out["metrics"].equal(out_ref["metrics"])
    assert out["video_prediction"].equal(out_ref["video_prediction"])
    assert all(d.equal(d_ref) for d, d_ref in zip(dins, dins_ref))
    for k, p in params.items():  # after Adam took the step's gradients
        assert p.equal(params_ref[k]), k


# per dtype: the largest gap of a predicted frame (in [0, 1]) and of a
# keypoint, folded against unfolded. The fold rounds once where the norm
# rounded four times: about 16 ulps of f32 at 1 (read: 3.6e-7), about 5 of
# bf16's 2^-8 (read: 7.8e-3)
TOLERANCE = {torch.float32: 2e-6, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_transfers_as_the_unfolded_path(name, dtype, monkeypatch):
    models = models_for(name)
    for net, m in models.items():
        models[net] = randomise_norms(m).to(dtype).eval()
    data = {k: v.to(dtype) for k, v in batch(frames=3).items()}
    with torch.no_grad():
        kp, out, _ = forward_all(models, data)
        kp_ref, out_ref, _ = unfolded(monkeypatch, lambda: forward_all(models, data))
    tol = TOLERANCE[dtype]
    for key in ("mean", "var"):
        torch.testing.assert_close(kp[key].float(), kp_ref[key].float(), rtol=0, atol=tol)
    torch.testing.assert_close(out["video_prediction"].float(),
                               out_ref["video_prediction"].float(), rtol=0, atol=tol)
