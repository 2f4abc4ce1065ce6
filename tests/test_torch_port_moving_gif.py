"""The PyTorch port against the benchmark's plain reference
(benchmarks/reference) at moving-gif's options, at tiny widths on the CPU:
the benchmark's `moving-gif128` configuration (config/moving-gif.yaml) with
its options as they are, its widths shrunk.

The options: keypoint detector, dense motion and keypoint embedding at scale
0.5, `use_difference` in the mask embedding, a generator one block deeper
than its dense motion, float32 (no `compute_dtype`), no remat. Both sides
load the same seeded state_dicts (`benchmarks.weights.draw`). Compared: the
keypoint detector's and generator's forward (keypoints, prediction, the
deformed source, and the mask embedding with its difference channels), one
`Trainer.run` step's losses and gradients against the reference's objective
(`benchmarks/reference/train.py`), and the Adam update.

Both sides compute in float32 with the same operations in a different order
(the port's warp, combine and heatmaps are its own plain versions, the
reference's are `F.grid_sample` and sums), so each tolerance is a few
hundred float32 ulps of the compared quantity's scale.
"""

from __future__ import annotations

import copy
import json
import statistics
from pathlib import Path

import pytest
import torch

from benchmarks import frames, program, weights
from benchmarks.reference import model as reference
from benchmarks.reference import train as ref_train
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding
from monkeynet_tpu_torch.tasks.train import Trainer

CONFIG = Path(__file__).resolve().parents[1] / "benchmarks" / "configs" / "moving-gif128.json"
HW = (32, 32)
BATCH = 4
SEED = 2 ** 31 + 2121
# Forward outputs: keypoints are soft-argmax means in [-1, 1] and pixels lie
# in [0, 1]; the port and the reference agree to ~1e-6 on them.
FORWARD_ATOL = 2e-5
# A leaf's gradient, relative to the larger of its norm and its network's
# median leaf norm: float32 sums over the batch and the plane in another
# order differ by ~1e-6 of that scale.
GRAD_RTOL = 1e-4
# Adam's first step moves a parameter by lr * g / (|g| + eps) after the bias
# corrections: the port's torch.optim.Adam and the reference's written-out
# update differ by an ulp or two of the parameter (~1e-7 at |p| ~ 1).
ADAM_ATOL = 5e-7


def _config():
    cfg = json.loads(CONFIG.read_text())
    mp = copy.deepcopy(cfg["model_params"])
    mp["common_params"]["num_kp"] = 4
    gp, dp = mp["generator_params"], mp["generator_params"]["dense_motion_params"]
    for params, blocks in ((mp["kp_detector_params"], 3), (gp, 3), (dp, 2)):
        params.update(block_expansion=4, max_features=16, num_blocks=blocks)
    gp["num_refinement_blocks"] = 1
    mp["discriminator_params"].update(block_expansion=4, max_features=16, num_blocks=2)
    tp = dict(cfg["train_params"], batch_size=BATCH)
    return mp, tp


def _state_and_batch(mp):
    clip = frames.clips(2, 8, HW, SEED, "cpu")
    state = weights.draw(mp, SEED + 1, clip[0])
    pool = frames.to_uint8(clip)
    gen = torch.Generator().manual_seed(SEED + 2)
    pick = torch.randint(0, 8, (2, BATCH), generator=gen)
    which = torch.arange(BATCH) % 2
    batch = {"source": pool[which, pick[0]][:, None], "video": pool[which, pick[1]][:, None]}
    return state, batch


@pytest.fixture(scope="module")
def setup():
    mp, tp = _config()
    state, batch = _state_and_batch(mp)
    return mp, tp, state, batch


def test_the_options_are_moving_gifs():
    cfg = json.loads(CONFIG.read_text())
    mp, tp = cfg["model_params"], cfg["train_params"]
    gp, dp = mp["generator_params"], mp["generator_params"]["dense_motion_params"]
    assert {mp["kp_detector_params"]["scale_factor"], dp["scale_factor"],
            gp["kp_embedding_params"]["scale_factor"]} == {0.5}
    assert dp["mask_embedding_params"]["use_difference"] is True
    assert gp["num_blocks"] == dp["num_blocks"] + 1
    assert "compute_dtype" not in tp and tp["remat"] is False
    # the mask embedding at the published widths: (heatmap + 2 difference + 3
    # shifted source channels) x (10 keypoints + background) = 66
    K, C = mp["common_params"]["num_kp"], mp["common_params"]["num_channels"]
    port = MovementEmbedding(num_kp=K, kp_variance="matrix", num_channels=C,
                             add_bg_feature_map=True, **dp["mask_embedding_params"])
    ref = reference.MovementEmbedding(reference.Ctx(), K, C, add_bg_feature_map=True,
                                      **dp["mask_embedding_params"])
    assert port.out_channels == ref.out_channels == 66


def _mask_embedding(generator, call):
    seen = []
    module = generator.dense_motion_module.mask_embedding
    handle = module.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        out = call()
    finally:
        handle.remove()
    return out, seen[-1]


@torch.no_grad()
def test_forward_matches_the_reference(setup):
    mp, _, state, batch = setup
    port = {k: v.eval() for k, v in program.networks(mp, state, "cpu").items()}
    ref = reference.build(mp, device="cpu")
    for name, net in ref.items():
        net.load_state_dict(state[name])
        net.eval()
    source = batch["source"].float() / 255.0
    driving = batch["video"].float() / 255.0
    kp_p, kp_r = port["kp_detector"](driving), ref["kp_detector"](driving)
    for key in ("mean", "var"):
        torch.testing.assert_close(kp_p[key], kp_r[key], rtol=0, atol=FORWARD_ATOL)
    kp_src = ref["kp_detector"](source)
    out_p, embed_p = _mask_embedding(port["generator"],
                                     lambda: port["generator"](source, kp_r, kp_src))
    out_r, embed_r = _mask_embedding(ref["generator"],
                                     lambda: ref["generator"](source, kp_r, kp_src))
    K1 = mp["common_params"]["num_kp"] + 1
    assert embed_p.shape[-1] == embed_r.shape[-1] == 6 * K1
    torch.testing.assert_close(embed_p, embed_r, rtol=0, atol=FORWARD_ATOL)
    # the difference channels (1 and 2 of each keypoint's 6) hold the
    # keypoints' displacement, constant over the plane and not zero
    diff = embed_p.reshape(*embed_p.shape[:-1], K1, 6)[..., 1:3]
    assert float(diff[..., 1:, :].abs().max()) > 1e-3
    assert float(diff[..., :1, :].abs().max()) == 0.0  # background slot
    for key in ("video_prediction", "video_deformed"):
        torch.testing.assert_close(out_p[key], out_r[key], rtol=0, atol=FORWARD_ATOL)


def _leaf_gaps(port, ref):
    """Each leaf's largest gap over the larger of its norm and the
    network's median leaf norm."""
    out = {}
    for net, leaves in ref.items():
        median = statistics.median(float(v.norm()) for v in leaves.values())
        for k, r in leaves.items():
            scale = max(float(r.norm()), median)
            out[f"{net}.{k}"] = float((port[net][k] - r).norm()) / scale
    return out


@pytest.fixture(scope="module")
def one_step(setup):
    """(the port's Trainer after one Trainer.run step, its gradients and
    losses; the reference's first gradients, losses and parameters after
    the same step)."""
    mp, tp, state, batch = setup
    trainer = Trainer(program.networks(mp, state, "cpu"), tp, device="cpu")
    chunk = {k: v[None] for k, v in batch.items()}
    metrics, _ = trainer.run(chunk, 0, 1)
    grads = {name: {k: p.grad.detach().clone() for k, p in net.named_parameters()}
             for name, net in trainer.models.items()}
    nets = reference.build(mp, device="cpu")
    floats = {k: v.float() / 255.0 for k, v in batch.items()}
    losses, first, params, _ = ref_train.train_steps(nets, state, [floats], tp)
    return trainer, grads, metrics[0], losses[0], first, params


def test_one_step_matches_the_reference_objective(one_step):
    _, grads, metrics, ref_losses, ref_first, _ = one_step
    # the loss terms in the reference's order: a reconstruction term for each
    # of the tiny discriminator's maps, the generator's and the
    # discriminator's GAN terms
    assert metrics.shape == (len(ref_losses),)
    torch.testing.assert_close(metrics, torch.tensor(ref_losses), rtol=1e-5, atol=1e-6)
    gaps = _leaf_gaps(grads, ref_first)
    assert max(gaps.values()) < GRAD_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    # every leaf the reference moves gets a gradient in the port
    assert all(float(grads[n][k].norm()) > 0 for n in ref_first for k in ref_first[n]
               if float(ref_first[n][k].norm()) > 0)


def test_adam_update_matches_the_reference(setup, one_step):
    _, tp, state, _ = setup
    trainer, grads, _, _, ref_first, ref_params = one_step
    for name, net in trainer.models.items():
        median = statistics.median(float(g.norm()) for g in ref_first[name].values())
        start = {k: state[name][k].clone() for k, _ in net.named_parameters()}
        # the reference's Adam applied to the port's own gradients
        adam = ref_train.Adam(start, tp["lr"])
        adam.step(start, grads[name])
        for k, p in net.named_parameters():
            torch.testing.assert_close(p.detach(), start[k], rtol=0, atol=ADAM_ATOL)
            # and the reference's own step, where its gradient is resolved:
            # an entry whose gradient is rounding noise (a bias before a
            # batch norm, which the norm cancels) moves by up to lr either way
            g = ref_first[name][k]
            if float(g.norm()) < 1e-3 * median:
                continue
            resolved = g.abs() > 1e-3 * float(g.abs().max())
            torch.testing.assert_close(p.detach()[resolved], ref_params[name][k][resolved],
                                       rtol=0, atol=ADAM_ATOL)
