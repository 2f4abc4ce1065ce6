"""The PyTorch port against the benchmark's plain reference
(benchmarks/reference) at each configuration the benchmark's cells run, at
tiny widths on the CPU: benchmarks/configs/<name>.json with its options as
they are, its widths and depths shrunk (`_config`: 4 keypoints, blocks of
4 to 16 channels, the generator 3 blocks deep over a dense motion of 2 at
every configuration, one refinement block, batch 4 at 32^2).

The options kept: the scale factors (none at taichi64, 0.25 at vox256, 0.5
at moving-gif128), the mask embedding (`use_difference` at moving-gif128),
vox256's interpolation mode, and remat where the configuration sets it
(vox256). The depths are not: taichi64's generator is as deep as its dense
motion. Cut to 2 over 2, one generated pixel of this batch lands within
1e-7 of its target, where the pixel L1's sign is a rounding apart, and the
dense-motion head's bias gradient differs from the reference's by 1.8e-2
of its scale with nothing wrong in either. Everything computes in float32
(`compute_dtype` None, as moving-gif128 ships): the cells' bfloat16 is held
against the reference by the benchmark's own check, not here. Both sides
load the same seeded state_dicts (`benchmarks.weights.draw`). Per
configuration: (a) the options; (b) the keypoint detector's and
generator's forward (keypoints, prediction, the deformed source, the mask
embedding); (c) one `Trainer.run` step's losses against the reference's
objective (`benchmarks/reference/train.py`); (d) that step's gradients;
(e) the Adam update; (f) `TransferEngine` with `move_location`, as the
transfer cells run it, over a driving video of two chunks (the second
padded), against `benchmarks.check.reference_transfer` on the port's
networks, and its keypoints against the reference's detector.

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

from benchmarks import check, frames, program, weights
from benchmarks.reference import model as reference
from benchmarks.reference import train as ref_train
from monkeynet_tpu_torch.models.movement_embedding import MovementEmbedding
from monkeynet_tpu_torch.tasks.train import Trainer

CONFIGS = Path(__file__).resolve().parents[1] / "benchmarks" / "configs"
NAMES = ("taichi64", "vox256", "moving-gif128")
# What each configuration sets: the scale factor of the kp detector, dense
# motion and kp embedding (1 where unset), the mask embedding's channels a
# keypoint and at the published widths, generator and dense-motion blocks
# (not kept by the cut), and train_params' compute_dtype and remat.
OPTIONS = {
    "taichi64": {"scale": 1, "per_kp": 4, "embedding": 44, "blocks": (5, 5),
                 "compute_dtype": "bfloat16", "remat": False},
    "vox256": {"scale": 0.25, "per_kp": 4, "embedding": 44, "blocks": (7, 5),
               "compute_dtype": "bfloat16", "remat": True},
    "moving-gif128": {"scale": 0.5, "per_kp": 6, "embedding": 66, "blocks": (6, 5),
                      "compute_dtype": None, "remat": False},
}
HW = (32, 32)
BATCH = 4
SEED = 2 ** 31 + 2121
# The transfer: chunks of TRANSFER_CHUNK (the engine's smallest, its frame
# granularity) over TRANSFER_FRAMES driving frames, so the second chunk is
# padded and normalised by the first chunk's first frame.
TRANSFER_CHUNK = 16
TRANSFER_FRAMES = 20
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


def _published(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _config(name):
    """(model_params, train_params) of `name` at the tests' widths and
    depths, in float32."""
    cfg = _published(name)
    mp = copy.deepcopy(cfg["model_params"])
    mp["common_params"]["num_kp"] = 4
    gp, dp = mp["generator_params"], mp["generator_params"]["dense_motion_params"]
    for params, blocks in ((mp["kp_detector_params"], 3), (gp, 3), (dp, 2)):
        params.update(block_expansion=4, max_features=16, num_blocks=blocks)
    gp["num_refinement_blocks"] = 1
    mp["discriminator_params"].update(block_expansion=4, max_features=16, num_blocks=2)
    tp = dict(cfg["train_params"], batch_size=BATCH)
    tp.pop("compute_dtype", None)
    return mp, tp


def _state_and_batch(mp):
    clip = frames.clips(2, 8, HW, SEED, "cpu")
    state = weights.draw(mp, SEED + 1, clip[0])
    pool = frames.to_uint8(clip)
    gen = torch.Generator().manual_seed(SEED + 2)
    pick = torch.randint(0, 8, (2, BATCH), generator=gen)
    which = torch.arange(BATCH) % 2
    batch = {"source": pool[which, pick[0]][:, None], "video": pool[which, pick[1]][:, None]}
    return state, batch, clip


@pytest.fixture(scope="module", params=NAMES)
def setup(request):
    mp, tp = _config(request.param)
    state, batch, clip = _state_and_batch(mp)
    return request.param, mp, tp, state, batch, clip


def _scales(mp):
    gp = mp["generator_params"]
    return {mp["kp_detector_params"].get("scale_factor", 1),
            gp["dense_motion_params"].get("scale_factor", 1),
            gp["kp_embedding_params"].get("scale_factor", 1)}


def _options(tree):
    """A configuration's tree without what `_config` cuts."""
    cut = ("block_expansion", "max_features", "num_blocks", "num_refinement_blocks", "num_kp",
           "batch_size", "compute_dtype")
    return {k: _options(v) if isinstance(v, dict) else v for k, v in tree.items() if k not in cut}


@pytest.mark.parametrize("name", NAMES)
def test_the_options_are_the_configurations(name):
    cfg, want = _published(name), OPTIONS[name]
    mp, tp = cfg["model_params"], cfg["train_params"]
    gp, dp = mp["generator_params"], mp["generator_params"]["dense_motion_params"]
    assert _scales(mp) == {want["scale"]}
    assert (gp["num_blocks"], dp["num_blocks"]) == want["blocks"]
    assert tp.get("compute_dtype") == want["compute_dtype"]
    assert tp["remat"] is want["remat"]
    assert dp["mask_embedding_params"].get("use_difference", False) is (want["per_kp"] == 6)
    # the mask embedding at the published widths: (heatmap, 2 difference
    # channels where set, 3 shifted source channels) x (10 keypoints +
    # background)
    K, C = mp["common_params"]["num_kp"], mp["common_params"]["num_channels"]
    port = MovementEmbedding(num_kp=K, kp_variance="matrix", num_channels=C,
                             add_bg_feature_map=True, **dp["mask_embedding_params"])
    ref = reference.MovementEmbedding(reference.Ctx(), K, C, add_bg_feature_map=True,
                                      **dp["mask_embedding_params"])
    assert port.out_channels == ref.out_channels == want["embedding"] == want["per_kp"] * (K + 1)
    # the cut changes widths, depths, keypoints, the batch and the dtype,
    # and no option
    small_mp, small_tp = _config(name)
    assert _options(small_mp) == _options(mp)
    assert _options(small_tp) == _options(tp)


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
    name, mp, _, state, batch, _ = setup
    port = {k: v.eval() for k, v in program.networks(mp, state, "cpu").items()}
    ref = check.reference_nets(mp, state, "cpu")
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
    K1, per_kp = mp["common_params"]["num_kp"] + 1, OPTIONS[name]["per_kp"]
    assert embed_p.shape[-1] == embed_r.shape[-1] == per_kp * K1
    torch.testing.assert_close(embed_p, embed_r, rtol=0, atol=FORWARD_ATOL)
    if per_kp == 6:
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
    _, mp, tp, state, batch, _ = setup
    trainer = Trainer(program.networks(mp, state, "cpu"), tp, device="cpu")
    assert trainer.remat is tp["remat"]
    chunk = {k: v[None] for k, v in batch.items()}
    metrics, _ = trainer.run(chunk, 0, 1)
    grads = {name: {k: p.grad.detach().clone() for k, p in net.named_parameters()}
             for name, net in trainer.models.items()}
    nets = reference.build(mp, device="cpu")
    floats = {k: v.float() / 255.0 for k, v in batch.items()}
    losses, first, params, _ = ref_train.train_steps(nets, state, [floats], tp)
    return trainer, grads, metrics[0], losses[0], first, params


def test_one_step_losses_match_the_reference_objective(one_step):
    _, _, metrics, ref_losses, _, _ = one_step
    # the loss terms in the reference's order: a reconstruction term for each
    # of the tiny discriminator's maps, the generator's and the
    # discriminator's GAN terms
    assert metrics.shape == (len(ref_losses),)
    torch.testing.assert_close(metrics, torch.tensor(ref_losses), rtol=1e-5, atol=1e-6)


def test_one_step_gradients_match_the_reference_objective(one_step):
    _, grads, _, _, ref_first, _ = one_step
    gaps = _leaf_gaps(grads, ref_first)
    assert max(gaps.values()) < GRAD_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    # every leaf the reference moves gets a gradient in the port
    assert all(float(grads[n][k].norm()) > 0 for n in ref_first for k in ref_first[n]
               if float(ref_first[n][k].norm()) > 0)


def test_adam_update_matches_the_reference(setup, one_step):
    _, _, tp, state, _, _ = setup
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


@torch.no_grad()
def test_transfer_matches_the_reference(setup):
    """The transfer cells' engine (relative move_location) in float32, one
    full chunk and one padded, against `reference_transfer` from the same
    source, driving frames and weights on the port's networks, so that what
    is compared is the engine's chunking, padding and normalisation; and
    its keypoints against the reference's detector. The networks'
    frames against the reference's are (b)'s; over 20 frames at vox256
    they differ by up to 2.6e-5, as far as either side's own output moves
    when its weights move by an ulp, and past FORWARD_ATOL."""
    _, mp, _, state, _, clip = setup
    source = clip[:1, :1]
    driving = frames.clips(1, TRANSFER_FRAMES, HW, SEED + 3, "cpu")
    out = program.transfer_engine(mp, state, "cpu", TRANSFER_CHUNK, None)(source, driving)
    assert out["video_prediction"].shape == (1, TRANSFER_FRAMES, *HW, 3)
    ref_mean = check.reference_nets(mp, state, "cpu")["kp_detector"](driving)["mean"][0]
    torch.testing.assert_close(out["kp_driving"]["mean"][0], ref_mean, rtol=0, atol=FORWARD_ATOL)
    # the driving keypoints move, so the relative normalisation is exercised
    assert float((ref_mean - ref_mean[:1]).abs().max()) > 1e-3
    nets = {k: v.eval() for k, v in
            program.networks(mp, state, "cpu", ("kp_detector", "generator")).items()}
    pred, mean = check.reference_transfer(nets, source, driving, "cpu")
    torch.testing.assert_close(out["video_prediction"][0], pred, rtol=0, atol=FORWARD_ATOL)
    torch.testing.assert_close(out["kp_driving"]["mean"][0], mean, rtol=0, atol=FORWARD_ATOL)
