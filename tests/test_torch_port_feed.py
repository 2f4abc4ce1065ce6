"""The PyTorch port's device feed held against the JAX package's on the CPU:
the augmentation plans and `plan_stream` (array for array), the gates of
`supports_device_feed`, the video cache and its budget, and the plan
executor against `jax.jit(make_device_augment)` and against the host
pipeline.

Tolerances are tests/test_device_feed.py's: the integer gathers (frame
selection, flips, resize and crop) agree to 1.2e-7, one f32 ulp at 1 (the
division by 255); the rotation to 5e-5 (bilinear with f32 weights against
cv2's fixed-point ones on the host, and against the JAX package's one-hot
contractions); the jitter to 1e-5 (the same HSV formulas in f32).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monkeynet_tpu.data import augmentation as jaug
from monkeynet_tpu.data import device_feed as jfeed
from monkeynet_tpu.data.dataset import FramesDataset as JFramesDataset
from monkeynet_tpu_torch.data import augmentation as taug
from monkeynet_tpu_torch.data import device_feed as tfeed
from monkeynet_tpu_torch.data.dataset import FramesDataset as TFramesDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.data.loader import DataLoader as TDataLoader

H = W = 32
N, T = 4, 10
FLIPS = {"time_flip": True, "horizontal_flip": True}
# actions.yaml's pipeline at the test size
PIPELINE = dict(
    flip_param=FLIPS,
    rotation_param={"degrees": (-10, 10)},
    resize_param={"ratio": (0.9, 1.1)},
    crop_param={"size": (H, W)},
    jitter_param={"hue": 0.5},
)
JITTER_ALL = {"jitter_param": {"hue": 0.5, "brightness": 0.3, "contrast": 0.2, "saturation": 0.4}}
OPS = {
    "select": ({}, 1.2e-7),
    "flip": ({"flip_param": FLIPS}, 1.2e-7),
    "resize_crop": ({"resize_param": {"ratio": (0.9, 1.1)}, "crop_param": {"size": (H, W)}},
                    1.2e-7),
    "pad_crop": ({"resize_param": {"ratio": (0.85, 0.95)}, "crop_param": {"size": (H, W)}},
                 1.2e-7),
    "rotation": ({"rotation_param": {"degrees": (-10, 10)}}, 5e-5),
    "jitter": (JITTER_ALL, 1e-5),
    "pipeline": (PIPELINE, 5e-5),
}


@pytest.fixture(scope="module")
def videos():
    rng = np.random.default_rng(7)
    return (rng.random((N, T, H, W, 3)) * 255).astype(np.uint8)


def _plans(tr, n_items, key=0):
    """One plan batch: item b of video b % N, drawn from generator (key, 0,
    0, b)."""
    return tfeed.collate_plans(
        [b % N for b in range(n_items)],
        [tr.plan(T, H, W, np.random.default_rng((key, 0, 0, b))) for b in range(n_items)],
    )


def _port_augment(tr, videos, plan):
    out = tfeed.make_device_augment(tr, (H, W, 3))(
        torch.from_numpy(videos), {k: torch.from_numpy(np.asarray(v)) for k, v in plan.items()})
    return {k: v.numpy() for k, v in out.items()}


def _assert_plans_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# ---- plans -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPS))
def test_plans_match_jax(name):
    """The port's plan of every op against the JAX package's, from the same
    generator, over many draws; the generators end in the same state."""
    params = OPS[name][0]
    tport, tjax = taug.AllAugmentationTransform(**params), jaug.AllAugmentationTransform(**params)
    for seed in range(40):
        gp, gj = np.random.default_rng((seed, 1)), np.random.default_rng((seed, 1))
        _assert_plans_equal(tport.plan(T, H, W, gp), tjax.plan(T, H, W, gj))
        assert gp.random() == gj.random()


def test_plan_takes_the_host_pipelines_draws():
    """A plan consumes exactly the draws of the host pipeline's __call__,
    the time flip's early return included: both leave a generator in the
    same state."""
    tr = taug.AllAugmentationTransform(**PIPELINE)
    clip = np.random.default_rng(0).random((T, H, W, 3)).astype(np.float32)
    time_flips = 0
    for seed in range(40):
        gp, gh = np.random.default_rng((seed, 2)), np.random.default_rng((seed, 2))
        plan = tr.plan(T, H, W, gp)
        tr(clip, rng=gh)
        assert gp.random() == gh.random()
        time_flips += plan["frame_idx"][0] > plan["frame_idx"][1]
    assert time_flips > 0


def test_jitter_ids_match_jax():
    assert (taug.JITTER_NONE, taug.JITTER_BRIGHT, taug.JITTER_SAT, taug.JITTER_HUE,
            taug.JITTER_CONTRAST) == (jaug.JITTER_NONE, jaug.JITTER_BRIGHT, jaug.JITTER_SAT,
                                      jaug.JITTER_HUE, jaug.JITTER_CONTRAST)


@pytest.mark.parametrize("params,want", [
    ({"resize_param": {"ratio": (0.5, 0.7)}}, False),  # prefilter radius > 0
    ({"resize_param": {"ratio": (0.9, 1.1), "interpolation": "bilinear"}}, False),
    ({"resize_param": {"ratio": (0.9, 1.1)}}, True),
    (PIPELINE, True),
    ({}, True),
])
def test_supports_device_feed_gates(params, want):
    assert taug.AllAugmentationTransform(**params).supports_device_feed(H, W) is want
    assert jaug.AllAugmentationTransform(**params).supports_device_feed(H, W) is want


# ---- the cache, its budget and the plan stream ------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory, videos):
    root = tmp_path_factory.mktemp("strips")
    for split, n in (("train", N), ("test", 2)):
        os.makedirs(root / split)
        for i in range(n):
            write_stacked_png(str(root / split / f"v{i:02d}.png"),
                              videos[i, : T - i].astype(np.float32) / 255.0)
    return str(root)


def _dataset_params(root):
    return dict(root_dir=root, image_shape=(H, W, 3), cache_videos=True,
                augmentation_params={"flip_param": FLIPS, "crop_param": {"size": (H, W)}})


def test_build_video_cache_matches_jax(root):
    """The ragged strips (T, T-1, ... frames) pad to Tmax with zeros, as the
    JAX package's cache does; the dataset's uint8 cache is filled."""
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    jds = JFramesDataset(is_train=True, **_dataset_params(root))
    got, got_len = tfeed.build_video_cache(tds)
    want, want_len = jfeed.build_video_cache(jds)
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got_len, [T - i for i in range(N)])
    assert got.dtype == np.uint8 and got.shape == (N, T, H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[N - 1, T - N + 1:].any()
    assert sorted(tds._cache) == list(range(N))


def test_build_video_cache_over_budget_raises_early(root):
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    with pytest.raises(tfeed.CacheOverBudget) as e:
        tfeed.build_video_cache(tds, budget_bytes=1024)
    assert e.value.budget_bytes == 1024 and e.value.estimated_bytes > 1024
    # raised at the first video: nothing past it was decoded
    assert sorted(tds._cache) == [0]
    cache, _ = tfeed.build_video_cache(tds, budget_bytes=1 << 30)
    assert cache.shape == (N, T, H, W, 3)


def test_cache_budget_bytes_explicit_and_default(monkeypatch):
    assert tfeed.cache_budget_bytes({"device_feed_hbm_gb": 2}) == 2 << 30
    assert tfeed.cache_budget_bytes({"device_feed_hbm_gb": 0.5}, "cpu") == 1 << 29
    assert tfeed.cache_budget_bytes({}, "cpu") == 8 << 30
    assert jfeed.cache_budget_bytes({"device_feed_hbm_gb": 0.5}) == 1 << 29

    class Properties:
        total_memory = 80 << 30

    asked = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: asked.append(device) or Properties())
    assert tfeed.cache_budget_bytes({}, "cuda") == 40 << 30
    assert tfeed.cache_budget_bytes(None, "cuda:0") == 40 << 30
    assert [d.type for d in asked] == ["cuda", "cuda"]


def test_padding_overhead_matches_jax():
    for lengths, shape in (([10, 4, 1], (8, 8, 3)), ([5], (4, 6, 3)), ([], (2, 2, 3))):
        assert tfeed.padding_overhead(lengths, shape) == jfeed.padding_overhead(lengths, shape)
    frame = 8 * 8 * 3
    assert tfeed.padding_overhead([10, 4, 1], (8, 8, 3)) == (3 * 10 * frame, 15 * frame)


def test_plan_stream_matches_jax_and_the_loader_order(root):
    """plan_stream against the JAX package's, plan batch for plan batch, over
    two epochs; its video indices are the port DataLoader's batches."""
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    jds = JFramesDataset(is_train=True, **_dataset_params(root))
    lengths = np.asarray([T - i for i in range(N)], np.int32)
    got = list(tfeed.plan_stream(tds, tds.transform, lengths, 2, 3, 1, 2))
    want = list(jfeed.plan_stream(jds, jds.transform, lengths, 2, 3, 1, 2))
    assert [ep for ep, _ in got] == [ep for ep, _ in want] == [1, 1, 2, 2]
    for (_, g), (_, w) in zip(got, want):
        _assert_plans_equal(g, w)
    loader = TDataLoader(tds, batch_size=2, num_workers=1, seed=3)
    order = [idxs for ep in (1, 2) for idxs in loader._batch_indices(ep)]
    for (_, plan), idxs in zip(got, order):
        np.testing.assert_array_equal(plan["video_idx"], idxs)


def test_plan_stream_and_augment_reproduce_the_loader(root):
    """The device feed's batches on the CPU are the port DataLoader's float
    batches, for a gather-only pipeline (the same shuffle, the same
    generators), to one f32 ulp."""
    tds = TFramesDataset(is_train=True, **_dataset_params(root))
    loader = TDataLoader(tds, batch_size=2, num_workers=1, seed=3)
    host = list(loader.stream(2))
    cache, lengths = tfeed.build_video_cache(tds)
    stream = list(tfeed.plan_stream(tds, tds.transform, lengths, 2, 3, 0, 2))
    assert len(host) == len(stream) == 4
    for (ep_h, batch), (ep_d, plan) in zip(host, stream):
        assert ep_h == ep_d
        dev = _port_augment(tds.transform, cache, plan)
        for key in ("source", "video"):
            np.testing.assert_allclose(dev[key], batch[key], rtol=0, atol=1.2e-7)


# ---- the executor ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPS))
def test_augment_matches_jax_and_the_host_pipeline(videos, name):
    """The port's executor on the CPU against jax.jit(make_device_augment)
    over one batch of 12 plans, and against the host pipeline run from the
    same generators, per op and for actions.yaml's whole pipeline."""
    params, tol = OPS[name]
    tr = taug.AllAugmentationTransform(**params)
    plan = _plans(tr, 12)
    got = _port_augment(tr, videos, plan)
    jaug_fn = jax.jit(jfeed.make_device_augment(jaug.AllAugmentationTransform(**params), (H, W, 3)))
    want = jaug_fn(jnp.asarray(videos), jax.tree.map(jnp.asarray, plan))
    host = [tr(videos[b % N], rng=np.random.default_rng((0, 0, 0, b))) for b in range(12)]
    for key in ("source", "video"):
        assert got[key].dtype == np.float32 and got[key].shape == (12, 1, H, W, 3)
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=tol, err_msg=key)
        np.testing.assert_allclose(got[key], np.stack([h[key] for h in host]), rtol=0, atol=tol,
                                   err_msg=f"{key} against the host")
    assert got["video"].std() > 0.1  # a real picture went through


def test_rotation_goes_through_the_warp(videos, monkeypatch):
    """The rotation is one warp of the batch's B x F frames at an
    align-corners grid (on the card, the warp kernel: one launch a step)."""
    from monkeynet_tpu_torch.ops.cuda import warp as warp_mod

    calls = []
    real = tfeed.warp

    def spy(image, grid):
        calls.append((tuple(image.shape), tuple(grid.shape)))
        return real(image, grid)

    monkeypatch.setattr(tfeed, "warp", spy)
    tr = taug.AllAugmentationTransform(**PIPELINE)
    _port_augment(tr, videos, _plans(tr, 6))
    assert calls == [((12, H, W, 3), (12, H, W, 2))]
    assert real is warp_mod.warp
    # A zero angle gives the identity grid, and the frames come back as they
    # were, up to the grid's round trip through [-1, 1]: a pixel coordinate
    # comes back a few f32 ulps off (4e-6 of a pixel at 32), which moves a
    # value by as much.
    x = torch.from_numpy(videos[:2, :2].astype(np.float32) / 255.0)
    same = tfeed.rotate_frames(x, torch.zeros(2))
    torch.testing.assert_close(same, x, rtol=0, atol=1e-5)
