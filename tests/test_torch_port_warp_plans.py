"""The warp forward and d_grid kernels of the PyTorch port, as far as a CPU
can hold them, and the generator's one warp per encoder skip.

(a) `warp_plan` and `dgrid_plan` over the warp shapes of every
    configs/*.yaml (a 128-frame transfer chunk and the config's train batch)
    and over drawn shapes: a replay in numpy of how the kernels' threads
    cover the (batch element, point, channel) space (every channel of every
    point exactly once), and the limits of the card (block size, launch
    grid, shared memory) and of 32-bit offsets.
(b) `dgrid_mirror` repeats in numpy f32 the d_grid kernel's partition of a
    point's channels over its lanes and its order of summation (the lanes'
    own sums, the segmented shuffle tree of 'grouped', the warp trees and
    the ordered shared-memory sum of 'split'). It is held against
    `warp_dgrid_plain` and against the JAX package's d_grid (jax.grad of the
    jnp grid_sample, and of the Pallas kernels in interpret mode, as
    tests/test_torch_port_grad.py runs them) on random and identity grids.
(c) The generator warps each encoder skip once: the first skip is the source
    frame, and its warp is also video_deformed, which the JAX package warps
    a second time.

The kernels themselves cannot run here: chip_smoke.py holds them against
their plain versions on the card.

Tolerances: d_grid sums 4 * C products per point in f32 in another order
than the plain version; 2e-5 of the largest value (at least 1), as
chip_smoke.py holds the kernel, and 1e-4 of it against the Pallas kernel,
which contracts whole planes with difference matrices.
"""

import glob
import os

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from monkeynet_tpu.ops import sampling as jsamp
from monkeynet_tpu.ops.pallas.warp import grid_sample_pallas
from monkeynet_tpu_torch.ops.cuda import warp as twarp

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))
DTYPES = [torch.float32, torch.bfloat16]
CHUNK = 128
MAX_DYNAMIC_SHARED = 232_448


def _config_warp_shapes(path):
    """(batch, points, channels, source pixels) of every warp of a config's
    generator: one per encoder skip (the first is the source frame), at a
    128-frame transfer chunk (batch 1) and at the train batch (one driving
    frame per sample)."""
    with open(path) as f:
        config = yaml.safe_load(f)
    h, w, c = config["dataset_params"].get("image_shape", (64, 64, 3))
    gen = config["model_params"]["generator_params"]
    widths = [c] + [min(gen["max_features"], gen["block_expansion"] * 2 ** (i + 1))
                    for i in range(gen["num_blocks"])]
    batch = config["train_params"]["batch_size"]
    shapes = []
    for i, C in enumerate(widths):
        px = (h >> i) * (w >> i)
        shapes += [(1, CHUNK * px, C, px), (batch, px, C, px)]
    return shapes


# ---- (a) plans -------------------------------------------------------------

def _replay_tile(plan, N, C, tile):
    """How often the threads of a block meet each (point, channel) of the
    tile of threads / lanes points it takes at once, the tile-th of the
    launch: lane l of a point takes packs l, l + lanes, ... of `vector`
    channels ('small': every channel). A thread meets no point at or past
    N."""
    rows = plan.threads // plan.lanes
    tid = np.arange(plan.threads)
    local, lane = tid // plan.lanes, tid % plan.lanes
    valid = tile * rows + local < N
    met = []
    if plan.variant == "small":
        met += [local[valid] * C + c for c in range(C)]
    else:
        packs = C // plan.vector
        for k0 in range(0, packs, plan.lanes):
            k = k0 + lane
            ok = valid & (k < packs)
            met += [local[ok] * C + k[ok] * plan.vector + i for i in range(plan.vector)]
    return np.bincount(np.concatenate(met), minlength=rows * C).reshape(rows, C)


def _check_common(plan, B, N, C, dtype, aligned, source_pixels):
    per_block = plan.threads // plan.lanes
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.threads % plan.lanes == 0
    bx, by = plan.blocks
    tiles = -(-N // per_block)
    assert by == B <= 65535 and 1 <= bx <= 2**31 - 1
    if getattr(plan, "shared_bytes", 0):
        # a staged plane: bx blocks walk the tiles grid-stride (block t % bx
        # takes tile t), one block an SM at most
        assert bx <= tiles and B * bx <= max(B, twarp.SMS)
    else:
        assert bx == tiles  # a block for every tile, none without a point
    pack = 16 // dtype.itemsize
    if plan.variant == "small":
        assert C <= twarp.SMALL_C and plan.vector == 1 and plan.lanes == 1
    else:
        assert C > twarp.SMALL_C
        assert plan.vector == (pack if aligned and C % pack == 0 else 1)
    # every offset the kernel forms in its index type: the source plane, the
    # grid / dout / output rows, and the point index of the last block's row
    largest = max(B * source_pixels * C, B * N * max(C, 2), N + bx * per_block)
    assert plan.index_bits == (32 if largest < 2**31 else 64)
    # the batch element is blockIdx.y and enters no point index, so every
    # batch element's tiles are batch element 0's; all but the last tile are
    # covered as the first is, and small launches are replayed tile by tile
    for t in (range(tiles) if tiles * plan.threads <= 50_000 else sorted({0, tiles - 1})):
        count = _replay_tile(plan, N, C, t)
        n_valid = min(per_block, N - t * per_block)
        assert (count[:n_valid] == 1).all() and (count[n_valid:] == 0).all()


def _check_warp_plan(B, N, C, dtype, aligned, source_pixels):
    plan = twarp.warp_plan(B, N, C, dtype, aligned, source_pixels)
    _check_common(plan, B, N, C, dtype, aligned, source_pixels)
    plane = source_pixels * C * dtype.itemsize
    if plan.shared_bytes:
        assert plan.variant == "small" and plan.threads == 1024 and N >= 1024
        assert plane <= plan.shared_bytes <= min(48 * 1024, MAX_DYNAMIC_SHARED)
        assert plan.shared_bytes % 16 == 0
    else:
        assert plan.threads == 256
        assert plan.variant == "vector" or plane > 48 * 1024 or N < 1024
    if plan.variant == "vector":
        packs = C // plan.vector
        # at most two packs a lane, or a full block of lanes; two only on a
        # large launch
        assert plan.lanes < 2 * packs and (2 * plan.lanes >= packs or plan.lanes == 256)
        assert plan.lanes == 256 or 2 * plan.lanes > packs or B * N * plan.lanes >= 65536
    return plan


def _check_dgrid_plan(B, N, C, dtype, aligned, source_pixels):
    plan = twarp.dgrid_plan(B, N, C, dtype, aligned, source_pixels)
    _check_common(plan, B, N, C, dtype, aligned, source_pixels)
    if plan.variant != "small":
        packs = C // plan.vector
        assert plan.lanes < 2 * packs
        assert 2 * plan.lanes >= packs or plan.lanes in (32, 1024)
    if plan.variant == "grouped":
        assert plan.lanes <= 32
    if plan.variant == "split":
        assert plan.lanes > 32 and plan.threads == max(256, plan.lanes)
        # only a point with more packs than a warp has lanes, on a launch
        # that 32 lanes a point would not fill
        assert C // plan.vector > 32 and B * N * 32 < twarp.FULL_WAVE
    # 'split' keeps one (gx, gy) per warp of the block in static shared memory
    assert 2 * 4 * (plan.threads // 32) <= min(48 * 1024, MAX_DYNAMIC_SHARED)
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_plans_for_every_config(path, dtype):
    for B, N, C, px in _config_warp_shapes(path):
        fwd = _check_warp_plan(B, N, C, dtype, True, px)
        dgrid = _check_dgrid_plan(B, N, C, dtype, True, px)
        # every shipped shape fits 32-bit offsets and 16-byte packs
        assert fwd.index_bits == dgrid.index_bits == 32
        assert fwd.variant == ("small" if C <= 4 else "vector")
        assert (dgrid.variant == "small") == (C <= 4)
        if C > 4:
            assert fwd.vector == dgrid.vector == 16 // dtype.itemsize


def test_plans_at_the_taichi_train_and_transfer_shapes():
    f32, bf16 = torch.float32, torch.bfloat16
    # the source frame: one thread per point, the 48 KB plane in shared
    # memory, a block of 1024 threads an SM walking the points
    assert twarp.warp_plan(1, CHUNK * 4096, 3, f32, True, 4096) == (
        "small", 1, 1, 1024, (132, 1), 32, 49152)
    assert twarp.warp_plan(32, 4096, 3, bf16, True, 4096) == (
        "small", 1, 1, 1024, (4, 32), 32, 24576)
    # a 256^2 frame does not fit: read in place
    assert twarp.warp_plan(1, CHUNK * 65536, 3, f32, True, 65536) == (
        "small", 1, 1, 256, (32768, 1), 32, 0)
    assert twarp.dgrid_plan(32, 4096, 3, bf16, True, 4096) == (
        "small", 1, 1, 256, (16, 32), 32)
    # 64 channels: 16 f32 or 8 bf16 packs, two a lane, summed in 3 or 2 steps
    assert twarp.dgrid_plan(32, 1024, 64, f32, True, 1024) == (
        "grouped", 4, 8, 256, (32, 32), 32)
    assert twarp.dgrid_plan(32, 1024, 64, bf16, True, 1024) == (
        "grouped", 8, 4, 256, (16, 32), 32)
    assert twarp.warp_plan(1, CHUNK * 1024, 64, bf16, True, 1024) == (
        "vector", 8, 4, 256, (2048, 1), 32, 0)
    # 256 f32 channels at 8x8: 2 packs a lane, 32 lanes, still one warp a point
    assert twarp.dgrid_plan(32, 64, 256, f32, True, 64).variant == "grouped"
    # C = 1024 at 2x2: 128 points, 256 f32 packs, 8 warps a point (one pack
    # a lane: two a lane would leave 16384 threads)
    assert twarp.dgrid_plan(32, 4, 1024, f32, True, 4) == ("split", 4, 256, 256, (4, 32), 32)
    assert twarp.dgrid_plan(32, 4, 1024, bf16, True, 4) == ("split", 8, 128, 256, (2, 32), 32)
    # a misaligned pointer or an odd C takes scalar loads
    assert twarp.dgrid_plan(32, 1024, 64, f32, False, 1024).vector == 1
    assert twarp.warp_plan(1, 8192, 5, f32, True, 64).vector == 1
    assert twarp.warp_plan(1, 8192, 12, bf16, True, 64).vector == 1
    # 2^31 elements of output need 64-bit offsets
    assert twarp.warp_plan(1, 2**21, 1024, bf16, True, 4).index_bits == 64
    assert twarp.dgrid_plan(1, 2**21, 1024, bf16, True, 4).index_bits == 64
    assert twarp.warp_plan(1, 2**21 - 1024, 1024, bf16, True, 4).index_bits == 32


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 4), st.integers(1, 3000),
       st.one_of(st.integers(1, 1100), st.sampled_from([3, 5, 7, 9, 12, 1023])),
       st.sampled_from(DTYPES), st.booleans(), st.integers(1, 5000))
def test_plans_drawn_shapes(B, N, C, dtype, aligned, source_pixels):
    _check_warp_plan(B, N, C, dtype, aligned, source_pixels)
    _check_dgrid_plan(B, N, C, dtype, aligned, source_pixels)


@pytest.mark.parametrize("B,N,C,px", [(64, 2**20, 40, 2**20), (1, 2**31 // 3 + 1, 3, 64),
                                      (60_000, 100, 8, 100), (2, 2**27, 1100, 16)])
def test_plans_at_large_shapes(B, N, C, px):
    for dtype in DTYPES:
        for aligned in (True, False):
            for plan in (twarp.warp_plan(B, N, C, dtype, aligned, px),
                         twarp.dgrid_plan(B, N, C, dtype, aligned, px)):
                largest = max(B * px * C, B * N * max(C, 2))
                assert plan.index_bits == (64 if largest >= 2**31 else 32)
                assert plan.blocks[1] == B and plan.blocks[0] <= 2**31 - 1


def test_plan_refuses_a_batch_past_the_launch_grid():
    with pytest.raises(ValueError, match="launch grid"):
        twarp.warp_plan(65536, 4, 64, torch.float32, True, 4)


# ---- (b) d_grid's partition and order of summation -------------------------

def dgrid_mirror(img, grid, dout, plan):
    """d_grid of (B, H, W, C) img at (B, N, 2) grid with (B, N, C) dout, in
    numpy f32, channel by channel as `plan` deals them to lanes and summed in
    the kernel's order."""
    B, H, W, C = img.shape
    N = grid.shape[1]
    one, half = np.float32(1), np.float32(0.5)
    x = (grid[..., 0] + one) * half * np.float32(W - 1)
    y = (grid[..., 1] + one) * half * np.float32(H - 1)
    x0, y0 = np.floor(x), np.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = one - wx1, one - wy1

    def corner(xs, ys):
        inside = (xs >= 0) & (xs <= W - 1) & (ys >= 0) & (ys <= H - 1)
        xi = np.clip(xs, 0, W - 1).astype(int)
        yi = np.clip(ys, 0, H - 1).astype(int)
        vals = img[np.arange(B)[:, None], yi, xi]  # (B, N, C)
        return np.where(inside[..., None], vals, np.float32(0))

    v00, v01 = corner(x0, y0), corner(x0 + 1, y0)
    v10, v11 = corner(x0, y0 + 1), corner(x0 + 1, y0 + 1)
    tx = dout * (wy0[..., None] * (v01 - v00) + wy1[..., None] * (v11 - v10))
    ty = dout * (wx0[..., None] * (v10 - v00) + wx1[..., None] * (v11 - v01))

    L, V = plan.lanes, plan.vector
    part = np.zeros((2, B, N, L), np.float32)
    for lane in range(L):
        for k in range(lane, C // V if plan.variant != "small" else 1, L):
            for c in (range(k * V, k * V + V) if plan.variant != "small" else range(C)):
                part[0, ..., lane] += tx[..., c]
                part[1, ..., lane] += ty[..., c]
    if plan.variant == "grouped":
        tree = [o for o in (16, 8, 4, 2, 1) if o < L]
    else:  # 'small' has one lane; 'split' sums each warp of 32
        tree = [o for o in (16, 8, 4, 2, 1) if o < min(L, 32)]
    for o in tree:
        part = part + part[..., np.arange(L) ^ o]
    total = np.zeros((2, B, N), np.float32)
    for w in range(0, L, 32) if plan.variant == "split" else (0,):
        total += part[..., w]
    return np.stack([total[0] * half * np.float32(W - 1),
                     total[1] * half * np.float32(H - 1)], axis=-1)


def _identity_grid(B, H, W):
    """Pixel coordinates on the integers (H - 1 and W - 1 powers of two, so
    the coordinate and its way back are exact in f32): the right
    difference."""
    xs = np.arange(W, dtype=np.float32) / (W - 1) * 2 - 1
    ys = np.arange(H, dtype=np.float32) / (H - 1) * 2 - 1
    g = np.stack(np.meshgrid(xs, ys), axis=-1)
    return np.broadcast_to(g, (B, H, W, 2)).astype(np.float32)


def _random_grid(rng, B, H, W, Ho, Wo, margin=0.05):
    """Samples over [-1.2, 1.2] (some corners outside), pixel coordinates
    kept `margin` away from the integers where floor() could flip."""
    g = rng.rand(B, Ho, Wo, 2).astype(np.float32) * 2.4 - 1.2
    for axis, n in ((0, W), (1, H)):
        px = (g[..., axis] + 1.0) * 0.5 * (n - 1)
        px = np.floor(px) + np.clip(px - np.floor(px), margin, 1.0 - margin)
        g[..., axis] = px / (0.5 * (n - 1)) - 1.0
    return g.astype(np.float32)


def _jax_dgrid(sampler, img, grid, dout):
    fn = jax.jit(jax.grad(lambda g, i, d: jnp.sum(sampler(i, g) * d)))
    return np.asarray(fn(jnp.asarray(grid), jnp.asarray(img), jnp.asarray(dout)))


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("C", [3, 5, 64, 1024])
def test_dgrid_mirror_matches_plain_jnp_and_pallas(C):
    """The mirror under the plan the kernel gets for this shape ('small' at
    3, scalar 'grouped' at 5, packed 'grouped' at 64, 'split' at 1024), on a
    random grid (batch element 0) and the identity grid (1). In f32, and in
    bf16 with its 8-channel packs on inputs rounded to bf16 and then held
    in f32, as the kernel reads them; the Pallas kernel in f32 only."""
    rng = np.random.RandomState(C)
    H, W = 5, 9
    img = rng.randn(2, H, W, C).astype(np.float32)
    grid = np.concatenate([_random_grid(rng, 1, H, W, H, W), _identity_grid(1, H, W)])
    dout = rng.randn(2, H, W, C).astype(np.float32)
    for dtype in DTYPES:
        if dtype == torch.bfloat16:
            img, dout = _bf16(img), _bf16(dout)
        plan = twarp.dgrid_plan(2, H * W, C, dtype, True, H * W)
        assert plan.variant == {3: "small", 5: "grouped", 64: "grouped", 1024: "split"}[C]
        assert plan.vector == (1 if C in (3, 5) else 16 // dtype.itemsize)
        got = dgrid_mirror(img, grid.reshape(2, -1, 2), dout.reshape(2, -1, C), plan)
        got = got.reshape(2, H, W, 2)
        plain = twarp.warp_dgrid_plain(torch.from_numpy(img), torch.from_numpy(grid),
                                       torch.from_numpy(dout)).numpy()
        scale = max(1.0, np.abs(plain).max())
        np.testing.assert_allclose(got, plain, atol=2e-5 * scale, rtol=0)
        np.testing.assert_allclose(got, _jax_dgrid(jsamp.grid_sample, img, grid, dout),
                                   atol=2e-5 * scale, rtol=0)
        if dtype == torch.float32:
            with pltpu.force_tpu_interpret_mode():
                pallas = _jax_dgrid(grid_sample_pallas, img, grid, dout)
            np.testing.assert_allclose(got, pallas, atol=1e-4 * scale, rtol=0)
        assert np.abs(plain).max() > 0.1
        # the identity grid's last column has its right neighbour outside:
        # d/dx there is -(W-1)/2 * sum_c dout * v
        right = -0.5 * (W - 1) * (dout[1, :, -1] * img[1, :, -1]).sum(-1)
        np.testing.assert_allclose(got[1, :, -1, 0], right, atol=2e-5 * scale, rtol=1e-5)


# ---- (c) one warp per encoder skip -----------------------------------------

def test_generator_warps_each_skip_once(monkeypatch):
    """A 5-block generator warps its 6 encoder skips once each (the JAX
    package warps 7 times: the source frame again for video_deformed), and
    video_deformed is what the JAX package's generator computes for it, a
    warp of the source frame by the flow (monkeynet_tpu/ops/sampling.py
    warp_video, plain jnp and the Pallas kernels in interpret mode). The
    whole generator against the JAX package's, video_deformed included:
    tests/test_torch_port_models.py."""
    from monkeynet_tpu_torch.models import generator as tgen
    from monkeynet_tpu_torch.tasks.build import build_models

    from .torch_port_common import kp_to_torch, random_kp, tiny_config

    config = tiny_config()
    config["model_params"]["generator_params"]["num_blocks"] = 5
    generator, _ = build_models(config, device="cpu", seed=0)
    head = generator.dense_motion_module.hourglass.decoder.conv
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # move the flow off the identity
        head.weight.copy_(0.02 * torch.randn(head.weight.shape, generator=gen))
    calls = []
    port_warp_video = tgen.warp_video

    def counting_warp_video(source, grid):
        calls.append((source, grid))
        return port_warp_video(source, grid)

    monkeypatch.setattr(tgen, "warp_video", counting_warp_video)
    rng = np.random.RandomState(5)
    source = rng.rand(1, 1, 32, 32, 3).astype(np.float32)
    kp_d, kp_s = random_kp(rng, 1, 2, 4), random_kp(rng, 1, 1, 4)
    with torch.no_grad():
        got = generator(torch.from_numpy(source), kp_to_torch(kp_d), kp_to_torch(kp_s))
    assert [tuple(s.shape) for s, _ in calls] == [
        (1, 32, 32, 3), (1, 16, 16, 16), (1, 8, 8, 32), (1, 4, 4, 64), (1, 2, 2, 64),
        (1, 1, 1, 64)]
    flow = calls[0][1].numpy()  # the deformation at the source frame's size
    assert np.array_equal(calls[0][0].numpy(), source[:, 0])
    want = jsamp.warp_video(jnp.asarray(source[:, 0]), jnp.asarray(flow))
    np.testing.assert_allclose(got["video_deformed"].numpy(), np.asarray(want), atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        pallas = grid_sample_pallas(jnp.asarray(source[:, 0]), jnp.asarray(flow.reshape(1, -1, 32, 2)))
    np.testing.assert_allclose(got["video_deformed"].numpy(),
                               np.asarray(pallas).reshape(got["video_deformed"].shape), atol=1e-5)
    assert np.abs(got["video_deformed"].numpy() - source).max() > 0.05  # warped off-grid
