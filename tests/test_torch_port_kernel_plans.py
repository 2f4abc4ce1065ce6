"""The soft-argmax and heatmap kernels of the PyTorch port, as far as a CPU
can hold them: what their wrappers decide in Python, the index arithmetic
the kernels share with those decisions, and the order of operations in which
the kernels depart from their plain versions.

(a) `softargmax_plan` and `heatmap_plan` over the shapes of every
    configs/*.yaml and over drawn shapes; a replay in numpy of how the
    kernels' threads walk a frame or a plane (every element met once, by the
    thread the kernel's reductions assume) and of the in-place conversion of
    staged bf16 logits (no store may reach an element another thread has
    still to read).
(b) `softargmax_mirror` and `heatmap_mirror` below repeat, in plain tensor
    code, the kernels' own order of operations (refined reciprocal division,
    one exp2 per element, folded factors, hoisted coordinates). They are held
    against the port's plain versions and against the JAX package (jnp form,
    and the Pallas kernels in interpret mode) from the same numpy inputs.

The kernels themselves cannot run here: chip_smoke.py holds them against
their plain versions on the card.

Tolerances: 1e-5 on soft-argmax statistics (size <= 1; f32 sums of a few
thousand terms in another order) and 1e-6 on heatmap values (<= 1; a few
ulps of the exponent), as chip_smoke.py; 2e-5 against the Pallas heatmap
kernel, the bound its own test holds it to.
"""

import glob
import math
import os

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
import torch

from monkeynet_tpu.ops import gaussian as jgauss
from monkeynet_tpu_torch.ops.cuda import heatmap as theat
from monkeynet_tpu_torch.ops.cuda import softargmax as tsoft

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))
DTYPES = [torch.float32, torch.bfloat16]
LOG2E = np.float32(1.44269504088896340736)
HALF_LOG2E = np.float32(0.72134752044448170368)


def _config_shapes(path):
    """(kp detector logits (H, W, K), embedding heatmap sizes) of a config."""
    with open(path) as f:
        config = yaml.safe_load(f)
    h, w, _ = config["dataset_params"].get("image_shape", (64, 64, 3))
    model = config["model_params"]
    K = model["common_params"]["num_kp"]
    scale = model["kp_detector_params"].get("scale_factor", 1)
    dense = model["generator_params"]["dense_motion_params"]
    embeddings = [dense.get("mask_embedding_params", {}),
                  model["generator_params"].get("kp_embedding_params", {})]
    sizes = {(int(h * e.get("scale_factor", 1)), int(w * e.get("scale_factor", 1)))
             for e in embeddings}
    norms = {e.get("norm_const", "sum") for e in embeddings}
    return (int(h * scale), int(w * scale), K), sorted(sizes), sorted(norms, key=str)


# ---- (a) plans -------------------------------------------------------------

def _staged_fits(H, W, K, dtype):
    """Whether any block size the staged variant allows fits the frame."""
    unit = math.lcm(32, K)
    elements = H * W * K
    return (unit <= 1024 and (elements * dtype.itemsize) % 16 == 0
            and 4 * (elements + 3 * unit + 3 * K) <= 232_448)


def _split_fits(H, W, K, dtype):
    """Whether the split variant has a block size for K: a multiple of 32
    within 640 threads whose vectors of 4 elements a sweep cover a multiple
    of K elements, on a frame of whole 16 bytes."""
    V = 4
    return (H * W * K * dtype.itemsize) % 16 == 0 and 32 * K // math.gcd(K, 32 * V) <= 640


def _check_softargmax_plan(H, W, K, dtype):
    plan = tsoft.softargmax_plan(H, W, K, dtype)
    if _staged_fits(H, W, K, dtype):
        assert plan.variant == "staged" and plan.rows == 0
        assert plan.threads % 32 == 0 and plan.threads % K == 0 and 0 < plan.threads <= 1024
        assert plan.shared_bytes == 4 * (H * W * K + 3 * plan.threads + 3 * K)
        assert plan.shared_bytes <= 232_448
    elif _split_fits(H, W, K, dtype):
        V = 4
        assert plan.variant == "split"
        assert plan.threads % 32 == 0 and (V * plan.threads) % K == 0
        assert 0 < plan.threads <= 640 and plan.shared_bytes == 28 * V * plan.threads
        # the most threads that keep each slot in one column, where some do
        unit = 32 * K // math.gcd(K, 32 * V)
        fixed = [t for t in range(unit, 641, unit) if (V * t // K) % W == 0]
        assert plan.threads == (fixed[-1] if fixed else max(unit, 320 // unit * unit))
        # a band is whole 16-byte vectors, and so the last, shorter, one too
        assert 1 <= plan.rows <= H and (plan.rows * W * K * dtype.itemsize) % 16 == 0
        # one frame in equal bands of about H / 132 rows, at least 4
        step = 16 // math.gcd(W * K * dtype.itemsize, 16)
        bands = max(1, round(H / max(4, H / 132)))
        assert plan.rows == min(H, -(-H // bands // step) * step)
    else:
        assert plan == tsoft.SoftargmaxPlan("plane", 256, 0)
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_softargmax_plan_for_every_config(path, dtype):
    (H, W, K), _, _ = _config_shapes(path)
    plan = _check_softargmax_plan(H, W, K, dtype)
    # the f32 tile of a frame decides, whatever the logits' dtype: 'split'
    # for vox-full's 256^2 x 10, 'staged' for every other config
    assert plan.variant == ("staged" if H * W * K * 4 <= 200_000 else "split")


def test_softargmax_plan_known_shapes():
    for dtype in DTYPES:
        # taichi, vox: 64^2 x 10, a thread per column (640 / 10 = 64 pixels a sweep)
        assert tsoft.softargmax_plan(64, 64, 10, dtype) == ("staged", 640, 171_640, 0)
        # vox-full: 256^2 x 10 is 2.6 MB a frame: 640 threads (a slot in one
        # column: 256 pixels a sweep), equal bands about 256 * frames / 132
        # rows high (at least 4: a source frame; a whole frame a block from
        # about 132 frames up)
        for frames, rows in ((1, 4), (2, 4), (32, 64), (128, 256), (200, 256)):
            assert tsoft.softargmax_plan(256, 256, 10, dtype, frames=frames) == (
                "split", 640, 71_680, rows)
        # a tensor that does not start on 16 bytes cannot be copied 16 bytes wide
        assert tsoft.softargmax_plan(64, 64, 10, dtype, aligned=False).variant == "plane"
    # 15 * 15 * 3 * 4 bytes is no multiple of 16; K = 33 has no block size
    assert tsoft.softargmax_plan(15, 15, 3, torch.float32).variant == "plane"
    assert tsoft.softargmax_plan(16, 16, 33, torch.float32).variant == "plane"
    # 16 * 16 * 1 bf16 elements are a multiple of 16 bytes, 3 * 3 * 8 are not
    assert tsoft.softargmax_plan(16, 16, 1, torch.bfloat16).variant == "staged"
    assert tsoft.softargmax_plan(3, 3, 8, torch.bfloat16).variant == "staged"
    assert tsoft.softargmax_plan(3, 3, 4, torch.bfloat16).variant == "plane"
    # 'split' where asked for and the frame allows it, else a refusal
    assert tsoft.softargmax_plan(32, 32, 3, torch.float32, variant="split") == (
        "split", 576, 64_512, 4)
    assert tsoft.softargmax_plan(20, 36, 10, torch.float32, variant="split") == (
        "split", 320, 35_840, 4)
    assert tsoft.softargmax_plan(256, 256, 10, torch.float32, variant="plane").variant == "plane"
    with pytest.raises(ValueError, match="no 'split' plan"):
        tsoft.softargmax_plan(15, 15, 3, torch.float32, variant="split")
    with pytest.raises(ValueError, match="no 'split' plan"):
        tsoft.softargmax_plan(16, 16, 33, torch.float32, variant="split")


def test_grid_sums_are_the_floor_terms_of_the_plain_version():
    """The floor's terms the split kernel adds: sum over the pixels of g and
    g g' of the coordinate grid, against make_coordinate_grid in f64. The
    kernel's f32 coordinates (one fused multiply-add each) sum to 4e-3, not
    0, at 256^2; the floor multiplies each sum by 1e-7, so 1e-2 of a sum
    moves a statistic by 1e-9."""
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    for H, W in ((256, 256), (48, 32), (3, 5)):
        g = make_coordinate_grid((H, W), dtype=torch.float64)
        gx, gy = g[..., 0], g[..., 1]
        want = [gx.sum(), gy.sum(), (gx * gx).sum(), (gy * gy).sum(), (gx * gy).sum(), H * W]
        np.testing.assert_allclose(tsoft.grid_sums(H, W), [float(v) for v in want],
                                   rtol=1e-6, atol=1e-2)


@settings(max_examples=300, deadline=None)
@given(st.integers(2, 300), st.integers(2, 300), st.integers(1, 40), st.sampled_from(DTYPES))
def test_softargmax_plan_drawn_shapes(H, W, K, dtype):
    _check_softargmax_plan(H, W, K, dtype)


def _walk_staged(H, W, K, threads, stages=4):
    """Replay the staged kernel's sweeps: (element -> thread, column, row as
    the kernel's float walk gives them, stage) for every element it meets."""
    E = H * W * K
    sweeps = -(-E // threads)
    t = np.arange(threads)
    p0, step = t // K, threads // K
    col, row = (p0 % W).astype(np.float32), (p0 // W).astype(np.float32)
    step_col, step_row = np.float32(step % W), np.float32(step // W)
    stage_end = [min(E, (sweeps * (s + 1) // stages) * threads) for s in range(stages)]
    owner = np.full(E, -1)
    cols, rows, stage = np.zeros(E), np.zeros(E), np.zeros(E, int)
    for sw in range(sweeps):
        e = sw * threads + t
        ok = e < E
        assert (owner[e[ok]] == -1).all()
        owner[e[ok]] = t[ok]
        cols[e[ok]], rows[e[ok]] = col[ok], row[ok]
        stage[e[ok]] = np.searchsorted(stage_end, e[ok], side="right")
        col, row = col + step_col, row + step_row
        wrap = col >= W
        col, row = np.where(wrap, col - W, col), np.where(wrap, row + 1, row)
    return owner, cols, rows, stage, stage_end


@pytest.mark.parametrize("shape", [(64, 64, 10), (64, 64, 4), (22, 20, 10), (20, 36, 10),
                                   (16, 12, 4), (5, 7, 16), (3, 3, 8)])
def test_staged_walk_meets_every_element_once(shape):
    """Thread t meets only keypoint t % K, every element once, at the pixel
    the walk says; stages are whole sweeps that start on 16 bytes."""
    H, W, K = shape
    plan = tsoft.softargmax_plan(H, W, K, torch.float32)
    assert plan.variant == "staged"
    owner, cols, rows, stage, stage_end = _walk_staged(H, W, K, plan.threads)
    e = np.arange(H * W * K)
    assert (owner >= 0).all()
    assert (owner % K == e % K).all()
    assert (cols == (e // K) % W).all() and (rows == (e // K) // W).all()
    assert stage_end[-1] == H * W * K and (stage < 4).all()
    assert all(end % plan.threads == 0 or end == H * W * K for end in stage_end)
    if (plan.threads // K) % W == 0:  # the kernel's fixed-column path
        for t in range(0, plan.threads, 7):
            assert len(set(cols[owner == t])) <= 1
            assert (np.diff(rows[owner == t]) == plan.threads // K // W).all()


@pytest.mark.parametrize("shape", [(64, 64, 10), (64, 64, 4), (22, 20, 10), (20, 36, 10),
                                   (3, 3, 8), (16, 16, 1)])
def test_bf16_conversion_in_place_never_overwrites_an_unread_element(shape):
    """bf16 logits sit in the upper half of the f32 tile; storing tile[e]
    overwrites staged elements 2e - E and 2e - E + 1. Replay the kernel's
    batches and barriers: every such element must have been read by its
    reader before a barrier that precedes the store, or by the storing thread
    itself earlier in its own program."""
    H, W, K = shape
    plan = tsoft.softargmax_plan(H, W, K, torch.bfloat16)
    assert plan.variant == "staged"
    E, NT, batch = H * W * K, plan.threads, 4
    sweeps = -(-E // NT)
    read_epoch = np.full(E, -1)  # barriers passed before the element is read
    read_batch = np.full(E, -1)
    epoch, read_by_all, barriers = 0, 0, 0
    for sw in range(0, sweeps, batch):
        lo, hi = sw * NT, min((sw + batch) * NT, E)
        read_epoch[lo:hi], read_batch[lo:hi] = epoch, sw
        reach = 2 * min((sw + batch) * NT, E) - E - 1
        if reach >= read_by_all * NT:
            epoch, read_by_all, barriers = epoch + 1, sw + batch, barriers + 1
        e = np.arange(lo, hi)
        for hit in (2 * e - E, 2 * e - E + 1):
            live = hit >= 0
            victim, storer = hit[live], e[live]
            assert (victim < E).all()
            assert (read_batch[victim] >= 0).all()  # read in this batch or before
            same_thread = victim % NT == storer % NT
            assert (same_thread | (read_epoch[victim] < epoch)).all()
    assert barriers <= 8


def _walk_heatmap(H, W, vector, threads=256):
    """Replay heatmap_kernel's thread mapping: how often each pixel of a
    plane is stored, and the most rows one thread meets."""
    wv = W // vector
    cols_per_sweep = min(wv, threads)
    rows_per_sweep = threads // cols_per_sweep
    count = np.zeros((H, W), int)
    most_rows = 0
    for t in range(threads):
        col_vec, trow = t % cols_per_sweep, t // cols_per_sweep
        row0 = trow if trow < rows_per_sweep else H
        rows = range(row0, H, rows_per_sweep)
        most_rows = max(most_rows, len(rows))
        for cv in range(col_vec, wv, cols_per_sweep):
            for r in rows:
                count[r, cv * vector:(cv + 1) * vector] += 1
    return count, most_rows, -(-wv // cols_per_sweep)


def _check_heatmap_plan(H, W, norm):
    plan = theat.heatmap_plan(H, W, norm)
    assert plan.vector == (4 if W % 4 == 0 else 1)
    count, most_rows, column_sweeps = _walk_heatmap(H, W, plan.vector)
    assert (count == 1).all()
    if norm == "sum":
        holds = column_sweeps == 1 and most_rows <= theat.HOLD_ROWS
        assert plan.sum_mode == ("registers" if holds else "recompute")
    else:
        assert plan.sum_mode is None
    return plan


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_heatmap_plan_for_every_config(path):
    _, sizes, norms = _config_shapes(path)
    for H, W in sizes:
        for norm in norms + ["sum", None]:
            plan = _check_heatmap_plan(H, W, norm)
            assert plan.vector == 4  # every shipped size is a multiple of 4 wide
            if norm == "sum":
                assert (plan.sum_mode == "registers") == (H * W <= 64 * 64)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 80), st.integers(1, 300), st.sampled_from([None, "sum", 100]))
def test_heatmap_plan_drawn_shapes(H, W, norm):
    _check_heatmap_plan(H, W, norm)


def test_heatmap_plan_known_shapes():
    assert theat.heatmap_plan(64, 64, 100) == (4, None)
    assert theat.heatmap_plan(64, 64, "sum") == (4, "registers")
    assert theat.heatmap_plan(128, 128, "sum") == (4, "recompute")
    assert theat.heatmap_plan(30, 30, "sum") == (1, "registers")
    assert theat.heatmap_plan(8, 2048, "sum") == (4, "recompute")  # two sweeps of columns


# ---- (b) the kernels' order of operations ----------------------------------

def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product of two f32 is exact in f64)."""
    return _f32(a.astype(np.float64) * np.float64(b) + np.asarray(c, np.float64))


def _divide(x, d):
    """csrc/softargmax.cu `divide`: x * (1 / d), corrected by its remainder."""
    d = np.float32(d)
    r = np.float32(1.0) / d
    q = _f32(x * r)
    return _fma(_fma(-q, d, x), r, q)


def test_refined_division_is_the_division():
    x = _f32(np.random.RandomState(0).randn(400_000) * 30.0)
    for d in (0.1, 0.07, 3.0, -0.1):
        got, want = _divide(x, d), _f32(x / np.float32(d))
        assert (got == want).mean() > 0.99999
        np.testing.assert_allclose(got, want, rtol=1.2e-7)
    # what it replaces: x * (1 / 0.1f) alone is an ulp off for a third of the values
    assert (_f32(x * (np.float32(1.0) / np.float32(0.1))) != _f32(x / np.float32(0.1))).mean() > 0.1


def softargmax_mirror(logits, temperature):
    """The staged kernel's order of operations on (B, D, H, W, K) logits
    (numpy f32, or bf16 values held in f32) -> (B, D, K, 5) f32."""
    B, D, H, W, K = logits.shape
    NT = tsoft.softargmax_plan(H, W, K, torch.float32).threads
    fixed_col = (NT // K) % W == 0
    E = H * W * K
    sweeps = -(-E // NT)
    x = _f32(logits).reshape(B * D, E)
    x = np.pad(x, ((0, 0), (0, sweeps * NT - E))).reshape(B * D, sweeps, NT)
    e_idx = np.arange(sweeps * NT).reshape(sweeps, NT)
    valid = e_idx < E  # the last sweep may end inside the block
    pixel = np.minimum(e_idx, E - 1) // K
    sx, sy = np.float32(2.0) / np.float32(W - 1), np.float32(2.0) / np.float32(H - 1)
    col, row = _f32(pixel % W), _f32(pixel // W)
    gx, gy = _fma(col, sx, np.float32(-1.0)), _fma(row, sy, np.float32(-1.0))

    def per_keypoint(partials, op=np.add):  # (N, NT) per-thread partials -> (N, NT)
        grouped = op.reduce(partials.reshape(-1, NT // K, K), axis=1, dtype=np.float32)
        return np.tile(grouped, (1, NT // K))

    def over_sweeps(terms):  # sequential f32 accumulation down a thread's sweeps
        acc = np.zeros_like(terms[:, 0])
        for s in range(sweeps):
            acc = _f32(acc + terms[:, s])
        return acc

    sign = np.float32(1.0 if temperature > 0 else -1.0)
    thread_max = np.where(valid, sign * x, -np.inf).max(axis=1)
    top = _divide(per_keypoint(thread_max, np.maximum) * sign, temperature)
    top2 = _f32(top * LOG2E)
    e = torch.exp2(torch.from_numpy(_fma(_divide(x, temperature), LOG2E, -top2[:, None, :])))
    e = np.where(valid, e.numpy(), np.float32(0.0))
    s0 = over_sweeps(e)
    if fixed_col:
        s1 = _fma(over_sweeps(_f32(e * row)), sy, -s0)
        s2 = _f32(gx[0] * s0)
    else:
        s1, s2 = over_sweeps(_f32(e * gy)), over_sweeps(_f32(e * gx))
    s0, s1, s2 = per_keypoint(s0), per_keypoint(s1), per_keypoint(s2)
    inv = np.float32(1.0) / s0
    mx, my = _f32(s2 * inv), _f32(s1 * inv)
    p = np.where(valid, _fma(e, inv[:, None, :], np.float32(1e-7)), np.float32(0.0))
    if fixed_col:
        dy = _f32(_fma(row, sy, _f32(-1.0 - my)[:, None, :]))
        dx = _f32(gx[0] - mx)
        pdy = _f32(p * dy)
        vxx = _f32(_f32(over_sweeps(p) * dx) * dx)
        vxy = _f32(over_sweeps(pdy) * dx)
        vyy = over_sweeps(_f32(pdy * dy))
    else:
        dx, dy = _f32(gx - mx[:, None, :]), _f32(gy - my[:, None, :])
        pdx = _f32(p * dx)
        vxx, vxy = over_sweeps(_f32(pdx * dx)), over_sweeps(_f32(pdx * dy))
        vyy = over_sweeps(_f32(_f32(p * dy) * dy))
    vxx, vxy, vyy = per_keypoint(vxx), per_keypoint(vxy), per_keypoint(vyy)
    stats = np.stack([mx, my, vxx, vxy, vyy], axis=-1)[:, :K]
    return stats.reshape(B, D, K, 5)


def _exp2(a):
    return _f32(torch.exp2(torch.from_numpy(_f32(a))).numpy())


def _merge(am, as_, bm, bs):
    """csrc/softargmax.cu partial_merge on arrays: (m, sums[..., 6])."""
    m = np.maximum(am, bm)
    with np.errstate(invalid="ignore"):
        fa = np.where(am == m, np.float32(1.0), _exp2(_f32(am - m)))
        fb = np.where(bm == m, np.float32(1.0), _exp2(_f32(bm - m)))
    return m, _f32(_f32(as_ * fa[..., None]) + _f32(bs * fb[..., None]))


def _lanes_then_butterfly(m, sums):
    """Merge partials (..., n) and (..., n, 6) as a warp does: lane l takes
    entries l, l + 32, ... in order, then the butterfly of shuffles; lane
    0's result."""
    n = m.shape[-1]
    lanes = -(-n // 32) * 32
    pm = np.concatenate([m, np.full(m.shape[:-1] + (lanes - n,), -np.inf, np.float32)], -1)
    ps = np.concatenate([sums, np.zeros(sums.shape[:-2] + (lanes - n, 6), np.float32)], -2)
    pm = pm.reshape(m.shape[:-1] + (lanes // 32, 32))
    ps = ps.reshape(sums.shape[:-2] + (lanes // 32, 32, 6))
    am = np.full(m.shape[:-1] + (32,), -np.inf, np.float32)
    as_ = np.zeros(m.shape[:-1] + (32, 6), np.float32)
    for c in range(lanes // 32):
        am, as_ = _merge(am, as_, pm[..., c, :], ps[..., c, :, :])
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        am, as_ = _merge(am, as_, am[..., lane ^ off], as_[..., lane ^ off, :])
    return am[..., 0], as_[..., 0, :]


def softargmax_split_mirror(logits, temperature, plan):
    """The split kernels' order of operations on (B, D, H, W, K) logits
    (numpy f32, or bf16 values held in f32) under `plan` -> (B, D, K, 5)
    f32: per band of plan.rows rows, each thread's 4 element slots (a
    vector of 4 elements) updated element by element with a running max of
    y log2(e) (where a slot stays in one column, only the sums without gx,
    those with gx from the column at the end), the block's slots of a
    keypoint merged by a warp, the frame's bands by another, then the
    statistics with the floor's grid sums."""
    B, D, H, W, K = logits.shape
    N, V, NT = B * D, 4, plan.threads
    x = _divide(_f32(logits).reshape(N, H, W * K), temperature)
    sx, sy = np.float32(2.0) / np.float32(W - 1), np.float32(2.0) / np.float32(H - 1)
    band_m, band_s = [], []
    for r0 in range(0, H, plan.rows):
        rb = min(plan.rows, H - r0)
        y = x[:, r0:r0 + rb].reshape(N, -1)
        n = y.shape[1]
        sweeps = -(-n // (V * NT))
        e_idx = np.arange(sweeps * NT * V).reshape(sweeps, NT, V)
        valid = e_idx < n
        y = np.pad(y, ((0, 0), (0, sweeps * NT * V - n))).reshape(N, sweeps, NT, V)
        pixel = np.minimum(e_idx, n - 1) // K
        gx = _fma(_f32(pixel % W), sx, np.float32(-1.0))
        gy = _fma(_f32(r0 + pixel // W), sy, np.float32(-1.0))
        fixed_col = (V * NT // K) % W == 0  # each slot in one column
        m = np.full((N, NT, V), -np.inf, np.float32)
        sums = np.zeros((N, NT, V, 6), np.float32)
        for s in range(sweeps):
            ys, ok = y[:, s], valid[s]
            y2 = _f32(ys * LOG2E)  # the running max is kept in base 2
            new = ok & (y2 > m)
            with np.errstate(invalid="ignore", over="ignore"):
                f = np.where(new, _exp2(np.where(new, m - y2, 0)), np.float32(1.0))
            sums = _f32(sums * f[..., None])
            m = np.where(new, y2, m)
            e = _exp2(_fma(ys, LOG2E, -m))
            egx, egy = _f32(e * gx[s]), _f32(e * gy[s])
            upd = np.stack([_f32(sums[..., 0] + e), _f32(sums[..., 1] + egx),
                            _f32(sums[..., 2] + egy), _fma(egx, gx[s], sums[..., 3]),
                            _fma(egx, gy[s], sums[..., 4]), _fma(egy, gy[s], sums[..., 5])], -1)
            if fixed_col:  # e*gx terms come from the column's gx at the end
                upd[..., [1, 3, 4]] = 0
            sums = np.where(ok[..., None], upd, sums)
        if fixed_col:
            sums[..., 1] = _f32(gx[0] * sums[..., 0])
            sums[..., 3] = _f32(gx[0] * sums[..., 1])
            sums[..., 4] = _f32(gx[0] * sums[..., 2])
        # slot u = V t + j holds keypoint u % K; keypoint k's slots k + K i
        m, sums = m.reshape(N, NT * V), sums.reshape(N, NT * V, 6)
        per = NT * V // K
        km = m.reshape(N, per, K).transpose(0, 2, 1)
        ks = sums.reshape(N, per, K, 6).transpose(0, 2, 1, 3)
        bm, bs = _lanes_then_butterfly(km, ks)
        band_m.append(bm)
        band_s.append(bs)
    m, sums = _lanes_then_butterfly(np.stack(band_m, -1), np.stack(band_s, -2))
    g1x, g1y, g2x, g2y, gxy, hw = (np.float32(v) for v in tsoft.grid_sums(H, W))
    inv = np.float32(1.0) / sums[..., 0]
    ex, ey = _f32(sums[..., 1] * inv), _f32(sums[..., 2] * inv)
    mx, my = _fma(np.float32(1e-7), g1x, ex), _fma(np.float32(1e-7), g1y, ey)
    cx, cy = _f32(ex - mx), _f32(ey - my)
    floor = np.float32(1e-7)
    vxx = _fma(-ex, ex, _f32(sums[..., 3] * inv)) + cx * cx + floor * (
        g2x - 2 * mx * g1x + hw * mx * mx)
    vxy = _fma(-ex, ey, _f32(sums[..., 4] * inv)) + cx * cy + floor * (
        gxy - mx * g1y - my * g1x + hw * mx * my)
    vyy = _fma(-ey, ey, _f32(sums[..., 5] * inv)) + cy * cy + floor * (
        g2y - 2 * my * g1y + hw * my * my)
    return _f32(np.stack([mx, my, vxx, vxy, vyy], -1)).reshape(B, D, K, 5)


SOFTARGMAX_CASES = {
    # name: (shape, scale of the randn logits, bf16 logits)
    "fixed column": ((2, 3, 16, 16, 10), 1.0, False),
    "moving column": ((1, 2, 10, 36, 10), 1.0, False),
    "K=4": ((2, 2, 16, 12, 4), 1.0, False),
    "ragged sweep": ((1, 3, 22, 20, 10), 1.0, False),
    "peaked": ((2, 3, 16, 16, 10), 30.0, False),
    "bf16": ((2, 3, 16, 16, 10), 1.0, True),
    "bf16 peaked": ((1, 2, 10, 36, 10), 30.0, True),
}


@pytest.mark.parametrize("case", list(SOFTARGMAX_CASES))
def test_softargmax_kernel_order_matches_plain_jnp_and_pallas(case):
    from monkeynet_tpu.ops.pallas.softargmax import gaussian2kp_pallas

    shape, scale, bf16 = SOFTARGMAX_CASES[case]
    logits = (np.random.RandomState(11).randn(*shape) * scale).astype(np.float32)
    t_logits = torch.from_numpy(logits)
    if bf16:
        t_logits = t_logits.to(torch.bfloat16)
        logits = t_logits.float().numpy()
    got = softargmax_mirror(logits, 0.1)
    plain = tsoft.softargmax_plain(t_logits, 0.1).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)

    def stats_of(kp):
        var = np.asarray(kp["var"], np.float32)
        return np.concatenate([np.asarray(kp["mean"], np.float32), var[..., 0, :1],
                               var[..., 0, 1:], var[..., 1, 1:]], axis=-1)

    j_logits = jnp.asarray(logits)
    ref = jgauss.gaussian2kp(jgauss.spatial_softmax(j_logits, 0.1), "matrix")
    np.testing.assert_allclose(got, stats_of(ref), atol=1e-5, rtol=0)
    pallas = gaussian2kp_pallas(j_logits, 0.1, "matrix", interpret=True)
    np.testing.assert_allclose(got, stats_of(pallas), atol=1e-5, rtol=0)
    assert np.isfinite(got).all() and (got[..., 2] > 0).all() and (got[..., 4] > 0).all()


SPLIT_CASES = {
    # name: (shape, rows a band, scale of the randn logits, bf16 logits)
    "32^2 K=3": ((1, 2, 32, 32, 3), 5, 1.0, False),
    "48^2 K=10": ((1, 2, 48, 48, 10), 7, 1.0, False),
    "48^2 K=10 peaked": ((2, 1, 48, 48, 10), 16, 30.0, False),
    "32^2 K=10 bf16": ((1, 2, 32, 32, 10), 6, 1.0, True),
    "48^2 K=3 bf16 peaked": ((1, 2, 48, 48, 3), 48, 30.0, True),
    "moving column": ((1, 2, 20, 36, 10), 6, 1.0, False),
    "moving column bf16 peaked": ((2, 1, 20, 36, 10), 20, 30.0, True),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_softargmax_split_order_matches_plain_jnp_and_pallas(case):
    """The split variant's band partition and merge order (forced through
    the plan at sizes 'staged' would take, with bands of a few rows, the
    last one shorter), against the plain version, the JAX package's jnp
    form and its Pallas kernel in interpret mode, tolerance 1e-5."""
    from monkeynet_tpu.ops.pallas.softargmax import gaussian2kp_pallas

    shape, rows, scale, bf16 = SPLIT_CASES[case]
    dtype = torch.bfloat16 if bf16 else torch.float32
    plan = tsoft.softargmax_plan(*shape[2:], dtype, variant="split")._replace(rows=rows)
    logits = (np.random.RandomState(12).randn(*shape) * scale).astype(np.float32)
    t_logits = torch.from_numpy(logits).to(dtype)
    logits = t_logits.float().numpy()
    got = softargmax_split_mirror(logits, 0.1, plan)
    plain = tsoft.softargmax_plain(t_logits, 0.1).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)
    j_logits = jnp.asarray(logits)
    ref = jgauss.gaussian2kp(jgauss.spatial_softmax(j_logits, 0.1), "matrix")
    pallas = gaussian2kp_pallas(j_logits, 0.1, "matrix", interpret=True)
    for kp in (ref, pallas):
        var = np.asarray(kp["var"], np.float32)
        want = np.concatenate([np.asarray(kp["mean"], np.float32), var[..., 0, :1],
                               var[..., 0, 1:], var[..., 1, 1:]], axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all() and (got[..., 2] > 0).all() and (got[..., 4] > 0).all()


def heatmap_mirror(kp, size, variance, norm):
    """csrc/heatmap.cu's order of operations -> (B, D, K, H, W) f32."""
    H, W = size
    mean = _f32(kp["mean"])
    mx, my = mean[..., 0, None, None], mean[..., 1, None, None]
    one, zero = np.float32(1.0), np.float32(0.0)
    if variance == "matrix":
        var = _f32(kp["var"])
        a, b, c, d = (var[..., i, j, None, None] for i in (0, 1) for j in (0, 1))
        ca, cu, cw = d, _f32(b + c), a
        factor = _f32(-HALF_LOG2E / _f32(_f32(a * d) - _f32(b * c)))
    else:
        v = _f32(kp["var"])[..., 0, 0, None, None] if variance == "single" else np.float32(variance)
        ca, cu, cw = one, zero, one
        factor = _f32(-HALF_LOG2E / v)
    gx = _f32(2.0 * (np.arange(W, dtype=np.float32) / np.float32(W - 1)) - 1.0)
    gy = _f32(2.0 * (np.arange(H, dtype=np.float32) / np.float32(H - 1)) - 1.0)
    dx, dy = _f32(gx[None, :] - mx), _f32(gy[:, None] - my)
    t1, u = _f32(_f32(ca * dx) * dx), _f32(cu * dx)  # per plane and column
    w = _f32(_f32(cw * dy) * dy)                       # per plane and row
    n = _f32(_f32(t1 - _f32(u * dy)) + w)
    h = torch.exp2(torch.from_numpy(_f32(n * factor))).numpy()
    if norm is None:
        return h
    if norm == "sum":
        return _f32(h * (one / h.sum(axis=(-1, -2), keepdims=True, dtype=np.float32)))
    return _f32(h * (one / np.float32(norm)))


def _narrow_keypoints(rng, B, D, K, variance):
    """Keypoints out to +-0.9 with variances from 0.005 (narrow gaussians
    near the border: the worst case for folded constants)."""
    mean = rng.choice([-0.9, 0.9], size=(B, D, K, 2)) * rng.uniform(0.0, 1.0, (B, D, K, 2)) ** 0.25
    kp = {"mean": mean.astype(np.float32)}
    if variance == "matrix":
        a = rng.randn(B, D, K, 2, 2) * 0.1
        kp["var"] = (a @ a.transpose(0, 1, 2, 4, 3) + 0.005 * np.eye(2)).astype(np.float32)
    elif variance == "single":
        kp["var"] = rng.uniform(0.005, 0.02, (B, D, K, 1, 1)).astype(np.float32)
    return kp


@pytest.mark.parametrize("variance", ["matrix", "single", 0.01])
@pytest.mark.parametrize("norm", [None, "sum", 100])
def test_heatmap_kernel_order_matches_plain_jnp_and_pallas(variance, norm):
    from monkeynet_tpu.ops.pallas.heatmap import kp2gaussian_pallas

    kp = _narrow_keypoints(np.random.RandomState(12), 2, 3, 10, variance)
    size = (32, 24)
    got = heatmap_mirror(kp, size, variance, norm)
    t_kp = {k: torch.from_numpy(v) for k, v in kp.items()}
    np.testing.assert_allclose(got, theat.heatmap_plain(t_kp, size, variance, norm).numpy(),
                               atol=1e-6, rtol=0)
    ref = np.asarray(jgauss.kp2gaussian(kp, size, variance))
    if norm == "sum":
        ref = ref / ref.sum(axis=(-1, -2), keepdims=True)
    elif norm is not None:
        ref = ref / norm
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    pallas = kp2gaussian_pallas({k: jnp.asarray(v) for k, v in kp.items()}, size, variance,
                                norm_const=norm, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=0)
    assert got.max() > (0.5 if norm is None else 0.0)  # the peaks lie on the grid
