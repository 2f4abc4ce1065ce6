"""The warp d_src kernel of the PyTorch port, as far as a CPU can hold it.

(a) `dsrc_plan` over the d_src shapes of every configs/*.yaml train step (the
    encoder skips past the source frame, which needs no gradient) and over
    drawn shapes: a replay in numpy of which block and thread write each
    (batch element, pixel, channel) of the gradient and which block reads
    each channel of dout, the card's limits (block size, launch grid, shared
    memory), the 32/64-bit choice, and where 'bands' is taken.
(b) `dsrc_mirror` repeats in numpy f32 the kernel's partition and order of
    summation: channel slices (and bands of rows), points binned a chunk at
    a time by the cell of their top-left corner, each pixel's four cells in
    the order its 2 x 2 quad walks them and the points of a cell in index
    order, f32 sums added into the slice's plane once per chunk, one
    rounding to the output dtype at the end. It is held against
    `warp_dsrc_plain` and against the JAX package's d_src (jax.grad of the
    jnp grid_sample, and of the Pallas kernels in interpret mode, as
    tests/test_torch_port_grad.py runs them) on random, out-of-range,
    integer and contracting grids, in f32 and bf16. `place_in_order`
    replays the kernel's placement (a warp's sweep, ranks among the lanes
    that share a cell) and shows that it puts every cell's points in index
    order, the order the mirror sums them in.

The kernel itself cannot run here: chip_smoke.py holds it against the plain
version on the card.

Tolerances: d_src sums a few products per (pixel, channel) in f32 in
another order than the plain version: 2e-5 of the largest value (at least
1), as chip_smoke.py holds the kernel; in bf16, results rounded to bf16 from
f32 sums of the same bf16 inputs: 2^-8 of it.
"""

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

from .test_torch_port_warp_plans import CONFIGS, _config_warp_shapes

DTYPES = [torch.float32, torch.bfloat16]
MAX_DYNAMIC_SHARED = 232_448


def _config_dsrc_shapes(path):
    """(batch, points, channels, (H, W)) of every d_src of a config's train
    step: one per encoder skip past the source frame, at the train batch."""
    with open(path) as f:
        h, w, _ = yaml.safe_load(f)["dataset_params"].get("image_shape", (64, 64, 3))
    # _config_warp_shapes gives a (chunk, train) pair per skip, the source first
    train = _config_warp_shapes(path)[1::2]
    return [(B, N, C, (h >> i, w >> i)) for i, (B, N, C, _) in enumerate(train) if i > 0]


# ---- (a) plans -------------------------------------------------------------

def _replay(plan, C, H, W):
    """How often the threads of the blocks of one batch element write each
    (pixel, channel) of the gradient, and which block reads each channel of
    dout in each band: block x owns band x // slices, rows [band * rows, +
    rows) clipped to H, and channels [s * channels, (s + 1) * channels) of
    slice s = x % slices; thread t is lane t % lanes of row t // lanes,
    takes the band's pixels row, row + rows, ... and packs lane, lane +
    lanes, ... of `vector` channels."""
    rows = plan.threads // plan.lanes
    tid = np.arange(plan.threads)
    row, lane = tid // plan.lanes, tid % plan.lanes
    slices = -(-C // plan.channels)
    written = np.zeros((H * W, C), int)
    reader = np.full((-(-H // plan.rows), C), -1)
    for x in range(plan.blocks[0]):
        band, s = divmod(x, slices)
        y_lo = band * plan.rows
        hb = min(plan.rows, H - y_lo)
        if hb <= 0:
            continue
        c0 = s * plan.channels
        packs = (min(C, c0 + plan.channels) - c0) // plan.vector
        assert packs >= 1
        assert (reader[band, c0:c0 + packs * plan.vector] == -1).all()
        reader[band, c0:c0 + packs * plan.vector] = x
        for px0 in range(0, hb * W, rows):
            px = px0 + row
            for k0 in range(0, packs, plan.lanes):
                k = k0 + lane
                ok = (px < hb * W) & (k < packs)
                for i in range(plan.vector):
                    np.add.at(written, (y_lo * W + px[ok], c0 + k[ok] * plan.vector + i), 1)
    return written, reader


def _check_dsrc_plan(B, N, C, dtype, aligned, hw):
    H, W = hw
    plan = twarp.dsrc_plan(B, N, C, dtype, aligned, hw)
    pack = 16 // dtype.itemsize
    chunk = max(1, min(N, 1024))
    vector = pack if aligned and C % pack == 0 else 1

    def shared_bytes(channels, chunk=chunk, rows=H):
        return twarp.dsrc_shared_bytes(rows, W, channels, chunk, dtype.itemsize, N > chunk)

    fits = shared_bytes(vector) <= MAX_DYNAMIC_SHARED
    assert plan.variant == ("shared" if fits else "bands")
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.threads % plan.lanes == 0
    bx, by = plan.blocks
    assert by == B <= 65535 and 1 <= bx <= 2**31 - 1
    assert plan.vector == vector
    assert plan.channels % plan.vector == 0 and plan.vector <= plan.channels <= C
    packs = plan.channels // plan.vector
    assert plan.lanes == min(256, 1 << (packs - 1).bit_length())
    # a slice of at least a 32-byte sector of channels where C has them
    sector = max(plan.vector, min(C, 32 // dtype.itemsize))
    if plan.variant == "shared":
        assert plan.rows == H
        # all the points in one chunk where they fit the shared memory at once
        one_chunk = N > chunk and shared_bytes(plan.channels, N) <= MAX_DYNAMIC_SHARED
        assert plan.chunk == (N if one_chunk else chunk)
        # the slice, from all C channels, is halved in whole loads while its
        # block does not fit, and down to a sector while it takes more than
        # half the shared memory or the launch has fewer blocks than SMs
        def halve(channels):
            return shared_bytes(channels) > MAX_DYNAMIC_SHARED or channels > sector and (
                shared_bytes(channels) > MAX_DYNAMIC_SHARED // 2
                or B * -(-C // channels) < twarp.SMS)

        halvings = [C]
        while halvings[-1] > plan.vector and halve(halvings[-1]):
            floor = sector if halvings[-1] > sector else plan.vector
            halvings.append(max(floor, -(-(halvings[-1] // 2) // plan.vector) * plan.vector))
        assert halvings[-1] == plan.channels
    else:
        # a sector of channels (one load where a row of it does not fit) over
        # the most rows that fit half the shared memory (all of it where one
        # row does not)
        assert plan.chunk == chunk
        assert plan.channels == (sector if shared_bytes(sector, rows=1) <= MAX_DYNAMIC_SHARED
                                 else plan.vector)
        budget = (MAX_DYNAMIC_SHARED // 2 if shared_bytes(plan.channels, rows=1)
                  <= MAX_DYNAMIC_SHARED // 2 else MAX_DYNAMIC_SHARED)
        assert 1 <= plan.rows < H
        assert shared_bytes(plan.channels, rows=plan.rows) <= budget
        assert shared_bytes(plan.channels, rows=plan.rows + 1) > budget
    assert bx == -(-C // plan.channels) * -(-H // plan.rows)
    # a 2 x 2 quad of pixels a gather thread where the block has 256 (quad,
    # load) items, else a pixel; a thread an item, 128 to 512
    assert plan.tile == (2 if -(-plan.rows // 2) * -(-W // 2) * packs >= 256 else 1)
    tiles = -(-plan.rows // plan.tile) * -(-W // plan.tile)
    assert plan.threads == min(512, max(128, 1 << (tiles * packs - 1).bit_length()))
    assert plan.shared_bytes == shared_bytes(plan.channels, plan.chunk, plan.rows)
    assert plan.shared_bytes <= MAX_DYNAMIC_SHARED
    # the point index runs to one chunk past the last point
    largest = max(B * H * W * C, B * N * max(C, 2), N + bx * plan.chunk)
    if H * W * C <= 200_000:
        written, reader = _replay(plan, C, H, W)
        assert (written == 1).all()  # every value of the gradient once
        assert (reader >= 0).all()  # every channel of dout by one block a band
    assert plan.index_bits == (32 if largest < 2**31 else 64)
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.rsplit("/", 1)[-1] for p in CONFIGS])
def test_dsrc_plans_for_every_config(path, dtype):
    for B, N, C, hw in _config_dsrc_shapes(path):
        plan = _check_dsrc_plan(B, N, C, dtype, True, hw)
        assert plan.index_bits == 32
        # one pack's slice fits unless the plane is 128^2 or larger
        assert (plan.variant == "bands") == (hw[0] * hw[1] >= 128 * 128)


def test_dsrc_plans_at_the_taichi_train_step():
    """One launch a call at every d_src shape of the taichi train step, with
    a block an SM or more (batch 32 x 8 slices; 4 where 8 would leave a slice
    under 32 bytes)."""
    f32, bf16 = torch.float32, torch.bfloat16
    for C, h in ((64, 32), (128, 16), (256, 8), (512, 4), (1024, 2)):
        for dtype in (f32, bf16):
            plan = twarp.dsrc_plan(32, h * h, C, dtype, True, (h, h))
            assert plan.variant == "shared" and plan.vector == 16 // dtype.itemsize
            # 8 slices, but no slice under 32 bytes: 4 of 16 bf16 channels at 64
            slices = 4 if (C, dtype) == (64, bf16) else 8
            assert plan.blocks == (slices, 32) and plan.channels == C // slices
    assert twarp.dsrc_plan(32, 1024, 64, f32, True, (32, 32)) == (
        "shared", 4, 8, 2, 1024, 2, 512, (8, 32), 66720, 32, 32)
    # the 64 x 128^2 skip of the 256^2 configs does not fit: 'bands' of 6
    # rows of 16 bf16 channels (22 bands x 4 slices), of 10 rows of 8 f32
    # channels (13 x 8)
    assert twarp.dsrc_plan(20, 16384, 64, bf16, True, (128, 128)) == (
        "bands", 8, 16, 2, 1024, 2, 512, (88, 20), 112896, 32, 6)
    assert twarp.dsrc_plan(20, 16384, 64, f32, True, (128, 128)) == (
        "bands", 4, 8, 2, 1024, 2, 512, (104, 20), 112960, 32, 10)
    # a misaligned pointer or an odd C: scalar loads (the slice no narrower
    # than a 32-byte sector, here all 5 channels)
    assert twarp.dsrc_plan(2, 64, 64, f32, False, (9, 17)).vector == 1
    assert twarp.dsrc_plan(2, 64, 5, f32, True, (9, 17))[:3] == ("shared", 1, 5)
    assert twarp.dsrc_plan(2, 64, 12, bf16, True, (9, 17)).vector == 1
    # 2^31 elements of dout need 64-bit offsets
    assert twarp.dsrc_plan(1, 2**21, 1024, bf16, True, (32, 32)).index_bits == 64
    assert twarp.dsrc_plan(1, 2**21 - 2048, 1024, bf16, True, (32, 32)).index_bits == 32


@settings(max_examples=120, deadline=None)
@given(st.integers(1, 40), st.integers(0, 3000),
       st.one_of(st.integers(1, 1100), st.sampled_from([3, 5, 8, 12, 64, 1023])),
       st.sampled_from(DTYPES), st.booleans(),
       st.tuples(st.integers(1, 300), st.integers(1, 300)))
def test_dsrc_plans_drawn_shapes(B, N, C, dtype, aligned, hw):
    _check_dsrc_plan(B, N, C, dtype, aligned, hw)


@pytest.mark.parametrize("B,N,C,hw", [(64, 2**20, 40, (1024, 1024)), (2, 2**27, 1100, (4, 4)),
                                      (60_000, 100, 8, (10, 10)), (1, 5, 3, (512, 512))])
def test_dsrc_plans_at_large_shapes(B, N, C, hw):
    for dtype in DTYPES:
        for aligned in (True, False):
            _check_dsrc_plan(B, N, C, dtype, aligned, hw)


def test_dsrc_plan_refuses_a_batch_past_the_launch_grid():
    with pytest.raises(ValueError, match="launch grid"):
        twarp.dsrc_plan(65536, 4, 64, torch.float32, True, (2, 2))


# ---- (b) the 'shared' kernel's partition and order of summation -------------

def _cells(grid, H, W):
    """(x0, y0, fx, fy, cell) of (B, N, 2) grid points as the kernel forms
    them: the top-left corner, the weights wx1 and wy1, and the corner cell
    ((y0 + 1) * (W + 1) + x0 + 1, or -1 where no corner lies inside)."""
    one, half = np.float32(1), np.float32(0.5)
    x = (grid[..., 0] + one) * half * np.float32(W - 1)
    y = (grid[..., 1] + one) * half * np.float32(H - 1)
    x0, y0 = np.floor(x), np.floor(y)
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    cell = np.where(inside, (y0 + 1) * (W + 1) + (x0 + 1), -1).astype(int)
    return x0, y0, x - x0, y - y0, cell


def dsrc_mirror(grid, dout, image_shape, plan, dtype):
    """d_src of (B, N, 2) grid and (B, N, C) dout into an `image_shape`
    (B, H, W, C) gradient, in numpy f32 as the kernel partitions and sums it
    under `plan` (bands of `plan.rows` pixel rows, channel slices, chunks of
    points), rounded once to `dtype` at the end."""
    B, H, W, C = image_shape
    N = grid.shape[1]
    one = np.float32(1)
    x0, y0, fx, fy, cell = _cells(grid, H, W)
    out = np.zeros((B, H * W, C), np.float32)
    for b in range(B):
        for y_lo in range(0, H, plan.rows):
            hb = min(plan.rows, H - y_lo)
            # the band's cells: corner rows y_lo - 1 ... y_lo + hb - 1
            in_band = (cell[b] >= 0) & (y0[b] >= y_lo - 1) & (y0[b] <= y_lo + hb - 1)
            for c0 in range(0, C, plan.channels):
                c1 = min(C, c0 + plan.channels)
                plane = np.zeros((hb * W, c1 - c0), np.float32)
                for q0 in range(0, N, plan.chunk):
                    q = np.arange(q0, min(N, q0 + plan.chunk))
                    q = q[in_band[q]]
                    if q.size == 0 and N > plan.chunk:
                        continue  # the kernel skips a chunk with no point in the band
                    acc = np.zeros_like(plane)
                    # each pixel's cells in the kernel's order (its quad walks
                    # the cells row by row, so a pixel meets the point whose
                    # corner (x0 + a, y0 + e) it is for e = 1 first, then for
                    # a = 1 first); np.add.at adds a pixel's points one by
                    # one, in index order within a cell
                    for e in (1, 0):
                        for a in (1, 0):
                            wx = fx[b, q] if a else one - fx[b, q]
                            wy = fy[b, q] if e else one - fy[b, q]
                            px, py = x0[b, q] + a, y0[b, q] + e
                            ok = (px >= 0) & (px <= W - 1) & (py >= y_lo) & (py < y_lo + hb)
                            pix = ((py[ok] - y_lo) * W + px[ok]).astype(int)
                            contrib = dout[b, q[ok], c0:c1] * (wx * wy)[ok, None]
                            np.add.at(acc, pix, contrib.astype(np.float32))
                    plane += acc
                out[b, y_lo * W:(y_lo + hb) * W, c0:c1] = plane
    return torch.from_numpy(out.reshape(B, H, W, C)).to(dtype)


def place_in_order(cells_of_chunk, n_cells):
    """The kernel's placement of one chunk (place_in_order in
    csrc/warp_dsrc.cu) in numpy: the cells' counts and exclusive scan, then
    two warps' sweep over the points 64 at a time, a thread's slot its
    cell's cursor plus its rank among the lower threads of its cell (the
    bits of the two warps' masks), the cursor moved past the group. Returns
    the point index at each slot and the starts."""
    cells_of_chunk = np.asarray(cells_of_chunk)
    counts = np.bincount(cells_of_chunk[cells_of_chunk >= 0], minlength=n_cells)
    start = np.concatenate([[0], np.cumsum(counts)])
    cursor = start[:-1].copy()
    binned = np.full(start[-1], -1)
    for base in range(0, cells_of_chunk.size, 64):
        step = cells_of_chunk[base:base + 64]
        masks = np.zeros((2, n_cells), np.uint64)
        for t, c in enumerate(step):
            if c >= 0:
                masks[t // 32, c] |= np.uint64(1 << (t % 32))
        for t, c in enumerate(step):
            if c < 0:
                continue
            lo, hi = int(masks[0, c]), int(masks[1, c])
            below = (1 << (t % 32)) - 1
            rank = bin(lo).count("1") + bin(hi & below).count("1") if t >= 32 \
                else bin(lo & below).count("1")
            binned[cursor[c] + rank] = base + t
        for c in set(step[step >= 0].tolist()):
            cursor[c] += int((step == c).sum())
    return binned, start


def _away_from_integers(grid, H, W, margin=0.05):
    out = grid.copy()
    for axis, n in ((0, W), (1, H)):
        px = (out[..., axis] + 1.0) * 0.5 * (n - 1)
        px = np.floor(px) + np.clip(px - np.floor(px), margin, 1.0 - margin)
        out[..., axis] = px / (0.5 * (n - 1)) - 1.0
    return out.astype(np.float32)


def _grid(kind, rng, B, H, W, Ho, Wo):
    """Interior samples; samples over [-1.4, 1.4], corners outside too; exact
    integer pixel coordinates (H - 1 and W - 1 powers of two), shifted by
    whole pixels so some land outside; or a contracting grid, every point of
    a batch element in one cell."""
    if kind in ("random", "out_of_range"):
        span = 1.8 if kind == "random" else 2.8
        grid = rng.rand(B, Ho, Wo, 2).astype(np.float32) * span - span / 2
        return _away_from_integers(grid, H, W)
    if kind == "contracting":
        centre = rng.rand(B, 1, 1, 2).astype(np.float32) - 0.5
        return _away_from_integers(centre + 1e-3 * rng.rand(B, Ho, Wo, 2).astype(np.float32),
                                   H, W, margin=0.2)
    ys = rng.randint(-1, H + 1, (B, Ho, Wo)).astype(np.float32)
    xs = rng.randint(-1, W + 1, (B, Ho, Wo)).astype(np.float32)
    return np.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], axis=-1).astype(np.float32)


def _jax_dsrc(sampler, img, grid, dout):
    fn = jax.jit(jax.grad(lambda i, g, d: jnp.sum(sampler(i, g) * d)))
    return np.asarray(fn(jnp.asarray(img), jnp.asarray(grid), jnp.asarray(dout)))


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("kind", ["random", "out_of_range", "integer", "contracting"])
@pytest.mark.parametrize("C", [3, 12, 64])
def test_dsrc_mirror_matches_plain_jnp_and_pallas(kind, C):
    """The mirror under the plan the kernel gets for a batch of 2 (scalar
    loads at C = 3, scalar in bf16 and 4-channel packs in f32 at 12, packs
    at 64; slices of 32 bytes of channels, or all C, since two batch
    elements leave the card short of blocks), under that plan with chunks
    of 16 points (the binning repeated, the plane summed over chunks), and
    with those chunks in bands of 3 rows, as 'bands' runs them (bit for bit
    the unbanded sums: a pixel's order of summation is the same), in f32 and
    in bf16 (on dout rounded to bf16, as the kernel reads it). The summation
    order does not depend on the gather's tile."""
    rng = np.random.RandomState(
        {"random": 0, "out_of_range": 1, "integer": 2, "contracting": 3}[kind] + C)
    B, H, W, Ho, Wo = 2, 9, 17, 8, 6
    grid = _grid(kind, rng, B, H, W, Ho, Wo)
    dout = rng.randn(B, Ho, Wo, C).astype(np.float32)
    shape = (B, H, W, C)
    flat_grid = grid.reshape(B, -1, 2)
    jnp_img = _jax_dsrc(jsamp.grid_sample, np.zeros(shape, np.float32), grid, dout)
    with pltpu.force_tpu_interpret_mode():
        pallas_img = _jax_dsrc(grid_sample_pallas, np.zeros(shape, np.float32), grid, dout)
    for dtype in DTYPES:
        d = _bf16(dout) if dtype == torch.bfloat16 else dout
        plain = twarp.warp_dsrc_plain(torch.from_numpy(grid), torch.from_numpy(d), shape)
        scale = max(1.0, plain.abs().max().item())
        tol = (2.0**-8 if dtype == torch.bfloat16 else 2e-5) * scale
        plan = twarp.dsrc_plan(B, Ho * Wo, C, dtype, True, (H, W))
        assert plan.variant == "shared" and plan.chunk == Ho * Wo
        assert plan.vector == {3: 1, 12: 4 if dtype == torch.float32 else 1, 64: 16 // dtype.itemsize}[C]
        flat_d = d.reshape(B, -1, C)
        chunked = dsrc_mirror(flat_grid, flat_d, shape, plan._replace(chunk=16), dtype)
        banded = dsrc_mirror(flat_grid, flat_d, shape,
                             plan._replace(chunk=16, rows=3, variant="bands"), dtype)
        assert torch.equal(banded, chunked)
        for p in (plan, plan._replace(chunk=16)):
            got = dsrc_mirror(flat_grid, flat_d, shape, p, dtype)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), plain.float(), atol=tol, rtol=0)
            if dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), jnp_img, atol=tol, rtol=0)
                np.testing.assert_allclose(got.numpy(), pallas_img, atol=tol, rtol=0)
            else:
                want = dsrc_mirror(flat_grid, flat_d, shape, p, torch.float32)
                torch.testing.assert_close(got.float(), want.bfloat16().float(), atol=0, rtol=0)
    assert np.abs(jnp_img).max() > 0.1


def test_dsrc_mirror_sums_points_that_share_a_corner():
    """Every point of a batch element samples (nearly) one place: all of them
    land in one or two cells, so each corner pixel sums N contributions, as
    the kernel's walk over a crowded cell does."""
    rng = np.random.RandomState(7)
    B, H, W, N, C = 1, 5, 9, 300, 8
    grid = np.full((B, N, 2), 0.13, np.float32) + rng.randn(B, N, 2).astype(np.float32) * 1e-3
    dout = rng.randn(B, N, C).astype(np.float32)
    plan = twarp.dsrc_plan(B, N, C, torch.float32, True, (H, W))
    got = dsrc_mirror(grid, dout, (B, H, W, C), plan._replace(chunk=64), torch.float32)
    plain = twarp.warp_dsrc_plain(torch.from_numpy(grid[:, :, None]),
                                  torch.from_numpy(dout[:, :, None]), (B, H, W, C))
    torch.testing.assert_close(got, plain, atol=2e-5 * max(1.0, plain.abs().max().item()), rtol=0)
    assert (got.abs().sum(-1) > 0).sum() <= 6


@pytest.mark.parametrize("kind", ["random", "contracting", "integer"])
def test_placement_puts_each_cell_in_point_order(kind):
    """place_in_order on chunks of 1024 points (16 steps of two warps): every
    cell's run holds its points in index order, as the mirror sums them,
    also where all 1024 share one cell (a contracting grid) and in a band
    that takes only some of the points."""
    rng = np.random.RandomState(17)
    H, W = 31, 33
    grid = _grid(kind, rng, 1, H, W, 32, 32).reshape(1, -1, 2)
    x0, y0, _, _, cell = _cells(grid, H, W)
    for y_lo, hb in ((0, H), (9, 7)):
        band = np.where((cell[0] >= 0) & (y0[0] >= y_lo - 1) & (y0[0] <= y_lo + hb - 1),
                        ((y0[0] + 1 - y_lo) * (W + 1) + x0[0] + 1), -1).astype(int)
        binned, start = place_in_order(band, (hb + 1) * (W + 1))
        assert (binned >= 0).all() and binned.size == (band >= 0).sum()
        for c in np.flatnonzero(np.diff(start)):
            np.testing.assert_array_equal(binned[start[c]:start[c + 1]],
                                          np.flatnonzero(band == c))
    if kind == "contracting":
        assert np.unique(cell[0]).size == 1 and (cell[0] >= 0).all()
