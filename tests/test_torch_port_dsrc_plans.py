"""The warp d_src kernel of the PyTorch port, as far as a CPU can hold it.

(a) `dsrc_plan` over the d_src shapes of every configs/*.yaml train step (the
    encoder skips past the source frame, which needs no gradient) and over
    drawn shapes: a replay in numpy of which block and thread write each
    (batch element, pixel, channel) of the gradient and which block reads
    each channel of dout, which block of 'binned''s first pass writes each
    word of the band lists, the card's limits (block size, launch grid,
    shared memory), the 32/64-bit choice, and where 'binned' is taken.
(b) `dsrc_mirror` repeats in numpy f32 the kernel's partition and order of
    summation: channel slices, points binned a chunk at a time (the points
    q0 to q0 + chunk - 1; 'binned': all of them at once) by the cell of
    their top-left corner, each pixel's four cells in the order its 2 x 2
    quad walks them and the points of a cell in index order, f32 sums added
    into the slice's plane once per chunk, one rounding to the output dtype
    at the end. It is held against
    `warp_dsrc_plain` and against the JAX package's d_src (jax.grad of the
    jnp grid_sample, and of the Pallas kernels in interpret mode, as
    tests/test_torch_port_grad.py runs them) on random, out-of-range,
    integer and contracting grids, in f32 and bf16. `place_in_order`
    replays the kernel's placement (a warp's sweep, ranks among the lanes
    that share a cell) and shows that it puts every cell's points in index
    order, the order the mirror sums them in.
(c) 'binned': `bin_bands`, `band_windows` and `sort_replay` replay its first
    pass (a bit per point in the list of the band of its cell row, block by
    block) and its sort blocks (a band's words compacted into windows of
    points, counted, scanned and placed), and show every band's list in
    point order, holding each point whose cell row falls in the band, and
    the sorted list stably sorted by cell; `gather_replay` replays its
    gather (strips of quads, runs of the sorted list staged a window at a
    time) and sums bit for bit as the mirror does.

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


def _replay_bin_words(bands, N, words_per_block):
    """How often the blocks of 'binned''s first pass write each word of a
    batch element's (bands, ceil(N / 32)) band lists: block x takes a point
    a thread, 32 x words_per_block of them, and writes word
    x * words_per_block + j of every band, j < words_per_block, where it
    lies below ceil(N / 32)."""
    n_words = -(-N // 32)
    written = np.zeros((bands, n_words), int)
    for x in range(-(-N // (32 * words_per_block))):
        for i in range(bands * words_per_block):
            w = x * words_per_block + i % words_per_block
            if w < n_words:
                written[i // words_per_block, w] += 1
    return written


def _replay_gather(plan, C, H, W):
    """How often 'binned''s gather writes each (pixel, channel) of a batch
    element: block x owns the strip x % strips of `groups` (threads /
    lanes) quads along quad row x // strips of the ceil(H / 2) x
    ceil(W / 2); its group g owns the strip's quad g, lane l the pack
    k0 + l of each pass k0 = 0, lanes, ... over the C / vector."""
    QW = -(-W // 2)
    groups = plan.threads // plan.lanes
    strips = -(-QW // groups)
    written = np.zeros((H, W, C), int)
    for x in range(plan.blocks[0]):
        qy, x0 = x // strips, x % strips * groups
        for g in range(groups):
            qx = x0 + g
            if qx >= QW:
                continue
            for k0 in range(0, C // plan.vector, plan.lanes):
                for lane in range(plan.lanes):
                    k = k0 + lane
                    if k < C // plan.vector:
                        written[2 * qy:2 * qy + 2, 2 * qx:2 * qx + 2,
                                k * plan.vector:(k + 1) * plan.vector] += 1
    return written


def _check_dsrc_plan(B, N, C, dtype, aligned, hw):
    H, W = hw
    plan = twarp.dsrc_plan(B, N, C, dtype, aligned, hw)
    pack = 16 // dtype.itemsize
    chunk = max(1, min(N, 1024))
    vector = pack if aligned and C % pack == 0 else 1

    def shared_bytes(channels, chunk=chunk, rows=H):
        return twarp.dsrc_shared_bytes(rows, W, channels, chunk, dtype.itemsize, N > chunk)

    fits = shared_bytes(vector) <= MAX_DYNAMIC_SHARED
    assert plan.variant == ("shared" if fits else "binned")
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.threads % plan.lanes == 0
    bx, by = plan.blocks
    assert by == B <= 65535 and 1 <= bx <= 2**31 - 1
    assert plan.vector == vector
    assert plan.channels % plan.vector == 0 and plan.vector <= plan.channels <= C
    packs = plan.channels // plan.vector
    # a slice of at least a 32-byte sector of channels where C has them
    sector = max(plan.vector, min(C, 32 // dtype.itemsize))
    if plan.variant == "shared":
        assert plan.lanes == min(256, 1 << (packs - 1).bit_length())
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
        assert bx == -(-C // plan.channels)
        # a 2 x 2 quad of pixels a gather thread where the block has 256
        # (quad, load) items, else a pixel; a thread an item, 128 to 512
        assert plan.tile == (2 if -(-H // 2) * -(-W // 2) * packs >= 256 else 1)
        tiles = -(-H // plan.tile) * -(-W // plan.tile)
        assert plan.threads == min(512, max(128, 1 << (tiles * packs - 1).bit_length()))
        assert plan.shared_bytes == shared_bytes(plan.channels, plan.chunk)
        if H * W * C <= 200_000:
            written, reader = _replay(plan, C, H, W)
            assert (written == 1).all()  # every value of the gradient once
            assert (reader >= 0).all()  # every channel of dout by one block
    else:
        # sort bands of the rows of cells that hold a chunk of evenly spread
        # points, at most 128 bands, as far as a sort block's shared memory
        # allows; the gather: a quad over all C channels a group of up to 32
        # lanes, a strip of 16 quads a block
        assert plan.chunk == chunk and plan.channels == C and plan.tile == 2
        assert plan.lanes == min(32, 1 << (packs - 1).bit_length())
        assert plan.threads == max(32, 16 * plan.lanes)  # 16 quads a block
        def sort_bytes(r):
            return twarp.dsrc_sort_bytes(r, W, chunk)

        lo, hi = 1, H + 1  # the most rows of cells a sort block holds
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if sort_bytes(mid) <= MAX_DYNAMIC_SHARED else (lo, mid - 1)
        assert plan.rows == min(lo, max(1, chunk * (H + 1) // max(N, 1), -(-(H + 1) // 128)))
        assert sort_bytes(plan.rows) == plan.shared_bytes <= MAX_DYNAMIC_SHARED
        # the first pass: a block takes the most words of every band's list
        # (up to 32, a power of two) that fit 48 KB of shared memory
        bands = -(-(H + 1) // plan.rows)
        words = twarp.dsrc_bin_words(bands)
        assert words in (1, 2, 4, 8, 16, 32) and bands * words * 4 <= 48 * 1024
        assert words == 32 or bands * words * 8 > 48 * 1024
        if bands * -(-N // 32) <= 200_000:
            assert (_replay_bin_words(bands, N, words) == 1).all()
        assert N <= 2**31 - 1
        # a block a strip of quads along a row of quads
        assert bx == -(-H // 2) * -(-(-(-W // 2)) // (plan.threads // plan.lanes))
        if H * W * C <= 200_000:
            assert (_replay_gather(plan, C, H, W)[:H, :W] == 1).all()
    assert plan.shared_bytes <= MAX_DYNAMIC_SHARED
    # the point index runs to one chunk past the last point
    largest = max(B * H * W * C, B * N * max(C, 2), N + bx * plan.chunk)
    assert plan.index_bits == (32 if largest < 2**31 else 64)
    return plan


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.rsplit("/", 1)[-1] for p in CONFIGS])
def test_dsrc_plans_for_every_config(path, dtype):
    for B, N, C, hw in _config_dsrc_shapes(path):
        plan = _check_dsrc_plan(B, N, C, dtype, True, hw)
        assert plan.index_bits == 32
        # one pack's slice fits unless the plane is 128^2 or larger
        assert (plan.variant == "binned") == (hw[0] * hw[1] >= 128 * 128)


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
    # the 64 x 128^2 skip of the 256^2 configs does not fit: 'binned', sort
    # bands of 8 of the 129 rows of cells (17 bands, ~1,000 points each on a
    # random grid), 32 words a first-pass block; the gather's quads take
    # all 64 channels, 8 bf16 lanes or 16 f32, in strips of 16 quads (4 a
    # row of 64 quads, 256 blocks)
    assert twarp.dsrc_plan(20, 16384, 64, bf16, True, (128, 128)) == (
        "binned", 8, 64, 8, 1024, 2, 128, (256, 20), 20752, 32, 8)
    assert twarp.dsrc_plan(20, 16384, 64, f32, True, (128, 128)) == (
        "binned", 4, 64, 16, 1024, 2, 256, (256, 20), 20752, 32, 8)
    assert twarp.dsrc_bin_words(17) == 32
    # a gather block stages 128 points at a time: 18 KB bf16, 34 KB f32
    assert twarp.dsrc_gather_window(8, 16) == twarp.dsrc_gather_window(16, 16) == 128
    assert twarp.dsrc_gather_window(32, 16) == 64 and twarp.dsrc_gather_window(32, 4) == 128
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


def test_dsrc_plan_refuses_binned_past_its_lists():
    """'binned' needs a word of every band in a first-pass block's 48 KB
    (at most 12,288 bands) and 32-bit point indices; the plan refuses
    beyond, before any launch."""
    f32 = torch.float32
    assert twarp.dsrc_bin_words(12288) == 1 and twarp.dsrc_bin_words(12289) == 0
    assert twarp.dsrc_bin_words(384) == 32 and twarp.dsrc_bin_words(385) == 16
    # a sort block holds 7 rows of 2,001 cells (1,858 bands of 13,001 cell
    # rows), one row of 14,001 (13,001 bands), none of 15,001
    assert twarp.dsrc_plan(1, 2048, 8, f32, True, (13000, 2000)).rows == 7
    with pytest.raises(ValueError, match="bands"):
        twarp.dsrc_plan(1, 2048, 8, f32, True, (13000, 14000))
    with pytest.raises(ValueError, match="cells does not fit"):
        twarp.dsrc_plan(1, 2048, 8, f32, True, (100, 15000))
    with pytest.raises(ValueError, match="32-bit"):
        twarp.dsrc_plan(1, 2**31, 8, f32, True, (512, 512))
    assert twarp.dsrc_plan(1, 2**31 - 1, 8, f32, True, (512, 512)).variant == "binned"


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
    under `plan` (channel slices, chunks of points q0 ... q0 + chunk - 1;
    'binned' sums every pixel as 'shared' does with all the points in one
    chunk), rounded once to `dtype` at the end. The loop over bands of
    `plan.rows` pixel rows is the same sums cut by rows."""
    B, H, W, C = image_shape
    N = grid.shape[1]
    if plan.variant == "binned":
        plan = plan._replace(variant="shared", rows=H, chunk=max(N, 1))
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
    binned = np.full(start[-1], -1)
    for slot, q in _sweep(cells_of_chunk, start[:-1].copy()).items():
        binned[slot] = q
    return binned, start


def _sweep(cells_of_chunk, cursor):
    """The two warps' sweep of place_in_order over one chunk's cells, from
    the cells' cursors (advanced in place): {slot: index in the chunk}."""
    cells_of_chunk = np.asarray(cells_of_chunk)
    slots = {}
    for base in range(0, cells_of_chunk.size, 64):
        step = cells_of_chunk[base:base + 64]
        masks = np.zeros((2, cursor.size), np.uint64)
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
            slots[cursor[c] + rank] = base + t
        for c in set(step[step >= 0].tolist()):
            cursor[c] += int((step == c).sum())
    return slots


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
    as 'binned' runs it (sort bands of 3 rows of cells, sorted 16 points at
    a time: the order of 'shared' with all points in one chunk, which the
    plan takes here, bit for bit), in f32 and in bf16 (on dout rounded to
    bf16, as the kernel reads it). The summation order does not depend on
    the gather's tile."""
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
        binned = plan._replace(rows=3, variant="binned", chunk=16)
        assert torch.equal(dsrc_mirror(flat_grid, flat_d, shape, binned, dtype),
                           dsrc_mirror(flat_grid, flat_d, shape, plan, dtype))
        for p in (plan, plan._replace(chunk=16), binned):
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


# ---- (c) 'binned': the band lists, their windows and the sorted list --------

def bin_bands(grid, H, W, rows, words_per_block):
    """'binned''s first pass (warp_dsrc_bin_kernel) in numpy: the (B, bands,
    ceil(N / 32)) band lists of (B, N, 2) grid points as 32-bit words, bit t
    of word w for point 32 w + t. Block x takes the points of words
    [x * words_per_block, + words_per_block), a thread a point; a point
    whose corner cell lies in the plane ORs its bit into the word of the
    band of its cell row y0 + 1 (bands of `rows` of the H + 1 cell rows),
    in the block's copy of its words, which it then writes."""
    B, N = grid.shape[:2]
    bands, n_words = -(-(H + 1) // rows), -(-N // 32)
    _, y0, _, _, cell = _cells(grid, H, W)
    out = np.zeros((B, bands, n_words), np.uint32)
    threads = 32 * words_per_block
    for b in range(B):
        for x in range(-(-N // threads)):
            block = np.zeros((bands, words_per_block), np.uint32)
            for t in range(threads):
                q = x * threads + t
                if q < N and cell[b, q] >= 0:
                    block[(int(y0[b, q]) + 1) // rows, t // 32] |= np.uint32(1 << (t % 32))
            for i in range(bands * words_per_block):
                w = x * words_per_block + i % words_per_block
                if w < n_words:
                    out[b, i // words_per_block, w] = block[i // words_per_block,
                                                            i % words_per_block]
    return out


def band_windows(words, chunk, threads):
    """A sort block's compaction of its band's words (for_each_window in
    warp_dsrc_sort_kernel) in numpy: `threads` words at a time, a word a
    thread, its points at the positions of the words' exclusive scan of bit
    counts, taken into the current window while it has room; a window is
    handed on when it holds `chunk` points, and the last one at the end.
    Returns the windows' point indices in order."""
    windows, current = [], []
    for w0 in range(0, len(words), threads):
        tile = [int(w) for w in words[w0:w0 + threads]]
        counts = [bin(w).count("1") for w in tile]
        before = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
        done, tile_total = 0, sum(counts)
        while done < tile_total:
            take = min(tile_total - done, chunk - len(current))
            slots = [-1] * take
            for t, word in enumerate(tile):
                pos = before[t]
                for bit in range(32):
                    if word >> bit & 1:
                        if done <= pos < done + take:
                            slots[pos - done] = (w0 + t) * 32 + bit
                        pos += 1
            current += slots
            done += take
            if len(current) == chunk:
                windows.append(current)
                current = []
    if current:
        windows.append(current)
    return [np.array(w, int) for w in windows]


def sort_replay(grid, H, W, rows, words_per_block, chunk, threads):
    """'binned''s first two passes in numpy: the band lists (bin_bands), the
    band totals, and per (sort band, batch element) the windows of its list
    (band_windows), counted by cell, scanned, and placed window by window in
    two warps' sweeps (place_in_order, the cursors carried from window to
    window) at the band's offset, the totals of the bands before it. Returns
    the band lists, each band's windows, the sorted lists (B, N) of point
    indices (-1 past the points in the plane) and the cell starts (B,
    (H + 1) (W + 1) + 1)."""
    B, N = grid.shape[:2]
    words = bin_bands(grid, H, W, rows, words_per_block)
    bands, cells_w = words.shape[1], W + 1
    x0, y0, _, _, _ = _cells(grid, H, W)
    totals = np.array([[sum(bin(int(v)).count("1") for v in words[b, k])
                        for k in range(bands)] for b in range(B)])
    sorted_ = np.full((B, N), -1)
    starts = np.zeros((B, (H + 1) * cells_w + 1), int)
    windows = {}
    for b in range(B):
        for k in range(bands):
            r0 = k * rows
            n_cells = min(rows, H + 1 - r0) * cells_w
            wins = windows[b, k] = band_windows(words[b, k], chunk, threads)

            def local(q):
                return ((y0[b, q] + 1 - r0) * cells_w + x0[b, q] + 1).astype(int)

            counts = np.zeros(n_cells, int)
            for win in wins:
                np.add.at(counts, local(win), 1)
            before = totals[b, :k].sum()
            start = np.concatenate([[0], np.cumsum(counts)])
            starts[b, r0 * cells_w:r0 * cells_w + n_cells + 1] = before + start
            cursor = start[:-1].copy()
            for win in wins:
                for slot, i in _sweep(local(win), cursor).items():
                    sorted_[b, before + slot] = win[i]
    return words, windows, sorted_, starts


@pytest.mark.parametrize("kind", ["random", "out_of_range", "integer", "contracting"])
@pytest.mark.parametrize("rows,words_per_block,chunk,threads", [
    (5, 4, 100, 8),    # several first-pass blocks; windows across tiles of 8 words
    (8, 32, 1024, 512),  # the plan's sort bands at the 256^2 skip: one tile, one window
    (1, 1, 7, 32),     # a row of cells a band, one word a block, windows of 7 points
])
def test_binning_sorts_each_band_in_point_order(kind, rows, words_per_block, chunk, threads):
    """Replayed on a (31, 33) plane with 1,000 points a batch element: every
    band's windows, joined, are the points whose cell row lies in the band,
    in point order, each point with a cell in the plane in exactly one
    band; all windows but the last hold `chunk` points; the sorted list is
    the points in the plane stably sorted by cell (a cell's points in point
    order, the order the gather and the mirror sum them in) and the starts
    are the cells' exclusive scan."""
    rng = np.random.RandomState({"random": 20, "out_of_range": 21, "integer": 22,
                                 "contracting": 23}[kind])
    B, H, W = 2, 31, 33
    grid = _grid(kind, rng, B, H, W, 25, 40).reshape(B, -1, 2)
    N = grid.shape[1]
    words, windows, sorted_, starts = sort_replay(grid, H, W, rows, words_per_block, chunk,
                                                  threads)
    _, y0, _, _, cell = _cells(grid, H, W)
    bands = -(-(H + 1) // rows)
    assert words.shape == (B, bands, -(-N // 32))
    for b in range(B):
        membership = np.zeros(N, int)
        for k in range(bands):
            in_band = (cell[b] >= 0) & ((y0[b] + 1) // rows == k)
            wins = windows[b, k]
            assert all(w.size == chunk for w in wins[:-1]) and (not wins or wins[-1].size <= chunk)
            listed = np.concatenate(wins) if wins else np.zeros(0, int)
            np.testing.assert_array_equal(listed, np.flatnonzero(in_band))
            membership[listed] += 1
        inside = cell[b] >= 0
        np.testing.assert_array_equal(membership, inside.astype(int))
        order = np.flatnonzero(inside)[np.argsort(cell[b, inside], kind="stable")]
        np.testing.assert_array_equal(sorted_[b, :order.size], order)
        assert (sorted_[b, order.size:] == -1).all()
        counts = np.bincount(cell[b, inside], minlength=(H + 1) * (W + 1))
        np.testing.assert_array_equal(starts[b], np.concatenate([[0], np.cumsum(counts)]))
    if kind == "contracting":
        assert ((words != 0).any(axis=2).sum(axis=1) == 1).all()


def gather_replay(grid, dout, image_shape, plan, window):
    """'binned''s gather (warp_dsrc_gather_kernel) in numpy f32 on the
    cell-sorted lists (the points with a cell in the plane, stably sorted
    by cell) and their starts: per block (a strip of threads / lanes quads
    of a quad row), its three runs of the sorted list (cell rows 2 y ...
    2 y + 2, the strip's columns) staged `window` points at a time, and each
    quad's 9 cells walked row by row in each window, the points of a cell
    that the window holds in order, each added to the quad's pixels as
    tile_sums adds them. Not rounded."""
    B, H, W, C = image_shape
    x0s, y0s, fx, fy, cell = _cells(grid, H, W)
    one = np.float32(1)
    QW, QH = -(-W // 2), -(-H // 2)
    groups = plan.threads // plan.lanes
    strips = -(-QW // groups)
    out = np.zeros((B, H, W, C), np.float32)
    for b in range(B):
        inside = np.flatnonzero(cell[b] >= 0)
        order = inside[np.argsort(cell[b, inside], kind="stable")]
        starts = np.concatenate([[0], np.cumsum(np.bincount(
            cell[b, inside], minlength=(H + 1) * (W + 1)))])
        for qy in range(QH):
            for strip in range(strips):
                x0 = strip * groups
                c_lo, c_hi = 2 * x0, min(2 * (x0 + groups), W)
                runs = [(starts[r * (W + 1) + c_lo], starts[r * (W + 1) + c_hi + 1])
                        for r in range(2 * qy, 2 * qy + 3) if r <= H]
                stream = np.concatenate([order[a:e] for a, e in runs] + [np.zeros(0, int)])
                at = np.cumsum([0] + [e - a for a, e in runs])
                acc = np.zeros((groups, 2, 2, C), np.float32)
                for p0 in range(0, stream.size, window):
                    for g in range(groups):
                        qx = x0 + g
                        if qx >= QW:
                            continue
                        for j in range(3):
                            for i in range(3):
                                row, col = 2 * qy + j, 2 * qx + i
                                if row > H or col > W:
                                    continue
                                c = row * (W + 1) + col
                                base = at[j] - runs[j][0]
                                lo = max(base + starts[c], p0)
                                hi = min(base + starts[c + 1], p0 + window)
                                for t in range(lo, hi):
                                    q = stream[t]
                                    for e in range(2):
                                        for a in range(2):
                                            dx, dy = i + a - 1, j + e - 1
                                            if 0 <= dx < 2 and 0 <= dy < 2:
                                                w = ((fx[b, q] if a else one - fx[b, q])
                                                     * (fy[b, q] if e else one - fy[b, q]))
                                                acc[g, dy, dx] += dout[b, q] * w
                for g in range(groups):
                    qx = x0 + g
                    for dy in range(2):
                        for dx in range(2):
                            if qx < QW and 2 * qy + dy < H and 2 * qx + dx < W:
                                out[b, 2 * qy + dy, 2 * qx + dx] = acc[g, dy, dx]
    return out


@pytest.mark.parametrize("kind", ["random", "out_of_range", "integer", "contracting"])
@pytest.mark.parametrize("groups,window", [(2, 4), (4, 128)])
def test_binned_gather_sums_in_the_order_of_one_chunk(kind, groups, window):
    """The gather replayed on a (9, 17) plane of 12 channels: strips of 2
    quads staged 4 points at a time (windows that cut cells and runs), and
    strips of 4 in one window: bit for bit the mirror's 'binned' sums, the
    order of 'shared' with all points in one chunk, before rounding and in
    bf16 after it."""
    rng = np.random.RandomState({"random": 30, "out_of_range": 31, "integer": 32,
                                 "contracting": 33}[kind])
    B, H, W, C = 2, 9, 17, 12
    grid = _grid(kind, rng, B, H, W, 8, 6).reshape(B, -1, 2)
    dout = rng.randn(B, grid.shape[1], C).astype(np.float32)
    plan = twarp.DsrcPlan("binned", 4, C, 1, 48, 2, groups, (0, B), 0, 32, 5)
    got = gather_replay(grid, dout, (B, H, W, C), plan, window)
    for dtype in DTYPES:
        want = dsrc_mirror(grid, dout, (B, H, W, C), plan, dtype)
        assert torch.equal(torch.from_numpy(got).to(dtype), want)
    assert np.abs(got).max() > 0.1
