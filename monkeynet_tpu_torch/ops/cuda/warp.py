"""Bilinear warp, align_corners=True with zeros padding: its three kernels
(forward, gradient w.r.t. the source, gradient w.r.t. the grid), their plain
forms, their launch plans, and the autograd function that joins them.

Kernels: csrc/warp.cu, csrc/warp_dsrc.cu and csrc/warp_dgrid.cu, CUDA C++ for
sm_90a. They replace the three TPU kernels of
monkeynet_tpu/ops/pallas/warp.py (`_warp_fwd_impl`, and the d_src and d_grid
`pallas_call`s of `_warp_bwd`). The TPU kernels turn the gather and the
scatter into separable hat-matrix matmuls over tiles of 256 points, and fall
back to XLA past an 8 MB source, because the TPU has neither. Hopper has
both, so none of that carries over:

- forward: a direct four-tap gather, coordinates and weights in f32, operand
  f32 or bf16, f32 accumulation. `warp_plan` picks 'small' (C <= 4: one
  thread per point carries every channel; a source plane of up to 48 KB is
  staged in shared memory) or 'vector' (a power-of-two group of threads per
  point, 16-byte packs of channels);
- d_src: `dsrc_plan` picks 'shared' wherever a slice of one load's channels
  fits a block's shared memory: a block per (channel slice, batch element)
  bins the batch element's points by the cell of their top-left corner (a
  count with integer shared-memory atomics, a scan, and a placement in
  point order by two warps), then each thread gathers `dout * w_corner` in
  f32 for the pixels it owns (one, or a 2 x 2 quad) from the cells around
  them and writes each value once, in dout's dtype: one launch a call, and
  no f32 atomics, which sm_90 runs on shared memory only as
  compare-and-swap loops. 'binned' (planes too large even for that) bins in
  device memory: a pass over the points gives each to a band of cell rows
  (a bit per point in its band's list), a block per band sorts its points
  by cell in point order into one cell-sorted list a batch element, and a
  block per strip of 2 x 2 quads of pixels stages its points from that list
  in shared memory and gathers them, a group of lanes a quad over every
  channel: three launches a call. Both sum each pixel in a fixed order (a
  cell's points in point order; 'binned' as 'shared' does with all points
  in one chunk), so two runs agree bit for bit;
- d_grid: the right difference at integer coordinates, f32 throughout.
  `dgrid_plan` picks 'small' (one thread per point), 'grouped' (up to 32
  threads per point on 16-byte packs, a segmented shuffle sum) or 'split'
  (several warps per point, partials added in shared memory in a fixed
  order), so the result does not change from run to run.
All three are bound by bytes: grids, outputs and gradients cross DRAM once,
and the source planes of the main paths fit in the 50 MB L2. The plans are
plain Python, decided from the shape, the dtype and the pointers' alignment
before the launch; a refused launch raises.

`grid_sample` is the plain version of the forward, the four-corner gather of
monkeynet_tpu/ops/sampling.py; its autograd is the plain version of both
gradients (`warp_dsrc_plain`, `warp_dgrid_plain`). `warp` takes `grid_sample`
for a CPU tensor; for a CUDA tensor it goes through `WarpFunction`, whose
forward and backward launch the kernels, so a CUDA tensor that requires grad
never gets a result without a `grad_fn`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from monkeynet_tpu_torch.ops.cuda import _build

SOURCE = "monkeynet_tpu_torch/csrc/warp.cu"
REPLACES = "monkeynet_tpu/ops/pallas/warp.py:213"
DSRC_SOURCE = "monkeynet_tpu_torch/csrc/warp_dsrc.cu"
DSRC_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:240"
DGRID_SOURCE = "monkeynet_tpu_torch/csrc/warp_dgrid.cu"
DGRID_REPLACES = "monkeynet_tpu/ops/pallas/warp.py:257"

MAX_THREADS = 1024
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535
SMALL_C = 4  # kSmallC in csrc/warp.cu and csrc/warp_dgrid.cu
SMS = 132  # streaming multiprocessors of an H100 SXM
# Threads an H100 holds resident at once (2048 an SM).
FULL_WAVE = SMS * 2048
# A lane takes two packs of a point while that leaves this many threads,
# else one: measured on an H100 at the taichi shapes, two packs a lane win
# wherever the launch stays this large, and lose to more threads below it
# (PERF.md).
_TWO_PACKS_MIN_THREADS = 65536
_THREADS = 256
# The 'small' forward stages a source plane of at most this many bytes in
# shared memory (the taichi source frame, 64 x 64 x 3 f32, is 48 KB), with
# one block of 1024 threads an SM walking the points.
_STAGE_MAX_BYTES = 48 * 1024
_STAGE_THREADS = 1024
# The most dynamic shared memory a block may use (kMaxDynamicShared in
# csrc/common.cuh), and the most a 'shared' d_src block takes, so that two
# blocks stay resident on an SM; the points such a block bins at a time.
MAX_DYNAMIC_SHARED = 232_448
_SLICE_MAX_BYTES = MAX_DYNAMIC_SHARED // 2
_DSRC_CHUNK = 1024
_DSRC_MAX_THREADS = 512
_DSRC_QUAD_ITEMS = 256
# 'binned': the shared memory a block takes without opting in (a block of
# the first pass, its words of every band's list; a gather block, its
# window); the most sort bands (the band lists take bands x N / 8 bytes);
# the points a batch element may have (a point's index is a 32-bit int);
# the gather's quads a block (the fastest strip at the 256^2 skip, PERF.md)
# and the most lanes a quad takes (a warp's: the lanes of a quad read each
# point's entry at one address).
_NO_OPT_IN_SHARED = 48 * 1024
_BIN_BANDS = 128
_BIN_MAX_POINTS = 2**31 - 1
_GATHER_QUADS = 16
_GATHER_MAX_LANES = 32
_FWD_VARIANTS = ("small", "vector")
_DSRC_VARIANTS = ("shared", "binned")
_DGRID_VARIANTS = ("small", "grouped", "split")


class WarpPlan(NamedTuple):
    """How csrc/warp.cu runs one forward call."""

    variant: str  # 'small' | 'vector'
    vector: int  # channels one load moves: 16 bytes' worth (4 f32, 8 bf16) or 1
    lanes: int  # threads per point, a power of two
    threads: int  # threads per block
    blocks: tuple  # (x over a batch element's points, y = batch element)
    index_bits: int  # 32, or 64 where an element offset reaches 2^31
    shared_bytes: int  # the source plane staged in shared memory; 0: read in place


class DsrcPlan(NamedTuple):
    """How csrc/warp_dsrc.cu runs one d_src call."""

    variant: str  # 'shared' (a block per slice) | 'binned' (sorted in device memory)
    vector: int  # channels a load: a 16-byte pack or 1
    channels: int  # channels a block owns (the last slice may be narrower); 'binned': C
    lanes: int  # threads per tile, a power of two
    chunk: int  # points a block bins at a time ('binned': a sort block)
    tile: int  # pixels a side of what one gather thread owns (1 or 2; 'binned': 2)
    threads: int  # of a block ('binned': of a gather block)
    blocks: tuple  # (x over slices, or 'binned''s over strips of quads; y = batch element)
    shared_bytes: int  # dsrc_shared_bytes ('binned': dsrc_sort_bytes, a sort block's)
    index_bits: int
    rows: int  # 'shared': H; 'binned': cell rows a sort band owns


class DgridPlan(NamedTuple):
    """How csrc/warp_dgrid.cu runs one d_grid call."""

    variant: str  # 'small' | 'grouped' | 'split'
    vector: int
    lanes: int  # threads per point: 1 ('small'), <= 32 ('grouped'), 64-1024 ('split')
    threads: int
    blocks: tuple
    index_bits: int


def _next_pow2(n):
    return 1 << max(0, n - 1).bit_length()


def _pack(C, dtype, aligned):
    """Channels a load moves: a 16-byte pack where C is a multiple of it and
    every operand pointer is 16-byte aligned, else 1."""
    v = 16 // dtype.itemsize
    return v if aligned and C % v == 0 else 1


def _launch(B, N, C, source_pixels, per_block, variant, blocks_x=None):
    """(blocks, index bits): blocks over a batch element's points (one per
    `per_block` points, unless the kernel walks them grid-stride with
    `blocks_x` blocks) and the batch elements; 32-bit offsets while every
    element offset the kernel forms (source plane, grid / dout / output rows,
    a point index one stride past the last point) stays below 2^31."""
    if blocks_x is None:
        blocks_x = -(-N // per_block)
    if B > MAX_GRID_Y or blocks_x > MAX_GRID_X:
        raise ValueError(f"{variant}: {B} batch elements of {N} points exceed the launch grid")
    largest = max(B * source_pixels * C, B * N * max(C, 2), N + blocks_x * per_block)
    return (blocks_x, B), 32 if largest < 2**31 else 64


def _lanes(B, N, packs):
    """Threads per point for `packs` packs a point: two packs a lane while
    B x N x lanes stays >= 65536, else one; a power of two."""
    two = _next_pow2(-(-packs // 2))
    return two if B * N * two >= _TWO_PACKS_MIN_THREADS else _next_pow2(packs)


def warp_plan(B, N, C, dtype, aligned, source_pixels) -> WarpPlan:
    """Variant, pack, threads per point and launch shape of the forward
    kernel for a (B, H, W, C) source of `dtype` with H * W = `source_pixels`,
    sampled at B x N points. `aligned`: whether the source and the output
    start on 16 bytes.

    C <= 4 is 'small': one thread per point. Where the source plane fits
    48 KB and a batch element has at least 1024 points, the plane is staged
    in shared memory and a block of 1024 threads an SM walks the points
    (the gathers then come from shared memory). Otherwise 'vector', with
    `_lanes` threads per point, at most a block of 256."""
    if C <= SMALL_C:
        plane = source_pixels * C * dtype.itemsize
        if plane <= _STAGE_MAX_BYTES and N >= _STAGE_THREADS:
            tiles = -(-N // _STAGE_THREADS)
            blocks, index_bits = _launch(B, N, C, source_pixels, _STAGE_THREADS, "warp",
                                         blocks_x=min(tiles, max(1, SMS // B)))
            return WarpPlan("small", 1, 1, _STAGE_THREADS, blocks, index_bits,
                            -(-plane // 16) * 16)
        variant, vector, lanes = "small", 1, 1
    else:
        variant, vector = "vector", _pack(C, dtype, aligned)
        lanes = min(_THREADS, _lanes(B, N, C // vector))
    blocks, index_bits = _launch(B, N, C, source_pixels, _THREADS // lanes, "warp")
    return WarpPlan(variant, vector, lanes, _THREADS, blocks, index_bits, 0)


def dgrid_plan(B, N, C, dtype, aligned, source_pixels) -> DgridPlan:
    """Variant, pack, threads per point and launch shape of the d_grid
    kernel for a (B, H, W, C) source of `dtype` with H * W =
    `source_pixels`, B x N points. `aligned`: whether the source and dout
    start on 16 bytes.

    C <= 4 is 'small': one thread per point. Otherwise `_lanes` threads per
    point: 'grouped' while they are at most 32; 'split' above, which only a
    point with more packs than a warp has lanes reaches, and only on a
    launch that 32 lanes a point would not fill (else 'grouped' with 32
    lanes, several packs each)."""
    if C <= SMALL_C:
        variant, vector, lanes = "small", 1, 1
    else:
        vector = _pack(C, dtype, aligned)
        lanes = min(MAX_THREADS, _lanes(B, N, C // vector))
        if lanes > 32 and B * N * 32 >= FULL_WAVE:
            lanes = 32
        variant = "split" if lanes > 32 else "grouped"
    threads = max(_THREADS, lanes)
    blocks, index_bits = _launch(B, N, C, source_pixels, threads // lanes, "warp_dgrid")
    return DgridPlan(variant, vector, lanes, threads, blocks, index_bits)


def dsrc_shared_bytes(rows, W, channels, chunk, itemsize, plane):
    """Dynamic shared memory of a d_src block that owns `rows` pixel rows of
    width W (shared_layout in csrc/warp_dsrc.cu), each part in whole 16
    bytes: the slice's f32 plane (rows x W x `channels`; only where `plane`,
    the points taking more than one chunk), the chunk's dout slices (`chunk`
    x `channels` of `itemsize` bytes), the binned points (16 bytes each), the
    start, cursor and two placement masks of each of the (rows + 1) x (W + 1)
    corner cells and one more start (the total), and 32 warp totals."""
    def r16(n):
        return -(-n // 16) * 16

    cells = (rows + 1) * (W + 1)
    return r16((r16(rows * W * channels * 4) if plane else 0) + r16(chunk * channels * itemsize)
               + 16 * chunk + 4 * (4 * cells + 1 + 32))


def _dsrc_rows(fits, H):
    """The most pixel rows, at most H, for which `fits(rows)` holds (it holds
    for fewer rows wherever it holds for more); 0 if not even one row fits."""
    lo, hi = 0, H
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def dsrc_sort_bytes(rows, W, chunk):
    """Dynamic shared memory of a 'binned' sort block that owns `rows` rows
    of W + 1 cells (sort_layout in csrc/warp_dsrc.cu), each part in whole 16
    bytes: the window's `chunk` point indices, the start, cursor and two
    placement masks of each cell and one more start, 32 warp totals."""
    cells = rows * (W + 1)
    return -(-(-(-chunk * 4 // 16) * 16 + 16 * cells + 4 + 128) // 16) * 16


def dsrc_binned_scratch_bytes(B, N, H, W, rows):
    """Device scratch of a 'binned' call (launch_binned in
    csrc/warp_dsrc.cu): the sorted lists (16 bytes a point), the band lists
    (a bit a point, in 32-bit words a band), the band totals and the cell
    starts ((H + 1) (W + 1) + 1 ints a batch element)."""
    bands = -(-(H + 1) // rows)
    return B * (16 * N + 4 * bands * -(-N // 32) + 4 * bands + 4 * ((H + 1) * (W + 1) + 1))


def dsrc_gather_window(lanes, pack_bytes):
    """Points a 'binned' gather block stages at a time (gather_window in
    csrc/warp_dsrc.cu): up to 128, a power of two, as many as keep their
    16-byte entries and `lanes` packs of `pack_bytes` each in 48 KB."""
    window = 128
    while window > 1 and window * (16 + lanes * pack_bytes) > _NO_OPT_IN_SHARED:
        window //= 2
    return window


def dsrc_bin_words(bands):
    """32-bit words of every band's list that a block of 'binned''s first
    pass takes (32 points a word, a thread a point): up to 32, a power of
    two, as many as keep bands x words in `_NO_OPT_IN_SHARED` of shared
    memory; 0 where not even one word a band fits."""
    words = 32
    while words > 1 and bands * words * 4 > _NO_OPT_IN_SHARED:
        words //= 2
    return words if bands * words * 4 <= _NO_OPT_IN_SHARED else 0


def dsrc_plan(B, N, C, dtype, aligned, source_hw) -> DsrcPlan:
    """Variant, load width, channels a block owns, threads per tile, points
    binned at a time, gather tile, rows a block owns and launch shape of the
    d_src kernel for B x N points of dout (`dtype`, C channels) gathered into
    a (B, H, W, C) gradient, (H, W) = `source_hw`. `aligned`: whether dout
    starts on 16 bytes (the output is a fresh allocation, which does).

    'shared' wherever a slice of one load's channels fits the shared memory
    a block may use, with the points binned `_DSRC_CHUNK` at a time (or all
    of them, if fewer). The slice starts at all C channels and is halved (in
    whole loads, down to 32 bytes of channels where C has them) while its
    block takes more than half of that memory or the launch has fewer blocks
    than the card has SMs. Where all N points then fit one chunk in the
    shared memory a block may use, they are binned at once (no f32 plane,
    one pass over the pixels). Otherwise 'binned': sort bands of as many
    rows of cells as hold `_DSRC_CHUNK` points where the points spread
    evenly over the H + 1 cell rows, and no more than `_BIN_BANDS` bands,
    as far as a sort block's shared memory allows; a sort block compacts
    `_DSRC_CHUNK` points at a time; the
    gather takes a 2 x 2 quad of pixels over all C channels a group of
    lanes (a lane a load, up to 32, in passes over the loads), a block a
    strip of `_GATHER_QUADS` quads along a row of quads.
    Refused where one row of cells does not fit a sort block, where a
    block of the first pass cannot hold a word of every band
    (`dsrc_bin_words`) or past `_BIN_MAX_POINTS` points a batch element.
    'shared': a gather thread owns a 2 x 2 quad of
    pixels where the block has at least `_DSRC_QUAD_ITEMS` (quad, load)
    items, else one pixel; a tile's loads are dealt to a power-of-two group
    of lanes, 128 to 512 threads a block."""
    H, W = source_hw
    vector = _pack(C, dtype, aligned)
    chunk = max(1, min(N, _DSRC_CHUNK))
    # a slice keeps at least a 32-byte sector of a pixel's channels where C
    # has them and it fits: narrower ones read dout and write the gradient in
    # part sectors
    sector = max(vector, min(C, 32 // dtype.itemsize))

    def shared_bytes(channels, chunk, rows=H):
        return dsrc_shared_bytes(rows, W, channels, chunk, dtype.itemsize, N > chunk)

    rows = H
    if shared_bytes(vector, chunk) <= MAX_DYNAMIC_SHARED:
        variant = "shared"

        def halve(channels):
            if shared_bytes(channels, chunk) > MAX_DYNAMIC_SHARED:
                return True
            return channels > sector and (shared_bytes(channels, chunk) > _SLICE_MAX_BYTES
                                          or B * -(-C // channels) < SMS)

        channels = C
        while channels > vector and halve(channels):
            floor = sector if channels > sector else vector
            channels = max(floor, -(-(channels // 2) // vector) * vector)
        if N > chunk and shared_bytes(channels, N) <= MAX_DYNAMIC_SHARED:
            chunk = N
    else:
        return _binned_plan(B, N, C, vector, chunk, (H, W))
    packs = channels // vector
    lanes = min(_THREADS, _next_pow2(packs))
    # a gather thread owns a 2 x 2 quad of pixels where the block has enough
    # (quad, load) items for its threads, else one pixel: with few items a
    # quad's 9 cells make a longer chain than a pixel's 4
    tile = 2 if -(-rows // 2) * -(-W // 2) * packs >= _DSRC_QUAD_ITEMS else 1
    # a thread for each of the block's (tile, load) items, 128 to 512
    tiles = -(-rows // tile) * -(-W // tile)
    threads = min(_DSRC_MAX_THREADS, max(128, _next_pow2(tiles * packs)))
    # the kernel's point index runs to one chunk past the last point
    blocks, index_bits = _launch(B, N, C, H * W, chunk, "warp_dsrc",
                                 blocks_x=-(-C // channels) * -(-H // rows))
    return DsrcPlan(variant, vector, channels, lanes, chunk, tile, threads, blocks,
                    shared_bytes(channels, chunk, rows), index_bits, rows)


def _binned_plan(B, N, C, vector, chunk, source_hw) -> DsrcPlan:
    """dsrc_plan's 'binned' (see there)."""
    H, W = source_hw
    fits = _dsrc_rows(lambda r: dsrc_sort_bytes(r, W, chunk) <= MAX_DYNAMIC_SHARED, H + 1)
    rows = min(fits, max(1, chunk * (H + 1) // max(N, 1), -(-(H + 1) // _BIN_BANDS)))
    if rows == 0:
        raise ValueError(f"warp_dsrc: a row of {W + 1} cells does not fit a sort block's "
                         f"shared memory")
    bands = -(-(H + 1) // rows)
    if dsrc_bin_words(bands) == 0:
        raise ValueError(f"warp_dsrc: {bands} bands of {rows} cell rows exceed the binning "
                         f"pass's shared memory")
    if N > _BIN_MAX_POINTS:
        raise ValueError(f"warp_dsrc: {N} points a batch element exceed 'binned''s 32-bit "
                         f"point indices")
    lanes = min(_GATHER_MAX_LANES, _next_pow2(C // vector))
    threads = max(32, _GATHER_QUADS * lanes)
    strips = -(-(-(-W // 2)) // (threads // lanes))
    blocks, index_bits = _launch(B, N, C, H * W, chunk, "warp_dsrc",
                                 blocks_x=-(-H // 2) * strips)
    return DsrcPlan("binned", vector, C, lanes, chunk, 2, threads, blocks,
                    dsrc_sort_bytes(rows, W, chunk), index_bits, rows)


def grid_sample(image, grid):
    """Bilinear sampling of `image` at `grid` locations (plain PyTorch).

    Args:
      image: (B, H, W, C) float tensor.
      grid:  (B, Ho, Wo, 2) xy coordinates in [-1, 1]; align_corners=True
             (-1 maps to pixel 0, +1 to pixel N-1).

    Out-of-range corners contribute zero (zeros padding). Corner weights are
    cast to the image's dtype, as the JAX reference does.

    Returns:
      (B, Ho, Wo, C).
    """
    B, H, W, C = image.shape
    dtype = image.dtype
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = (x - x0).to(dtype)
    wx0 = 1.0 - wx1
    wy1 = (y - y0).to(dtype)
    wy0 = 1.0 - wy1
    flat = image.reshape(B, H * W, C)

    def corner(xi, yi, wgt):
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(xi.shape + (C,))
        w_eff = torch.where(valid, wgt, torch.zeros_like(wgt))
        return vals * w_eff[..., None]

    return (
        corner(x0, y0, wx0 * wy0)
        + corner(x1, y0, wx1 * wy0)
        + corner(x0, y1, wx0 * wy1)
        + corner(x1, y1, wx1 * wy1)
    )


def warp_dsrc_plain(grid, dout, image_shape):
    """Plain d_src: autograd of `grid_sample` w.r.t. an image of
    `image_shape` (B, H, W, C), in dout's dtype. The warp is linear in the
    image, so the gradient does not depend on its values."""
    image = torch.zeros(image_shape, dtype=dout.dtype, device=dout.device, requires_grad=True)
    with torch.enable_grad():
        out = grid_sample(image, grid.detach())
    return torch.autograd.grad(out, image, dout)[0]


def warp_dgrid_plain(image, grid, dout):
    """Plain d_grid: autograd of `grid_sample` w.r.t. the grid. floor() and
    the range masks carry no gradient, so at an integer coordinate this is
    the right difference."""
    grid = grid.detach().requires_grad_()
    with torch.enable_grad():
        out = grid_sample(image.detach(), grid)
    return torch.autograd.grad(out, grid, dout)[0]


def _check_pair(image, grid, name):
    _build.require_cuda_tensor(image, f"{name} image", _build.DTYPE_CODES, 4)
    _build.require_cuda_tensor(grid, f"{name} grid", (torch.float32,), 4)
    if grid.shape[0] != image.shape[0] or grid.shape[-1] != 2 or grid.device != image.device:
        raise ValueError(
            f"{name}: grid {tuple(grid.shape)} on {grid.device} does not match "
            f"image {tuple(image.shape)} on {image.device}"
        )


def _check_dout(dout, grid, C, dtypes, name):
    _build.require_cuda_tensor(dout, f"{name} dout", dtypes, 4)
    if tuple(dout.shape) != tuple(grid.shape[:3]) + (C,) or dout.device != grid.device:
        raise ValueError(
            f"{name}: dout {tuple(dout.shape)} on {dout.device} does not match grid "
            f"{tuple(grid.shape)} on {grid.device} and {C} channels"
        )


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_forward(image, grid, out, plan):
    """Run the forward kernel under `plan` into `out`."""
    B, H, W, C = image.shape
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_fwd(
            image.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[image.dtype],
            _FWD_VARIANTS.index(plan.variant), plan.vector, plan.lanes.bit_length() - 1,
            plan.threads, plan.blocks[0], plan.shared_bytes, int(plan.index_bits == 64),
            _build.stream_of(image),
        )
    _build.check_launch(status, f"warp ({plan.variant})")


def _warp_forward(image, grid):
    """Launch the forward kernel: image (B, H, W, C) f32 or bf16, grid
    (B, Ho, Wo, 2) f32, both contiguous CUDA tensors."""
    _check_pair(image, grid, "warp")
    B, H, W, C = image.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    out = torch.empty((B, Ho, Wo, C), dtype=image.dtype, device=image.device)
    plan = warp_plan(B, Ho * Wo, C, image.dtype, _aligned(image, out), H * W)
    _launch_forward(image, grid, out, plan)
    warp.launches += 1
    warp.launches_by_variant[plan.variant] += 1
    return out


def _launch_dsrc(grid, dout, out, image_shape, plan):
    """Run the d_src kernel under `plan` into `out`, in dout's dtype.
    'binned' takes its scratch (dsrc_binned_scratch_bytes) from PyTorch's
    allocator on the current stream; the launcher zeroes the part that
    needs it."""
    B, H, W, C = image_shape
    N = grid.shape[1] * grid.shape[2]
    lib = _build.library()
    dtype, lanes_log2 = _build.DTYPE_CODES[dout.dtype], plan.lanes.bit_length() - 1
    with torch.cuda.device(dout.device):
        if plan.variant == "binned":
            scratch = torch.empty(dsrc_binned_scratch_bytes(B, N, H, W, plan.rows),
                                  dtype=torch.uint8, device=dout.device)
            status = lib.mk_warp_dsrc_binned(
                grid.data_ptr(), dout.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W,
                C, N, dtype, plan.vector, lanes_log2, plan.chunk, plan.rows, plan.threads,
                plan.blocks[0], plan.shared_bytes, int(plan.index_bits == 64),
                dsrc_bin_words(-(-(H + 1) // plan.rows)), _build.stream_of(dout))
        else:
            status = lib.mk_warp_dsrc(
                grid.data_ptr(), dout.data_ptr(), out.data_ptr(), B, H, W, C, N, dtype,
                plan.vector, plan.channels, lanes_log2, plan.chunk, plan.tile, plan.rows,
                plan.threads, plan.blocks[0], plan.shared_bytes, int(plan.index_bits == 64),
                _build.stream_of(dout))
    _build.check_launch(status, f"warp_dsrc ({plan.variant})")


def warp_dsrc(grid, dout, image_shape):
    """Gradient of the warp w.r.t. its image, (B, H, W, C) in dout's dtype:
    the d_src kernel for CUDA tensors, plain on the CPU.

    grid (B, Ho, Wo, 2) f32 and dout (B, Ho, Wo, C) f32 or bf16, contiguous.
    """
    if dout.device.type == "cpu":
        return warp_dsrc_plain(grid, dout, image_shape)
    B, H, W, C = image_shape
    _build.require_cuda_tensor(grid, "warp_dsrc grid", (torch.float32,), 4)
    if grid.shape[0] != B or grid.shape[-1] != 2:
        raise ValueError(f"warp_dsrc: grid {tuple(grid.shape)} does not match image {image_shape}")
    _check_dout(dout, grid, C, _build.DTYPE_CODES, "warp_dsrc")
    plan = dsrc_plan(B, grid.shape[1] * grid.shape[2], C, dout.dtype, _aligned(dout), (H, W))
    out = torch.empty((B, H, W, C), dtype=dout.dtype, device=dout.device)
    _launch_dsrc(grid, dout, out, (B, H, W, C), plan)
    warp_dsrc.launches += 1
    warp_dsrc.launches_by_variant[plan.variant] += 1
    return out


warp_dsrc.launches = 0
warp_dsrc.launches_by_variant = dict.fromkeys(_DSRC_VARIANTS, 0)


def _launch_dgrid(image, grid, dout, dgrid, plan):
    """Run the d_grid kernel under `plan` into `dgrid`."""
    B, H, W, C = image.shape
    lib = _build.library()
    with torch.cuda.device(image.device):
        status = lib.mk_warp_dgrid(
            image.data_ptr(), grid.data_ptr(), dout.data_ptr(), dgrid.data_ptr(), B, H, W, C,
            grid.shape[1] * grid.shape[2], _build.DTYPE_CODES[image.dtype],
            _DGRID_VARIANTS.index(plan.variant), plan.vector, plan.lanes.bit_length() - 1,
            plan.threads, plan.blocks[0], int(plan.index_bits == 64), _build.stream_of(image),
        )
    _build.check_launch(status, f"warp_dgrid ({plan.variant})")


def warp_dgrid(image, grid, dout):
    """Gradient of the warp w.r.t. its grid, (B, Ho, Wo, 2) f32: the d_grid
    kernel for CUDA tensors, plain on the CPU.

    image (B, H, W, C) and dout (B, Ho, Wo, C) share a dtype, f32 or bf16;
    grid (B, Ho, Wo, 2) f32; all contiguous.
    """
    if image.device.type == "cpu":
        return warp_dgrid_plain(image, grid, dout)
    _check_pair(image, grid, "warp_dgrid")
    B, H, W, C = image.shape
    _check_dout(dout, grid, C, (image.dtype,), "warp_dgrid")
    dgrid = torch.empty(grid.shape, dtype=torch.float32, device=image.device)
    plan = dgrid_plan(B, grid.shape[1] * grid.shape[2], C, image.dtype,
                      _aligned(image, dout), H * W)
    _launch_dgrid(image, grid, dout, dgrid, plan)
    warp_dgrid.launches += 1
    warp_dgrid.launches_by_variant[plan.variant] += 1
    return dgrid


warp_dgrid.launches = 0
warp_dgrid.launches_by_variant = dict.fromkeys(_DGRID_VARIANTS, 0)


class WarpFunction(torch.autograd.Function):
    """The warp on CUDA tensors with both gradients as kernels. A gradient
    that autograd does not ask for (the raw source frame needs none) costs
    no launch."""

    @staticmethod
    def forward(ctx, image, grid):
        ctx.save_for_backward(image, grid)
        return _warp_forward(image, grid)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        image, grid = ctx.saved_tensors
        dout = dout.contiguous()
        d_image = d_grid = None
        if ctx.needs_input_grad[0]:
            d_image = warp_dsrc(grid, dout, tuple(image.shape))
        if ctx.needs_input_grad[1]:
            d_grid = warp_dgrid(image, grid, dout)
        return d_image, d_grid


def warp(image, grid):
    """grid_sample through the kernels for CUDA tensors (differentiable
    through `WarpFunction`), plain on the CPU.

    image (B, H, W, C) f32 or bf16, grid (B, Ho, Wo, 2) f32, both
    contiguous -> (B, Ho, Wo, C) in the image's dtype.
    """
    if image.device.type == "cpu":
        return grid_sample(image, grid)
    return WarpFunction.apply(image, grid)


warp.launches = 0
warp.launches_by_variant = dict.fromkeys(_FWD_VARIANTS, 0)
