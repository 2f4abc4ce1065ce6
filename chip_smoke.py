#!/usr/bin/env python3
"""Smoke run of the PyTorch port (monkeynet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build every CUDA kernel from monkeynet_tpu_torch/csrc/ (nvcc, sm_90a);
  2. per kernel, the kernel against its plain PyTorch version on the card,
     with times for the kernel, the plain version and, for the warp,
     F.grid_sample and its backward: the four forward kernels at the shapes
     of the taichi-64^2 transfer (chunk of 128 frames), the warp forward,
     soft-argmax and heatmap also L2-cold, the warp on random and identity
     grids with its launch plan, the soft-argmax and heatmap at the source
     frame's shapes, in both variants of the first and every variance mode
     and normalisation of the second (softargmax_phase, heatmap_phase); the
     warp's forward, d_src and d_grid kernels at the warps of the
     taichi-64^2 train step (batch 32), random and identity
     (integer-coordinate) grids, f32 and bf16, the plans and cold times of
     the forward and d_grid, F.grid_sample's backward for the grid alone,
     the input alone and both; the forward and d_grid with scalar loads and
     with 64-bit offsets (warp_edge_phase); the combine's closed-form
     backward against autograd;
  3. slice parity, kernels on the card against the plain versions on the
     CPU from one state_dict: a 4-frame transfer at taichi width, and one
     train step at taichi width and batch 2 (metrics, the gradients of the
     three networks, the updated batch-norm statistics), tolerances stated;
  4. the main paths, with every kernel's launch count checked against the
     count the path implies: TransferEngine on configs/taichi.yaml's model
     at 64^2, 256 driving frames in chunks of 128, in bf16 and in f32; and
     Trainer on the same config at batch 32 with Adam, 3 warm-up steps and
     10 timed ones, in bf16 (the config's setting) and in f32.
Then one JSON line with every kernel's numbers, the card's name and power
limit, and the last line {"ok": true, "device": {...}}.

It exits non-zero, with no result line, where CUDA is missing or where the
repository is not beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CHUNK = 128
N_FRAMES = 256
HW = 64
SEED = 0
TRAIN_BATCH = 32
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 10
# (channels, size) of warps of the taichi model: the six encoder skips (the
# first is the source frame itself, and its warp is also video_deformed), and
# last the source frame again, the warp that the JAX package makes a second
# time for video_deformed. The paths make the first six (WARP_IN_PATH); the
# seventh is still timed so that the seven-warp sums compare with earlier runs.
WARP_SHAPES = ((3, 64), (64, 32), (128, 16), (256, 8), (512, 4), (1024, 2), (3, 64))
WARP_IN_PATH = (True, True, True, True, True, True, False)
# Which of them a train step runs backward: all six for the grid, and the
# five skips past the raw source frame (which needs no gradient) for d_src.
DGRID_IN_STEP = WARP_IN_PATH
DSRC_IN_STEP = (False, True, True, True, True, True, False)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def _replay_ms(graph, reps: int) -> float:
    """Device time of one replay of `graph`, mean over `reps` back-to-back
    replays queued while the device spins in a sleep kernel."""
    import torch

    cycles = 50_000_000
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            graph.replay()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if enqueue_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        cycles *= 2
        if cycles > 3_200_000_000:  # ~2 s of sleep, still outrun by the host
            raise RuntimeError("time_ms: replays could not be queued behind the sleep")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back replays, from CUDA
    events. The inputs and outputs are the same in every replay: where they
    fit the L2 cache, this is an L2-warm time.

    fn is captured once into a CUDA graph, and the device spins in a sleep
    kernel while the host enqueues the replays, so the events time the
    device's work and not the rate at which Python launches it (~25 us a
    call, more than most of these kernels take; a plain version launches
    ~100 kernels a call, which would also fill the launch queue).
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _replay_ms(graph, reps)


def time_cold_ms(calls, bytes_per_call: int, reps: int = 5) -> float:
    """Mean device time of one call when its inputs and outputs come from
    device memory, not from the L2 cache.

    `calls` are the same function on distinct copies of its inputs. One CUDA
    graph runs them all in turn and keeps every result alive, so each call
    also writes memory of its own; together they must move at least three
    times the L2's size, so that by the time a replay comes back to a copy
    the cache has long dropped it. The time of a replay is divided by the
    number of calls.
    """
    import torch

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    if bytes_per_call * len(calls) < 3 * l2:
        raise ValueError(f"time_cold_ms: {len(calls)} calls of {bytes_per_call} bytes do not "
                         f"exceed three times the L2 cache ({l2} bytes)")
    calls[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [call() for call in calls]
    graph.replay()
    torch.cuda.synchronize()
    ms = _replay_ms(graph, reps) / len(calls)
    del kept
    return ms


def cold_copies(nbytes: int) -> int:
    """How many distinct copies of an `nbytes` working set time_cold_ms walks
    over: at least six, and enough to exceed the L2 cache 3.5 times."""
    import torch

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(6, -(-7 * l2 // (2 * nbytes)))


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) for moving `nbytes` through HBM and
    doing `flops` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} exceeds tolerance {tol}")


# ---- phase 1 ---------------------------------------------------------------

def build_kernels() -> float:
    from monkeynet_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    build_log = _build.BUILD_DIR / "build.log"
    usage = []
    if build_log.exists():
        usage = [line.strip() for line in build_log.read_text().splitlines()
                 if "Used" in line or "Compiling entry" in line or "spill" in line]
    log({"phase": "build", "seconds": seconds, "ptxas": usage})
    return seconds


# ---- phase 2 ---------------------------------------------------------------

def _warp_cases(device, gen):
    """The warps of a chunk at each of WARP_SHAPES: the skip's plane, a grid
    near the identity (every frame with noise of its own) and the identity
    grid itself (pixel coordinates on, or within an ulp of, the integers)."""
    import torch

    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    cases = []
    for C, h in WARP_SHAPES:
        src = torch.randn(1, h, h, C, generator=gen).to(device)
        ident = make_coordinate_grid((h, h))[None, None].expand(1, CHUNK, h, h, 2)
        grid = ident + 0.1 * torch.randn(1, CHUNK, h, h, 2, generator=gen)
        cases.append((src, grid.reshape(1, CHUNK * h, h, 2).contiguous().to(device),
                      ident.reshape(1, CHUNK * h, h, 2).contiguous().to(device)))
    return cases


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from monkeynet_tpu_torch.ops.cuda import combine, warp

    gen = torch.Generator().manual_seed(SEED)
    summary = {}

    # warp: f32 and bf16 at each of the seven shapes, L2-warm and cold; the
    # sums cover the six warps a chunk makes, and `ms_seven_shapes` all seven
    for dtype, tol_of in ((torch.float32, lambda ref: 1e-5),
                          (torch.bfloat16, lambda ref: 2.0**-8 * ref.abs().max().item())):
        bf16 = dtype == torch.bfloat16
        es = 2 if bf16 else 4
        tot = {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "err": 0.0, "library_ms": None if bf16 else 0.0, "ms_seven_shapes": 0.0}
        for (src, grid, ident), in_path in zip(_warp_cases(device, gen), WARP_IN_PATH):
            src = src.to(dtype)
            B, H, W, C = src.shape
            n = grid.shape[1] * grid.shape[2]
            errs, tols = {}, {}
            for kind, g in (("random", grid), ("identity", ident)):
                ref = warp.grid_sample(src.float(), g)
                errs[kind], tols[kind] = max_err(warp.warp(src, g), ref), tol_of(ref)
                check(f"warp {dtype} C={C} {kind} grid", errs[kind], tols[kind])
            nbytes = src.numel() * es + grid.numel() * 4 + n * C * es
            copies = [(src.clone(), grid.clone()) for _ in range(cold_copies(nbytes))]
            row = {
                "kernel": "warp", "dtype": str(dtype), "shape": [B, H, W, C], "points": n,
                "in_path": in_path, "plan": warp.warp_plan(B, n, C, dtype, True, H * W)._asdict(),
                "max_abs_err": errs, "tol": tols,
                "kernel_ms": time_ms(lambda: warp.warp(src, grid)),
                "kernel_cold_ms": time_cold_ms(
                    [lambda s=s, g=g: warp.warp(s, g) for s, g in copies], nbytes),
                "cold_copies": len(copies),
                "plain_ms": time_ms(lambda: warp.grid_sample(src, grid)),
                "library_ms": None,
            }
            del copies
            if not bf16:
                nchw = src.permute(0, 3, 1, 2)
                lib = F.grid_sample(nchw, grid, align_corners=True, padding_mode="zeros")
                row["library_err"] = max_err(lib.permute(0, 2, 3, 1),
                                             warp.grid_sample(src, grid))
                check(f"F.grid_sample vs plain C={C}", row["library_err"], 1e-5)
                row["library_ms"] = time_ms(lambda: F.grid_sample(
                    nchw, grid, align_corners=True, padding_mode="zeros"))
            log(row)
            tot["ms_seven_shapes"] += row["kernel_ms"]
            tot["err"] = max(tot["err"], *errs.values())
            if not in_path:
                continue
            tot["ms"] += row["kernel_ms"]
            tot["cold_ms"] += row["kernel_cold_ms"]
            tot["plain_ms"] += row["plain_ms"]
            tot["bytes"] += nbytes
            tot["flops"] += n * (C * 8 + 20)  # 4 taps x (mul + add) per channel + coords
            if not bf16:
                tot["library_ms"] += row["library_ms"]
        summary["warp_bf16" if bf16 else "warp"] = tot

    # combine (f32): mask logits, displacement table and correction of a chunk
    K1 = 11
    logits = (2.0 * torch.randn(1, CHUNK, HW, HW, K1, generator=gen)).to(device)
    diff = (0.1 * torch.randn(1, CHUNK, K1, 2, generator=gen))
    diff[:, :, 0] = 0.0
    diff = diff.to(device)
    corr = (0.01 * torch.randn(1, CHUNK, HW, HW, 2, generator=gen)).to(device)
    err = max_err(combine.combine(logits, diff, corr), combine.combine_plain(logits, diff, corr))
    check("combine", err, 1e-5)
    px = CHUNK * HW * HW
    summary["combine"] = {
        "ms": time_ms(lambda: combine.combine(logits, diff, corr)),
        "plain_ms": time_ms(lambda: combine.combine_plain(logits, diff, corr)),
        "library_ms": None, "err": err,
        "bytes": (logits.numel() + diff.numel() + corr.numel() + px * 2) * 4,
        "flops": px * (K1 * 8 + 6),
    }
    log({"kernel": "combine", "shape": list(logits.shape), "max_abs_err": err, "tol": 1e-5,
         "kernel_ms": summary["combine"]["ms"], "plain_ms": summary["combine"]["plain_ms"],
         "library_ms": None})

    summary.update(softargmax_phase(device, gen))
    summary.update(heatmap_phase(device, gen))
    return summary


def softargmax_phase(device, gen) -> dict:
    """The soft-argmax kernel against its plain version (tolerance 1e-5 on
    statistics of size <= 1: f32 sums of up to 65536 terms in another order).

    Timed at the transfer's two shapes, the kp detector's logits of a
    128-frame chunk in f32 and bf16 (L2-warm and cold) and of the source
    frame. Checked besides at K = 4 (configs/shapes.yaml), with peaked logits
    (randn x 30: at temperature 0.1 the max and the 1e-7 floor decide), on a
    frame that ends inside a sweep of the block, on one whose width leaves no
    thread in a fixed column, and at 256^2 and at a frame
    whose byte size is no multiple of 16, which take the 'plane' variant."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import softargmax

    tol = 1e-5
    stats = softargmax.softargmax_stats
    # a 0-dim tensor, so that the plain version divides: PyTorch's CUDA
    # division by a Python number multiplies by its reciprocal, which is an
    # ulp of x / T away from the quotient that the CPU path, the JAX package
    # and the kernel form, and at T = 0.1 that ulp moves peaked logits' p by 1e-4
    temperature = torch.tensor(0.1, device=device)
    before = dict(stats.launches_by_variant)
    summary = {}

    def run(name, hm, variant, timed=False):
        plan = softargmax.softargmax_plan(*hm.shape[2:], hm.dtype)
        if plan.variant != variant:
            raise AssertionError(f"softargmax {name}: planned {plan}, expected {variant}")
        err = max_err(stats(hm, 0.1), softargmax.softargmax_plain(hm, temperature))
        check(f"softargmax {name} {hm.dtype}", err, tol)
        row = {"kernel": "softargmax", "case": name, "dtype": str(hm.dtype),
               "shape": list(hm.shape), "variant": plan.variant, "threads": plan.threads,
               "shared_bytes": plan.shared_bytes, "max_abs_err": err, "tol": tol}
        if timed:
            row["kernel_ms"] = time_ms(lambda: stats(hm, 0.1))
            row["plain_ms"] = time_ms(lambda: softargmax.softargmax_plain(hm, 0.1))
            row["library_ms"] = None
        return row

    for dtype in (torch.float32, torch.bfloat16):
        hm = torch.randn(1, CHUNK, HW, HW, 10, generator=gen).to(device, dtype)
        row = run("chunk", hm, "staged", timed=True)
        nbytes = hm.numel() * hm.element_size() + CHUNK * 10 * 5 * 4
        copies = [hm.clone() for _ in range(cold_copies(nbytes))]
        row["kernel_cold_ms"] = time_cold_ms([lambda x=x: stats(x, 0.1) for x in copies], nbytes)
        row["cold_copies"] = len(copies)
        del copies
        log(row)
        summary["softargmax" if dtype == torch.float32 else "softargmax_bf16"] = {
            "ms": row["kernel_ms"], "cold_ms": row["kernel_cold_ms"],
            "plain_ms": row["plain_ms"], "library_ms": None, "err": row["max_abs_err"],
            "bytes": nbytes,
            # per element: a compare, a divide, a subtract and an exp; the sum;
            # p (2); two coordinates in each of two passes (8); the mean (4);
            # the centred moments (11)
            "flops": hm.numel() * 30,
        }
        for name, shape, scale, variant, timed in (
                ("source frame", (1, 1, HW, HW, 10), 1.0, "staged", True),
                ("K=4", (1, CHUNK, HW, HW, 4), 1.0, "staged", False),
                ("peaked", (1, CHUNK, HW, HW, 10), 30.0, "staged", False),
                ("ragged sweep", (1, 3, 22, 20, 10), 1.0, "staged", False),
                ("moving column", (1, 3, 20, 36, 10), 1.0, "staged", False),
                ("256^2", (1, 2, 256, 256, 10), 1.0, "plane", True),
                ("odd bytes", (1, 5, 15, 15, 3), 1.0, "plane", False)):
            hm = (scale * torch.randn(*shape, generator=gen)).to(device, dtype)
            log(run(name, hm, variant, timed))
    launched = {k: stats.launches_by_variant[k] - before[k] for k in before}
    if min(launched.values()) <= 0:
        raise AssertionError(f"softargmax: a variant was never launched: {launched}")
    log({"kernel": "softargmax", "launches_by_variant_in_phase": launched})
    return summary


def heatmap_phase(device, gen) -> dict:
    """The heatmap kernel against its plain version, tolerance 1e-6 (values
    <= 1 with no normalisation, <= 0.01 at / 100: a few ulps of the exponent),
    the plain version evaluated on the CPU and, with the limits `run` states,
    on the card.

    Timed at the transfer's shapes: the driving keypoints of a 128-frame
    chunk, 'matrix' variance, / 100 (L2-warm and cold), and the source's
    D = 1. Checked besides in all three variance modes x three normalisations
    at 64^2 (keypoints within +-0.9, variances from 0.005), at a width that
    is no multiple of 4 (scalar stores) and at 128^2 with 'sum' (a plane too
    large for registers, evaluated twice)."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import heatmap

    tol = 1e-6

    def keypoints(D, K=10):
        mean = 1.8 * torch.rand(1, D, K, 2, generator=gen) - 0.9
        a = 0.1 * torch.randn(1, D, K, 2, 2, generator=gen)
        var = a @ a.transpose(-1, -2) + 0.005 * torch.eye(2)
        single = 0.005 + 0.02 * torch.rand(1, D, K, 1, 1, generator=gen)
        return {"matrix": {"mean": mean.to(device), "var": var.to(device)},
                "single": {"mean": mean.to(device), "var": single.to(device)},
                0.01: {"mean": mean.to(device)}}

    def run(name, kp, size, variance, norm, timed=False):
        plan = heatmap.heatmap_plan(*size, norm)
        got = heatmap.heatmap(kp, size, variance, norm)
        # The plain version on the CPU is the yardstick: there, as in the JAX
        # package and in the kernel, a pixel's coordinate is 2 * (i / (n - 1)) - 1
        # with a division. On the card PyTorch divides by a Python number by
        # multiplying with its reciprocal, so the plain version's coordinates
        # are an ulp off, and a gaussian of variance 0.005 turns that ulp
        # (6e-8 of dx ~ 0.1 in q = dx^2 / var) into 1.5e-6 of a value near 1.
        # Against the card's plain version the limit is therefore 4e-6 on
        # values <= 1, 4e-6 / 100 at / 100, and 1e-6 where a plane sums to one.
        cpu_kp = {k: v.cpu() for k, v in kp.items()}
        err = max_err(got.cpu(), heatmap.heatmap_plain(cpu_kp, size, variance, norm))
        check(f"heatmap {name} {variance} {norm}", err, tol)
        card_err = max_err(got, heatmap.heatmap_plain(kp, size, variance, norm))
        card_tol = {None: 4e-6, "sum": 1e-6}.get(norm, 4e-6 / 100)
        check(f"heatmap {name} {variance} {norm} against the card's plain", card_err, card_tol)
        row = {"kernel": "heatmap", "case": name, "shape": list(got.shape),
               "kp_variance": variance, "norm_const": norm, "vector": plan.vector,
               "sum_mode": plan.sum_mode, "max_abs_err": err, "tol": tol,
               "max_abs_err_card_plain": card_err, "tol_card_plain": card_tol}
        if timed:
            row["kernel_ms"] = time_ms(lambda: heatmap.heatmap(kp, size, variance, norm))
            row["plain_ms"] = time_ms(lambda: heatmap.heatmap_plain(kp, size, variance, norm))
            row["library_ms"] = None
        return row

    chunk = keypoints(CHUNK)
    row = run("chunk", chunk["matrix"], (HW, HW), "matrix", 100, timed=True)
    elements = CHUNK * 10 * HW * HW
    nbytes = elements * 4 + CHUNK * 10 * 6 * 4
    row["cold_copies"] = cold_copies(nbytes)
    row["kernel_cold_ms"] = time_cold_ms(
        [lambda: heatmap.heatmap(chunk["matrix"], (HW, HW), "matrix", 100)] * row["cold_copies"],
        nbytes)
    log(row)
    summary = {"heatmap": {
        "ms": row["kernel_ms"], "cold_ms": row["kernel_cold_ms"], "plain_ms": row["plain_ms"],
        "library_ms": None, "err": row["max_abs_err"], "bytes": nbytes,
        # per element: the numerator (4), the exponent's factor, exp2, the scale
        "flops": elements * 7,
    }}
    for variance in ("matrix", "single", 0.01):
        for norm in (None, "sum", 100):
            if (variance, norm) != ("matrix", 100):
                log(run("chunk", chunk[variance], (HW, HW), variance, norm))
    source = keypoints(1)
    log(run("source frame", source["matrix"], (HW, HW), "matrix", 100, timed=True))
    for name, D, size, norms in (("W % 4 != 0", 4, (30, 30), (None, "sum", 100)),
                                 ("128^2", 2, (128, 128), ("sum",))):
        small = keypoints(D)
        for variance in ("matrix", "single", 0.01):
            for norm in norms:
                log(run(name, small[variance], size, variance, norm))
    return summary


def grid_off_integers(B, h, gen, margin=0.05):
    """A (B, h, h, 2) grid over [-1.1, 1.1] (some samples outside) whose pixel
    coordinates stay `margin` away from every integer, so that every way of
    forming the coordinate picks the same corner."""
    import torch

    px = (2.2 * torch.rand(B, h, h, 2, generator=gen) - 0.1) * (h - 1) / 2.0
    frac = (px - torch.floor(px)).clamp(margin, 1.0 - margin)
    return ((torch.floor(px) + frac) / (0.5 * (h - 1)) - 1.0).contiguous()


def warp_train_phase(device) -> dict:
    """The three warp kernels at the seven warps of WARP_SHAPES at the
    taichi-64^2 train step (batch 32, one driving frame), f32 and bf16, each
    against the plain version (grid_sample and its autograd, in f32 on the
    same inputs) on a random grid and on the identity grid, with the plans
    of the forward and d_grid, and their L2-warm and cold times. Beside them
    (f32) F.grid_sample's backward three ways: with only the grid leaf
    requiring grad (d_grid's own function), with only the input leaf (d_src's)
    and with both. The summed times, bytes and operations cover the launches
    of one step (6 forward, 5 d_src, 6 d_grid)."""
    import torch
    import torch.nn.functional as F

    from monkeynet_tpu_torch.ops.cuda import warp
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    gen = torch.Generator().manual_seed(SEED + 10)
    B = TRAIN_BATCH
    names = ("warp_train", "warp_dsrc", "warp_dgrid")
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        es = 2 if bf16 else 4
        tot = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None if bf16 else 0.0,
                   "bytes": 0.0, "flops": 0.0, "err": 0.0} for n in names}
        for n in ("warp_train", "warp_dgrid"):
            tot[n]["cold_ms"] = 0.0
        for n in ("warp_dsrc", "warp_dgrid"):
            tot[n]["library_both_ms"] = None if bf16 else 0.0
        tot["warp_dsrc"]["extra_bytes"] = 0.0
        tot["warp_train"]["ms_seven_shapes"] = 0.0

        def tol_of(ref, rounded=False):
            # f32 results: sums of up to 4 * 1024 terms in another order
            # (and, for d_src, atomics in no fixed order); results rounded to
            # bf16 (the bf16 forward and d_src; d_grid is always f32): 2^-8
            scale = max(1.0, ref.abs().max().item())
            return (2.0**-8 if rounded else 2e-5) * scale

        for (C, h), in_path, dsrc_in_step, dgrid_in_step in zip(
                WARP_SHAPES, WARP_IN_PATH, DSRC_IN_STEP, DGRID_IN_STEP):
            src = torch.randn(B, h, h, C, generator=gen).to(device, dtype)
            dout = torch.randn(B, h, h, C, generator=gen).to(device, dtype)
            grids = {
                "random": grid_off_integers(B, h, gen).to(device),
                # pixel coordinates on, or within an ulp of, the integers: the
                # kernels must pick the corners the plain version picks, and
                # d_grid must be its right difference
                "identity": make_coordinate_grid((h, h))[None].expand(B, h, h, 2)
                .contiguous().to(device),
            }
            errs = {}
            for kind, grid in grids.items():
                got = {
                    "warp_train": warp.warp(src, grid),
                    "warp_dsrc": warp.warp_dsrc(grid, dout, tuple(src.shape)),
                    "warp_dgrid": warp.warp_dgrid(src, grid, dout),
                }
                ref = {
                    "warp_train": warp.grid_sample(src.float(), grid),
                    "warp_dsrc": warp.warp_dsrc_plain(grid, dout.float(), tuple(src.shape)),
                    "warp_dgrid": warp.warp_dgrid_plain(src.float(), grid, dout.float()),
                }
                torch.cuda.synchronize()
                for n in names:
                    err = max_err(got[n], ref[n])
                    tol = tol_of(ref[n], rounded=bf16 and n != "warp_dgrid")
                    check(f"{n} {dtype} C={C} {kind} grid", err, tol)
                    errs[f"{n}.{kind}"] = err
                    tot[n]["err"] = max(tot[n]["err"], err)
            grid = grids["random"]
            shape = tuple(src.shape)
            n_pts = B * h * h
            plane = B * h * h * C
            work = {
                "warp_train": (plane * es + n_pts * 8 + n_pts * C * es, n_pts * (C * 8 + 20)),
                # grid and dout read once, the gradient written once in dout's
                # dtype. The kernel's own extra traffic is no part of the
                # bound: see dsrc_extra_bytes below
                "warp_dsrc": (n_pts * 8 + n_pts * C * es + plane * es, n_pts * (C * 8 + 20)),
                "warp_dgrid": (plane * es + n_pts * 8 + n_pts * C * es + n_pts * 8,
                               n_pts * (C * 14 + 24)),
            }
            cold = [(src.clone(), grid.clone(), dout.clone())
                    for _ in range(cold_copies(work["warp_train"][0]))]
            row = {"kernel": "warp fwd/d_src/d_grid", "dtype": str(dtype), "shape": list(shape),
                   "fwd_plan": warp.warp_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "dgrid_plan": warp.dgrid_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "max_abs_err": errs,
                   "fwd_ms": time_ms(lambda: warp.warp(src, grid)),
                   "fwd_cold_ms": time_cold_ms([lambda s=s, g=g: warp.warp(s, g)
                                                for s, g, _ in cold], work["warp_train"][0]),
                   "dsrc_ms": time_ms(lambda: warp.warp_dsrc(grid, dout, shape)),
                   "dgrid_ms": time_ms(lambda: warp.warp_dgrid(src, grid, dout)),
                   "dgrid_cold_ms": time_cold_ms([lambda s=s, g=g, d=d: warp.warp_dgrid(s, g, d)
                                                  for s, g, d in cold], work["warp_dgrid"][0]),
                   "cold_copies": len(cold),
                   "fwd_plain_ms": time_ms(lambda: warp.grid_sample(src, grid)),
                   "dsrc_plain_ms": time_ms(lambda: warp.warp_dsrc_plain(grid, dout, shape)),
                   "dgrid_plain_ms": time_ms(lambda: warp.warp_dgrid_plain(src, grid, dout)),
                   "library_fwd_ms": None, "library_dsrc_ms": None, "library_dgrid_ms": None,
                   "library_bwd_ms": None,
                   # what d_src moves beyond its bound: the zero fill of its f32
                   # buffer and, in bf16, the cast's read of that buffer
                   "dsrc_extra_bytes": plane * (8 if bf16 else 4)}
            del cold
            if not bf16:
                # F.grid_sample's backward; its values are compared only on the
                # grid that avoids integers
                nchw = src.permute(0, 3, 1, 2)
                d_nchw = dout.permute(0, 3, 1, 2)

                def library(image, lgrid):
                    return F.grid_sample(image, lgrid, align_corners=True, padding_mode="zeros")

                def library_grads(want_src=True, want_grid=True):
                    def fn():
                        # leaves made here, so a captured replay owns its graph
                        image = nchw.detach().requires_grad_(want_src)
                        lgrid = grid.detach().requires_grad_(want_grid)
                        leaves = [t for t in (image, lgrid) if t.requires_grad]
                        return torch.autograd.grad(library(image, lgrid), leaves, d_nchw)
                    return fn

                lib_src, lib_grid = library_grads()()
                ref_src = warp.warp_dsrc_plain(grid, dout, shape)
                ref_grid = warp.warp_dgrid_plain(src, grid, dout)
                row["library_err"] = {
                    "d_src": max_err(lib_src.permute(0, 2, 3, 1), ref_src),
                    "d_grid": max_err(lib_grid, ref_grid),
                }
                check(f"F.grid_sample d_src C={C}", row["library_err"]["d_src"], tol_of(ref_src))
                check(f"F.grid_sample d_grid C={C}", row["library_err"]["d_grid"],
                      10 * tol_of(ref_grid))
                row["library_fwd_ms"] = time_ms(lambda: library(nchw, grid))
                # the backward alone cannot be replayed from a graph recorded
                # outside the capture: time forward + backward, less the forward
                for key, want in (("library_bwd_ms", (True, True)),
                                  ("library_dsrc_ms", (True, False)),
                                  ("library_dgrid_ms", (False, True))):
                    row[key] = time_ms(library_grads(*want)) - row["library_fwd_ms"]
            log(row)
            tot["warp_train"]["ms_seven_shapes"] += row["fwd_ms"]
            in_step = {"warp_train": in_path, "warp_dsrc": dsrc_in_step,
                       "warp_dgrid": dgrid_in_step}
            for n, key in zip(names, ("fwd", "dsrc", "dgrid")):
                if not in_step[n]:
                    continue
                tot[n]["ms"] += row[f"{key}_ms"]
                tot[n]["plain_ms"] += row[f"{key}_plain_ms"]
                tot[n]["bytes"] += work[n][0]
                tot[n]["flops"] += work[n][1]
                if "cold_ms" in tot[n]:
                    tot[n]["cold_ms"] += row[f"{key}_cold_ms"]
                if n == "warp_dsrc":
                    tot[n]["extra_bytes"] += row["dsrc_extra_bytes"]
                if not bf16:
                    tot[n]["library_ms"] += row[f"library_{key}_ms"]
                    if n != "warp_train":
                        tot[n]["library_both_ms"] += row["library_bwd_ms"]
        for n in names:
            summary[n + ("_bf16" if bf16 else "")] = tot[n]
    return summary


def warp_edge_phase(device) -> dict:
    """The forward and d_grid kernels where the taichi paths do not take
    them, against their plain versions: scalar loads (a source and dout one
    element off 16 bytes at C = 64; C = 5 and 12, no multiple of the bf16
    pack, the first of the f32 one), the small forward with its plane read
    in place and staged from a misaligned plane, and 64-bit offsets (2^21 points of 1024
    bf16 channels, 2^31 elements of output and of dout, held against the
    plain version on the first and the last two rows of points). Then every
    variant of both kernels must have launched in the phases so far."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import warp

    gen = torch.Generator().manual_seed(SEED + 12)
    result = {"phase": "warp_edge", "scalar": [], "index64": {}}
    for dtype in (torch.float32, torch.bfloat16):
        rounded = 2.0**-8 if dtype == torch.bfloat16 else 2e-5
        for C in (5, 12, 64):
            # slices one element into their storage: 4 or 2 bytes off 16
            src = torch.randn(2 * 9 * 17 * C + 1, generator=gen).to(device, dtype)[1:]
            src = src.view(2, 9, 17, C)
            dout = torch.randn(2 * 8 * 8 * C + 1, generator=gen).to(device, dtype)[1:]
            dout = dout.view(2, 8, 8, C)
            grid = grid_off_integers(2, 8, gen).to(device)
            plans = (warp.warp_plan(2, 64, C, dtype, False, 9 * 17),
                     warp.dgrid_plan(2, 64, C, dtype, False, 9 * 17))
            if any(p.vector != 1 for p in plans):
                raise AssertionError(f"warp edge: planned {plans}, expected scalar loads")
            ref = warp.grid_sample(src.float(), grid)
            dref = warp.warp_dgrid_plain(src.float(), grid, dout.float())
            errs = {"fwd": max_err(warp.warp(src, grid), ref),
                    "dgrid": max_err(warp.warp_dgrid(src, grid, dout), dref)}
            check(f"warp edge fwd {dtype} C={C}", errs["fwd"],
                  rounded * max(1.0, ref.abs().max().item()))
            check(f"warp edge dgrid {dtype} C={C}", errs["dgrid"],
                  2e-5 * max(1.0, dref.abs().max().item()))
            result["scalar"].append({"dtype": str(dtype), "C": C, "max_abs_err": errs,
                                     "plans": [p._asdict() for p in plans]})

    # the small forward with its source plane read in place (128^2 x 3 is
    # more than the 48 KB it stages) and staged from a plane one element off
    # 16 bytes (copied element by element)
    result["small"] = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, size, offset in (("in place", 128, 0), ("staged, misaligned", 64, 1)):
            src = torch.randn(size * size * 3 + offset, generator=gen).to(device, dtype)
            src = src[offset:].view(1, size, size, 3)
            grid = grid_off_integers(1, 32, gen).to(device)
            plan = warp.warp_plan(1, 32 * 32, 3, dtype, True, size * size)
            if (plan.shared_bytes > 0) != (name != "in place"):
                raise AssertionError(f"warp edge {name}: planned {plan}")
            ref = warp.grid_sample(src.float(), grid)
            err = max_err(warp.warp(src, grid), ref)
            tol = (2.0**-8 if dtype == torch.bfloat16 else 2e-5) * max(1.0, ref.abs().max().item())
            check(f"warp edge small {name} {dtype}", err, tol)
            result["small"].append({"case": name, "dtype": str(dtype), "max_abs_err": err,
                                    "plan": plan._asdict()})

    n, C, dtype = 2**21, 1024, torch.bfloat16
    src = torch.randn(1, 2, 2, C, generator=gen).to(device, dtype)
    grid = (2.4 * torch.rand(1, n // 1024, 1024, 2, generator=gen) - 1.2).to(device)
    plans = (warp.warp_plan(1, n, C, dtype, True, 4), warp.dgrid_plan(1, n, C, dtype, True, 4))
    if any(p.index_bits != 64 for p in plans):
        raise AssertionError(f"warp edge: planned {plans}, expected 64-bit offsets")
    out = warp.warp(src, grid)
    errs = {}
    for name, rows in (("first", slice(0, 2)), ("last", slice(-2, None))):
        ref = warp.grid_sample(src.float(), grid[:, rows])
        errs[f"fwd.{name}"] = max_err(out[:, rows], ref)
        check(f"warp edge fwd 64-bit {name}", errs[f"fwd.{name}"],
              2.0**-8 * max(1.0, ref.abs().max().item()))
    del out
    dout = torch.randn(1, n // 1024, 1024, C, generator=torch.Generator(device).manual_seed(1),
                       device=device, dtype=dtype)
    dgrid = warp.warp_dgrid(src, grid, dout)
    for name, rows in (("first", slice(0, 2)), ("last", slice(-2, None))):
        ref = warp.warp_dgrid_plain(src.float(), grid[:, rows], dout[:, rows].float())
        errs[f"dgrid.{name}"] = max_err(dgrid[:, rows], ref)
        check(f"warp edge dgrid 64-bit {name}", errs[f"dgrid.{name}"],
              2e-5 * max(1.0, ref.abs().max().item()))
    del dout, dgrid
    result["index64"] = {"points": n, "channels": C, "max_abs_err": errs,
                         "plans": [p._asdict() for p in plans]}
    launched = {"warp": dict(warp.warp.launches_by_variant),
                "warp_dgrid": dict(warp.warp_dgrid.launches_by_variant)}
    if min(min(v.values()) for v in launched.values()) <= 0:
        raise AssertionError(f"warp: a variant was never launched: {launched}")
    result["launches_by_variant"] = launched
    log(result)
    return result


def combine_backward_phase(device) -> dict:
    """At the train step's shape, on the card: the combine kernel against
    combine_plain, and its closed-form backward (plain PyTorch in both
    packages) against autograd of combine_plain."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import combine

    gen = torch.Generator().manual_seed(SEED + 11)
    K1 = 11
    logits = (2.0 * torch.randn(TRAIN_BATCH, 1, HW, HW, K1, generator=gen)).to(device)
    diff = (0.1 * torch.randn(TRAIN_BATCH, 1, K1, 2, generator=gen)).to(device)
    corr = (0.01 * torch.randn(TRAIN_BATCH, 1, HW, HW, 2, generator=gen)).to(device)
    g = torch.randn(TRAIN_BATCH, 1, HW, HW, 2, generator=gen).to(device)
    forward_err = max_err(combine.combine(logits, diff, corr),
                          combine.combine_plain(logits, diff, corr))
    check("combine forward, train shape", forward_err, 1e-5)

    def grads(fn):
        # leaves made here, so a captured replay owns its whole graph
        leaves = [t.detach().requires_grad_() for t in (logits, diff, corr)]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    # through CombineFunction: the kernel forward, the closed-form backward
    got = grads(combine.combine)
    want = grads(combine.combine_plain)
    # ddiff sums 4096 pixels per entry: f32 noise of ~1e-5 on sums of ~50
    tols = {"dlogits": 1e-5, "ddiff": 1e-3, "dcorr": 0.0}
    errs = {"forward": forward_err}
    for (name, tol), a, b in zip(tols.items(), got, want):
        errs[name] = max_err(a, b)
        check(f"combine backward {name}", errs[name], tol)
    result = {
        "phase": "combine_backward", "shape": list(logits.shape), "max_abs_err": errs,
        "tol": dict(tols, forward=1e-5),
        "closed_form_ms": time_ms(lambda: combine.combine_backward(logits, diff, g)),
        "autograd_fwd_bwd_ms": time_ms(lambda: grads(combine.combine_plain)),
    }
    log(result)
    return result


# ---- phase 3 ---------------------------------------------------------------

def _perturb_for_parity(generator, seed: int) -> None:
    """Small random weights on the dense-motion head (zero at init), so the
    flow leaves the identity and the warps sample off-grid, and random
    running statistics, so every batch norm does real work."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    head = generator.dense_motion_module.hourglass.decoder.conv
    with torch.no_grad():
        head.weight.copy_(0.005 * torch.randn(head.weight.shape, generator=gen))
        for name, buf in generator.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def slice_parity(config, device="cuda") -> dict:
    """4-frame transfer at taichi width: kernels on the card against the
    plain versions on the CPU, from one state_dict, in f32."""
    import copy

    import torch

    from monkeynet_tpu_torch.tasks.animate import TransferEngine
    from monkeynet_tpu_torch.tasks.build import build_models

    generator, kp_detector = build_models(config, device="cpu", seed=SEED)
    _perturb_for_parity(generator, SEED + 1)
    gen = torch.Generator().manual_seed(SEED + 2)
    source = torch.rand(1, 1, HW, HW, 3, generator=gen)
    driving = torch.rand(1, 4, HW, HW, 3, generator=gen)
    cpu = TransferEngine(generator, kp_detector, device="cpu")(source, driving)
    gpu = TransferEngine(copy.deepcopy(generator), copy.deepcopy(kp_detector),
                         device=device)(source, driving)
    torch.cuda.synchronize()
    tolerances = {
        # ~30 conv layers at widths up to 2048 summed in other orders by
        # cuDNN and the CPU: f32 noise grows to ~1e-5 on [0, 1] outputs
        "video_prediction": 1e-3,
        "video_deformed": 1e-3,
        # keypoints come out of a temperature-0.1 softmax over 4096 pixels
        "kp_driving.mean": 1e-4,
        "kp_source.mean": 1e-4,
    }
    errs = {
        "video_prediction": max_err(gpu["video_prediction"].cpu(), cpu["video_prediction"]),
        "video_deformed": max_err(gpu["video_deformed"].cpu(), cpu["video_deformed"]),
        "kp_driving.mean": max_err(gpu["kp_driving"]["mean"].cpu(), cpu["kp_driving"]["mean"]),
        "kp_source.mean": max_err(gpu["kp_source"]["mean"].cpu(), cpu["kp_source"]["mean"]),
    }
    off_identity = max_err(cpu["video_deformed"], source.expand_as(cpu["video_deformed"]))
    if off_identity < 0.05:
        raise AssertionError(f"parity flow is the identity (max change {off_identity})")
    for name, err in errs.items():
        check(f"slice parity {name}", err, tolerances[name])
    result = {"phase": "slice_parity", "frames": 4, "max_abs_err": errs,
              "tol": tolerances, "deformed_vs_source": off_identity}
    log(result)
    return result


# ---- phase 4 ---------------------------------------------------------------

def _counters():
    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    return {"warp": warp.warp, "warp_dsrc": warp.warp_dsrc, "warp_dgrid": warp.warp_dgrid,
            "combine": combine.combine, "softargmax": softargmax.softargmax_stats,
            "heatmap": heatmap.heatmap}


def expected_launches(n_frames: int, chunk: int) -> dict:
    """Per chunk: six warps (the six encoder skips; the first is the source
    frame, whose warp is also video_deformed), one combine, four heatmaps
    (driving and source in two embeddings), one soft-argmax; plus one
    soft-argmax for the source frame on the first chunk."""
    chunks = -(-n_frames // chunk)
    return {"warp": 6 * chunks, "warp_dsrc": 0, "warp_dgrid": 0, "combine": chunks,
            "heatmap": 4 * chunks, "softargmax": chunks + 1}


def main_path(config, dtype, device="cuda") -> dict:
    import torch

    from monkeynet_tpu_torch.tasks.animate import TransferEngine
    from monkeynet_tpu_torch.tasks.build import build_models

    generator, kp_detector = build_models(config, device=device, seed=SEED)
    engine = TransferEngine(generator, kp_detector, chunk=CHUNK, dtype=dtype, device=device)
    gen = torch.Generator().manual_seed(SEED + 3)
    source = torch.rand(1, 1, HW, HW, 3, generator=gen).to(device)
    driving = torch.rand(1, N_FRAMES, HW, HW, 3, generator=gen).to(device)

    engine(source, driving)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine(source, driving)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    want = expected_launches(N_FRAMES, CHUNK)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    pred = out["video_prediction"]
    if tuple(pred.shape) != (1, N_FRAMES, HW, HW, 3) or not torch.isfinite(pred).all():
        raise AssertionError(f"bad video_prediction: {tuple(pred.shape)}")
    if not torch.isfinite(out["video_deformed"]).all():
        raise AssertionError("non-finite video_deformed")
    for group in ("kp_driving", "kp_norm", "kp_source"):
        for k, v in out[group].items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"non-finite {group}.{k}")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine(source, driving)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    result = {
        "phase": "main_path", "dtype": str(dtype), "frames": N_FRAMES, "chunk": CHUNK,
        "launches": launches, "expected_launches": want,
        "counted_run_s": first_s, "run_s": times,
        "frames_per_s_median": N_FRAMES / times[1], "frames_per_s_best": N_FRAMES / times[0],
        "peak_mem_gb": peak / 1e9,
    }
    log(result)
    return result


# ---- the train step --------------------------------------------------------

def _sgd(params):
    import torch

    return torch.optim.SGD(params, lr=1e-3)


# Train parity, card against CPU: the largest relative L2 gap of a
# sub-module's gradient, the largest absolute gap of a batch-norm statistic,
# the largest relative gap of a metric. On an H100 the sound kernels read
# 8.6e-3 (3.4e-3 on another batch), 4.9e-6 and 5.5e-6. With d_grid's x scale
# W/2 for (W-1)/2 the gradient gap reads 7.1e-2 and 1.2e-1 in the two
# sub-modules the grid feeds, and with two of d_src's corner weights
# exchanged 9.7e-1 in the appearance encoder
# (scripts/train_parity_mutation.py): the gradient limit lies midway, on a
# log scale, between the sound reading and the smallest wrong one.
PARITY_TOL = {"grad_rel_l2": 2.5e-2, "bn_stats_max_abs": 1e-4, "metrics_max_rel": 1e-4}


def _grad_groups(trainer) -> dict:
    """Gradients of a Trainer's three networks, concatenated per top-level
    sub-module ('generator.appearance_encoder', 'kp_detector.predictor', ...)."""
    import torch

    groups = {}
    for name, model in trainer.models.items():
        for key, p in model.named_parameters():
            if p.grad is None:
                raise AssertionError(f"train parity: no gradient for {name}.{key}")
            groups.setdefault(f"{name}.{key.split('.')[0]}", []).append(p.grad.flatten().cpu())
    return {k: torch.cat(v) for k, v in groups.items()}


def _buffers(trainer) -> dict:
    return {f"{name}.{key}": b.detach().cpu()
            for name, model in trainer.models.items()
            for key, b in model.named_buffers() if not key.endswith("num_batches_tracked")}


def train_parity(config, device="cuda") -> dict:
    """One SGD step at taichi width, batch 2, f32: kernels on the card against
    the plain versions on the CPU, from one state_dict, held to PARITY_TOL.

    At this width and with random weights the step amplifies rounding: thirty
    1024-wide layers with batch statistics and a temperature-0.1 softmax in
    the kp detector turn the few f32 ulps between two conv summation orders
    into 3e-3 to 9e-3 of a gradient's size, whichever versions of the kernels
    run.
    A wrong kernel gradient is off by a large share of the gradient's own
    size in the sub-modules it feeds. The kernels' own tight comparisons are
    phase 2.
    """
    import copy

    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer, metric_names

    train_params = dict(config["train_params"], compute_dtype=None)
    models = build_train_models(config, device="cpu", seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 4)
    batch = {"source": torch.rand(2, 1, HW, HW, 3, generator=gen),
             "video": torch.rand(2, 1, HW, HW, 3, generator=gen)}
    runs = {}
    for where in ("cpu", device):
        trainer = Trainer(copy.deepcopy(models), train_params, device=where,
                          optimizer_factory=_sgd)
        out = trainer.step(batch)
        torch.cuda.synchronize()
        runs[where] = (_grad_groups(trainer), _buffers(trainer), out["metrics"].cpu())
    grads, buffers, metrics = runs["cpu"]
    card_grads, card_buffers, card_metrics = runs[device]
    gaps = {
        "grad_rel_l2": {k: ((card_grads[k] - grads[k]).norm() / grads[k].norm()).item()
                        for k in grads},
        "bn_stats_max_abs": max(max_err(card_buffers[k], buffers[k]) for k in buffers),
        "metrics_max_rel": ((card_metrics - metrics).abs()
                            / metrics.abs().clamp_min(1e-6)).max().item(),
    }
    result = {"phase": "train_parity", "batch": 2, "metric_names": metric_names(train_params),
              "metrics_cpu": metrics.tolist(), "metrics_card": card_metrics.tolist(),
              "card_vs_cpu": gaps, "tol": PARITY_TOL}
    log(result)
    for group, err in gaps["grad_rel_l2"].items():
        check(f"train parity grad {group}", err, PARITY_TOL["grad_rel_l2"])
    for key in ("bn_stats_max_abs", "metrics_max_rel"):
        check(f"train parity {key}", gaps[key], PARITY_TOL[key])
    return result


# Per train step: six warps forward (the encoder skips; video_deformed is the
# first of them), all six backward for the grid and five for the source (the
# raw source frame needs no gradient); one combine; the softargmax and
# heatmap kernels are forward-only and stay out of training.
TRAIN_STEP_LAUNCHES = {"warp": 6, "warp_dsrc": 5, "warp_dgrid": 6, "combine": 1,
                       "softargmax": 0, "heatmap": 0}


def train_path(config, compute_dtype, device="cuda") -> dict:
    """Trainer on configs/taichi.yaml at 64^2, batch 32, Adam, uint8 batches
    made on the card from a seed."""
    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer, metric_names

    train_params = dict(config["train_params"], compute_dtype=compute_dtype)
    models = build_train_models(config, device=device, seed=SEED)
    trainer = Trainer(models, train_params, device=device, steps_per_epoch=100)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    n_steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = [
        {k: torch.randint(0, 256, (TRAIN_BATCH, 1, HW, HW, 3), dtype=torch.uint8,
                          device=device, generator=gen) for k in ("source", "video")}
        for _ in range(n_steps)
    ]
    before = {name: [p.detach().clone() for p in trainer.models[name].parameters()]
              for name in MODEL_NAMES}
    for batch in batches[:TRAIN_WARMUP_STEPS]:  # cuDNN plans, allocator, Adam state
        trainer.step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    times, metrics = [], []
    for batch in batches[TRAIN_WARMUP_STEPS:]:
        t0 = time.perf_counter()
        out = trainer.step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append(out["metrics"])
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    want = {k: v * TRAIN_TIMED_STEPS for k, v in TRAIN_STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != expected {want}")
    metrics = torch.stack(metrics).float()
    if not torch.isfinite(metrics).all():
        raise AssertionError(f"non-finite train metrics: {metrics.tolist()}")
    if tuple(out["video_prediction"].shape) != (TRAIN_BATCH, 1, HW, HW, 3) \
            or not torch.isfinite(out["video_prediction"].float()).all():
        raise AssertionError("bad video_prediction from the train step")
    moved = {}
    for name in MODEL_NAMES:
        params = list(trainer.models[name].parameters())
        if any(p.dtype != torch.float32 or not torch.isfinite(p).all() for p in params):
            raise AssertionError(f"{name}: master parameters must stay finite f32")
        moved[name] = sum((p.detach() - b).abs().sum().item()
                          for p, b in zip(params, before[name]))
        if not moved[name] > 0:
            raise AssertionError(f"{name}: parameters did not move")
    ordered = sorted(times)
    median = 0.5 * (ordered[len(ordered) // 2 - 1] + ordered[len(ordered) // 2])
    result = {
        "phase": "train_path", "compute_dtype": compute_dtype or "float32",
        "batch": TRAIN_BATCH, "steps": TRAIN_TIMED_STEPS, "warmup_steps": TRAIN_WARMUP_STEPS,
        "launches": launches, "expected_launches": want,
        "metric_names": metric_names(train_params),
        "first_metrics": metrics[0].tolist(), "last_metrics": metrics[-1].tolist(),
        "step_s": times, "steps_per_s_median": 1.0 / median,
        "steps_per_s_best": 1.0 / ordered[0], "steps_per_s_worst": 1.0 / ordered[-1],
        "sum_abs_param_change": moved, "peak_mem_gb": peak / 1e9,
    }
    log(result)
    return result


def kernels_line(summary: dict, transfer_launches: dict, train_launches: dict) -> dict:
    """One row per kernel. `launches` is the count of the path that runs the
    kernel: the 256-frame transfer for the four forward kernels, the ten
    timed train steps for d_src and d_grid; both paths' counts are also given
    under their own names. Times are per transfer chunk (forward kernels)
    and per train step (d_src, d_grid; the warp's `train` entry), summed over
    the calls the path makes; the warp's `ms_seven_shapes` adds the seventh
    shape, the second warp of the source frame that the path no longer
    makes."""
    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    def numbers(s):
        b_ms, b_by = bound_ms(s["bytes"], s["flops"])
        row = {"max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": s["library_ms"]}
        for key in ("cold_ms", "ms_seven_shapes", "library_both_ms", "extra_bytes"):
            if key in s:  # cold_ms: the redesigned kernels, `ms` is L2-warm
                row[key] = s[key]
        return row

    specs = (
        ("warp", warp.SOURCE, warp.REPLACES, "warp", transfer_launches),
        ("warp_dsrc", warp.DSRC_SOURCE, warp.DSRC_REPLACES, "warp_dsrc", train_launches),
        ("warp_dgrid", warp.DGRID_SOURCE, warp.DGRID_REPLACES, "warp_dgrid", train_launches),
        ("combine", combine.SOURCE, combine.REPLACES, "combine", transfer_launches),
        ("softargmax", softargmax.SOURCE, softargmax.REPLACES, "softargmax", transfer_launches),
        ("heatmap", heatmap.SOURCE, heatmap.REPLACES, "heatmap", transfer_launches),
    )
    rows = []
    for name, source, replaces, key, launches in specs:
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], **numbers(summary[key]),
               "transfer_launches": transfer_launches[name],
               "train_launches": train_launches[name]}
        if f"{key}_bf16" in summary:
            row["bf16"] = numbers(summary[f"{key}_bf16"])
        if name == "warp":
            row["train"] = {"f32": numbers(summary["warp_train"]),
                            "bf16": numbers(summary["warp_train_bf16"])}
        if name in ("warp_dsrc", "warp_dgrid"):
            # extra_bytes (d_src): beyond the bound's bytes, the zero fill and,
            # in bf16, the cast's read
            leaf = "input" if name == "warp_dsrc" else "grid"
            row["library"] = (f"F.grid_sample backward with only the {leaf} requiring grad; "
                              "library_both_ms: both gradients in one call")
        rows.append(row)
    return {"kernels": rows}


def full_f32() -> None:
    """Full f32 in every f32 comparison and run: no TF32 in convs or matmuls."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    if not (REPO / "monkeynet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from monkeynet_tpu_torch.utils.config import load_config

    full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    config = load_config(str(REPO / "configs" / "taichi.yaml"))
    build_kernels()
    summary = kernel_phase("cuda")
    summary.update(warp_train_phase("cuda"))
    warp_edge_phase("cuda")
    combine_backward_phase("cuda")
    slice_parity(config)
    train_parity(config)
    runs = [main_path(config, torch.bfloat16), main_path(config, torch.float32)]
    train_runs = [train_path(config, "bfloat16"), train_path(config, None)]
    # every run of a path launched the same counts (checked above); report the
    # bf16 runs' counts, the setting both the benchmark and the config use
    print(json.dumps(kernels_line(summary, runs[0]["launches"], train_runs[0]["launches"])),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
