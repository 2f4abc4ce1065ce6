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
     all three, F.grid_sample's backward for the grid alone, the input
     alone and both; the three with scalar loads and with 64-bit offsets,
     and d_src's 'global' variant and its 'shared' one past 48 KB of shared
     memory at the 256^2 configs' skips (warp_edge_phase); the combine's
     closed-form backward against autograd; the four kernels of the train
     loop at the shapes its steps give them (configs/shapes.yaml, batch
     16: the three warp kernels at C = 3 ... 128 over 64^2 ... 2^2, both
     dtypes, random and identity grids; the combine and its backward at
     K1 = 5; loop_kernel_phase);
  3. slice parity, kernels on the card against the plain versions on the
     CPU from one state_dict: a 4-frame transfer at taichi width, and one
     train step at batch 2 (metrics, the gradients of the three networks,
     the updated batch-norm statistics) at taichi width and at shapes
     width, tolerances stated;
  4. the main paths, with every kernel's launch count checked against the
     count the path implies: TransferEngine on configs/taichi.yaml's model
     at 64^2, 256 driving frames in chunks of 128, in bf16 and in f32; and
     Trainer on the same config at batch 32 with Adam, 3 warm-up steps and
     10 timed ones, in bf16 (the config's setting) and in f32, and the
     same 10 steps as replays of the step's CUDA graph (Trainer.run);
  5. the train loop (train_loop_phase): train() on configs/shapes.yaml over
     the first 512 train videos of data/shapes, full width, batch 16, 2
     epochs of 32 steps, on the path the config asks for (the device feed,
     k = 32 steps a dispatch through the step's CUDA graph), with its
     kernel launches (6 warp, 5 d_src, 6 d_grid, 1 combine a step) checked
     as captured launches x replays and by the profiler's count of one
     replay, log rows, train-vis gifs and epoch checkpoints checked; a
     resume from the epoch-0 checkpoint, restored bit for bit, that trains
     epoch 0 again; the same cut on the eager host feed (device_feed false,
     steps_per_dispatch 1), its launches counted step by step; the loops'
     steps over their wall time beside the step alone, eager and graphed
     (log.txt's steps/s per window as a breakdown), the wait on the
     feeder, the cache, the reader that decoded, peak memory and the first
     and last reconstruction loss;
  6. the eval paths (eval_phase) on phase 5's last checkpoint, each step with
     its launches counted and checked against its route's and its wall time
     printed beside the card: reconstruction() over the first 4 test videos
     of data/shapes (files, finite L1 / AKD / AED, L1 below the loop's
     initial weights'); transfer() over 4 pairs on both routes (the config's
     move_location through TransferEngine; the hull and covariance recipe
     through KPExtractor, normalize_kp and Animator); one reconstruction video
     and one hull pair on the card against the CPU, keypoints and generator
     each from the same inputs; prediction() with the
     GRU at 1024 features, 20 epochs over 16 train videos, 4 test videos
     rolled out (the loss falls, the gifs are written); the demo on
     configs/moving-gif.yaml at 128^2, full width, random weights, over
     data/demo;
  7. the device feed, k steps a dispatch and remat (dispatch_phase): (a)
     configs/actions.yaml's augmentation over a batch of 32 items of
     data/actions on the card against the CPU and the host pipeline (the
     gathers to 1.2e-7, rotation and jitter to 5e-5; where it rotates, the
     host pipeline with scipy's exact rotation in place of cv2's
     fixed-point one); (b) the step's CUDA graph against eager steps at
     actions width, bf16 and f32, 4 device-fed steps from one state, and a
     rate milestone inside the chunk; (c) train() on configs/actions.yaml as
     shipped, cut to 90 epochs (3 dispatches of k = 30), with the device
     feed, launches by capture x replays and by the profiler, rows, gif,
     checkpoints, the exit checkpoint reloaded into an eager Trainer, the
     graphed and eager step alone, one chunk's busy share, the cache and
     peak memory; (d) remat on configs/shapes-256.yaml as shipped over the
     first 64 videos of data/shapes256: a step with and without, peak
     memory and time, and a graphed remat step;
  8. data parallelism (parallel_phase): (a) over an explicit one-rank NCCL
     group whose all-reduces are captured in the step's graph: one graphed
     step of configs/shapes.yaml equal to the unsharded step bit for bit
     outside the appearance encoder (where d_src's f32 sums differ run to
     run) and its gradients within train parity's limit inside it; phase 5's cut
     through train() over the group, launches as capture x replays with the
     captured all-reduces and a profiler trace of one replay, rank 0's rows,
     gifs and checkpoints; (b) two gloo ranks sharing the card at
     configs/actions.yaml's width, the batch of 32 as two slabs of 16, 2
     eager device-fed SGD steps in bf16 and f32 against one process at 32
     (parameters within the train-parity limit, the first f32 update too,
     running statistics, num_batches_tracked, launches a rank; a control
     with the batch's halves swapped), each rank's four train kernels
     held against their plain versions at its shapes; (c) frame-sharded eval
     over the card named twice on (a)'s checkpoint: the engines,
     reconstruction() and the move_location transfer() against the
     unsharded ones, and the moving-gif demo at 128^2, launches counted;
  9. the JAX package's msgpack checkpoint (jaxckpt_phase), the committed
     tests/fixtures/jax_train_checkpoint.msgpack (the JAX train() at the
     tests' tiny widths, 64^2): (a) into a Trainer on the card, every tensor
     bit for bit against the decoded file (parameters, batch statistics,
     Adam moments and steps), the rate at the JAX schedule's value at the
     file's count, one eager step at it; (b) reconstruction() from the file
     over 2 test videos of data/shapes on the card and on the CPU, launches
     counted, frames compared; (c) train() resumed from the file on the
     config's path (the device feed, the step's CUDA graph), launches as
     capture x replays, rows from the file's `it`, Adam steps and rates
     after; (d) the command lines of the dataset tools, bg_removal and the
     user study, each in a process of its own.
Then one JSON line with every kernel's numbers, the card's name and power
limit, and the last line {"ok": true, "device": {...}}.

It exits non-zero, with no result line, where CUDA is missing or where the
repository is not beside it. It imports nothing of JAX. `--only PHASE ...`
(kernels, parity, main, loop, dispatch, parallel, jaxckpt) runs only those phases
after the build and prints no result line.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

def _warp_cases(device, gen, shapes=WARP_SHAPES, frames=CHUNK):
    """The warps of a chunk of `frames` at each of `shapes`: the skip's
    plane, a grid near the identity (every frame with noise of its own) and
    the identity grid itself (pixel coordinates on, or within an ulp of, the
    integers)."""
    import torch

    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    cases = []
    for C, h in shapes:
        src = torch.randn(1, h, h, C, generator=gen).to(device)
        ident = make_coordinate_grid((h, h))[None, None].expand(1, frames, h, h, 2)
        grid = ident + 0.1 * torch.randn(1, frames, h, h, 2, generator=gen)
        cases.append((src, grid.reshape(1, frames * h, h, 2).contiguous().to(device),
                      ident.reshape(1, frames * h, h, 2).contiguous().to(device)))
    return cases


def _combine_inputs(frames, h, K1, gen, device):
    """Mask logits, displacement table (the background's row zero) and
    correction of a chunk of `frames` at h^2, batch 1."""
    import torch

    logits = (2.0 * torch.randn(1, frames, h, h, K1, generator=gen)).to(device)
    diff = 0.1 * torch.randn(1, frames, K1, 2, generator=gen)
    diff[:, :, 0] = 0.0
    corr = (0.01 * torch.randn(1, frames, h, h, 2, generator=gen)).to(device)
    return logits, diff.to(device), corr


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
    logits, diff, corr = _combine_inputs(CHUNK, HW, K1, gen, device)
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


def _warp_tol(ref, rounded=False):
    """f32 results: sums of up to 4 * 1024 terms in another order (and, for
    d_src, points binned in no fixed order); results rounded to bf16 (the
    bf16 forward and d_src; d_grid is always f32): 2^-8. Both relative to
    the reference's largest magnitude, at least 1."""
    return (2.0**-8 if rounded else 2e-5) * max(1.0, ref.abs().max().item())


def _warp_train_inputs(B, h, C, dtype, gen, device):
    """A (B, h, h, C) source and dout, and two (B, h, h, 2) grids: one that
    keeps off the integers and the identity, whose pixel coordinates lie on,
    or within an ulp of, the integers (the kernels must pick the corners the
    plain version picks, and d_grid must be its right difference)."""
    import torch

    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    src = torch.randn(B, h, h, C, generator=gen).to(device, dtype)
    dout = torch.randn(B, h, h, C, generator=gen).to(device, dtype)
    grids = {
        "random": grid_off_integers(B, h, gen).to(device),
        "identity": make_coordinate_grid((h, h))[None].expand(B, h, h, 2)
        .contiguous().to(device),
    }
    return src, dout, grids


def _check_warp_train(src, dout, grids, label: str) -> dict:
    """The warp's forward, d_src and d_grid kernels against their plain
    versions (in f32 on the same inputs) on each grid; max abs errors by
    '<kernel>.<grid>'."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import warp

    bf16 = src.dtype == torch.bfloat16
    shape = tuple(src.shape)
    errs = {}
    for kind, grid in grids.items():
        got = {
            "warp_train": warp.warp(src, grid),
            "warp_dsrc": warp.warp_dsrc(grid, dout, shape),
            "warp_dgrid": warp.warp_dgrid(src, grid, dout),
        }
        ref = {
            "warp_train": warp.grid_sample(src.float(), grid),
            "warp_dsrc": warp.warp_dsrc_plain(grid, dout.float(), shape),
            "warp_dgrid": warp.warp_dgrid_plain(src.float(), grid, dout.float()),
        }
        torch.cuda.synchronize()
        for n, value in got.items():
            err = max_err(value, ref[n])
            check(f"{n} {label} {src.dtype} {list(shape)} {kind} grid", err,
                  _warp_tol(ref[n], rounded=bf16 and n != "warp_dgrid"))
            errs[f"{n}.{kind}"] = err
    return errs


def warp_train_phase(device) -> dict:
    """The three warp kernels at the seven warps of WARP_SHAPES at the
    taichi-64^2 train step (batch 32, one driving frame), f32 and bf16, each
    against the plain version (grid_sample and its autograd, in f32 on the
    same inputs) on a random grid and on the identity grid, with the plans
    of the three, and their L2-warm and cold times. Beside them
    (f32) F.grid_sample's backward three ways: with only the grid leaf
    requiring grad (d_grid's own function), with only the input leaf (d_src's)
    and with both. The summed times, bytes and operations cover the launches
    of one step (6 forward, 5 d_src, 6 d_grid)."""
    import torch
    import torch.nn.functional as F

    from monkeynet_tpu_torch.ops.cuda import warp

    gen = torch.Generator().manual_seed(SEED + 10)
    B = TRAIN_BATCH
    names = ("warp_train", "warp_dsrc", "warp_dgrid")
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        es = 2 if bf16 else 4
        tot = {n: {"ms": 0.0, "cold_ms": 0.0, "plain_ms": 0.0,
                   "library_ms": None if bf16 else 0.0, "bytes": 0.0, "flops": 0.0, "err": 0.0}
               for n in names}
        for n in ("warp_dsrc", "warp_dgrid"):
            tot[n]["library_both_ms"] = None if bf16 else 0.0
        tot["warp_dsrc"]["extra_bytes"] = 0.0
        tot["warp_train"]["ms_seven_shapes"] = 0.0

        for (C, h), in_path, dsrc_in_step, dgrid_in_step in zip(
                WARP_SHAPES, WARP_IN_PATH, DSRC_IN_STEP, DGRID_IN_STEP):
            src, dout, grids = _warp_train_inputs(B, h, C, dtype, gen, device)
            errs = _check_warp_train(src, dout, grids, "taichi")
            for key, err in errs.items():
                n = key.split(".")[0]
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
            dsrc_plan = warp.dsrc_plan(B, h * h, C, dtype, True, (h, h))
            row = {"kernel": "warp fwd/d_src/d_grid", "dtype": str(dtype), "shape": list(shape),
                   "fwd_plan": warp.warp_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "dsrc_plan": dsrc_plan._asdict(),
                   "dgrid_plan": warp.dgrid_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "max_abs_err": errs,
                   "fwd_ms": time_ms(lambda: warp.warp(src, grid)),
                   "fwd_cold_ms": time_cold_ms([lambda s=s, g=g: warp.warp(s, g)
                                                for s, g, _ in cold], work["warp_train"][0]),
                   "dsrc_ms": time_ms(lambda: warp.warp_dsrc(grid, dout, shape)),
                   "dsrc_cold_ms": time_cold_ms([lambda g=g, d=d: warp.warp_dsrc(g, d, shape)
                                                 for _, g, d in cold], work["warp_dsrc"][0]),
                   "dgrid_ms": time_ms(lambda: warp.warp_dgrid(src, grid, dout)),
                   "dgrid_cold_ms": time_cold_ms([lambda s=s, g=g, d=d: warp.warp_dgrid(s, g, d)
                                                  for s, g, d in cold], work["warp_dgrid"][0]),
                   "cold_copies": len(cold),
                   "fwd_plain_ms": time_ms(lambda: warp.grid_sample(src, grid)),
                   "dsrc_plain_ms": time_ms(lambda: warp.warp_dsrc_plain(grid, dout, shape)),
                   "dgrid_plain_ms": time_ms(lambda: warp.warp_dgrid_plain(src, grid, dout)),
                   "library_fwd_ms": None, "library_dsrc_ms": None, "library_dgrid_ms": None,
                   "library_bwd_ms": None,
                   # what d_src moves beyond its bound: nothing for 'shared';
                   # for 'global' the zero fill of its f32 buffer and, in
                   # bf16, the cast's read of that buffer
                   "dsrc_extra_bytes": 0 if dsrc_plan.variant == "shared"
                   else plane * (8 if bf16 else 4)}
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
                check(f"F.grid_sample d_src C={C}", row["library_err"]["d_src"], _warp_tol(ref_src))
                check(f"F.grid_sample d_grid C={C}", row["library_err"]["d_grid"],
                      10 * _warp_tol(ref_grid))
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
    """The three warp kernels where the taichi paths do not take them,
    against their plain versions: scalar loads (a source and dout one
    element off 16 bytes at C = 64; C = 5 and 12, no multiple of the bf16
    pack, the first of the f32 one), the small forward with its plane read
    in place and staged from a misaligned plane, d_src at two skips of the
    256^2 configs' train step (batch 20): 'global' at (128^2, 64), where no
    slice fits a block, and 'shared' past 48 KB of shared memory at
    (64^2, 128), both dtypes, and 64-bit offsets (2^21 points of 1024 bf16
    channels, 2^31 elements of output and of dout, held against the plain
    version on the first and the last two rows of points; for d_src, dout
    is zero elsewhere). Then every variant of the three kernels must have
    launched in the phases so far."""
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
                     warp.dgrid_plan(2, 64, C, dtype, False, 9 * 17),
                     warp.dsrc_plan(2, 64, C, dtype, False, (9, 17)))
            if any(p.vector != 1 for p in plans):
                raise AssertionError(f"warp edge: planned {plans}, expected scalar loads")
            ref = warp.grid_sample(src.float(), grid)
            dref = warp.warp_dgrid_plain(src.float(), grid, dout.float())
            sref = warp.warp_dsrc_plain(grid, dout.float(), tuple(src.shape))
            errs = {"fwd": max_err(warp.warp(src, grid), ref),
                    "dgrid": max_err(warp.warp_dgrid(src, grid, dout), dref),
                    "dsrc": max_err(warp.warp_dsrc(grid, dout, tuple(src.shape)), sref)}
            check(f"warp edge fwd {dtype} C={C}", errs["fwd"],
                  rounded * max(1.0, ref.abs().max().item()))
            check(f"warp edge dgrid {dtype} C={C}", errs["dgrid"],
                  2e-5 * max(1.0, dref.abs().max().item()))
            check(f"warp edge dsrc {dtype} C={C}", errs["dsrc"],
                  rounded * max(1.0, sref.abs().max().item()))
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

    # d_src at two skips of the 256^2 configs' train step (batch 20)
    result["dsrc_256"] = []
    for dtype in (torch.float32, torch.bfloat16):
        rounded = 2.0**-8 if dtype == torch.bfloat16 else 2e-5
        for (C, h), want in (((64, 128), "global"), ((128, 64), "shared")):
            shape = (20, h, h, C)
            dout = torch.randn(shape, generator=gen).to(device, dtype)
            grid = grid_off_integers(20, h, gen).to(device)
            plan = warp.dsrc_plan(20, h * h, C, dtype, True, (h, h))
            if plan.variant != want or (want == "shared" and plan.shared_bytes <= 48 * 1024):
                raise AssertionError(f"warp edge d_src {shape}: planned {plan}")
            ref = warp.warp_dsrc_plain(grid, dout.float(), shape)
            got = warp.warp_dsrc(grid, dout, shape)
            err = max_err(got, ref)
            check(f"warp edge dsrc {want} {dtype} {shape}", err,
                  rounded * max(1.0, ref.abs().max().item()))
            if got.dtype != dtype:
                raise AssertionError(f"warp edge d_src {shape}: result in {got.dtype}")
            result["dsrc_256"].append({"dtype": str(dtype), "shape": list(shape),
                                       "max_abs_err": err, "plan": plan._asdict()})
            del dout, ref, got

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
    del dgrid
    # d_src into a 32^2 plane of the same channels, dout zero but for those
    # rows: the kernel must read the last rows at offsets past 2^31
    dout[:, 2:-2] = 0
    shape = (1, 32, 32, C)
    dsrc_plan = warp.dsrc_plan(1, n, C, dtype, True, (32, 32))
    if dsrc_plan.index_bits != 64:
        raise AssertionError(f"warp edge: planned {dsrc_plan}, expected 64-bit offsets")
    rows = torch.cat([torch.arange(2), torch.arange(n // 1024 - 2, n // 1024)]).to(device)
    ref = warp.warp_dsrc_plain(grid[:, rows], dout[:, rows].float(), shape)
    errs["dsrc.first_and_last"] = max_err(warp.warp_dsrc(grid, dout, shape), ref)
    check("warp edge dsrc 64-bit", errs["dsrc.first_and_last"],
          2.0**-8 * max(1.0, ref.abs().max().item()))
    del dout
    result["index64"] = {"points": n, "channels": C, "max_abs_err": errs,
                         "plans": [p._asdict() for p in (*plans, dsrc_plan)]}
    launched = {"warp": dict(warp.warp.launches_by_variant),
                "warp_dsrc": dict(warp.warp_dsrc.launches_by_variant),
                "warp_dgrid": dict(warp.warp_dgrid.launches_by_variant)}
    if min(min(v.values()) for v in launched.values()) <= 0:
        raise AssertionError(f"warp: a variant was never launched: {launched}")
    result["launches_by_variant"] = launched
    log(result)
    return result


def combine_backward_phase(device, batch=TRAIN_BATCH, K1=11, label="taichi") -> dict:
    """At a train step's shape (batch, one frame, HW^2, K1 = num_kp + 1),
    on the card: the combine kernel against combine_plain, and its
    closed-form backward (plain PyTorch in both packages) against autograd
    of combine_plain."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import combine

    gen = torch.Generator().manual_seed(SEED + 11)
    logits = (2.0 * torch.randn(batch, 1, HW, HW, K1, generator=gen)).to(device)
    diff = (0.1 * torch.randn(batch, 1, K1, 2, generator=gen)).to(device)
    corr = (0.01 * torch.randn(batch, 1, HW, HW, 2, generator=gen)).to(device)
    g = torch.randn(batch, 1, HW, HW, 2, generator=gen).to(device)
    forward_err = max_err(combine.combine(logits, diff, corr),
                          combine.combine_plain(logits, diff, corr))
    check(f"combine forward, {label} train shape", forward_err, 1e-5)

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
        check(f"combine backward {label} {name}", errs[name], tol)
    result = {
        "phase": "combine_backward", "config": label, "shape": list(logits.shape),
        "max_abs_err": errs,
        "tol": dict(tols, forward=1e-5),
        "closed_form_ms": time_ms(lambda: combine.combine_backward(logits, diff, g)),
        "autograd_fwd_bwd_ms": time_ms(lambda: grads(combine.combine_plain)),
    }
    log(result)
    return result


def config_warps(config, size: int) -> list:
    """(C, h) of each warp of a config's generator on size^2 frames: the
    generator warps each encoder skip once (the first is the source frame)."""
    gp = config["model_params"]["generator_params"]
    widths = [config["model_params"]["common_params"]["num_channels"]] + [
        min(gp["max_features"], gp["block_expansion"] * 2 ** (i + 1))
        for i in range(gp["num_blocks"])]
    return [(C, size >> i) for i, C in enumerate(widths)]


def shapes_train_shapes(config) -> tuple:
    """(batch, [(C, h) of each warp], K1) of a config's train step at 64^2;
    the combine mixes num_kp + 1 masks."""
    K1 = config["model_params"]["common_params"]["num_kp"] + 1
    return config["train_params"]["batch_size"], config_warps(config, HW), K1


def loop_kernel_phase(device, config=None, label="shapes") -> dict:
    """The four kernels of the train loop (train_loop_phase) at the shapes
    its steps give them, configs/shapes.yaml at batch 16 (or `config`'s
    train step at 64^2): the warp's forward, d_src and d_grid at each of the
    six warps (C = 3, 32, 64, 128, 128, 128 over 64^2 ... 2^2) on a random
    and an identity grid, in f32 (the loop's dtype) and bf16, with their
    plans and L2-warm times; the combine and its backward at K1 = 5."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import warp
    from monkeynet_tpu_torch.utils.config import load_config

    if config is None:
        config = load_config(str(REPO / "configs" / "shapes.yaml"))
    B, warps, K1 = shapes_train_shapes(config)
    gen = torch.Generator().manual_seed(SEED + 13)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for C, h in warps:
            src, dout, grids = _warp_train_inputs(B, h, C, dtype, gen, device)
            grid, shape = grids["random"], tuple(src.shape)
            row = {"kernel": "warp fwd/d_src/d_grid", "config": label, "dtype": str(dtype),
                   "shape": list(shape),
                   "max_abs_err": _check_warp_train(src, dout, grids, label),
                   "fwd_plan": warp.warp_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "dsrc_plan": warp.dsrc_plan(B, h * h, C, dtype, True, (h, h))._asdict(),
                   "dgrid_plan": warp.dgrid_plan(B, h * h, C, dtype, True, h * h)._asdict(),
                   "fwd_ms": time_ms(lambda: warp.warp(src, grid)),
                   "dsrc_ms": time_ms(lambda: warp.warp_dsrc(grid, dout, shape)),
                   "dgrid_ms": time_ms(lambda: warp.warp_dgrid(src, grid, dout))}
            log(row)
            rows.append(row)
    combine_row = combine_backward_phase(device, batch=B, K1=K1, label=label)
    return {"phase": "loop_kernels", "config": label, "warp_rows": rows, "combine": combine_row}


def eval_chunks() -> list:
    """(label, config, size, frames) of each eval path's generator chunk
    (eval_phase): configs/shapes.yaml at 64^2 over one test video of
    data/shapes, and the demo, configs/moving-gif.yaml at 128^2 over
    data/demo's driving frames; each chunk padded to its frame bucket."""
    from monkeynet_tpu_torch.data.io import read_video
    from monkeynet_tpu_torch.tasks.animate import _bucket
    from monkeynet_tpu_torch.utils.config import load_config

    test_video = sorted((REPO / "data" / "shapes" / "test").iterdir())[0]
    shapes_frames = read_video(str(test_video), (HW, HW, 3)).shape[0]
    demo_frames = read_video(str(REPO / "data" / "demo" / "driving.png"),
                             (128, 128, 3)).shape[0]
    return [("shapes", load_config(str(REPO / "configs" / "shapes.yaml")), HW,
             _bucket(shapes_frames, CHUNK)),
            ("moving-gif demo", load_config(str(REPO / "configs" / "moving-gif.yaml")), 128,
             _bucket(demo_frames, CHUNK))]


def _kp_kernel_checks(label, config, size, frames, gen, device) -> list:
    """The soft-argmax and the heatmap at an eval chunk of `frames` on
    size^2 frames and at the source frame (f32, batch 1), at the shapes and
    settings the config's kp detector and movement embeddings give them:
    the soft-argmax against its plain version with the temperature as a
    0-dim tensor (softargmax_phase), the heatmap against its plain version
    on the CPU (heatmap_phase), at those phases' tolerances."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import heatmap, softargmax

    mp = config["model_params"]
    K, variance = mp["common_params"]["num_kp"], mp["common_params"]["kp_variance"]
    kpp, gp = mp["kp_detector_params"], mp["generator_params"]
    dm = gp["dense_motion_params"]
    h = int(size * kpp.get("scale_factor", 1))
    temperature = torch.tensor(kpp["temperature"], device=device)
    # each embedding that renders heatmaps: its size and norm_const; a
    # 'difference' one renders the source's keypoints too
    embeddings = [(e, scale * e.get("scale_factor", 1)) for e, scale in
                  ((dm["mask_embedding_params"], dm.get("scale_factor", 1)),
                   (gp.get("kp_embedding_params"), 1)) if e and e.get("use_heatmap", True)]
    rows = []
    for D in (frames, 1):
        logits = torch.randn(1, D, h, h, K, generator=gen).to(device)
        err = max_err(softargmax.softargmax_stats(logits, kpp["temperature"]),
                      softargmax.softargmax_plain(logits, temperature))
        check(f"softargmax {label} {list(logits.shape)}", err, 1e-5)
        rows.append({"kernel": "softargmax", "config": label, "shape": list(logits.shape),
                     "variant": softargmax.softargmax_plan(h, h, K, logits.dtype).variant,
                     "max_abs_err": err, "tol": 1e-5})
        mean = 1.8 * torch.rand(1, D, K, 2, generator=gen) - 0.9
        a = 0.1 * torch.randn(1, D, K, 2, 2, generator=gen)
        kp = {"mean": mean, "var": a @ a.transpose(-1, -2) + 0.005 * torch.eye(2)}
        if variance == "single":
            kp["var"] = 0.005 + 0.02 * torch.rand(1, D, K, 1, 1, generator=gen)
        elif not isinstance(variance, str):
            del kp["var"]
        for e, scale in embeddings:
            hw, norm = (int(size * scale),) * 2, e.get("norm_const", "sum")
            got = heatmap.heatmap({k: v.to(device) for k, v in kp.items()}, hw, variance, norm)
            err = max_err(got.cpu(), heatmap.heatmap_plain(kp, hw, variance, norm))
            check(f"heatmap {label} {list(got.shape)} {norm}", err, 1e-6)
            rows.append({"kernel": "heatmap", "config": label, "shape": list(got.shape),
                         "norm_const": norm, "max_abs_err": err, "tol": 1e-6})
    for row in rows:
        log(row)
    return rows


def eval_kernel_phase(device, chunks=None) -> dict:
    """The forward kernels at the eval paths' chunks (eval_chunks, or
    `chunks` of (label, config, size, frames); batch 1): the warp at each
    encoder skip on a grid near the identity and on the identity grid, f32
    and bf16, with the plans and L2-warm times; the combine at the dense
    motion's size and num_kp + 1 masks, f32; the soft-argmax and the
    heatmap (_kp_kernel_checks); each against its plain version at
    kernel_phase's tolerances."""
    import torch

    from monkeynet_tpu_torch.ops.cuda import combine, warp

    gen = torch.Generator().manual_seed(SEED + 14)
    result = {"phase": "eval_kernels", "warp": [], "combine": [], "kp": []}
    for label, config, size, frames in chunks or eval_chunks():
        shapes = config_warps(config, size)
        for dtype, tol_of in ((torch.float32, lambda ref: 1e-5),
                              (torch.bfloat16, lambda ref: 2.0**-8 * ref.abs().max().item())):
            for src, grid, ident in _warp_cases(device, gen, shapes, frames):
                src = src.to(dtype)
                B, H, W, C = src.shape
                n = grid.shape[1] * grid.shape[2]
                errs = {}
                for kind, g in (("random", grid), ("identity", ident)):
                    ref = warp.grid_sample(src.float(), g)
                    errs[kind] = max_err(warp.warp(src, g), ref)
                    check(f"warp {label} {dtype} C={C} {H}^2 {kind} grid", errs[kind],
                          tol_of(ref))
                row = {"kernel": "warp", "config": label, "dtype": str(dtype),
                       "shape": [B, H, W, C], "points": n,
                       "plan": warp.warp_plan(B, n, C, dtype, True, H * W)._asdict(),
                       "max_abs_err": errs, "kernel_ms": time_ms(lambda: warp.warp(src, grid))}
                log(row)
                result["warp"].append(row)
        dm = config["model_params"]["generator_params"]["dense_motion_params"]
        h = int(size * dm.get("scale_factor", 1))
        K1 = config["model_params"]["common_params"]["num_kp"] + 1
        logits, diff, corr = _combine_inputs(frames, h, K1, gen, device)
        err = max_err(combine.combine(logits, diff, corr),
                      combine.combine_plain(logits, diff, corr))
        check(f"combine {label}", err, 1e-5)
        row = {"kernel": "combine", "config": label, "shape": list(logits.shape),
               "max_abs_err": err, "kernel_ms": time_ms(lambda: combine.combine(logits, diff, corr))}
        log(row)
        result["combine"].append(row)
        result["kp"] += _kp_kernel_checks(label, config, size, frames, gen, device)
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


PARITY_OUT_TOL = {
    # ~30 conv layers at widths up to 2048 summed in other orders by
    # cuDNN and the CPU: f32 noise grows to ~1e-5 on [0, 1] outputs
    "video_prediction": 1e-3,
    "video_deformed": 1e-3,
    # keypoints come out of a temperature-0.1 softmax over 4096 pixels
    "kp_driving.mean": 1e-4,
    "kp_source.mean": 1e-4,
}


def parity_errors(gpu: dict, cpu: dict, label: str) -> dict:
    """Max abs errors of the card's outputs against the CPU's (tensors or
    numpy), each checked against PARITY_OUT_TOL."""
    import torch

    def get(out, name):
        group, _, key = name.partition(".")
        value = out[group][key] if key else out[group]
        return torch.as_tensor(value).cpu()

    errs = {name: max_err(get(gpu, name), get(cpu, name)) for name in PARITY_OUT_TOL}
    for name, err in errs.items():
        check(f"{label} {name}", err, PARITY_OUT_TOL[name])
    return errs


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
    off_identity = max_err(cpu["video_deformed"], source.expand_as(cpu["video_deformed"]))
    if off_identity < 0.05:
        raise AssertionError(f"parity flow is the identity (max change {off_identity})")
    errs = parity_errors(gpu, cpu, "slice parity")
    result = {"phase": "slice_parity", "frames": 4, "max_abs_err": errs,
              "tol": PARITY_OUT_TOL, "deformed_vs_source": off_identity}
    log(result)
    return result


# ---- phase 4 ---------------------------------------------------------------

def _counters():
    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    return {"warp": warp.warp, "warp_dsrc": warp.warp_dsrc, "warp_dgrid": warp.warp_dgrid,
            "combine": combine.combine, "softargmax": softargmax.softargmax_stats,
            "heatmap": heatmap.heatmap}


def generator_launches(config) -> dict:
    """Forward kernels of one generator call (one chunk of frames): a warp
    per encoder skip (num_blocks + 1, the first the source frame itself), one
    combine (the dense motion's masks), and per movement embedding with
    heatmaps one heatmap of the driving keypoints, and a second of the
    source's where it is a 'difference' heatmap."""
    gp = config["model_params"]["generator_params"]
    embeddings = (gp["dense_motion_params"]["mask_embedding_params"],
                  gp.get("kp_embedding_params"))
    heatmaps = sum(1 + (e.get("heatmap_type") == "difference")
                   for e in embeddings if e and e.get("use_heatmap", True))
    return {"warp": gp["num_blocks"] + 1, "warp_dsrc": 0, "warp_dgrid": 0, "combine": 1,
            "heatmap": heatmaps, "softargmax": 0}


def _route_launches(config, calls: int, softargmax: int) -> dict:
    """`calls` generator calls of one chunk each, and `softargmax` keypoint
    detector calls of one chunk each."""
    return {k: v * calls for k, v in generator_launches(config).items()} | {
        "softargmax": softargmax}


def expected_launches(config, n_frames: int, chunk: int) -> dict:
    """TransferEngine: per chunk one generator call and one soft-argmax;
    plus one soft-argmax for the source frame on the first chunk (taichi:
    six warps, one combine and four heatmaps a chunk)."""
    chunks = -(-n_frames // chunk)
    return _route_launches(config, chunks, chunks + 1)


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

    want = expected_launches(config, N_FRAMES, CHUNK)
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


def train_parity(config, label="taichi", device="cuda") -> dict:
    """One SGD step at a config's width (taichi's; shapes', the loop's),
    batch 2, f32: kernels on the card against the plain versions on the
    CPU, from one state_dict, held to PARITY_TOL.

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
    result = {"phase": "train_parity", "config": label, "batch": 2,
              "metric_names": metric_names(train_params),
              "metrics_cpu": metrics.tolist(), "metrics_card": card_metrics.tolist(),
              "card_vs_cpu": gaps, "tol": PARITY_TOL}
    log(result)
    for group, err in gaps["grad_rel_l2"].items():
        check(f"train parity {label} grad {group}", err, PARITY_TOL["grad_rel_l2"])
    for key in ("bn_stats_max_abs", "metrics_max_rel"):
        check(f"train parity {label} {key}", gaps[key], PARITY_TOL[key])
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
    del trainer, out
    # The same steps through the step's CUDA graph: the eager window above
    # one step at a time, here TRAIN_TIMED_STEPS replays back to back, one sync.
    trainer = Trainer(build_train_models(config, device=device, seed=SEED), train_params,
                      device=device, steps_per_epoch=100)
    chunk = {k: torch.stack([b[k] for b in batches]) for k in ("source", "video")}
    trainer.run(chunk, 0, TRAIN_WARMUP_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph_metrics, _ = trainer.run(chunk, TRAIN_WARMUP_STEPS, n_steps)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    if not torch.isfinite(graph_metrics).all():
        raise AssertionError(f"non-finite graphed train metrics: {graph_metrics.tolist()}")
    del trainer
    result = {
        "phase": "train_path", "compute_dtype": compute_dtype or "float32",
        "batch": TRAIN_BATCH, "steps": TRAIN_TIMED_STEPS, "warmup_steps": TRAIN_WARMUP_STEPS,
        "launches": launches, "expected_launches": want,
        "metric_names": metric_names(train_params),
        "first_metrics": metrics[0].tolist(), "last_metrics": metrics[-1].tolist(),
        "step_s": times, "steps_per_s_median": 1.0 / median,
        "steps_per_s_best": 1.0 / ordered[0], "steps_per_s_worst": 1.0 / ordered[-1],
        "sum_abs_param_change": moved, "peak_mem_gb": peak / 1e9,
        "graph_window_s": graph_s, "graph_steps_per_s": TRAIN_TIMED_STEPS / graph_s,
    }
    log(result)
    log(f"train_path {result['compute_dtype']}: graph {result['graph_steps_per_s']:.3f} steps/s "
        f"({TRAIN_TIMED_STEPS} replays, one sync) against eager median "
        f"{result['steps_per_s_median']:.3f} (synchronised steps)")
    return result


# ---- the train loop ----------------------------------------------------------

# configs/shapes.yaml cut to size: the first LOOP_VIDEOS train videos of
# data/shapes (32 steps an epoch at batch 16), LOOP_EPOCHS epochs, a log line
# and a train-vis gif every LOOP_LOG_FREQ steps, a checkpoint every epoch.
LOOP_VIDEOS = 512
LOOP_EPOCHS = 2
LOOP_LOG_FREQ = 8
LOOP_STEP_TIMED = 32  # a step alone, one window after TRAIN_WARMUP_STEPS
LOG_ROW = re.compile(r"^(\d+)\) (.*); steps/s - (\S+)$")
# The csrc kernels of the train step, by the names a profiler trace gives
# them (templated names carry these as prefixes).
TRACE_KERNELS = {"warp": "warp_fwd_kernel", "warp_dsrc": "warp_dsrc_kernel",
                 "warp_dgrid": "warp_dgrid_kernel", "combine": "combine_kernel"}


def _log_rows(log_dir) -> list:
    """(iteration, {name: value}, steps/s) for every line of a log.txt."""
    rows = []
    for line in (Path(log_dir) / "log.txt").read_text().splitlines():
        m = LOG_ROW.match(line)
        if m is None:
            raise AssertionError(f"train loop: malformed log line {line!r}")
        values = dict(part.split(" - ") for part in m.group(2).split("; "))
        rows.append((int(m.group(1)), {k: float(v) for k, v in values.items()},
                     float(m.group(3))))
    return rows


def _same_state(a, b, where: str) -> int:
    """Assert two (nested) state dicts are equal bit for bit; count tensors."""
    import torch

    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu())):
            raise AssertionError(f"resume: {where} differs from the checkpoint")
        return 1
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"resume: keys of {where} differ from the checkpoint")
        return sum(_same_state(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"resume: {where} differs from the checkpoint")
        return sum(_same_state(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    if a != b:
        raise AssertionError(f"resume: {where} = {a!r}, checkpoint {b!r}")
    return 0


def _step_launches(config) -> dict:
    """Kernel launches of one train step of `config`: a warp and a d_grid per
    encoder skip of its generator (num_blocks + 1), a d_src for each but the
    raw source frame's, one combine (TRAIN_STEP_LAUNCHES at 5 blocks); plus
    one warp where its augmentation rotates on the card (the device feed
    warps the batch's frames once)."""
    blocks = config["model_params"]["generator_params"]["num_blocks"]
    rotates = bool(config["train_params"].get("device_feed")) and \
        "rotation_param" in config["dataset_params"].get("augmentation_params", {})
    return dict(TRAIN_STEP_LAUNCHES, warp=blocks + 1 + rotates, warp_dsrc=blocks,
                warp_dgrid=blocks + 1)


def _graph_launches(label: str, trainer, counted: dict, per_step: dict, steps: int) -> dict:
    """The launches of a run that replayed the trainer's CUDA graph. The
    wrappers' counters see each captured launch once, at the capture, and
    the eager warm-up steps before it; so the capture must hold one step's
    launches, the counters that and the warm-up's, and the run's launches
    are the captured ones times the replays."""
    stats = trainer.graph_stats
    captured = stats["captured"]
    if captured != per_step:
        raise AssertionError(f"{label}: the capture recorded {captured}, one step is {per_step}")
    if stats["replays"] != steps:
        raise AssertionError(f"{label}: {stats['replays']} replays for {steps} steps")
    want = {k: v * (stats["warmup_steps"] + 1) for k, v in per_step.items()}
    if counted != want:
        raise AssertionError(f"{label}: counters read {counted}, warm-up and capture give {want}")
    return {k: v * stats["replays"] for k, v in captured.items()}


def _profiled(fn, trace_path: Path) -> dict:
    """fn() once under torch.profiler, synchronised: the csrc kernels'
    launches counted by name in the device trace (TRACE_KERNELS), every
    kernel's count, the device's busy time (the union of the kernels'
    intervals) and the span from the first kernel's start to the last one's
    end, in microseconds, and the host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("cat") == "kernel"]
    trace_path.unlink()
    if not events:
        raise AssertionError("profiler: the trace holds no device kernels")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, reach = 0.0, spans[0][0]
    for a, b in spans:
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return {"launches": {name: sum(prefix in e["name"] for e in events)
                         for name, prefix in TRACE_KERNELS.items()},
            "nccl": sum("nccl" in e["name"].lower() for e in events),
            "kernels": len(events), "busy_us": busy, "span_us": spans[-1][1] - spans[0][0],
            "wall_us": wall_s * 1e6}


def _replay_counts(label: str, trainer, per_step: dict, work_dir: Path) -> dict:
    """One replay of the trainer's graph under the profiler: its kernels,
    counted by name, are one step's (TRACE_KERNELS' four)."""
    traced = _profiled(trainer.graph.replay, work_dir / "replay_trace.json")
    want = {k: per_step[k] for k in TRACE_KERNELS}
    if traced["launches"] != want:
        raise AssertionError(f"{label}: the profiler counts {traced['launches']} in one "
                             f"replay, the capture {want}")
    return traced


def _device_feed_of(dataset, image_shape, device="cuda"):
    """(execute, cache on the card, lengths): the device feed of `dataset`,
    as train() builds it."""
    import torch

    from monkeynet_tpu_torch.data.device_feed import build_video_cache, make_device_augment

    videos, lengths = build_video_cache(dataset)
    return (make_device_augment(dataset.transform, image_shape),
            torch.from_numpy(videos).to(device), lengths)


def _plan_chunk(dataset, lengths, batch_size: int, steps: int, device="cuda") -> dict:
    """`steps` plan batches of the loader's order from epoch 0 on, stacked
    into a chunk on the card."""
    import numpy as np
    import torch

    from monkeynet_tpu_torch.data.device_feed import plan_stream

    plans = []
    per_epoch = len(dataset) // batch_size
    for _, plan in plan_stream(dataset, dataset.transform, lengths, batch_size, SEED, 0,
                               -(-steps // per_epoch)):
        plans.append(plan)
        if len(plans) == steps:
            break
    return {k: torch.from_numpy(np.stack([p[k] for p in plans])).to(device) for k in plans[0]}


def _steps_alone(config, dataset, image_shape, steps: int, device="cuda") -> dict:
    """The train step alone at `config` on device-fed batches: `steps`
    eager `Trainer.step`s back to back, then `steps` graph replays
    (`Trainer.run`), each window after TRAIN_WARMUP_STEPS and ended by one
    synchronise."""
    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer

    tp = config["train_params"]
    execute, cache, lengths = _device_feed_of(dataset, image_shape, device)
    chunk = _plan_chunk(dataset, lengths, tp["batch_size"], TRAIN_WARMUP_STEPS + steps, device)

    def augment(plan):
        return execute(cache, plan)

    out = {"steps": steps}
    for label in ("eager", "graph"):
        trainer = Trainer(build_train_models(config, device=device, seed=SEED), tp,
                          device=device, steps_per_epoch=100)
        if label == "eager":
            def window(a, b):
                for j in range(a, b):
                    with torch.no_grad():
                        batch = augment({k: v[j] for k, v in chunk.items()})
                    trainer.step(batch)
        else:
            def window(a, b):
                trainer.run(chunk, a, b, augment=augment)
        window(0, TRAIN_WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(TRAIN_WARMUP_STEPS, TRAIN_WARMUP_STEPS + steps)
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        out[f"{label}_steps_per_s"] = steps / out[f"{label}_s"]
        del trainer
    return out


def train_loop_phase(work_dir: Path, device="cuda") -> dict:
    """train() on configs/shapes.yaml over data/shapes at full width and
    batch 16 (cut as LOOP_* say), on the path the config asks for: the
    device feed, k = 32 steps a dispatch through the step's CUDA graph. Its
    launches (capture x replays, and the profiler's count of one replay);
    its log rows, gifs and checkpoints; a resume from the epoch-0 checkpoint
    that restores the state bit for bit and trains epoch 0 again. Then the
    same cut on the eager host feed (device_feed false, steps_per_dispatch
    1: the path a user gets on the CPU), with its launches counted step by
    step; and the step alone, eager and graphed. Writes under `work_dir`;
    the result's `checkpoint` is the last epoch's, for eval_phase."""
    import copy

    import torch

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.data.io import decode_video
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer, largest_divisor_leq, metric_names
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "shapes.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    tp = config["train_params"]
    tp.update(num_epochs=LOOP_EPOCHS,
              log_params={"log_freq_iter": LOOP_LOG_FREQ, "cpk_freq_epoch": 1})
    if not tp.get("device_feed"):
        raise AssertionError("configs/shapes.yaml no longer asks for the device feed")
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    dataset.images = dataset.images[:LOOP_VIDEOS]
    image_shape = dataset.image_shape
    _, reader = decode_video(str(Path(dataset.root_dir) / dataset.images[0]), image_shape)
    steps_per_epoch = LOOP_VIDEOS // tp["batch_size"]
    steps = LOOP_EPOCHS * steps_per_epoch
    k = largest_divisor_leq(steps, 32)
    names = metric_names(tp)
    rec_names = [n for n in names if n.endswith("_rec")]
    per_step = _step_launches(config)

    log_dir, resume_dir, eager_dir = work_dir / "run", work_dir / "resume", work_dir / "eager"
    for d in (log_dir, resume_dir, eager_dir):
        d.mkdir()
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    run = train(config, str(log_dir), dataset, seed=SEED, device=device)
    counted = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if run.steps != steps or run.epochs != list(range(LOOP_EPOCHS)):
        raise AssertionError(f"train loop: {run.steps} steps over epochs {run.epochs}")
    if not run.device_feed or run.steps_per_dispatch != k:
        raise AssertionError(f"train loop: device feed {run.device_feed}, "
                             f"{run.steps_per_dispatch} steps a dispatch (want {k})")
    launches = _graph_launches("train loop", run.trainer, counted, per_step, steps)
    rows = _log_rows(log_dir)
    if [it for it, _, _ in rows] != list(range(0, steps, LOOP_LOG_FREQ)):
        raise AssertionError(f"train loop: log rows at {[it for it, _, _ in rows]}")
    for it, values, _ in rows:
        if list(values) != names or not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"train loop: bad log row {it}: {values}")
    gifs = sorted(p.name for p in (log_dir / "train-vis").iterdir())
    if gifs != [f"{it:08d}-rec.gif" for it, _, _ in rows]:
        raise AssertionError(f"train loop: train-vis holds {gifs}")
    cpks = [log_dir / checkpoint_name(e) for e in range(LOOP_EPOCHS)]
    if not all(p.exists() for p in cpks):
        raise AssertionError(f"train loop: missing checkpoints in {sorted(os.listdir(log_dir))}")

    # The last checkpoint is also the exit save: the trainer's final state.
    tensors = _same_state(load_checkpoint(str(cpks[-1])),
                          {**run.trainer.state_dict(), "epoch": LOOP_EPOCHS - 1,
                           "it": steps - 1}, "final state")
    # One more replay of the loop's graph, under the profiler (after the
    # state checks: it takes a step).
    traced = _replay_counts("train loop", run.trainer, per_step, work_dir)
    # A fresh trainer restores the epoch-0 checkpoint bit for bit.
    saved = load_checkpoint(str(cpks[0]))
    trainer = Trainer(build_train_models(config, device=device, seed=SEED + 1), tp,
                      device=device, steps_per_epoch=steps_per_epoch)
    trainer.load_state_dict(saved)
    restored = _same_state({**trainer.state_dict(), "epoch": saved["epoch"],
                            "it": saved["it"]}, saved, "restored state")
    lrs = {name: trainer.schedulers[name].get_last_lr() for name in trainer.schedulers}
    for name, lr in lrs.items():
        if lr != saved[f"scheduler_{name}"]["_last_lr"]:
            raise AssertionError(f"resume: {name} learning rate {lr}")
    del trainer

    resume_config = copy.deepcopy(config)
    resume_config["train_params"]["num_epochs"] = 1
    resumed = train(resume_config, str(resume_dir), dataset, checkpoint=str(cpks[0]),
                    seed=SEED, device=device)
    resumed_rows = _log_rows(resume_dir)
    if resumed.epochs != [0] or resumed.steps != steps_per_epoch or not resumed.device_feed:
        raise AssertionError(f"resume: trained epochs {resumed.epochs}, {resumed.steps} steps")
    # The resumed run counts on from the checkpoint's `it`.
    want_its = [i for i in range(saved["it"], saved["it"] + steps_per_epoch)
                if i % LOOP_LOG_FREQ == 0]
    if [it for it, _, _ in resumed_rows] != want_its or not all(
            math.isfinite(v) for _, values, _ in resumed_rows for v in values.values()):
        raise AssertionError(f"resume: log rows {resumed_rows}")
    wall_s, wait_s = run.wall_s, run.loader_wait_s
    cache_bytes, cache_s = run.cache_bytes, run.cache_s
    del run, resumed

    # The same cut on the eager host feed, its launches counted step by step.
    eager_config = copy.deepcopy(config)
    eager_config["train_params"].update(device_feed=False, steps_per_dispatch=1)
    for fn in counters.values():
        fn.launches = 0
    eager = train(eager_config, str(eager_dir), dataset, seed=SEED, device=device)
    eager_launches = {name: fn.launches for name, fn in counters.items()}
    want_eager = {n: v * steps for n, v in TRAIN_STEP_LAUNCHES.items()}
    if eager.device_feed or eager.steps_per_dispatch != 1 or eager.steps != steps:
        raise AssertionError(f"eager loop: {eager}")
    if eager_launches != want_eager or eager.trainer.graph is not None:
        raise AssertionError(f"eager loop launch counts {eager_launches} != {want_eager}")
    eager_rows = _log_rows(eager_dir)
    if [it for it, _, _ in eager_rows] != [it for it, _, _ in rows]:
        raise AssertionError(f"eager loop: log rows {eager_rows}")
    eager_wall, eager_wait = eager.wall_s, eager.loader_wait_s
    del eager

    alone = _steps_alone(config, dataset, image_shape, LOOP_STEP_TIMED, device)
    loop_sps = [sps for _, _, sps in rows]
    result = {
        "phase": "train_loop", "config": "configs/shapes.yaml", "videos": LOOP_VIDEOS,
        "checkpoint": str(cpks[-1]),
        "batch": tp["batch_size"], "epochs": LOOP_EPOCHS, "steps": steps,
        "steps_per_dispatch": k, "reader": reader, "launches": launches,
        "counted": counted, "expected_per_step": per_step, "replay_trace": traced,
        # the loop's rate: its steps over its wall time, first batch to the
        # last step's end (the capture, gifs and checkpoint writes
        # included); log.txt's windows of LOOP_LOG_FREQ steps only break it down
        "loop_wall_s": wall_s, "loop_steps_per_s": steps / wall_s,
        "loop_steps_per_s_logged": loop_sps,
        "loader_wait_s": wait_s, "cache_bytes": cache_bytes, "cache_s": cache_s,
        "eager_host_feed_wall_s": eager_wall, "eager_host_feed_steps_per_s": steps / eager_wall,
        "eager_host_feed_loader_wait_s": eager_wait, "eager_host_feed_launches": eager_launches,
        "step_alone": alone,
        "rec_first": sum(rows[0][1][n] for n in rec_names),
        "rec_last": sum(rows[-1][1][n] for n in rec_names),
        "rec_names": rec_names, "checkpoint_tensors_checked": tensors,
        "restored_tensors_checked": restored, "restored_lr": lrs,
        "resumed_epochs": [0], "resumed_from_it": saved["it"],
        "resumed_logged_its": want_its,
        "peak_mem_gb": peak / 1e9,
    }
    log(result)
    log(f"train_loop: {result['loop_steps_per_s']:.3f} steps/s ({steps} steps over the loop's "
        f"wall time; device feed, graph, k = {k}) against "
        f"{result['eager_host_feed_steps_per_s']:.3f} on the eager host feed; the step alone "
        f"({LOOP_STEP_TIMED} warm steps back to back): graph {alone['graph_steps_per_s']:.3f}, "
        f"eager {alone['eager_steps_per_s']:.3f}; log.txt windows: "
        + ", ".join(f"{sps:.3f}" for sps in loop_sps))
    log(f"train_loop: waited {wait_s:.3f} s on the feeder in {wall_s:.3f} s of loop "
        f"({eager_wait:.3f} s in {eager_wall:.3f} s on the host feed); cache "
        f"{cache_bytes} bytes built in {cache_s:.3f} s")
    log(f"train_loop: launches {launches} (capture x replays; one replay's trace "
        f"{traced['launches']}, the device busy {traced['busy_us']:.1f} of "
        f"{traced['span_us']:.1f} us)")
    log(f"train_loop: videos decoded by the {reader} reader")
    log(f"train_loop: peak device memory {result['peak_mem_gb']:.3f} GB")
    log(f"train_loop: reconstruction loss {result['rec_first']:.5f} at iteration 0, "
        f"{result['rec_last']:.5f} at iteration {rows[-1][0]}")
    return result


# ---- phase 6: the eval paths ---------------------------------------------------

# configs/shapes.yaml cut to size: the first EVAL_VIDEOS test videos of
# data/shapes (32 frames each) for reconstruction (num_videos EVAL_VIDEOS - 1:
# reconstruction's bound takes one more), EVAL_PAIRS transfer pairs a route, and
# prediction with PREDICTION_EPOCHS epochs over PREDICTION_TRAIN_SIZE + 1
# train videos and the same test videos; every width as shipped.
EVAL_VIDEOS = 4
EVAL_PAIRS = 4
PREDICTION_EPOCHS = 20
PREDICTION_TRAIN_SIZE = 15
HULL_RECIPE = {"movement_mult": True, "move_location": True, "adapt_variance": True,
               "clip_mean": True}
# The hull's area ratio scales every driving displacement, so the keypoint
# gaps of PARITY_OUT_TOL can grow a few times in the normalised keypoints.
KP_NORM_TOL = 1e-3
# The chained outputs (the card's keypoints, normalised on the host, through
# the card's generator, against the same chain on the CPU): a keypoint gap d
# moves a hard edge of a shapes frame by d (H - 1) / 2 pixels. Three times
# the largest gap two full runs read on the hull pair (1.53e-3, 1.73e-3).
CHAINED_OUT_TOL = 5e-3


def _counted(label: str, smi: str, want: dict, fn):
    """fn() with the kernels' launch counts set to 0 just before and read
    just after; they must equal `want`. Prints the step's wall time beside
    the card; returns (fn's result, launches, seconds)."""
    import torch

    counters = _counters()
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: counter.launches for name, counter in counters.items()}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != expected {want}")
    log(f"eval {label}: {seconds:.3f} s wall on {smi}")
    return out, launches, seconds


def _expect_files(directory: Path, names, fmt: str, label: str) -> None:
    want_png = sorted(name + ".png" for name in names)
    want_vis = sorted(name + fmt for name in names)
    got_png = sorted(os.listdir(directory / "png"))
    got_vis = sorted(p for p in os.listdir(directory) if p != "png")
    if got_png != want_png or got_vis != want_vis:
        raise AssertionError(f"{label}: wrote {got_png} and {got_vis}")
    for name in want_png + want_vis:
        path = directory / "png" / name if name.endswith(".png") else directory / name
        if path.stat().st_size == 0:
            raise AssertionError(f"{label}: {path} is empty")


def eval_parity(config, checkpoint: str, cases: dict, label: str, device="cuda") -> dict:
    """The card against the CPU from one checkpoint (load_eval_models on
    both devices), each case {name: (source, driving, normalization
    recipe)} stage by stage: the keypoints (and the normalised ones) to
    their tolerances, then the generator on both devices from the card's
    keypoints to PARITY_OUT_TOL, and the chained outputs to CHAINED_OUT_TOL
    (PARITY_OUT_TOL does not cover a keypoint gap carried to a hard edge)."""
    import torch

    from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor
    from monkeynet_tpu_torch.tasks.reconstruction import load_eval_models, to_numpy
    from monkeynet_tpu_torch.tasks.transfer import transfer_one

    models = {dev: load_eval_models(config, checkpoint, device=dev) for dev in ("cpu", device)}
    parity = {}
    for name, (source, driving, norm) in cases.items():
        chain = {dev: transfer_one(Animator(gen, device=dev), KPExtractor(kp, device=dev),
                                   source, driving, {"normalization_params": norm})
                 for dev, (gen, kp) in models.items()}
        card = chain[device]
        same_kp = to_numpy(Animator(models["cpu"][0], device="cpu")(
            source, card["kp_norm"], card["kp_source"]))
        errs = parity_errors(card, dict(chain["cpu"], **same_kp), f"{label} {name}")
        errs["kp_norm.mean"] = max_err(torch.as_tensor(card["kp_norm"]["mean"]),
                                       torch.as_tensor(chain["cpu"]["kp_norm"]["mean"]))
        check(f"{label} {name} kp_norm.mean", errs["kp_norm.mean"], KP_NORM_TOL)
        for key in ("video_prediction", "video_deformed"):
            errs[f"chained.{key}"] = max_err(torch.as_tensor(card[key]),
                                             torch.as_tensor(chain["cpu"][key]))
            check(f"{label} {name} chained {key}", errs[f"chained.{key}"], CHAINED_OUT_TOL)
        parity[name] = errs
    return {"max_abs_err": parity,
            "tol": dict(PARITY_OUT_TOL, **{"kp_norm.mean": KP_NORM_TOL,
                                           "chained": CHAINED_OUT_TOL})}


def eval_phase(checkpoint: str, work_dir: Path, smi: str, device="cuda") -> dict:
    """The eval drivers on the train loop's last checkpoint (configs/shapes.yaml,
    full width, f32), each with its launches counted: (a) reconstruction, and
    again at the random weights the loop started from, which it must beat in
    L1; (b) transfer on both routes; (c) one reconstruction video and one
    hull-and-covariance pair on the card against the CPU, stage by stage and
    chained; (d) prediction; (e) the demo on configs/moving-gif.yaml at
    128^2 from random weights, on the card against the CPU."""
    import copy

    from PIL import Image

    from monkeynet_tpu_torch.data.dataset import FramesDataset, PairedDataset
    from monkeynet_tpu_torch.data.io import read_video
    from monkeynet_tpu_torch.demo import run_demo
    from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor
    from monkeynet_tpu_torch.tasks.build import build_models
    from monkeynet_tpu_torch.tasks.prediction import prediction
    from monkeynet_tpu_torch.tasks.reconstruction import (load_eval_models, reconstruction,
                                                          to_numpy)
    from monkeynet_tpu_torch.tasks.transfer import transfer
    from monkeynet_tpu_torch.utils.checkpoint import save_checkpoint
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "shapes.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    config["reconstruction_params"]["num_videos"] = EVAL_VIDEOS - 1
    config["transfer_params"]["num_pairs"] = EVAL_PAIRS
    test = FramesDataset(is_train=False, **config["dataset_params"])
    test.images = test.images[:EVAL_VIDEOS]
    names = list(test.images)
    result = {"phase": "eval", "config": "configs/shapes.yaml", "checkpoint": checkpoint,
              "videos": EVAL_VIDEOS, "pairs": EVAL_PAIRS, "seconds": {}, "launches": {}}

    def counted(label, want, fn):
        out, launches, seconds = _counted(label, smi, want, fn)
        result["launches"][label] = launches
        result["seconds"][label] = seconds
        return out

    # (a) reconstruction: per video one chunk (32 frames), the source and the
    # chunk through the kp detector, and the generated frames through it again
    out_dir = work_dir / "eval_trained"
    metrics = counted("reconstruction", _route_launches(config, EVAL_VIDEOS, 3 * EVAL_VIDEOS),
                      lambda: reconstruction(config, str(out_dir), test, checkpoint,
                                             device=device))
    _expect_files(out_dir / "reconstruction", names, ".gif", "reconstruction")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"reconstruction: metrics {metrics}")
    initial = str(work_dir / "initial.pth.tar")
    generator, kp_detector = build_models(config, device=device, seed=SEED)
    save_checkpoint(initial, {"generator": generator.state_dict(),
                              "kp_detector": kp_detector.state_dict()})
    del generator, kp_detector
    initial_metrics = reconstruction(config, str(work_dir / "eval_initial"), test, initial,
                                     device=device)
    if not metrics["l1"] < initial_metrics["l1"]:
        raise AssertionError(f"reconstruction: L1 {metrics['l1']} after training, "
                             f"{initial_metrics['l1']} at the initial weights")
    result["metrics"], result["initial_metrics"] = metrics, initial_metrics

    # (b) transfer, both routes: the config's recipe in a TransferEngine, and
    # the hull and covariance recipe through KPExtractor, normalize_kp and
    # Animator; each pair two kp detector calls and one generator call
    pairs = PairedDataset(test, EVAL_PAIRS)
    pair_names = ["-".join([names[d], names[s]]) for d, s in pairs.pairs]
    for route, norm in (("transfer_engine", config["transfer_params"]["normalization_params"]),
                        ("transfer_hull", HULL_RECIPE)):
        route_config = copy.deepcopy(config)
        route_config["transfer_params"]["normalization_params"] = dict(norm)
        counted(route, _route_launches(config, EVAL_PAIRS, 2 * EVAL_PAIRS),
                lambda: transfer(route_config, str(work_dir / route), test, checkpoint,
                                 device=device))
        _expect_files(work_dir / route / "transfer", pair_names, ".gif", route)

    # (c) one reconstruction video and one hull pair, card against CPU
    x = pairs[0]
    result["parity"] = eval_parity(config, checkpoint, {
        "reconstruction": (test[0]["video"][None, :1], test[0]["video"][None], {}),
        "transfer_hull": (x["source_video"][None, :1], x["driving_video"][None], HULL_RECIPE),
    }, "eval parity", device)

    # (d) prediction: the train split and the first EVAL_VIDEOS test videos
    # (linked into a directory of their own); a kp detector call per train
    # video swept, two per test video, and one generator call per test video
    pred_root = work_dir / "prediction_data"
    (pred_root / "test").mkdir(parents=True)
    os.symlink(REPO / "data" / "shapes" / "train", pred_root / "train")
    for name in names:
        os.symlink(REPO / "data" / "shapes" / "test" / name, pred_root / "test" / name)
    pconfig = copy.deepcopy(config)
    pconfig["dataset_params"]["root_dir"] = str(pred_root)
    pconfig["prediction_params"].update(num_epochs=PREDICTION_EPOCHS,
                                        train_size=PREDICTION_TRAIN_SIZE)
    predicted = counted(
        "prediction",
        _route_launches(config, EVAL_VIDEOS, PREDICTION_TRAIN_SIZE + 1 + 2 * EVAL_VIDEOS),
        lambda: prediction(pconfig, str(work_dir / "predict"), checkpoint, device=device))
    losses = predicted["losses"]
    if len(losses) != PREDICTION_EPOCHS or not losses[-1] < losses[0] or predicted[
            "videos"] != EVAL_VIDEOS:
        raise AssertionError(f"prediction: {predicted}")
    _expect_files(work_dir / "predict" / "prediction", names, ".gif", "prediction")
    result["prediction"] = predicted

    # (e) the demo: configs/moving-gif.yaml at 128^2, full width, random
    # weights; the driving frames in one chunk. Its outputs against the CPU's
    # from the same checkpoint: the keypoints, and the generator on the CPU
    # from the card's keypoints (the recipe, move_location off, passes the
    # driving keypoints through), to PARITY_OUT_TOL
    mconfig = load_config(str(REPO / "configs" / "moving-gif.yaml"))
    generator, kp_detector = build_models(mconfig, device=device, seed=SEED)
    demo_ckpt = str(work_dir / "moving-gif-random.pth.tar")
    save_checkpoint(demo_ckpt, {"generator": generator.state_dict(),
                                "kp_detector": kp_detector.state_dict()})
    del generator, kp_detector
    driving, source = (REPO / "data" / "demo" / "driving.png",
                       REPO / "data" / "demo" / "source.png")
    driving_video = read_video(str(driving), (128, 128, 3))[None]
    source_image = read_video(str(source), (128, 128, 3))[None, :1]
    frames = driving_video.shape[1]
    gif = work_dir / "demo.gif"
    card = counted("demo", _route_launches(mconfig, 1, 2),
                   lambda: run_demo(mconfig, demo_ckpt, str(driving), str(source), str(gif),
                                    (128, 128), device=device))
    with Image.open(gif) as im:
        if im.n_frames != frames or im.size != (128, 128):
            raise AssertionError(f"demo: gif of {im.n_frames} frames at {im.size}, "
                                 f"want {frames} at 128^2")
    generator, kp_detector = load_eval_models(mconfig, demo_ckpt, device="cpu")
    extract_kp = KPExtractor(kp_detector, device="cpu")
    cpu = to_numpy(Animator(generator, device="cpu")(source_image, card["kp_norm"],
                                                     card["kp_source"]))
    cpu.update(kp_driving=extract_kp(driving_video), kp_source=extract_kp(source_image))
    del generator, kp_detector
    result["demo_frames"] = frames
    result["demo_parity"] = {"max_abs_err": parity_errors(card, cpu, "eval parity demo"),
                             "tol": PARITY_OUT_TOL}

    result["eval_launches"] = {name: sum(launches[name] for launches in
                                         result["launches"].values())
                               for name in _counters()}
    log(result)
    log(f"eval: reconstruction L1 {metrics['l1']:.6f}, AKD {metrics['akd']:.4f} px, AED "
        f"{metrics['aed']:.4f} (initial weights: L1 {initial_metrics['l1']:.6f}); prediction "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f} over {len(losses)} epochs")
    return result


# ---- phase 7: the device feed, k steps a dispatch, remat ----------------------

# (a) The device feed's batch on the card against the CPU and the host
# pipeline: the integer gathers to one f32 ulp at 1 (the division by 255),
# the rotation and the jitter to tests/test_device_feed.py's host-against-
# device limit.
AUG_GATHER_TOL = 1.2e-7
AUG_FLOAT_TOL = 5e-5
AUG_BATCH = 32
# (b) The graph against eager steps: the first step's metrics, and after
# DISPATCH_K steps the graph's distance from an eager run against the spread
# of two eager runs (d_src sums in the order of its atomics, so two eager
# runs differ) times DISPATCH_SPREAD.
DISPATCH_K = 4
FIRST_STEP_REL_TOL = 1e-5
DISPATCH_SPREAD = 2.0
# A rate milestone after this many steps, inside the chunk.
MILESTONE_STEP = 2
# (c) configs/actions.yaml as shipped, cut only in epochs: 3 dispatches of 30.
ACTIONS_EPOCHS = 90
# (d) configs/shapes-256.yaml as shipped, over the first REMAT_VIDEOS train
# videos of data/shapes256; REMAT_TIMED warm steps timed after the compared one.
REMAT_VIDEOS = 64
REMAT_TIMED = 3


def _actions(device="cuda"):
    """(config, train dataset, image shape) of configs/actions.yaml over
    data/actions."""
    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "actions.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "actions")
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    return config, dataset, dataset.image_shape


def _state_tensors(trainer) -> dict:
    """Copies of a trainer's parameters and batch-norm running statistics."""
    out = {}
    for name, model in trainer.models.items():
        for key, value in model.state_dict().items():
            if value.is_floating_point():
                out[f"{name}.{key}"] = value.detach().float().clone()
    return out


def _distance(a: dict, b: dict, buffers: bool) -> float:
    """L2 distance over the parameters (buffers False) or the running
    statistics (True) of two `_state_tensors`."""
    total = 0.0
    for key, value in a.items():
        if ("running_" in key) == buffers:
            total += (value - b[key]).double().pow(2).sum().item()
    return math.sqrt(total)


def _exact_rotation(transform):
    """A copy of `transform` whose rotation takes RandomRotation's draw and
    rotates with scipy's exact bilinear sample (float64 coordinates, zeros
    outside: ndimage's 'grid-constant', which the host rotation is pinned
    to in tests/test_data.py), in place of cv2's."""
    import copy

    import numpy as np
    from scipy import ndimage

    class ExactRotation(type(transform.rotation)):
        def __call__(self, clip, rng=None):
            theta = math.radians(rng.uniform(*self.degrees))
            clip = np.asarray(clip, np.float32)
            h, w = clip.shape[1:3]
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
            c, s = math.cos(theta), math.sin(theta)
            matrix = np.array([[c, s], [-s, c]])
            offset = np.array([cy, cx]) - matrix @ np.array([cy, cx])
            return np.stack([np.stack([
                ndimage.affine_transform(frame[..., ch].astype(np.float64), matrix,
                                         offset=offset, order=1, mode="grid-constant", cval=0.0)
                for ch in range(clip.shape[-1])], axis=-1) for frame in clip]).astype(np.float32)

    exact = copy.deepcopy(transform)
    exact.rotation = ExactRotation(transform.rotation.degrees)
    exact.transforms = [exact.rotation if t is transform.rotation else t
                        for t in transform.transforms]
    return exact


def augment_phase(device="cuda") -> dict:
    """(a) configs/actions.yaml's augmentation on the card against the CPU
    and against the host pipeline, over one plan batch of AUG_BATCH items
    of data/actions: the gathers (flips, resize, crop), the rotation, the
    jitter, and the whole pipeline; and the whole pipeline's time on the
    card. The host pipeline rotates with cv2, whose bilinear weights are
    fixed-point: where it rotates, the card is held against the host
    pipeline with scipy's exact rotation in cv2's place, and the gap to cv2
    is printed beside cv2's version."""
    import cv2
    import numpy as np
    import torch

    from monkeynet_tpu_torch.data.augmentation import AllAugmentationTransform
    from monkeynet_tpu_torch.data.device_feed import (
        build_video_cache, collate_plans, make_device_augment)

    config, dataset, image_shape = _actions(device)
    h, w, _ = image_shape
    videos, lengths = build_video_cache(dataset)
    cache = {"cpu": torch.from_numpy(videos), "cuda": torch.from_numpy(videos).to(device)}
    params = config["dataset_params"]["augmentation_params"]
    cases = {
        "gathers": ({k: params[k] for k in ("flip_param", "resize_param", "crop_param")},
                    AUG_GATHER_TOL),
        "rotation": ({"rotation_param": params["rotation_param"]}, AUG_FLOAT_TOL),
        "jitter": ({"jitter_param": params["jitter_param"]}, AUG_FLOAT_TOL),
        "pipeline": (params, AUG_FLOAT_TOL),
    }
    items = np.random.default_rng(SEED).permutation(len(dataset))[:AUG_BATCH]
    keys = [(SEED, 0, 0, b) for b in range(AUG_BATCH)]
    result = {"phase": "augment", "batch": AUG_BATCH, "shape": list(image_shape),
              "cv2": cv2.__version__, "cases": {}}

    def host_batch(transform):
        host = [transform(videos[j, : lengths[j]], rng=np.random.default_rng(key))
                for j, key in zip(items, keys)]
        return {k: torch.from_numpy(np.stack([item[k] for item in host])).to(device)
                for k in ("source", "video")}

    for label, (case, tol) in cases.items():
        transform = AllAugmentationTransform(**case)
        plan = collate_plans(items, [transform.plan(int(lengths[j]), h, w,
                                                    np.random.default_rng(key))
                                     for j, key in zip(items, keys)])
        execute = make_device_augment(transform, image_shape)
        out = {dev: execute(cache[dev], {k: torch.from_numpy(v).to(dev) for k, v in plan.items()})
               for dev in ("cpu", "cuda")}
        card = out["cuda"]
        host = host_batch(transform)
        reference = host if transform.rotation is None else host_batch(_exact_rotation(transform))
        errs = {k: max(max_err(card[key], ref[key]) for key in ("source", "video"))
                for k, ref in (("cpu", {key: v.to(device) for key, v in out["cpu"].items()}),
                               ("host", reference), ("host_cv2", host))}
        check(f"augment {label}: card against the CPU", errs["cpu"], tol)
        check(f"augment {label}: card against the host pipeline"
              + ("" if transform.rotation is None else " with scipy's exact rotation"),
              errs["host"], tol)
        row = {"max_abs_err": errs, "tol": tol}
        if label == "pipeline":
            plan_dev = {k: torch.from_numpy(v).to(device) for k, v in plan.items()}
            with torch.no_grad():
                row["card_ms"] = time_ms(lambda: execute(cache["cuda"], plan_dev))
        result["cases"][label] = row
    log(result)
    log("augment: card against the CPU / the host pipeline (exact rotation) / the host pipeline "
        f"(cv2 {cv2.__version__}): " + "; ".join(
            f"{label} {r['max_abs_err']['cpu']:.2e} / {r['max_abs_err']['host']:.2e} / "
            f"{r['max_abs_err']['host_cv2']:.2e}" for label, r in result["cases"].items()))
    return result


def graph_against_eager(feed, base, dtype: str, milestone: bool = False,
                        device="cuda") -> dict:
    """(b) At configs/actions.yaml's width, DISPATCH_K device-fed steps from
    one state and one list of plans: two eager runs (Trainer.step, capturable
    Adam) and one graphed (Trainer.run). The graph's first-step metrics
    against eager's, and its distance from an eager run after the chunk
    against the two eager runs' spread. With `milestone`, a rate milestone
    after MILESTONE_STEP steps: the host rate drops there, and so do the
    graph's updates. `feed`: (config, executor, cache, a chunk of DISPATCH_K
    plans) of configs/actions.yaml; `base`: the networks every run starts
    from."""
    import copy

    import torch

    from monkeynet_tpu_torch.tasks.train import Trainer

    config, execute, cache, chunk = feed
    tp = dict(config["train_params"], compute_dtype=dtype)
    if milestone:
        tp["epoch_milestones"] = [MILESTONE_STEP]

    def augment(plan):
        return execute(cache, plan)

    def trainer():  # one step an epoch: the milestone falls at step MILESTONE_STEP
        return Trainer(copy.deepcopy(base), tp, device=device, steps_per_epoch=1)

    runs = {}
    for label in ("eager_1", "eager_2", "graph"):
        t = trainer()
        before = _state_tensors(t)
        metrics, updates, rates = [], [], []
        for j in range(DISPATCH_K):
            rates.append(t.optimizers["generator"].param_groups[0]["lr"])
            if label == "graph":
                m, _ = t.run(chunk, j, j + 1, augment=augment)
                metrics.append(m[0])
            else:
                with torch.no_grad():
                    batch = augment({k: v[j] for k, v in chunk.items()})
                metrics.append(t.step(batch)["metrics"])
            after = _state_tensors(t)
            updates.append(_distance(after, before, buffers=False))
            before = after
        runs[label] = {"metrics": torch.stack(metrics).float(), "state": after,
                       "updates": updates, "rates": rates}
        if label == "graph" and t.graph_stats["replays"] != DISPATCH_K:
            raise AssertionError(f"graph: {t.graph_stats}")
        del t
    e1, e2, g = runs["eager_1"], runs["eager_2"], runs["graph"]
    first_rel = ((g["metrics"][0] - e1["metrics"][0]).abs()
                 / e1["metrics"][0].abs().clamp_min(1e-12)).max().item()
    check(f"graph {dtype}: first step's metrics (relative)", first_rel, FIRST_STEP_REL_TOL)
    result = {"phase": "graph_against_eager", "dtype": dtype, "steps": DISPATCH_K,
              "milestone": MILESTONE_STEP if milestone else None,
              "first_step_metrics_rel": first_rel,
              "graph_metrics": g["metrics"].tolist(), "eager_metrics": e1["metrics"].tolist()}
    for kind, buffers in (("params", False), ("buffers", True)):
        reading = _distance(g["state"], e1["state"], buffers)
        spread = _distance(e2["state"], e1["state"], buffers)
        result[f"{kind}_graph_to_eager"] = reading
        result[f"{kind}_eager_spread"] = spread
        if not reading <= DISPATCH_SPREAD * spread:
            raise AssertionError(f"graph {dtype}: {kind} {reading} from eager, two eager runs "
                                 f"{spread} apart (x{DISPATCH_SPREAD} allowed)")
    result["graph_update_norms"] = g["updates"]
    result["eager_update_norms"] = e1["updates"]
    result["rates"] = g["rates"]
    if milestone:
        lr = config["train_params"]["lr"]
        want_rates = [lr if j < MILESTONE_STEP else lr * 0.1 for j in range(DISPATCH_K)]
        if any(abs(r - w) > 1e-12 for r, w in zip(g["rates"], want_rates)):
            raise AssertionError(f"milestone: host rates {g['rates']}, want {want_rates}")
        # Adam moves each parameter by about the rate: the update falls
        # tenfold at the milestone, in the graph as in eager steps.
        for label, run in (("graph", g), ("eager", e1)):
            u = run["updates"]
            drop, before = u[MILESTONE_STEP] / u[MILESTONE_STEP - 1], \
                u[MILESTONE_STEP - 1] / u[MILESTONE_STEP - 2]
            if not (drop < 0.3 and before > 0.5):
                raise AssertionError(f"milestone, {label}: update norms {u}")
    log(result)
    log(f"graph against eager, {dtype or 'float32'}{', milestone' if milestone else ''}: "
        f"parameters "
        f"{result['params_graph_to_eager']:.4e} from eager (two eager runs "
        f"{result['params_eager_spread']:.4e} apart), running statistics "
        f"{result['buffers_graph_to_eager']:.4e} ({result['buffers_eager_spread']:.4e}); "
        f"first step's metrics {first_rel:.2e} relative; update norms "
        + ", ".join(f"{u:.3e}" for u in g["updates"]))
    return result


def actions_loop_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """(c) train() on configs/actions.yaml over data/actions as shipped, cut
    only to ACTIONS_EPOCHS epochs (3 dispatches of k = 30, 1 step an
    epoch): the device feed ran, k = 30, the launches by capture x replays
    and by the profiler, finite log rows at the recipe's cadence, the gif,
    the epoch-0 checkpoint (due at cpk_freq_epoch 5000) and the exit
    checkpoint, which reloads into an eager Trainer that then steps. The
    loop's rate beside the graphed and the eager step alone, the cache, peak
    memory and the first and last reconstruction loss. (A whole chunk's
    busy share: scripts/profile_torch_port.py --path train_graph.)"""
    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer, largest_divisor_leq, metric_names
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint

    config, dataset, image_shape = _actions(device)
    tp = config["train_params"]
    shipped = dict(tp)
    tp["num_epochs"] = ACTIONS_EPOCHS
    steps_per_epoch = len(dataset) // tp["batch_size"]
    steps = ACTIONS_EPOCHS * steps_per_epoch
    k = largest_divisor_leq(shipped["num_epochs"] * steps_per_epoch,
                            shipped.get("steps_per_dispatch", 32))
    names = metric_names(tp)
    rec_names = [n for n in names if n.endswith("_rec")]
    per_step = _step_launches(config)
    log_dir = work_dir / "actions"
    log_dir.mkdir()

    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    run = train(config, str(log_dir), dataset, seed=SEED, device=device)
    counted = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if not run.device_feed:
        raise AssertionError("actions: the device feed did not run")
    if run.steps_per_dispatch != k or k != 30 or run.steps != steps:
        raise AssertionError(f"actions: k = {run.steps_per_dispatch} (want {k}), {run.steps} steps")
    launches = _graph_launches("actions", run.trainer, counted, per_step, steps)
    freq = tp["log_params"]["log_freq_iter"]
    rows = _log_rows(log_dir)
    if [it for it, _, _ in rows] != list(range(0, steps, freq)) or not rows:
        raise AssertionError(f"actions: log rows at {[it for it, _, _ in rows]}")
    for it, values, _ in rows:
        if list(values) != names or not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"actions: bad log row {it}: {values}")
    gifs = sorted(p.name for p in (log_dir / "train-vis").iterdir())
    if gifs != [f"{it:08d}-rec.gif" for it, _, _ in rows]:
        raise AssertionError(f"actions: train-vis holds {gifs}")
    cpk_freq = tp["log_params"]["cpk_freq_epoch"]
    due = [e for e in range(ACTIONS_EPOCHS) if e % cpk_freq == 0]
    want_cpks = sorted({checkpoint_name(e) for e in due + [ACTIONS_EPOCHS - 1]})
    cpks = sorted(p.name for p in log_dir.iterdir() if p.name.endswith("checkpoint.pth.tar"))
    if cpks != want_cpks:
        raise AssertionError(f"actions: checkpoints {cpks}, want {want_cpks}")
    last = run.last_metrics.float().cpu()
    if not torch.isfinite(last).all():
        raise AssertionError(f"actions: last step's losses {last.tolist()}")
    # The exit checkpoint reloads into an eager Trainer, which then steps.
    saved = load_checkpoint(str(log_dir / checkpoint_name(ACTIONS_EPOCHS - 1)))
    _same_state(saved, {**run.trainer.state_dict(), "epoch": ACTIONS_EPOCHS - 1,
                        "it": steps - 1}, "actions exit checkpoint")
    traced = _replay_counts("actions", run.trainer, per_step, work_dir)
    eager = Trainer(build_train_models(config, device=device, seed=SEED + 1), tp,
                    device=device, steps_per_epoch=steps_per_epoch)
    eager.load_state_dict(saved)
    reloaded = _same_state({**eager.state_dict(), "epoch": saved["epoch"], "it": saved["it"]},
                           saved, "actions exit checkpoint, reloaded")
    execute, cache, lengths = _device_feed_of(dataset, image_shape, device)
    with torch.no_grad():
        batch = execute(cache, {k: v[0] for k, v in
                                _plan_chunk(dataset, lengths, tp["batch_size"], 1).items()})
    eager_metrics = eager.step(batch)["metrics"].float().cpu()
    if not torch.isfinite(eager_metrics).all():
        raise AssertionError(f"actions: the reloaded eager step's losses {eager_metrics}")
    del eager, cache, batch
    wall_s, wait_s, cache_bytes, cache_s = run.wall_s, run.loader_wait_s, run.cache_bytes, \
        run.cache_s
    del run
    alone = _steps_alone(config, dataset, image_shape, LOOP_STEP_TIMED, device)
    result = {
        "phase": "actions_loop", "config": "configs/actions.yaml", "epochs": ACTIONS_EPOCHS,
        "steps": steps, "steps_per_dispatch": k, "batch": tp["batch_size"],
        "compute_dtype": tp.get("compute_dtype"), "feed_dtype": tp.get("feed_dtype"),
        "launches": launches, "counted": counted, "expected_per_step": per_step,
        "replay_trace": traced,
        "loop_wall_s": wall_s, "loop_steps_per_s": steps / wall_s,
        "loop_steps_per_s_logged": [sps for _, _, sps in rows], "loader_wait_s": wait_s,
        "cache_bytes": cache_bytes, "cache_s": cache_s, "step_alone": alone,
        "rec_names": rec_names, "rec_first": sum(rows[0][1][n] for n in rec_names),
        "rec_last": sum(last[names.index(n)].item() for n in rec_names),
        "checkpoints": cpks, "reloaded_tensors": reloaded,
        "reloaded_eager_step_metrics": eager_metrics.tolist(),
        "peak_mem_gb": peak / 1e9, "device": smi,
    }
    log(result)
    log(f"actions: {result['loop_steps_per_s']:.3f} steps/s ({steps} steps over the loop's wall "
        f"time, device feed, graph, k = {k}); the step alone ({LOOP_STEP_TIMED} warm steps back "
        f"to back): graph {alone['graph_steps_per_s']:.3f}, eager "
        f"{alone['eager_steps_per_s']:.3f}; on {smi}")
    log(f"actions: cache {cache_bytes} bytes built in {cache_s:.3f} s; waited {wait_s:.3f} s on "
        f"the feeder; peak device memory {result['peak_mem_gb']:.3f} GB; one replay's device "
        f"busy {traced['busy_us']:.1f} us of {traced['wall_us']:.1f} us wall")
    log(f"actions: launches {launches} (capture x replays; one replay's trace "
        f"{traced['launches']}); reconstruction loss {result['rec_first']:.5f} at step 0, "
        f"{result['rec_last']:.5f} at step {steps - 1}")
    return result


def remat_phase(device="cuda") -> dict:
    """(d) configs/shapes-256.yaml as shipped (batch 20, bf16, uint8 feed,
    256^2, widths 32 / 1024, a 7-block generator), device-fed from the first
    REMAT_VIDEOS train videos of data/shapes256: one step with remat and
    two without, from one state and one batch. Remat agrees with the plain
    step by (b)'s rule and leaves the running statistics as the plain step
    does (updated once). Peak memory and step time of each (REMAT_TIMED warm
    steps after the compared one), and a graphed remat step."""
    import copy

    import torch

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "shapes-256.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes256")
    tp = config["train_params"]
    if not (tp.get("remat") and tp.get("device_feed")):
        raise AssertionError("configs/shapes-256.yaml no longer sets remat and device_feed")
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    dataset.images = dataset.images[:REMAT_VIDEOS]
    execute, cache, lengths = _device_feed_of(dataset, dataset.image_shape, device)
    chunk = _plan_chunk(dataset, lengths, tp["batch_size"], 1 + REMAT_TIMED, device)

    def augment(plan):
        return execute(cache, plan)

    with torch.no_grad():
        batches = [augment({k: v[j] for k, v in chunk.items()}) for j in range(1 + REMAT_TIMED)]
    base = build_train_models(config, device=device, seed=SEED)
    runs = {}
    for label, remat in (("remat", True), ("plain_1", False), ("plain_2", False)):
        trainer = Trainer(copy.deepcopy(base), dict(tp, remat=remat), device=device,
                          steps_per_epoch=100)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        metrics = trainer.step(batches[0])["metrics"].float().cpu()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        state = _state_tensors(trainer)
        counts = {f"{name}.{k}": int(v) for name, model in trainer.models.items()
                  for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
        times = []
        if label != "plain_2":
            for batch in batches[1:]:
                t0 = time.perf_counter()
                trainer.step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        runs[label] = {"metrics": metrics, "state": state, "first_step_s": first_s,
                       "warm_step_s": times, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "peak_above_resident_gb":
                           (torch.cuda.max_memory_allocated() - resident) / 1e9,
                       "bn_counts": sorted(set(counts.values()))}
        del trainer
    r, p1, p2 = runs["remat"], runs["plain_1"], runs["plain_2"]
    if r["bn_counts"] != [1] or p1["bn_counts"] != [1]:
        raise AssertionError(f"remat: running statistics updated {r['bn_counts']} times "
                             f"(plain {p1['bn_counts']})")
    result = {"phase": "remat", "config": "configs/shapes-256.yaml", "videos": REMAT_VIDEOS,
              "batch": tp["batch_size"], "metrics_remat": r["metrics"].tolist(),
              "metrics_plain": p1["metrics"].tolist()}
    for kind, buffers in (("params", False), ("buffers", True)):
        reading = _distance(r["state"], p1["state"], buffers)
        spread = _distance(p2["state"], p1["state"], buffers)
        result[f"{kind}_remat_to_plain"] = reading
        result[f"{kind}_plain_spread"] = spread
        limit = spread if buffers else DISPATCH_SPREAD * spread
        if not reading <= limit:
            raise AssertionError(f"remat: {kind} {reading} from the plain step, two plain steps "
                                 f"{spread} apart")
    for label in ("remat", "plain_1"):
        result[label] = {k: v for k, v in runs[label].items() if k not in ("state", "metrics")}

    # The remat step captured and replayed.
    graphed = Trainer(copy.deepcopy(base), tp, device=device, steps_per_epoch=100)
    graphed.run(chunk, 0, 1, augment=augment)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_metrics, _ = graphed.run(chunk, 1, 1 + REMAT_TIMED, augment=augment)
    torch.cuda.synchronize()
    result["graph_remat_step_s"] = (time.perf_counter() - t0) / REMAT_TIMED
    if not torch.isfinite(g_metrics).all() or graphed.graph_stats["replays"] != 1 + REMAT_TIMED:
        raise AssertionError(f"remat graph: {g_metrics.tolist()}, {graphed.graph_stats}")
    del graphed, base
    log(result)
    log(f"remat at shapes-256: peak {r['peak_gb']:.3f} GB against {p1['peak_gb']:.3f} GB "
        f"without ({r['peak_above_resident_gb']:.3f} / {p1['peak_above_resident_gb']:.3f} above "
        f"the resident state); warm step {min(r['warm_step_s']):.4f} s against "
        f"{min(p1['warm_step_s']):.4f} s; graphed remat step "
        f"{result['graph_remat_step_s']:.4f} s; parameters {result['params_remat_to_plain']:.4e} "
        f"from the plain step (two plain steps {result['params_plain_spread']:.4e} apart), "
        f"running statistics {result['buffers_remat_to_plain']:.4e} "
        f"({result['buffers_plain_spread']:.4e})")
    return result


def dispatch_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """Phase 7: (a) augment_phase, (b) graph_against_eager in bf16 and f32
    and across a milestone, (c) actions_loop_phase, (d) remat_phase."""
    from monkeynet_tpu_torch.tasks.build import build_train_models

    result = {"augment": augment_phase(device)}
    config, dataset, image_shape = _actions(device)
    execute, cache, lengths = _device_feed_of(dataset, image_shape, device)
    feed = (config, execute, cache,
            _plan_chunk(dataset, lengths, config["train_params"]["batch_size"], DISPATCH_K,
                        device))
    base = build_train_models(config, device=device, seed=SEED)
    result["graph"] = [graph_against_eager(feed, base, "bfloat16", device=device),
                       graph_against_eager(feed, base, None, device=device),
                       graph_against_eager(feed, base, "bfloat16", milestone=True,
                                           device=device)]
    del feed, base, cache
    result["actions"] = actions_loop_phase(work_dir, smi, device)
    result["remat"] = remat_phase(device)
    return result


# ---- phase 8: data parallelism --------------------------------------------------

# (b) Two gloo ranks share the card (NCCL refuses two ranks on one GPU) at
# configs/actions.yaml's width: the global batch of AUG_BATCH (32) as two
# slabs of 16, PARALLEL_STEPS device-fed eager steps from one state, against
# one process at the whole batch. SGD (_sgd), so that a step moves each
# parameter by its gradient times the rate; every run's step j starts from
# the one process's state before its step j. Other batch sizes give cuDNN
# other algorithms, so the two cannot agree bit for bit. Held
# (`parallel_refusals`): in f32 the first step's update, as the relative L2
# gap of each network's whole update, to train parity's gradient limit (the
# later steps' are printed: their start carries d_src's run-to-run order, and
# there the control reads 7.5e-3 to 2.1e-2 from one call to the next); in both
# dtypes the running statistics after each step and the metrics to train
# parity's limits in f32 and to the bf16 limits below; and the ranks'
# parameters and statistics equal bit for bit. The bf16 limits come from
# scripts/parallel_fault_probe.py, which reads each planted fault refused in
# both dtypes (H100, 700 W): sound ranks 4.1e-4 / 7.1e-4 (running statistics) and 3.8e-3
# (metrics); batch norms on the rank's own slab 4.8e-3 to 6.4e-3; losses
# not divided by the world 1.0. The bf16 update is printed, not held: at
# this width bf16 rounding alone (one process, the batch's halves swapped)
# moves it by 0.16 to 0.41, the sound ranks read 0.42 to 0.87 and the faults
# 0.86 to 1.5.
PARALLEL_STEPS = 2
PARALLEL_RANKS = 2
PARALLEL_UPDATE_TOL = {"float32": PARITY_TOL["grad_rel_l2"]}
PARALLEL_BN_TOL = {"float32": PARITY_TOL["bn_stats_max_abs"], "bfloat16": 2.5e-3}
PARALLEL_METRICS_TOL = {"float32": PARITY_TOL["metrics_max_rel"], "bfloat16": 1e-2}
# (c) frame-sharded eval over the card named twice. The outputs against the
# unsharded path's, f32: the same per-frame arithmetic, with cuDNN free to
# pick other algorithms for the half-size conv batches.
SHARDED_DEVICES = ("cuda:0", "cuda:0")
SHARDED_EVAL_TOL = 1e-5


def _process_group(backend: str):
    """A one-rank process group of this process, on a free localhost port."""
    import torch.distributed as dist

    from monkeynet_tpu_torch.parallel.distributed import free_port

    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    return dist.group.WORLD


def _norm_layers(trainer) -> int:
    from monkeynet_tpu_torch.models.blocks import SyncBatchNorm

    return sum(isinstance(m, SyncBatchNorm) for model in trainer.models.values()
               for m in model.modules())


def _step_state(trainer) -> dict:
    """Copies of a trainer's state_dicts, gradients and Adam state, keyed
    '<network>.<parameter or buffer>[.grad | .adam_<key>]'."""
    import torch

    out = {}
    for name, model in trainer.models.items():
        for key, value in model.state_dict().items():
            out[f"{name}.{key}"] = value.detach().clone()
        for key, p in model.named_parameters():
            out[f"{name}.{key}.grad"] = p.grad.detach().clone()
            for k, v in trainer.optimizers[name].state[p].items():
                if torch.is_tensor(v):
                    out[f"{name}.{key}.adam_{k}"] = v.detach().clone()
    return out


def _grad_rel_l2(a: dict, b: dict, prefix: str) -> float:
    """Relative L2 gap of the gradients under `prefix` of two `_step_state`s."""
    import torch

    keys = sorted(k for k in b if k.startswith(prefix) and k.endswith(".grad"))
    ga, gb = (torch.cat([s[k].double().flatten() for k in keys]) for s in (a, b))
    return ((ga - gb).norm() / gb.norm()).item()


def _gaps(a: dict, b: dict) -> dict:
    """{key: largest absolute difference} of the tensors not equal bit for bit."""
    import torch

    return {k: (a[k].double() - b[k].double()).abs().max().item()
            for k in a if not torch.equal(a[k], b[k])}


def one_rank_nccl_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """(a) The sharded train path over an explicit one-rank NCCL group,
    whose all-reduces are captured in the step's CUDA graph with the
    kernels, on phase 5's cut of configs/shapes.yaml (f32, the device feed).

    Exactness: one graphed step from the seed's weights on the cut's first
    plan, twice unsharded and once over the group (cuDNN deterministic).
    An all-reduce over one rank and a division by 1.0 are exact, so the
    group's metrics and every parameter, gradient, running statistic and
    Adam moment must equal the unsharded step's bit for bit, except where
    d_src's gradient lands: d_src adds a cell's points in the order its
    atomics placed them, so the appearance encoder's gradients (the only
    ones it feeds) differ run to run in f32 (two unsharded steps too), and
    there the group's gradients are held to the train-parity limit
    (scripts/train_determinism_probe.py: after more steps that order spreads
    to every network).

    The loop: train() on the cut (512 videos, 2 epochs of 32 steps, k = 32)
    over the group: launches as the capture's per step x replays, the
    all-reduces the capture recorded (one a batch norm forward and one
    backward, one for the metrics, one a network's gradients), one replay
    under the profiler, log rows, gifs and checkpoints from rank 0, the last
    checkpoint equal to the final state. Returns, beside the numbers, that
    checkpoint for (c)."""
    import torch
    import torch.distributed as dist

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer, largest_divisor_leq
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "shapes.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    tp = config["train_params"]
    tp.update(num_epochs=LOOP_EPOCHS,
              log_params={"log_freq_iter": LOOP_LOG_FREQ, "cpk_freq_epoch": 1})
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    dataset.images = dataset.images[:LOOP_VIDEOS]
    steps = LOOP_EPOCHS * (LOOP_VIDEOS // tp["batch_size"])
    k = largest_divisor_leq(steps, 32)
    per_step = _step_launches(config)
    counters = _counters()

    # exactness, one graphed step
    execute, cache, lengths = _device_feed_of(dataset, dataset.image_shape, device)
    chunk = _plan_chunk(dataset, lengths, tp["batch_size"], 1, device)

    def augment(plan):
        return execute(cache, plan)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    step = {}
    try:
        for label in ("unsharded", "unsharded_again", "nccl_one_rank"):
            group = _process_group("nccl") if label == "nccl_one_rank" else None
            try:
                trainer = Trainer(build_train_models(config, device=device, seed=SEED), tp,
                                  device=device, steps_per_epoch=100, group=group)
                metrics, _ = trainer.run(chunk, 0, 1, augment=augment)
                step[label] = (metrics.cpu(), _step_state(trainer))
                del trainer
            finally:
                if group is not None:
                    dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del cache
    encoder = "generator.appearance_encoder."
    spread = _gaps(step["unsharded_again"][1], step["unsharded"][1])
    reading = _gaps(step["nccl_one_rank"][1], step["unsharded"][1])
    exact = {
        "metrics_equal": torch.equal(step["nccl_one_rank"][0], step["unsharded"][0]),
        "tensors": len(reading) + sum(1 for key in step["unsharded"][1] if key not in reading),
        "outside_encoder_differing": sorted(k for k in reading if not k.startswith(encoder)),
        "outside_encoder_differing_unsharded": sorted(k for k in spread
                                                      if not k.startswith(encoder)),
        "encoder_max_gap": max(reading.values(), default=0.0),
        "encoder_max_gap_unsharded": max(spread.values(), default=0.0),
        "encoder_differing": len(reading), "encoder_differing_unsharded": len(spread),
        "encoder_grad_rel_l2": _grad_rel_l2(step["nccl_one_rank"][1], step["unsharded"][1],
                                            encoder),
        "encoder_grad_rel_l2_unsharded": _grad_rel_l2(step["unsharded_again"][1],
                                                      step["unsharded"][1], encoder),
    }
    del step

    log_dir = work_dir / "parallel_nccl_one_rank"
    log_dir.mkdir()
    group = _process_group("nccl")
    try:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        run = train(config, str(log_dir), dataset, seed=SEED, device=device, group=group)
        counted = {name: fn.launches for name, fn in counters.items()}
        if run.steps != steps or run.steps_per_dispatch != k or not run.device_feed:
            raise AssertionError(f"parallel (a): {run.steps} steps, k = {run.steps_per_dispatch}")
        launches = _graph_launches("parallel (a)", run.trainer, counted, per_step, steps)
        captured = run.trainer.graph_stats["captured_collectives"]
        want_collectives = 2 * _norm_layers(run.trainer) + 1 + len(MODEL_NAMES)
        final = _same_state(load_checkpoint(str(log_dir / checkpoint_name(LOOP_EPOCHS - 1))),
                            {**run.trainer.state_dict(), "epoch": LOOP_EPOCHS - 1,
                             "it": steps - 1}, "parallel (a) final state")
        trace = _replay_counts("parallel (a)", run.trainer, per_step, work_dir)
        wall_s, rows = run.wall_s, _log_rows(log_dir)
        del run
    finally:
        dist.destroy_process_group()
    gifs = sorted(p.name for p in (log_dir / "train-vis").iterdir())
    result = {"phase": "parallel_one_rank_nccl", "config": "configs/shapes.yaml",
              "videos": LOOP_VIDEOS, "steps": steps, "steps_per_dispatch": k,
              "one_step_exactness": exact, "launches": launches,
              "captured_collectives_per_step": captured,
              "expected_collectives_per_step": want_collectives,
              "collectives_in_replays": captured * steps, "replay_trace": trace,
              "loop_wall_s": wall_s, "loop_steps_per_s": steps / wall_s,
              "last_checkpoint_tensors_equal": final, "card": smi}
    log(result)
    log(f"parallel (a): one graphed step over a one-rank NCCL group: metrics equal "
        f"{exact['metrics_equal']}, {len(exact['outside_encoder_differing'])} tensors outside "
        f"the appearance encoder differ from the unsharded step (two unsharded steps: "
        f"{len(exact['outside_encoder_differing_unsharded'])}); the encoder {exact['encoder_max_gap']:.3e}"
        f" apart, its gradients {exact['encoder_grad_rel_l2']:.3e} relative L2 (two unsharded "
        f"steps: {exact['encoder_max_gap_unsharded']:.3e}, "
        f"{exact['encoder_grad_rel_l2_unsharded']:.3e})")
    log(f"parallel (a): train() over the group, launches {launches} (capture x {steps} "
        f"replays), {captured} all-reduces captured a step (x {steps} replays = "
        f"{captured * steps}); one replay's trace: {trace['launches']}, {trace['nccl']} NCCL "
        f"kernels; {steps / wall_s:.3f} steps/s over the loop's wall on {smi}")
    if not exact["metrics_equal"] or exact["outside_encoder_differing"] \
            or exact["outside_encoder_differing_unsharded"]:
        raise AssertionError(f"parallel (a): one step over the group is not the unsharded "
                             f"step bit for bit outside the appearance encoder: {exact}")
    check("parallel (a) the appearance encoder's gradients (relative L2)",
          exact["encoder_grad_rel_l2"], PARITY_TOL["grad_rel_l2"])
    if captured != want_collectives:
        raise AssertionError(f"parallel (a): {captured} all-reduces captured a step, want "
                             f"{want_collectives}")
    if [it for it, _, _ in rows] != list(range(0, steps, LOOP_LOG_FREQ)) or gifs != [
            f"{it:08d}-rec.gif" for it, _, _ in rows] or not all(
            math.isfinite(v) for _, values, _ in rows for v in values.values()):
        raise AssertionError(f"parallel (a): log rows {rows}, gifs {gifs}")
    result["checkpoint"] = str(log_dir / checkpoint_name(LOOP_EPOCHS - 1))
    return result


def _parallel_inputs(world: int, rank: int, device, swap: bool = False):
    """(config, augment, chunk of PARALLEL_STEPS plans on the card) of
    configs/actions.yaml for `rank` of `world` slabs of the AUG_BATCH
    batch: the device feed's cache and plan_stream's shard. `swap` puts the
    second half of each batch first (the same batch in another order)."""
    import numpy as np
    import torch

    from monkeynet_tpu_torch.data.device_feed import plan_stream

    config, dataset, image_shape = _actions(device)
    execute, cache, lengths = _device_feed_of(dataset, image_shape, device)
    local = AUG_BATCH // world
    plans = []
    for _, plan in plan_stream(dataset, dataset.transform, lengths, local, SEED, 0,
                               PARALLEL_STEPS, num_shards=world, shard_index=rank):
        plans.append(plan)
    plans = plans[:PARALLEL_STEPS]
    chunk = {key: torch.from_numpy(np.stack([p[key] for p in plans])).to(device)
             for key in plans[0]}
    if swap:
        chunk = {key: v.roll(local // 2, dims=1) for key, v in chunk.items()}

    def augment(plan):
        return execute(cache, plan)

    return config, augment, chunk


def _groups(state: dict) -> dict:
    """The parameters of a `_state_tensors` (no running statistics),
    flattened and concatenated per top-level sub-module, on the CPU."""
    import torch

    groups = {}
    for key, value in state.items():
        if "running_" not in key:
            groups.setdefault(".".join(key.split(".")[:2]), []).append(value.flatten().cpu())
    return {k: torch.cat(v) for k, v in groups.items()}


def _parallel_steps(world: int, rank: int, device, group=None, swap: bool = False,
                    starts=None) -> dict:
    """PARALLEL_STEPS eager SGD steps of configs/actions.yaml on this rank's
    slab, bf16 and f32, from the seed's weights. With `starts` (a one-process
    run's), step j starts from that run's state before its step j, so that
    every run's step j is the gradient of one batch at one point; without,
    the steps follow on and their starting states are returned as `starts`.
    Per dtype: each step's parameter update and the running statistics
    after it (CPU, by sub-module), the parameters after the last step, the
    num_batches_tracked, the metrics and the launches counted."""
    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer

    config, augment, chunk = _parallel_inputs(world, rank, device, swap)
    counters = _counters()
    out = {}
    for dtype in ("bfloat16", "float32"):
        tp = dict(config["train_params"], compute_dtype=None if dtype == "float32" else dtype)
        trainer = Trainer(build_train_models(config, device=device, seed=SEED), tp,
                          device=device, optimizer_factory=_sgd, group=group)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        updates, running, metrics, own, seconds = [], [], [], [], 0.0
        for j in range(PARALLEL_STEPS):
            if starts is None:
                own.append({name: {k: v.detach().cpu().clone()
                                   for k, v in model.state_dict().items()}
                            for name, model in trainer.models.items()})
            else:
                for name, model in trainer.models.items():
                    model.load_state_dict(starts[dtype][j][name])
            before = _groups(_state_tensors(trainer))
            t0 = time.perf_counter()
            m, _ = trainer.run(chunk, j, j + 1, augment=augment, graph=False)
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            state = _state_tensors(trainer)
            after = _groups(state)
            updates.append({k: after[k] - before[k] for k in after})
            running.append({k: v.cpu() for k, v in state.items() if "running_" in k})
            metrics.append(m[0].float().cpu())
        out[dtype] = {
            "updates": updates, "running": running, "params": after, "starts": own,
            "tracked": sorted({int(b) for model in trainer.models.values()
                               for key, b in model.named_buffers()
                               if key.endswith("num_batches_tracked")}),
            "metrics": torch.stack(metrics),
            "launches": {name: fn.launches for name, fn in counters.items()},
            "seconds": seconds,
        }
        del trainer
    return out


def _rel_l2(got: dict, want: dict):
    """(largest relative L2 gap of a sub-module, which one)."""
    rel = {k: ((got[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30)).item()
           for k in want}
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def _by_network(groups: dict) -> dict:
    """Sub-module groups concatenated per network."""
    import torch

    nets = {}
    for key, value in groups.items():
        nets.setdefault(key.split(".")[0], []).append(value)
    return {k: torch.cat(v) for k, v in nets.items()}


def _compare_parallel(got: dict, want: dict) -> dict:
    """A `_parallel_steps` run from the one process's starts against the
    one process's, per dtype: for each step the largest relative L2 gap of
    a sub-module's update and of a network's whole update, and the largest
    absolute gap of a running statistic after it; the largest relative gap
    of a metric, per step; the parameters' relative L2 gap after the last
    step (printed only: a step moves them by ~1e-3 of their size)."""
    out = {}
    for dtype, g in got.items():
        w = want[dtype]
        steps = [_rel_l2(gu, wu) for gu, wu in zip(g["updates"], w["updates"])]
        nets = [_rel_l2(_by_network(gu), _by_network(wu))
                for gu, wu in zip(g["updates"], w["updates"])]
        out[dtype] = {
            "update_rel_l2": [gap for gap, _ in steps],
            "update_rel_l2_worst": [where for _, where in steps],
            "network_update_rel_l2": [gap for gap, _ in nets],
            "network_update_rel_l2_worst": [where for _, where in nets],
            "params_rel_l2": _rel_l2(g["params"], w["params"])[0],
            "running_max_abs": [max((gr[k] - wr[k]).abs().max().item() for k in wr)
                                for gr, wr in zip(g["running"], w["running"])],
            "metrics_max_rel": ((g["metrics"] - w["metrics"]).abs()
                                / w["metrics"].abs().clamp_min(1e-6)).amax(dim=1).tolist(),
            "tracked": g["tracked"], "tracked_one_process": w["tracked"],
            "digest": _digest([g["params"], g["running"][-1]]),
        }
    return out


def _digest(states) -> str:
    """sha256 of the tensors of some {name: tensor} dicts, in key order."""
    h = hashlib.sha256()
    for state in states:
        for key in sorted(state):
            h.update(key.encode())
            h.update(state[key].detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gloo_rank(rank: int, world: int, device, reference: str) -> dict:
    """One rank of (b), in a process of its own: its PARALLEL_STEPS steps
    over the gloo group against the one process's (read from `reference`),
    its launches, and the four train kernels against their plain versions at its shapes
    (batch AUG_BATCH / world, the config's six warps, both dtypes, and the
    combine with its backward)."""
    import torch
    import torch.distributed as dist

    full_f32()
    device = torch.device(device)
    want = torch.load(reference, weights_only=True)
    t0 = time.perf_counter()
    got = _parallel_steps(world, rank, device, dist.group.WORLD,
                          starts={d: w["starts"] for d, w in want.items()})
    steps_s = time.perf_counter() - t0
    result = {"rank": rank, "steps_s": steps_s,
              "launches": {dtype: g["launches"] for dtype, g in got.items()},
              "step_seconds": {dtype: g["seconds"] for dtype, g in got.items()},
              "against_one_process": _compare_parallel(got, want),
              }
    # the four kernels of the step at this rank's shapes, outside the counted run
    config, _, _ = _actions(device)
    B, warps, K1 = AUG_BATCH // world, config_warps(config, HW), \
        config["model_params"]["common_params"]["num_kp"] + 1
    gen = torch.Generator().manual_seed(SEED + 15 + rank)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for C, h in warps:
            src, dout, grids = _warp_train_inputs(B, h, C, dtype, gen, device)
            errs[f"{dtype}.{C}x{h}"] = _check_warp_train(src, dout, grids,
                                                         f"actions rank {rank}")
    result["kernel_max_abs_err"] = {
        "warp": errs, "combine": combine_backward_phase(device, batch=B, K1=K1,
                                                        label=f"actions rank {rank}")["max_abs_err"]}
    return result


def parallel_refusals(cmps: list, dtype: str) -> list:
    """What phase 8 (b) refuses in the ranks' `_compare_parallel` entries of
    `dtype`: a first update (f32: relative L2 of each network's whole
    update, from the seed's weights), or a step's running statistics or
    metrics, further from the one process's than PARALLEL_UPDATE_TOL /
    PARALLEL_BN_TOL / PARALLEL_METRICS_TOL; or ranks whose parameters and
    running statistics differ."""
    out = []
    for rank, cmp in enumerate(cmps):
        held = [("update", cmp["network_update_rel_l2"][:1], PARALLEL_UPDATE_TOL.get(dtype)),
                ("running statistics", cmp["running_max_abs"], PARALLEL_BN_TOL[dtype]),
                ("metrics", cmp["metrics_max_rel"], PARALLEL_METRICS_TOL[dtype])]
        for what, gaps, tol in held:
            out += [f"rank {rank} step {j} {what}: {gap:.4e} > {tol}"
                    for j, gap in enumerate(gaps) if tol is not None and not gap <= tol]
    if len({cmp["digest"] for cmp in cmps}) > 1:
        out.append("the ranks' parameters and running statistics differ")
    return out


def _describe_parallel(cmp: dict) -> str:
    return ("each step's update "
            + ", ".join(f"{u:.4e} ({w})" for u, w in zip(cmp["network_update_rel_l2"],
                                                       cmp["network_update_rel_l2_worst"]))
            + " by network, "
            + ", ".join(f"{u:.4e} ({w})" for u, w in zip(cmp["update_rel_l2"],
                                                       cmp["update_rel_l2_worst"]))
            + " by sub-module; running statistics "
            + ", ".join(f"{v:.3e}" for v in cmp["running_max_abs"])
            + "; metrics " + ", ".join(f"{v:.3e}" for v in cmp["metrics_max_rel"])
            + f" relative; parameters after the last step {cmp['params_rel_l2']:.4e}")


def parallel_reference(work_dir: Path, device="cuda"):
    """(b)'s one process at batch AUG_BATCH: its run (saved for the ranks
    under `work_dir`), the file, and the control: the same process from the
    same starts with each batch's halves swapped, a gap that summation order
    alone makes at batch 32."""
    import torch

    want = _parallel_steps(1, 0, torch.device(device))
    reference = work_dir / "parallel_one_process.pt"
    torch.save(want, reference)
    starts = {d: w["starts"] for d, w in want.items()}
    swapped = _compare_parallel(
        _parallel_steps(1, 0, torch.device(device), swap=True, starts=starts), want)
    torch.cuda.empty_cache()
    return want, reference, swapped


def gloo_two_rank_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """(b) configs/actions.yaml at full width, the global batch of 32 as two
    slabs of 16 on two gloo ranks that share the card, PARALLEL_STEPS eager
    device-fed SGD steps in bf16 and f32, against one process at batch 32
    (this one). Step j of every run starts from the one process's state
    before its step j, so each step's update is the gradient of the global
    batch at one point: `parallel_refusals` holds the first (f32), the running
    statistics and metrics after it, and the ranks' agreement bit for bit.
    num_batches_tracked equal. Each
    rank launches one process's kernels a step and holds them against their
    plain versions at its shapes. A control that needs no collectives at the
    ranks' batch of 16 computes another function (the batch norms couple the
    slabs): scripts/parallel_fault_probe.py reads it as the local_batch_norm
    fault, refused with the others. gloo stages through the host: its step
    times say nothing of NCCL across cards."""
    import torch

    from monkeynet_tpu_torch.parallel.distributed import spawn

    t0 = time.perf_counter()
    want, reference, swapped = parallel_reference(work_dir, device)
    one_process_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn(_gloo_rank, ["cuda:0"] * PARALLEL_RANKS, "gloo", args=(str(reference),),
                  timeout=600)
    spawn_s = time.perf_counter() - t0
    config, _, _ = _actions(device)
    per_step = _step_launches(config)
    want_launches = {name: v * PARALLEL_STEPS for name, v in per_step.items()}
    result = {"phase": "parallel_two_gloo_ranks", "config": "configs/actions.yaml",
              "global_batch": AUG_BATCH, "ranks": PARALLEL_RANKS, "steps": PARALLEL_STEPS,
              "one_process_launches": {d: w["launches"] for d, w in want.items()},
              "one_process_step_seconds": {d: w["seconds"] for d, w in want.items()},
              "ranks_result": ranks, "one_process_swapped_halves": swapped,
              "one_process_s": one_process_s, "spawn_s": spawn_s,
              "tol": {"network_update_rel_l2": PARALLEL_UPDATE_TOL,
                      "running_max_abs": PARALLEL_BN_TOL,
                      "metrics_max_rel": PARALLEL_METRICS_TOL}, "card": smi}
    log(result)
    for dtype, ctl in swapped.items():
        log(f"parallel (b) {dtype} control, one process with the batch's halves swapped: "
            + _describe_parallel(ctl))
    refused = []
    for dtype in want:
        refused += [f"{dtype} {why}" for why in parallel_refusals(
            [r["against_one_process"][dtype] for r in ranks], dtype)]
    for r in ranks:
        for dtype, cmp in r["against_one_process"].items():
            log(f"parallel (b) rank {r['rank']} {dtype} against one process: "
                + _describe_parallel(cmp) + f"; launches {r['launches'][dtype]}; steps "
                f"{r['step_seconds'][dtype]:.3f} s (one process {want[dtype]['seconds']:.3f} s) "
                f"on {smi}")
            if not cmp["tracked"] == cmp["tracked_one_process"] == [PARALLEL_STEPS]:
                raise AssertionError(f"parallel (b): num_batches_tracked {cmp['tracked']}, "
                                     f"one process {cmp['tracked_one_process']}")
            if r["launches"][dtype] != want_launches:
                raise AssertionError(f"parallel (b) rank {r['rank']} {dtype}: launches "
                                     f"{r['launches'][dtype]} != {want_launches}")
    if refused:
        raise AssertionError("parallel (b): " + "; ".join(refused))
    for d, w in want.items():
        if w["launches"] != want_launches:
            raise AssertionError(f"parallel (b) one process {d}: {w['launches']}")
    result["launches"] = ranks[0]["launches"]["bfloat16"]
    return result


@contextlib.contextmanager
def _eval_devices(devices):
    """The eval drivers' device lists named as `devices` (the card twice):
    their `num_devices` counts cards, and one card is present."""
    import torch

    from monkeynet_tpu_torch.tasks import reconstruction, transfer

    def named(num_devices, device="cuda"):
        if num_devices != len(devices):
            raise AssertionError(f"num_devices {num_devices}, devices {devices}")
        return [torch.device(d) for d in devices]

    saved = reconstruction.local_devices, transfer.local_devices
    reconstruction.local_devices = transfer.local_devices = named
    try:
        yield
    finally:
        reconstruction.local_devices, transfer.local_devices = saved


def frame_sharded_phase(checkpoint: str, work_dir: Path, smi: str, device="cuda") -> dict:
    """(c) Frame-sharded eval over SHARDED_DEVICES on (a)'s last checkpoint
    (configs/shapes.yaml, f32): the engines on one test video against the
    unsharded ones (reconstruction's identity recipe and transfer's
    move_location); reconstruction() and the move_location transfer() with
    num_devices 2, their launches those of the route for the padded frames
    split in two slabs, their L1 and PNGs against the unsharded drivers';
    and the moving-gif demo at 128^2 (random weights) through a sharded
    KPExtractor and Animator against the unsharded."""
    import numpy as np
    import torch
    from PIL import Image

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.data.io import read_video
    from monkeynet_tpu_torch.tasks.animate import Animator, KPExtractor, TransferEngine
    from monkeynet_tpu_torch.tasks.build import build_models
    from monkeynet_tpu_torch.tasks.reconstruction import load_eval_models, reconstruction
    from monkeynet_tpu_torch.tasks.transfer import transfer, transfer_one
    from monkeynet_tpu_torch.utils.config import load_config

    devices = list(SHARDED_DEVICES)
    n = len(devices)
    config = load_config(str(REPO / "configs" / "shapes.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    config["reconstruction_params"]["num_videos"] = EVAL_VIDEOS - 1
    config["transfer_params"]["num_pairs"] = EVAL_PAIRS
    test = FramesDataset(is_train=False, **config["dataset_params"])
    test.images = test.images[:EVAL_VIDEOS]
    result = {"phase": "parallel_frame_sharded", "devices": devices, "card": smi,
              "tol": SHARDED_EVAL_TOL, "max_abs_err": {}, "launches": {}, "seconds": {}}

    def compare(label, got, want):
        for key in want:
            if isinstance(want[key], dict):
                compare(f"{label}.{key}", got[key], want[key])
                continue
            err = max_err(torch.as_tensor(got[key]), torch.as_tensor(want[key]))
            result["max_abs_err"][f"{label}.{key}"] = err
            check(f"parallel (c) {label}.{key}", err, SHARDED_EVAL_TOL)

    # the engines on one video, sharded against unsharded
    generator, kp_detector = load_eval_models(config, checkpoint, device)
    video = torch.as_tensor(test[0]["video"][None], device=device)
    for label, move in (("reconstruction_engine", False), ("transfer_engine", True)):
        plain = TransferEngine(generator, kp_detector, move_location=move, device=device)
        sharded = TransferEngine(generator, kp_detector, move_location=move, devices=devices)
        compare(label, sharded(video[:, :1], video), plain(video[:, :1], video))
    compare("kp_extractor", KPExtractor(kp_detector, devices=devices).device_call(video),
            KPExtractor(kp_detector, device=device).device_call(video))
    del generator, kp_detector

    # the drivers, sharded (counted) and not
    def counted(label, want, fn):
        out, launches, seconds = _counted(label, smi, want, fn)
        result["launches"][label] = launches
        result["seconds"][label] = seconds
        return out

    plain_metrics = reconstruction(config, str(work_dir / "recon_plain"), test, checkpoint,
                                   device=device)
    with _eval_devices(devices):
        # per video: the source once, each slab of the chunk and of the
        # generated frames through the kp detector, each slab through the
        # generator
        metrics = counted("sharded reconstruction",
                          _route_launches(config, n * EVAL_VIDEOS, (1 + 2 * n) * EVAL_VIDEOS),
                          lambda: reconstruction(config, str(work_dir / "recon_sharded"), test,
                                                 checkpoint, device=device, num_devices=n))
        route_config = dict(config, transfer_params=dict(
            config["transfer_params"], normalization_params={"move_location": True}))
        counted("sharded transfer", _route_launches(config, n * EVAL_PAIRS, (1 + n) * EVAL_PAIRS),
                lambda: transfer(route_config, str(work_dir / "transfer_sharded"), test,
                                 checkpoint, device=device, num_devices=n))
    l1_err = abs(metrics["l1"] - plain_metrics["l1"])
    result["max_abs_err"]["reconstruction.l1"] = l1_err
    check("parallel (c) reconstruction L1", l1_err, SHARDED_EVAL_TOL)
    png_err = 0
    for name in test.images:
        a, b = (np.asarray(Image.open(work_dir / d / "reconstruction" / "png" / (name + ".png")),
                           np.int32) for d in ("recon_sharded", "recon_plain"))
        png_err = max(png_err, int(np.abs(a - b).max()))
    result["max_abs_err"]["reconstruction.png_levels"] = png_err
    if png_err > 1:  # frames 1e-5 apart round to the same 8-bit level, or the next
        raise AssertionError(f"parallel (c): sharded reconstruction PNGs {png_err} levels off")
    result["metrics"], result["unsharded_metrics"] = metrics, plain_metrics
    pairs = sorted(os.listdir(work_dir / "transfer_sharded" / "transfer" / "png"))
    if len(pairs) != EVAL_PAIRS:
        raise AssertionError(f"parallel (c): sharded transfer wrote {pairs}")

    # the demo at 128^2: a sharded KPExtractor and Animator against unsharded
    mconfig = load_config(str(REPO / "configs" / "moving-gif.yaml"))
    generator, kp_detector = build_models(mconfig, device=device, seed=SEED)
    driving = read_video(str(REPO / "data" / "demo" / "driving.png"), (128, 128, 3))[None]
    source = read_video(str(REPO / "data" / "demo" / "source.png"), (128, 128, 3))[None, :1]
    recipe = mconfig["transfer_params"]
    plain = transfer_one(Animator(generator, device=device),
                         KPExtractor(kp_detector, device=device), source, driving, recipe)
    sharded = counted("sharded demo", _route_launches(mconfig, n, 2 * n),
                      lambda: transfer_one(Animator(generator, devices=devices),
                                           KPExtractor(kp_detector, devices=devices),
                                           source, driving, recipe))
    compare("demo", {k: sharded[k] for k in ("video_prediction", "video_deformed",
                                              "kp_driving", "kp_source")},
            {k: plain[k] for k in ("video_prediction", "video_deformed", "kp_driving",
                                   "kp_source")})
    del generator, kp_detector
    result["eval_launches"] = {name: sum(launches[name] for launches in
                                         result["launches"].values()) for name in _counters()}
    log(result)
    log(f"parallel (c): frame-sharded over {devices}: largest gap "
        f"{max(v for v in result['max_abs_err'].values()):.3e} (limit {SHARDED_EVAL_TOL}); "
        + ", ".join(f"{k} {v:.3f} s" for k, v in result["seconds"].items()) + f" on {smi}")
    return result


def parallel_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """Phase 8: (a) one NCCL rank in the step's graph, (b) two gloo ranks
    sharing the card at actions width, (c) frame-sharded eval; each
    sub-phase's seconds."""
    seconds, t0 = {}, time.perf_counter()
    nccl = one_rank_nccl_phase(work_dir, smi, device)
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gloo = gloo_two_rank_phase(work_dir, smi, device)
    seconds["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = frame_sharded_phase(nccl["checkpoint"], work_dir, smi, device)
    seconds["c"] = time.perf_counter() - t0
    log({"phase": "parallel_seconds", **seconds, "card": smi})
    return {"nccl": nccl, "gloo": gloo, "frame_sharded": sharded, "seconds": seconds}


def parallel_launches(parallel: dict) -> dict:
    """Phase 8's launches by path: (a) the one-rank NCCL train loop (capture
    x replays), (b) one gloo rank's bf16 steps, (c) the frame-sharded eval;
    each kernel of the slice's path must have launched in one of them."""
    paths = {"nccl_one_rank_loop": parallel["nccl"]["launches"],
             "gloo_rank_steps": parallel["gloo"]["launches"],
             "frame_sharded_eval": parallel["frame_sharded"]["eval_launches"]}
    for name in paths["nccl_one_rank_loop"]:
        if not any(launches[name] for launches in paths.values()):
            raise AssertionError(f"phase 8: {name} never launched on the sharded paths")
    return paths


# ---- phase 9: the JAX package's checkpoints, and the framework-free tools ------

# The committed file the JAX package's train() wrote (2 steps at the tiny
# widths of tests/torch_port_common.py's tiny_config over the first 8 train
# videos of data/shapes at 64^2, batch 4; scripts/make_jax_checkpoint_fixture.py)
# and its config. The card's machine has no JAX to write one.
JAX_FIXTURE = REPO / "tests" / "fixtures" / "jax_train_checkpoint.msgpack"
JAX_FIXTURE_CONFIG = REPO / "tests" / "fixtures" / "jax_train_checkpoint.yaml"
# The layout of the JAX package's train checkpoint at configs/shapes.yaml's
# widths, from the same script (the 58.5 MB file is too large to commit):
# the card fills it with seeded values (jax_layout_tree) and writes it in
# the bytes the JAX package's save_checkpoint writes (pack_msgpack).
JAX_SHAPES_LAYOUT = REPO / "tests" / "fixtures" / "jax_shapes_train_layout.json"
JAXCKPT_EVAL_VIDEOS = 2
# Each file's resumed train(): (train videos, the epochs the config is cut
# to). The fixture holds epoch 0 at Adam count 2, 2 steps an epoch at batch
# 4; the run trains epochs 0-3 again: 8 steps, k = 8. At configs/shapes.yaml
# width, 4 steps an epoch at batch 16; the file holds epoch 2 at count 12,
# and the run trains epochs 2-4: 12 steps, k = 12, past the epoch-4
# milestone (count 16) inside the graph's chunk.
JAXCKPT_FIXTURE_CUT = (8, 4)
JAXCKPT_SHAPES_CUT = (64, 5)
JAXCKPT_SHAPES_EPOCH = 2


def _tool(args, cwd: Path) -> str:
    """One tool's command line in a process of its own; its standard output."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    if proc.returncode != 0:
        raise AssertionError(f"tools: {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-2000:]}")
    return proc.stdout


def tools_phase(work_dir: Path) -> dict:
    """(d) Each framework-free tool's command line once, on temporary
    copies: a split of 10 videos, a preprocess of 4 frames, bg_removal of
    data/demo's source frame, the user study's make / page / analyze."""
    import numpy as np
    from PIL import Image

    t0, root = time.perf_counter(), work_dir / "tools"
    videos = root / "videos"
    videos.mkdir(parents=True)
    shapes_test = REPO / "data" / "shapes" / "test"
    for name in sorted(os.listdir(shapes_test))[:10]:
        shutil.copy(shapes_test / name, videos / name)
    _tool(["monkeynet_tpu_torch.data.tools", "split", str(videos)], root)
    split = {s: len(os.listdir(videos / s)) for s in ("train", "test")}
    if split != {"train": 9, "test": 1}:
        raise AssertionError(f"tools split: {split}")

    frames = root / "frames" / "clip"
    frames.mkdir(parents=True)
    with Image.open(videos / "train" / sorted(os.listdir(videos / "train"))[0]) as im:
        strip = np.asarray(im.convert("RGB"))
    for i in range(4):
        Image.fromarray(strip[:, 64 * i:64 * (i + 1)]).save(frames / f"{i:03d}.png")
    _tool(["monkeynet_tpu_torch.data.tools", "preprocess", str(frames.parent),
           str(root / "stacked"), "--size", "32"], root)
    with Image.open(root / "stacked" / "clip.jpg") as im:
        if im.size != (4 * 32, 32):
            raise AssertionError(f"tools preprocess: a {im.size} image")

    with Image.open(REPO / "data" / "demo" / "source.png") as im:
        source = np.asarray(im.convert("RGB"))
    Image.fromarray(source[:, :source.shape[0]]).save(root / "frame.png")
    out = _tool(["monkeynet_tpu_torch.data.bg_removal", str(root / "frame.png"),
                 str(root / "clean.png"), "--image_shape", str(source.shape[0])], root)
    with Image.open(root / "clean.png") as im:
        if im.size != (source.shape[0],) * 2 or "wrote" not in out:
            raise AssertionError(f"tools bg_removal: {im.size}, {out!r}")

    for sub in ("ours", "baseline"):
        (root / sub).mkdir()
        for i in range(6):
            (root / sub / f"{sub}-{i:08d}.gif").write_bytes(b"GIF89a")
    study = root / "study"
    study_cli = "monkeynet_tpu_torch.utils.user_study"
    _tool([study_cli, "make", "--ours", str(root / "ours"), "--baseline",
           str(root / "baseline"), "--out", str(study)], root)
    _tool([study_cli, "page", "--manifest-dir", str(study)], root)
    keys = (study / "key.csv").read_text().splitlines()[1:]
    (root / "responses.csv").write_text(
        "first,choice\n" + "".join(f"{k.split(',')[0]},optionA\n" for k in keys))
    report = _tool([study_cli, "analyze", "--responses", str(root / "responses.csv"),
                    "--key", str(study / "key.csv")], root)
    if not report.startswith("n=6 votes") or not (study / "index.html").stat().st_size:
        raise AssertionError(f"tools user_study: {report!r}")
    return {"split": split, "study": report.strip(), "seconds": time.perf_counter() - t0}


def pack_msgpack(tree) -> bytes:
    """`tree` (dicts with str keys, numpy leaves) in the bytes the JAX
    package's `save_checkpoint` writes for it: flax's msgpack_serialize of
    the tree after jax.tree.map (keys sorted), every leaf an ndarray ext
    (code 1: msgpack of (shape, dtype name, C-order bytes)), every header in
    the shortest form msgpack has for it. The port reads such files and
    writes none; this writes one on the card, which has no flax."""
    import struct

    import numpy as np

    def head(n, fix, codes):
        # the fix form (first code, limit) or the 8-, 16- or 32-bit form
        if fix is not None and n < fix[1]:
            return bytes([fix[0] | n])
        for code, fmt in zip(codes, (">B", ">H", ">I")):
            if code is not None and n < 256 ** struct.calcsize(fmt):
                return bytes([code]) + struct.pack(fmt, n)
        raise ValueError(f"msgpack: a length of {n}")

    def pack(x):
        if isinstance(x, dict):
            return head(len(x), (0x80, 16), (None, 0xDE, 0xDF)) + b"".join(
                pack(k) + pack(x[k]) for k in sorted(x))
        if isinstance(x, tuple):
            return head(len(x), (0x90, 16), (None, 0xDC, 0xDD)) + b"".join(map(pack, x))
        if isinstance(x, str):
            return head(len(x.encode()), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + x.encode()
        if isinstance(x, bytes):
            return head(len(x), None, (0xC4, 0xC5, 0xC6)) + x
        if isinstance(x, int) and 0 <= x < 2**32:  # a dimension: fixint or uint8/16/32
            return bytes([x]) if x < 128 else head(x, None, (0xCC, 0xCD, 0xCE))
        if isinstance(x, np.ndarray):
            data = pack((x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()))
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
            return (bytes([fixext[len(data)]]) if len(data) in fixext
                    else head(len(data), None, (0xC7, 0xC8, 0xC9))) + b"\x01" + data
        raise TypeError(f"msgpack: cannot pack a {type(x).__name__}")

    return pack(tree)


def jax_layout_tree(layout: dict, count: int, epoch: int, seed: int = SEED) -> dict:
    """A JAX train checkpoint's payload of `layout` (JAX_SHAPES_LAYOUT) with
    seeded values: kernels at the scale of their fan-in, norm scales near
    1, biases and running means near 0, running variances in [0.5, 1.5],
    Adam's mu near 0 and nu positive; the state's step and both optax counts
    at `count`, `epoch`, and `it` at `count` (where the JAX train loop's
    epoch-end file puts it)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ints = {"step": count, "count": count, "epoch": epoch, "it": count}

    def fill(tree, path):
        if "dtype" not in tree:
            return {k: fill(tree[k], path + (k,)) for k in sorted(tree)}
        shape, dtype, name = tuple(tree["shape"]), np.dtype(tree["dtype"]), path[-1]
        moment = path[4] if path[:2] == ("state", "opt_states") and len(path) > 5 else None
        if dtype.kind != "f":
            value = ints[name]
        elif moment == "nu":
            value = 1e-6 * rng.uniform(0.5, 1.5, shape)
        elif moment == "mu":
            value = 1e-3 * rng.randn(*shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, shape)
        elif name == "kernel":
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            value = 1 + 0.1 * rng.randn(*shape)
        else:  # biases, running means
            value = 0.1 * rng.randn(*shape)
        return np.asarray(value, dtype)

    return fill(layout, ())


def _same_tree(got, want, where: str = "") -> int:
    """Leaves of two decoded trees equal in keys, order, dtype and bits."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            raise AssertionError(f"jaxckpt: {where or '/'} holds other keys")
        return sum(_same_tree(got[k], want[k], f"{where}/{k}") for k in want)
    if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"jaxckpt: {where} differs")
    return 1


def _jax_file_phase(label: str, config, ckpt: Path, cut, work_dir: Path, smi: str,
                    device="cuda") -> dict:
    """(a)-(c) of jaxckpt_phase for the JAX train checkpoint `ckpt` of
    `config`, after its kernels at the shapes that (a)-(c) give them
    (loop_kernel_phase at the train step, eval_kernel_phase at the
    reconstruction's chunks)."""
    import copy

    import numpy as np
    import torch

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.animate import _bucket
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.reconstruction import reconstruction
    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer, multistep_lr
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_any
    from monkeynet_tpu_torch.utils.msgpack import read_msgpack
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    videos, epochs = cut
    tp = config["train_params"]
    steps_per_epoch = videos // tp["batch_size"]
    test = FramesDataset(is_train=False, **config["dataset_params"])
    test.images = test.images[:JAXCKPT_EVAL_VIDEOS]
    result = {"file": label, "bytes": ckpt.stat().st_size, "seconds": {}, "launches": {}}
    loop_kernel_phase(device, config, f"jaxckpt {label}")
    chunks = sorted({_bucket(test[i]["video"].shape[0], CHUNK) for i in range(len(test))})
    eval_kernel_phase(device, [(f"jaxckpt {label}", config, HW, f) for f in chunks])

    # (a) the file into a Trainer on the card
    trainer = Trainer(build_train_models(config, device=device, seed=SEED + 2), tp,
                      device=device, steps_per_epoch=steps_per_epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.load_state_dict(load_any(str(ckpt)))
    torch.cuda.synchronize()
    result["seconds"]["load"] = time.perf_counter() - t0
    tree = read_msgpack(str(ckpt))
    state = tree["state"]
    on = torch.device(device).type
    count = int(state["opt_states"]["generator"]["0"]["count"])
    schedule = multistep_lr(tp["lr"], tp["epoch_milestones"], steps_per_epoch)
    lr = np.float32(schedule(count))
    tensors = 0
    for name in MODEL_NAMES:
        want = from_jax_variables(state["params"][name], state["batch_stats"].get(name, {}))
        got = trainer.models[name].state_dict()
        if set(got) != set(want):
            raise AssertionError(f"jaxckpt {label} (a): {name}'s keys differ from the file's")
        for key, value in want.items():
            if got[key].device.type != on or not torch.equal(got[key].cpu(), value):
                raise AssertionError(f"jaxckpt {label} (a): {name}.{key} differs from the file")
            tensors += 1
        adam = state["opt_states"][name]["0"]
        moments = {"exp_avg": from_jax_variables(adam["mu"], {}),
                   "exp_avg_sq": from_jax_variables(adam["nu"], {})}
        optimizer = trainer.optimizers[name]
        for (pname, p), q in zip(trainer.models[name].named_parameters(),
                                 optimizer.param_groups[0]["params"]):
            entry = optimizer.state[q]
            if p is not q or entry["step"].device.type != on or entry["step"].item() != count:
                raise AssertionError(f"jaxckpt {label} (a): {name}.{pname}'s Adam step "
                                     f"{entry['step']}")
            for key, values in moments.items():
                if not torch.equal(entry[key].cpu(), values[pname]):
                    raise AssertionError(f"jaxckpt {label} (a): {name}.{pname} {key} differs")
                tensors += 1
        if np.float32(optimizer.param_groups[0]["lr"]) != lr or \
                trainer.schedulers[name].last_epoch != count:
            raise AssertionError(f"jaxckpt {label} (a): {name} resumes at rate "
                                 f"{optimizer.param_groups[0]['lr']}, the schedule's {lr}")
    gen = torch.Generator().manual_seed(SEED)
    batch = {k: torch.randint(0, 256, (tp["batch_size"], 1, HW, HW, 3), generator=gen,
                              dtype=torch.uint8).to(device) for k in ("source", "video")}
    metrics = trainer.step(batch)["metrics"]
    rates = {name: rate.item() for name, rate in trainer._rates.items()}
    if any(np.float32(r) != lr for r in rates.values()) or not torch.isfinite(metrics).all():
        raise AssertionError(f"jaxckpt {label} (a): the first step ran at {rates} (want "
                             f"{lr}), metrics {metrics}")
    del trainer
    result.update(tensors_checked=tensors, count=count, lr=float(lr), first_step_rates=rates)

    # (b) reconstruction from the file on the card (launches counted), and
    # one test video card against CPU, stage by stage
    rconfig = copy.deepcopy(config)
    rconfig["reconstruction_params"]["num_videos"] = JAXCKPT_EVAL_VIDEOS - 1
    want = _route_launches(rconfig, JAXCKPT_EVAL_VIDEOS, 3 * JAXCKPT_EVAL_VIDEOS)
    metrics, launches, seconds = _counted(
        f"jaxckpt {label} reconstruction", smi, want,
        lambda: reconstruction(rconfig, str(work_dir / f"{label}_eval"), test, str(ckpt),
                               device=device))
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"jaxckpt {label} (b): metrics {metrics}")
    result["launches"]["reconstruction"], result["seconds"]["reconstruction"] = launches, seconds
    video = test[0]["video"]
    result["reconstruction"] = metrics
    result["parity"] = eval_parity(config, str(ckpt), {
        "reconstruction": (video[None, :1], video[None], {})}, f"jaxckpt {label} parity", device)

    # (c) train() resumed from the file on the config's path
    tconfig = copy.deepcopy(config)
    tconfig["train_params"].update(num_epochs=epochs,
                                   log_params={"log_freq_iter": 1, "cpk_freq_epoch": 1})
    if not tconfig["train_params"].get("device_feed"):
        raise AssertionError(f"jaxckpt {label}: the config no longer asks for the device feed")
    dataset = FramesDataset(is_train=True, **tconfig["dataset_params"])
    dataset.images = dataset.images[:videos]
    start = int(tree["epoch"])
    steps = (epochs - start) * steps_per_epoch
    per_step = _step_launches(tconfig)
    counters = _counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    run = train(tconfig, str(ckpt.parent), dataset, checkpoint=str(ckpt), seed=SEED,
                device=device)
    torch.cuda.synchronize()
    counted = {name: fn.launches for name, fn in counters.items()}
    if run.steps != steps or run.epochs != list(range(start, epochs)) or \
            not run.device_feed or run.steps_per_dispatch != steps:
        raise AssertionError(f"jaxckpt {label} (c): {run.steps} steps over epochs "
                             f"{run.epochs}, device feed {run.device_feed}, "
                             f"k {run.steps_per_dispatch}")
    result["launches"]["resumed_train"] = _graph_launches(
        f"jaxckpt {label} resume", run.trainer, counted, per_step, steps)
    it = int(tree["it"])
    rows = _log_rows(ckpt.parent)
    if [r[0] for r in rows] != list(range(it, it + steps)) or not all(
            math.isfinite(v) for _, values, _ in rows for v in values.values()):
        raise AssertionError(f"jaxckpt {label} (c): log rows {rows}")
    # After the run: every Adam step at count + steps; the rate the last
    # replay read (filled before it) at count + steps - 1, the host's next
    # at count + steps
    last_lr, next_lr = np.float32(schedule(count + steps - 1)), np.float32(schedule(count + steps))
    for name in MODEL_NAMES:
        optimizer = run.trainer.optimizers[name]
        after = {entry["step"].item() for entry in optimizer.state.values()}
        if after != {count + steps} or np.float32(optimizer.param_groups[0]["lr"]) != next_lr \
                or np.float32(run.trainer._rates[name].item()) != last_lr:
            raise AssertionError(f"jaxckpt {label} (c): {name} Adam steps {after}, rate "
                                 f"{optimizer.param_groups[0]['lr']} after the run")
    cpks = [ckpt.parent / checkpoint_name(e) for e in range(start, epochs)]
    if not all(p.exists() for p in cpks):
        raise AssertionError(f"jaxckpt {label} (c): checkpoints "
                             f"{sorted(os.listdir(ckpt.parent))}")
    result["seconds"]["train_wall"] = run.wall_s
    result.update(resumed_steps=steps, steps_per_dispatch=run.steps_per_dispatch,
                  expected_per_step=per_step, steps_per_s=steps / run.wall_s,
                  step_wall_ms=1e3 * run.wall_s / steps, logged_its=[r[0] for r in rows],
                  rates=[float(schedule(count)), float(last_lr)])
    del run
    log(result)
    log(f"jaxckpt {label}: loaded {result['bytes']} bytes in {result['seconds']['load']:.3f} "
        f"s; reconstruction of {JAXCKPT_EVAL_VIDEOS} videos {seconds:.3f} s; resumed train() "
        f"{steps} steps in {result['seconds']['train_wall']:.3f} s "
        f"({result['step_wall_ms']:.3f} ms a step, device feed, graph); on {smi}")
    return result


def jaxckpt_phase(work_dir: Path, smi: str, device="cuda") -> dict:
    """JAX package train checkpoints on the card, through the entry points a
    user calls, for two files: the committed one the JAX package wrote
    (JAX_FIXTURE, tiny widths) and one of configs/shapes.yaml's layout at
    full width (JAX_SHAPES_LAYOUT with seeded values, written as the JAX
    package writes it and read back leaf for leaf). For each, after its
    kernels at the shapes below: (a) the file into a Trainer on the card,
    every tensor bit for bit against the decoded arrays after the layout
    map (parameters, batch statistics, Adam moments, each Adam step on the
    card at the file's count), the rate at the JAX schedule's value there,
    one eager step at that rate; (b) reconstruction() from the file over
    the first 2 test videos of data/shapes on the card (launches counted),
    and the first video card against CPU stage by stage (eval_parity);
    (c) train() resumed from the file on the config's path (the device
    feed, the step's CUDA graph), launches as capture x replays, finite
    rows from the file's `it` on, the Adam steps and rate after the run.
    Then (d) the tools' command lines (tools_phase)."""
    import json

    from monkeynet_tpu_torch.utils.config import load_config
    from monkeynet_tpu_torch.utils.msgpack import read_msgpack

    fixture = work_dir / "fixture" / JAX_FIXTURE.name
    fixture.parent.mkdir()
    shutil.copy(JAX_FIXTURE, fixture)
    shapes_config = load_config(str(REPO / "configs" / "shapes.yaml"))
    count = (JAXCKPT_SHAPES_EPOCH + 1) * (
        JAXCKPT_SHAPES_CUT[0] // shapes_config["train_params"]["batch_size"])
    tree = jax_layout_tree(json.loads(JAX_SHAPES_LAYOUT.read_text()), count,
                           JAXCKPT_SHAPES_EPOCH)
    shapes = work_dir / "shapes" / f"{JAXCKPT_SHAPES_EPOCH:08d}-checkpoint.msgpack"
    shapes.parent.mkdir()
    t0 = time.perf_counter()
    shapes.write_bytes(pack_msgpack(tree))
    result = {"phase": "jaxckpt", "shapes_file_write_s": time.perf_counter() - t0,
              "shapes_file_leaves": _same_tree(read_msgpack(str(shapes)), tree),
              "files": {}, "launches": {}}
    del tree
    for label, config, path, cut in (
            ("fixture", load_config(str(JAX_FIXTURE_CONFIG)), fixture, JAXCKPT_FIXTURE_CUT),
            ("shapes", shapes_config, shapes, JAXCKPT_SHAPES_CUT)):
        config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
        one = _jax_file_phase(label, config, path, cut, work_dir, smi, device)
        result["files"][label] = one
        for name, launches in one["launches"].items():
            result["launches"][f"{label} {name}"] = launches

    # (d) the tools' command lines
    result["tools"] = tools_phase(work_dir)
    result["jaxckpt_launches"] = {name: sum(launches[name] for launches in
                                            result["launches"].values())
                                  for name in _counters()}
    log(result)
    log(f"jaxckpt: tools {result['tools']['seconds']:.3f} s; on {smi}")
    return result


def kernels_line(summary: dict, transfer_launches: dict, train_launches: dict,
                 loop_launches: dict, eval_launches: dict, actions_launches: dict,
                 sharded_launches: dict, jaxckpt_launches: dict) -> dict:
    """One row per kernel. `launches` is the count of the path that runs the
    kernel: the 256-frame transfer for the four forward kernels, the ten
    timed train steps for d_src and d_grid; every path's counts are also
    given under its own name (`train_loop_launches`: the train loop's 64
    steps through the step's CUDA graph, captured launches x replays;
    `eval_launches`: the counted steps of eval_phase; `actions_launches`:
    phase 7's loop on configs/actions.yaml, 90 steps through the graph;
    `parallel_launches`: phase 8's paths, `parallel_launches` above;
    `jaxckpt_launches`: phase 9's reconstruction and resumed train() from
    each JAX package file).
    Times are per transfer chunk (forward kernels)
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
               "train_launches": train_launches[name],
               "train_loop_launches": loop_launches[name],
               "eval_launches": eval_launches[name],
               "actions_launches": actions_launches[name],
               "parallel_launches": {path: launches[name]
                                     for path, launches in sharded_launches.items()},
               "jaxckpt_launches": {path: launches[name]
                                    for path, launches in jaxckpt_launches.items()}}
        if f"{key}_bf16" in summary:
            row["bf16"] = numbers(summary[f"{key}_bf16"])
        if name == "warp":
            row["train"] = {"f32": numbers(summary["warp_train"]),
                            "bf16": numbers(summary["warp_train_bf16"])}
        if name in ("warp_dsrc", "warp_dgrid"):
            # extra_bytes (d_src): beyond the bound's bytes, the zero fill and,
            # in bf16, the cast's read of the 'global' variant; 0 where every
            # call is 'shared'
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


PHASES = ("kernels", "parity", "main", "loop", "dispatch", "parallel", "jaxckpt")


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one GPU.")
    parser.add_argument("--only", nargs="+", choices=PHASES, default=None,
                        help="run only these phases (after the build; 'loop' includes the eval "
                             "phase) and print no result line")
    only = parser.parse_args(argv).only
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
    if only is not None:
        phases = {
            "kernels": lambda work: (kernel_phase("cuda"), warp_train_phase("cuda"),
                                     warp_edge_phase("cuda"), combine_backward_phase("cuda"),
                                     loop_kernel_phase("cuda"), eval_kernel_phase("cuda")),
            "parity": lambda work: (slice_parity(config), train_parity(config)),
            "main": lambda work: (main_path(config, torch.bfloat16),
                                  train_path(config, "bfloat16")),
            "loop": lambda work: eval_phase(train_loop_phase(work)["checkpoint"], work, smi),
            "dispatch": lambda work: dispatch_phase(work, smi),
            "parallel": lambda work: parallel_launches(parallel_phase(work, smi)),
            "jaxckpt": lambda work: jaxckpt_phase(work, smi),
        }
        for name in only:
            with tempfile.TemporaryDirectory(prefix="monkeynet_smoke_") as work:
                phases[name](Path(work))
        log(f"chip_smoke: phases {only} passed on {smi}")
        return 0
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    summary = kernel_phase("cuda")
    summary.update(warp_train_phase("cuda"))
    warp_edge_phase("cuda")
    combine_backward_phase("cuda")
    loop_kernel_phase("cuda")
    eval_kernel_phase("cuda")
    lap("kernels")
    slice_parity(config)
    train_parity(config)
    train_parity(load_config(str(REPO / "configs" / "shapes.yaml")), "shapes")
    lap("parity")
    runs = [main_path(config, torch.bfloat16), main_path(config, torch.float32)]
    train_runs = [train_path(config, "bfloat16"), train_path(config, None)]
    lap("main")
    with tempfile.TemporaryDirectory(prefix="monkeynet_smoke_") as work:
        loop = train_loop_phase(Path(work))
        lap("loop")
        evals = eval_phase(loop["checkpoint"], Path(work), smi)
        lap("eval")
    with tempfile.TemporaryDirectory(prefix="monkeynet_smoke_") as work:
        dispatch = dispatch_phase(Path(work), smi)
    lap("dispatch")
    with tempfile.TemporaryDirectory(prefix="monkeynet_smoke_") as work:
        sharded = parallel_launches(parallel_phase(Path(work), smi))
    lap("parallel")
    with tempfile.TemporaryDirectory(prefix="monkeynet_smoke_") as work:
        jaxckpt = jaxckpt_phase(Path(work), smi)
    lap("jaxckpt")
    log({"phase": "seconds", **seconds})
    # every run of a path launched the same counts (checked above); report the
    # bf16 runs' counts, the setting both the benchmark and the config use
    print(json.dumps(kernels_line(summary, runs[0]["launches"], train_runs[0]["launches"],
                                  loop["launches"], evals["eval_launches"],
                                  dispatch["actions"]["launches"], sharded,
                                  jaxckpt["launches"])), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
