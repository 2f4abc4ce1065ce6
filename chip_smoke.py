#!/usr/bin/env python3
"""Smoke run of the PyTorch port (monkeynet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. build every CUDA kernel from monkeynet_tpu_torch/csrc/ (nvcc, sm_90a);
  2. per kernel, at the shapes of the taichi-64^2 transfer (chunk of 128
     frames): the kernel against its plain PyTorch version on the card, with
     times for the kernel, the plain version and, for the warp, F.grid_sample;
  3. slice parity: a 4-frame transfer at taichi width through the kernels on
     the card against the plain versions on the CPU, from one state_dict;
  4. the main path: TransferEngine on configs/taichi.yaml's model at 64^2,
     256 driving frames in chunks of 128, in bf16 and in f32, with every
     kernel's launch count checked against the count the path implies.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back replays, from CUDA
    events.

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
                 if "Used" in line or "Compiling entry" in line]
    log({"phase": "build", "seconds": seconds, "ptxas": usage})
    return seconds


# ---- phase 2 ---------------------------------------------------------------

def _warp_cases(device, gen):
    """The generator's seven warps per chunk: the six encoder skips of the
    taichi model and the source frame, each at the skip's size."""
    import torch

    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    cases = []
    for C, h in ((3, 64), (64, 32), (128, 16), (256, 8), (512, 4), (1024, 2), (3, 64)):
        src = torch.randn(1, h, h, C, generator=gen).to(device)
        ident = make_coordinate_grid((h, h))[None, None].expand(1, CHUNK, h, h, 2)
        grid = ident + 0.1 * torch.randn(1, CHUNK, h, h, 2, generator=gen)
        cases.append((src, grid.reshape(1, CHUNK * h, h, 2).contiguous().to(device)))
    return cases


def kernel_phase(device) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F

    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    gen = torch.Generator().manual_seed(SEED)
    summary = {}

    # warp: f32 and bf16, summed over the seven calls of one chunk
    for dtype, tol_of in ((torch.float32, lambda ref: 1e-5),
                          (torch.bfloat16, lambda ref: 2.0**-8 * ref.abs().max().item())):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "err": 0.0}
        for src, grid in _warp_cases(device, gen):
            src = src.to(dtype)
            B, H, W, C = src.shape
            out = warp.warp(src, grid)
            ref = warp.grid_sample(src.float(), grid)
            err, tol = max_err(out, ref), tol_of(ref)
            check(f"warp {dtype} C={C}", err, tol)
            row = {
                "kernel": "warp", "dtype": str(dtype), "shape": [B, H, W, C],
                "points": grid.shape[1] * grid.shape[2], "max_abs_err": err, "tol": tol,
                "kernel_ms": time_ms(lambda: warp.warp(src, grid)),
                "plain_ms": time_ms(lambda: warp.grid_sample(src, grid)),
                "library_ms": None,
            }
            if dtype == torch.float32:
                nchw = src.permute(0, 3, 1, 2)
                lib = F.grid_sample(nchw, grid, align_corners=True, padding_mode="zeros")
                row["library_err"] = max_err(lib.permute(0, 2, 3, 1), ref)
                check(f"F.grid_sample vs plain C={C}", row["library_err"], 1e-5)
                row["library_ms"] = time_ms(lambda: F.grid_sample(
                    nchw, grid, align_corners=True, padding_mode="zeros"))
                tot["library_ms"] += row["library_ms"]
            log(row)
            n = row["points"]
            tot["ms"] += row["kernel_ms"]
            tot["plain_ms"] += row["plain_ms"]
            tot["bytes"] += src.numel() * src.element_size() + grid.numel() * 4 \
                + n * C * src.element_size()
            tot["flops"] += n * (C * 8 + 20)  # 4 taps x (mul + add) per channel + coords
            tot["err"] = max(tot["err"], err)
        key = "warp" if dtype == torch.float32 else "warp_bf16"
        summary[key] = tot

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

    # softargmax: the kp detector's heatmap logits of a chunk, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        hm = torch.randn(1, CHUNK, HW, HW, 10, generator=gen).to(device, dtype)
        got = softargmax.softargmax_stats(hm, 0.1)
        err = max_err(got, softargmax.softargmax_plain(hm, 0.1))
        check(f"softargmax {dtype}", err, 1e-5)
        row = {
            "kernel": "softargmax", "dtype": str(dtype), "shape": list(hm.shape),
            "max_abs_err": err, "tol": 1e-5,
            "kernel_ms": time_ms(lambda: softargmax.softargmax_stats(hm, 0.1)),
            "plain_ms": time_ms(lambda: softargmax.softargmax_plain(hm, 0.1)),
            "library_ms": None,
        }
        log(row)
        if dtype == torch.float32:
            summary["softargmax"] = {
                "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "library_ms": None,
                "err": err, "bytes": hm.numel() * 4 + CHUNK * 10 * 5 * 4,
                "flops": hm.numel() * 40,  # 4 passes: scale, exp, divide, moments
            }

    # heatmap: the driving keypoints of a chunk, 'matrix' variance, / 100
    mean = (1.8 * torch.rand(1, CHUNK, 10, 2, generator=gen) - 0.9)
    a = 0.1 * torch.randn(1, CHUNK, 10, 2, 2, generator=gen)
    var = a @ a.transpose(-1, -2) + 0.005 * torch.eye(2)
    kp = {"mean": mean.to(device), "var": var.to(device)}
    got = heatmap.heatmap(kp, (HW, HW), "matrix", 100)
    err = max_err(got, heatmap.heatmap_plain(kp, (HW, HW), "matrix", 100))
    check("heatmap", err, 1e-6)
    summary["heatmap"] = {
        "ms": time_ms(lambda: heatmap.heatmap(kp, (HW, HW), "matrix", 100)),
        "plain_ms": time_ms(lambda: heatmap.heatmap_plain(kp, (HW, HW), "matrix", 100)),
        "library_ms": None, "err": err,
        "bytes": got.numel() * 4 + CHUNK * 10 * 6 * 4,
        "flops": got.numel() * 16,
    }
    log({"kernel": "heatmap", "shape": list(got.shape), "max_abs_err": err, "tol": 1e-6,
         "kernel_ms": summary["heatmap"]["ms"], "plain_ms": summary["heatmap"]["plain_ms"],
         "library_ms": None})
    return summary


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

    return {"warp": warp.warp, "combine": combine.combine,
            "softargmax": softargmax.softargmax_stats, "heatmap": heatmap.heatmap}


def expected_launches(n_frames: int, chunk: int) -> dict:
    """Per chunk: seven warps (six skips + the source frame), one combine,
    four heatmaps (driving and source in two embeddings), one soft-argmax;
    plus one soft-argmax for the source frame on the first chunk."""
    chunks = -(-n_frames // chunk)
    return {"warp": 7 * chunks, "combine": chunks, "heatmap": 4 * chunks,
            "softargmax": chunks + 1}


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


def kernels_line(summary: dict, launches: dict) -> dict:
    from monkeynet_tpu_torch.ops.cuda import combine, heatmap, softargmax, warp

    modules = {"warp": warp, "combine": combine, "softargmax": softargmax, "heatmap": heatmap}
    rows = []
    for name, mod in modules.items():
        s = summary[name]
        b_ms, b_by = bound_ms(s["bytes"], s["flops"])
        row = {
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": launches[name], "max_abs_err": s["err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": s["library_ms"],
        }
        if name == "warp":
            bf = summary["warp_bf16"]
            row["bf16"] = {"ms": bf["ms"], "plain_ms": bf["plain_ms"], "max_abs_err": bf["err"],
                           "bound_ms": bound_ms(bf["bytes"], bf["flops"])[0]}
        rows.append(row)
    return {"kernels": rows}


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

    # Full f32 in every f32 comparison and run: no TF32 in convs or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    slice_parity(config)
    runs = [main_path(config, torch.bfloat16), main_path(config, torch.float32)]
    # every run must have launched every kernel; report the bf16 run's counts
    launches = runs[0]["launches"]
    print(json.dumps(kernels_line(summary, launches)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
