"""The port's benchmark on one card: transfer frames/s, train steps/s and the
sustained train loop's steps/s, with FLOPs and MFU.

    python -m monkeynet_tpu_torch.bench
    python -m monkeynet_tpu_torch.bench loader --config configs/actions.yaml \\
        --batches 50 --workers 4 [--batch_size N]

Counterpart of the repository's bench.py (the JAX package's benchmark),
with its constants, its model, weights and inputs, and its JSON line:

- **Model and weights**: configs/taichi.yaml's networks as the JAX package's
  `init_models(config, PRNGKey(0), (64, 64, 3))` draws them, here without
  JAX (utils/flax_init.py `init_models_variables`), mapped into the port by
  `from_jax_variables`. So the keypoints, the flow grids and the kernels'
  access patterns are the ones bench.py timed.
- **Transfer** (the headline): `TransferEngine` at chunk 128, bf16,
  move_location, on numpy `RandomState(0)`'s `rand(1, 1, 64, 64, 3)` source
  and `rand(1, 512, 64, 64, 3)` driving frames, resident on the card. The
  kernels are built first and their seconds reported apart; one warm-up
  pass ("compile": on the card that is cuDNN's plans and the allocator's
  growth), then RUNS passes, each closed by a synchronize; `value` is
  frames over the best pass. The same again in f32 (no TF32) in `extra`.
- **Train step**: `Trainer` on the config's train_params (bf16, Adam, the
  schedule at 100 steps an epoch as bench.py's) at batch 32, fed the
  float32 `RandomState(0)` batch of bench.py (source, then video), resident
  on the card, the same batch every step. `Trainer.run` captures the step in
  a CUDA graph (its eager warm-up steps are undone, so every timed step is a
  replay) and replays it: one step as the warm-up, then 3 blocks of 30
  steps, each closed by one synchronize; the rate is the best block's. The
  eager `Trainer.step` rate (median of 10 synchronised steps after 3) is in
  `extra`.
- **Sustained loop**: `train()` on configs/actions.yaml as shipped (device
  feed, uint8, the step's graph, bf16) over data/actions, 810 steps, no
  checkpoint but the loop's own at epoch 0, stdout sent to stderr. The rate
  is taken from synchronised clocks, not from log.txt (whose rows inside a
  graphed chunk time the host's enqueue): the steps after the loop's first
  chunk over the wall after it (`TrainRun.steps`, `steps_per_dispatch`,
  `wall_s`, `first_chunk_s`). The first chunk holds the first dispatch's
  set-up (the eager warm-up steps and the capture), as bench.py leaves out
  its first log row. `sustained_wall_seconds_incl_compile` is the whole
  call, set-up and cache included.
- **FLOPs**: `torch.utils.flop_counter.FlopCounterMode`, eagerly, once: one
  first transfer chunk (the source and 128 driving frames) divided by 128,
  and one eager train step at batch 32. Only convolutions are counted
  (`aten.convolution` and `aten.convolution_backward`: every layer with
  weights in these networks is a conv). On the CPU the kernels' plain
  versions hold einsums that the counter would see, while on the card the
  kernels are opaque to it; counting the layers alone makes the figure the
  same work on both. Left out: the movement embedding's two batched shift
  products, the plain soft-argmax's products in training, and all
  elementwise work. The port's UpBlock upsamples and then convolves, the
  model formulation bench.py recovers with MONKEYNET_FUSED_UPCONV=0, so
  `train_gflop_per_step_measured` and `train_hw_gflop_per_step_executed`
  carry the same count. MFU = rate x FLOPs / the card's bf16 dense peak,
  from a table keyed by `torch.cuda.get_device_name()`; a card not in the
  table gets MFU null and a `peak_source` that says so.
- **Launches**: each kernel's launches per transfer pass and per train step,
  from the wrappers' counters. On the card a wrapper launches its kernel or
  raises; a pass or step that launched none of a kernel its path runs (a
  plain version in its place) fails the bench.

The last line of stdout is one JSON object, {"metric", "value", "unit",
"vs_baseline", "extra"}; everything else goes to stderr. Without a card it
raises and prints no line. `loader` times the host data path alone
(scripts/bench_loader.py's counterpart): the port's `FramesDataset` and
`DataLoader`, one warm batch, then `--batches` batches, re-iterating
epochs; it runs on the CPU and prints one line.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from monkeynet_tpu_torch.ops.cuda import launch_counts
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.flax_init import init_models_variables

REPO = Path(__file__).resolve().parents[1]
V100_EST_FPS = 100.0
CHUNK = 128
N_FRAMES = 512
H = W = 64
RUNS = 5
TRAIN_BATCH = 32
TRAIN_STEPS = 30
TRAIN_BLOCKS = 3
EAGER_WARMUP = 3
EAGER_STEPS = 10
SUSTAINED_STEPS = 810
# bench.py's schedule: multistep_lr(lr, epoch_milestones, 100)
TRAIN_STEPS_PER_EPOCH = 100
# bf16 dense peak FLOP/s by torch.cuda.get_device_name(); NVIDIA's data
# sheet, SXM part, at the full 700 W power limit.
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
TRANSFER_KERNELS = ("warp", "combine", "softargmax", "heatmap")
TRAIN_KERNELS = ("warp", "warp_dsrc", "warp_dgrid", "combine")
CONV_OPS = ("aten.convolution", "aten.convolution_backward")


@dataclasses.dataclass
class Sizes:
    """The bench's sizes; the defaults are bench.py's. Tests shrink them."""

    n_frames: int = N_FRAMES
    chunk: int = CHUNK
    runs: int = RUNS
    hw: int = H
    batch: int = TRAIN_BATCH
    train_steps: int = TRAIN_STEPS
    train_blocks: int = TRAIN_BLOCKS
    eager_warmup: int = EAGER_WARMUP
    eager_steps: int = EAGER_STEPS
    sustained_steps: int = SUSTAINED_STEPS


def transfer_inputs(n_frames: int = N_FRAMES, hw: int = H, channels: int = 3):
    """bench.py's transfer inputs: RandomState(0)'s source frame, then its
    driving frames, f32 in [0, 1)."""
    rng = np.random.RandomState(0)
    source = rng.rand(1, 1, hw, hw, channels).astype(np.float32)
    driving = rng.rand(1, n_frames, hw, hw, channels).astype(np.float32)
    return source, driving


def train_batch(batch: int = TRAIN_BATCH, hw: int = H, channels: int = 3) -> Dict[str, np.ndarray]:
    """bench.py's train batch: RandomState(0)'s 'source', then its 'video',
    f32 in [0, 1)."""
    rng = np.random.RandomState(0)
    source = rng.rand(batch, 1, hw, hw, channels).astype(np.float32)
    video = rng.rand(batch, 1, hw, hw, channels).astype(np.float32)
    return {"source": source, "video": video}


def load_variables(models: Dict[str, torch.nn.Module], variables) -> None:
    """Load (params, batch_stats), flax trees as `init_models_variables`
    gives them, into the port's networks."""
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    params, batch_stats = variables
    for name, model in models.items():
        model.load_state_dict(from_jax_variables(params[name], batch_stats.get(name, {})))


def conv_flops(fn) -> int:
    """FLOPs of the convolutions (forward and backward) that fn() runs, by
    FlopCounterMode's rules: 2 x multiply-adds of the forward; in the
    backward the input's gradient as much as the forward where the input
    needs one, and the weight's gradient as much times groups where the
    weight needs one."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return sum(n for op, n in counter.get_flop_counts().get("Global", {}).items()
               if str(op) in CONV_OPS)


def peak_flops(kind: str):
    """(bf16 dense peak FLOP/s or None, where it comes from)."""
    if kind in BF16_PEAK_FLOPS:
        return BF16_PEAK_FLOPS[kind], f"{kind}: NVIDIA data sheet, SXM, bf16 dense, 700 W"
    return None, f"no bf16 peak known for {kind!r}: MFU not computed"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


def check_launches(label: str, counts: Dict[str, int], path_kernels) -> None:
    """On the card every kernel of the path launched, and none other."""
    bad = {k: n for k, n in counts.items() if (n > 0) != (k in path_kernels)}
    if bad:
        raise AssertionError(f"{label}: kernel launches {counts}; the path runs exactly "
                             f"{list(path_kernels)} (a plain version in a kernel's place "
                             "launches none)")


def _peak_gb(device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _spread_pct(times) -> float:
    return round(100.0 * (max(times) - min(times)) / min(times), 1)


def bench_transfer(config, variables, dtype=torch.bfloat16, device="cuda",
                   sizes: Sizes = Sizes()) -> dict:
    """TransferEngine frames/s over `sizes.runs` passes after one warm-up,
    with launches per pass, peak memory and the conv FLOPs per frame of one
    first chunk."""
    from monkeynet_tpu_torch.tasks.animate import TransferEngine
    from monkeynet_tpu_torch.tasks.build import build_models

    device = require_device(device)
    generator, kp_detector = build_models(config, device=device)
    load_variables({"generator": generator, "kp_detector": kp_detector}, variables)
    engine = TransferEngine(generator, kp_detector, chunk=sizes.chunk, dtype=dtype,
                            move_location=True, device=device)
    channels = config["model_params"]["common_params"]["num_channels"]
    source, driving = (torch.from_numpy(a).to(device)
                       for a in transfer_inputs(sizes.n_frames, sizes.hw, channels))
    _sync(device)
    _reset_peak(device)

    def one_pass():
        before = launch_counts()
        t0 = time.perf_counter()
        out = engine(source, driving)
        _sync(device)
        return time.perf_counter() - t0, _delta(before), out

    compile_s, _, out = one_pass()
    pred = out["video_prediction"]
    if tuple(pred.shape) != tuple(driving.shape) or not torch.isfinite(pred).all():
        raise AssertionError(f"transfer: bad video_prediction {tuple(pred.shape)}")
    del out, pred
    times, launches = [], []
    for _ in range(sizes.runs):
        seconds, counts, _ = one_pass()
        times.append(seconds)
        launches.append(counts)
    if any(c != launches[0] for c in launches):
        raise AssertionError(f"transfer: launches differ between passes: {launches}")
    if device.type == "cuda":
        check_launches(f"transfer {dtype}", launches[0], TRANSFER_KERNELS)
    peak = _peak_gb(device)
    flops = conv_flops(lambda: engine(source, driving[:, :sizes.chunk])) / sizes.chunk
    best = min(times)
    return {
        "fps": sizes.n_frames / best,
        "fps_median": round(sizes.n_frames / float(np.median(times)), 2),
        "spread_pct": _spread_pct(times),
        "n_runs": sizes.runs,
        "compile_seconds": round(compile_s, 1),
        # a warm-up many times a steady pass: this process paid for plans
        # and allocations; close to one: nothing was left to pay
        "compile_cache": "cold" if compile_s > 5 * best + 5 else "warm",
        "run_seconds": times,
        "peak_mem_gb": peak,
        "launches_per_pass": launches[0],
        "flops_per_frame": flops,
    }


def bench_train(config, variables, device="cuda", sizes: Sizes = Sizes()) -> dict:
    """Trainer at the config's train_params on bench.py's batch: replays of
    the step's CUDA graph in `train_blocks` blocks of `train_steps`, then
    eager steps; launches per step, peak memory and the conv FLOPs of one
    eager step."""
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer

    device = require_device(device)
    channels = config["model_params"]["common_params"]["num_channels"]
    data = {k: torch.from_numpy(v).to(device)
            for k, v in train_batch(sizes.batch, sizes.hw, channels).items()}

    def trainer():
        models = build_train_models(config, device=device)
        load_variables(models, variables)
        return Trainer(models, config["train_params"], device=device,
                       steps_per_epoch=TRAIN_STEPS_PER_EPOCH)

    # the same batch every step, as bench.py feeds it
    chunk = {k: v.unsqueeze(0).expand(sizes.train_steps, *v.shape) for k, v in data.items()}
    _sync(device)
    _reset_peak(device)
    graphed = trainer()
    t0 = time.perf_counter()
    graphed.run(chunk, 0, 1)  # capture (its warm-up steps undone) and one replay
    _sync(device)
    warmup_s = time.perf_counter() - t0
    rates = []
    for _ in range(sizes.train_blocks):
        t0 = time.perf_counter()
        metrics, _ = graphed.run(chunk, 0, sizes.train_steps)
        _sync(device)
        rates.append(sizes.train_steps / (time.perf_counter() - t0))
    if not torch.isfinite(metrics).all():
        raise AssertionError(f"train: non-finite metrics {metrics.tolist()}")
    captured = dict(graphed.graph_stats["captured"]) if device.type == "cuda" else None
    graph_peak = _peak_gb(device)
    del graphed, metrics

    eager = trainer()
    flops = conv_flops(lambda: eager.step(data))  # the first warm-up step
    for _ in range(sizes.eager_warmup - 1):
        eager.step(data)
    _sync(device)
    _reset_peak(device)
    before = launch_counts()
    times = []
    for _ in range(sizes.eager_steps):
        t0 = time.perf_counter()
        eager.step(data)
        _sync(device)
        times.append(time.perf_counter() - t0)
    counts = _delta(before)
    per_step = {k: n // sizes.eager_steps for k, n in counts.items()}
    if device.type == "cuda":
        if any(n % sizes.eager_steps for n in counts.values()):
            raise AssertionError(f"train: {counts} launches over {sizes.eager_steps} steps")
        check_launches("eager train step", per_step, TRAIN_KERNELS)
        check_launches("captured train step", captured, TRAIN_KERNELS)
    eager_peak = _peak_gb(device)
    del eager
    return {
        "steps_per_sec": max(rates),
        "spread_pct": _spread_pct(rates),
        "block_rates": rates,
        "warmup_seconds": warmup_s,
        "eager_steps_per_sec": 1.0 / float(np.median(times)),
        "eager_step_seconds": times,
        "launches_per_step": per_step,
        "captured_launches": captured,
        "graph_peak_mem_gb": graph_peak,
        "eager_peak_mem_gb": eager_peak,
        "flops_per_step": flops,
    }


def bench_sustained(config, dataset, device="cuda", steps: int = SUSTAINED_STEPS,
                    seed: int = 0) -> dict:
    """train() on `config` over `dataset` for about `steps` steps (whole
    epochs), checkpoints off past epoch 0, stdout to stderr; the rate of the
    steps after the first chunk over the wall after it."""
    from monkeynet_tpu_torch.tasks.train_loop import train

    device = require_device(device)
    config = copy.deepcopy(config)
    tp = config["train_params"]
    steps_per_epoch = max(1, len(dataset) // tp["batch_size"])
    tp["num_epochs"] = max(1, steps // steps_per_epoch)
    tp.setdefault("log_params", {})["cpk_freq_epoch"] = 10**9
    with tempfile.TemporaryDirectory(prefix="monkeynet_bench_") as log_dir:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            run = train(config, log_dir, dataset, seed=seed, device=device)
        wall = time.perf_counter() - t0
    after = run.steps - run.steps_per_dispatch
    if after <= 0:
        raise ValueError(f"sustained: {run.steps} steps in chunks of {run.steps_per_dispatch} "
                         "leave nothing after the first chunk")
    rate = after / (run.wall_s - run.first_chunk_s)
    if not (np.isfinite(rate) and rate > 0) or not torch.isfinite(run.last_metrics).all():
        raise AssertionError(f"sustained: rate {rate}, last metrics {run.last_metrics}")
    return {
        "sustained_steps_per_sec_actions": round(rate, 2),
        "sustained_loop_steps": run.steps,
        "sustained_wall_seconds_incl_compile": round(wall, 1),
        "sustained_detail": {
            "steps_per_sec": rate, "loop_wall_s": run.wall_s,
            "first_chunk_s": run.first_chunk_s, "steps_per_dispatch": run.steps_per_dispatch,
            "device_feed": run.device_feed, "cache_s": run.cache_s,
            "loader_wait_s": run.loader_wait_s,
            "steps_per_sec_incl_first_chunk": run.steps / run.wall_s,
        },
    }


def _repo_path(path) -> str:
    """`path` as given where it exists, else under the repository."""
    path = Path(path)
    return str(path if path.is_absolute() or path.exists() else REPO / path)


def _dataset(config):
    from monkeynet_tpu_torch.data.dataset import FramesDataset

    params = dict(config["dataset_params"], root_dir=_repo_path(config["dataset_params"]["root_dir"]))
    return FramesDataset(is_train=True, **params)


def _load(path):
    from monkeynet_tpu_torch.utils.config import load_config

    return load_config(_repo_path(path))


def full_f32() -> None:
    """f32 means f32: no TF32 in convolutions or matrix products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _nvidia_smi() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def headline(fps: float) -> dict:
    """The line's head, as bench.py prints it: `value` and `vs_baseline` are
    each one rounding of the unrounded rate, so `vs_baseline` need not equal
    `round(value / V100_EST_FPS, 3)`."""
    return {
        "metric": "transfer_frames_per_sec_per_chip_taichi64",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / V100_EST_FPS, 3),
    }


def run(config, sustained_config, sustained_dataset, device="cuda",
        sizes: Sizes = Sizes()) -> dict:
    """The whole bench; returns the JSON line as a dict."""
    device = require_device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    build_s = None
    if device.type == "cuda":
        full_f32()
        from monkeynet_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
    peak, peak_source = peak_flops(kind)
    channels = config["model_params"]["common_params"]["num_channels"]
    variables = init_models_variables(config, (sizes.hw, sizes.hw, channels))
    transfer = bench_transfer(config, variables, torch.bfloat16, device, sizes)
    transfer_f32 = bench_transfer(config, variables, torch.float32, device, sizes)
    train = bench_train(config, variables, device, sizes)
    sustained = bench_sustained(sustained_config, sustained_dataset, device,
                                sizes.sustained_steps)

    def mfu(rate, flops):
        return None if peak is None else round(rate * flops / peak, 4)

    fps, sps = transfer["fps"], train["steps_per_sec"]
    step_gflop = round(train["flops_per_step"] / 1e9, 2)
    extra = {
        "device_kind": kind,
        "train_steps_per_sec_taichi_b32": round(sps, 2),
        "train_spread_pct": train["spread_pct"],
        **{k: v for k, v in sustained.items() if k != "sustained_detail"},
        **{k: transfer[k] for k in ("fps_median", "spread_pct", "n_runs", "compile_seconds",
                                    "compile_cache")},
        "transfer_gflop_per_frame_measured": round(transfer["flops_per_frame"] / 1e9, 2),
        "transfer_flops_per_frame": transfer["flops_per_frame"],
        "train_flops_per_step": train["flops_per_step"],
        "transfer_mfu_vs_bf16_peak": mfu(fps, transfer["flops_per_frame"]),
        # one count: the port's UpBlock is the model formulation (upsample,
        # then conv), so what runs is what the model defines
        "train_hw_gflop_per_step_executed": step_gflop,
        "train_hw_mfu_vs_bf16_peak": mfu(sps, train["flops_per_step"]),
        "train_gflop_per_step_measured": step_gflop,
        "train_mfu_vs_bf16_peak": mfu(sps, train["flops_per_step"]),
        "nvidia_smi": _nvidia_smi() if device.type == "cuda" else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "peak_flops_bf16": peak,
        "peak_source": peak_source,
        "flop_count": "FlopCounterMode, convolutions only (aten.convolution, "
                      "aten.convolution_backward): one first transfer chunk / chunk, one "
                      "eager train step",
        "kernel_build_seconds": build_s,
        "transfer_peak_mem_gb": transfer["peak_mem_gb"],
        "transfer_launches_per_pass": transfer["launches_per_pass"],
        "transfer_run_seconds": transfer["run_seconds"],
        "transfer_f32": {
            "fps": transfer_f32["fps"],
            **{k: transfer_f32[k] for k in ("fps_median", "spread_pct", "n_runs",
                                            "compile_seconds", "compile_cache", "run_seconds",
                                            "peak_mem_gb", "launches_per_pass")},
            "mfu_vs_bf16_peak": mfu(transfer_f32["fps"], transfer_f32["flops_per_frame"]),
        },
        "train_block_rates": train["block_rates"],
        "train_warmup_seconds": train["warmup_seconds"],
        "train_eager_steps_per_sec": train["eager_steps_per_sec"],
        "train_eager_step_seconds": train["eager_step_seconds"],
        "train_launches_per_step": train["launches_per_step"],
        "train_captured_launches": train["captured_launches"],
        "train_graph_peak_mem_gb": train["graph_peak_mem_gb"],
        "train_eager_peak_mem_gb": train["eager_peak_mem_gb"],
        "sustained_detail": sustained["sustained_detail"],
        "sizes": dataclasses.asdict(sizes),
    }
    return {**headline(fps), "extra": extra}


def loader_rate(config_path, batches: int = 50, workers: int = 4,
                batch_size: Optional[int] = None) -> dict:
    """Batches/s of the host data path: decode, augmentation, collate."""
    from monkeynet_tpu_torch.data.loader import DataLoader

    config = _load(config_path)
    dataset = _dataset(config)
    bs = batch_size or config["train_params"]["batch_size"]
    loader = DataLoader(dataset, batch_size=bs, shuffle=True, num_workers=workers)
    # one warm batch (cache fill, threads), then `batches`, re-iterating the
    # loader across epochs (actions: one batch an epoch)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = 0
    while n < batches:
        for _ in it:
            n += 1
            if n >= batches:
                break
        else:
            it = iter(loader)
    dt = time.perf_counter() - t0
    return {"batches_per_s": n / dt, "items_per_s": n * bs / dt, "ms_per_batch": dt / n * 1e3,
            "batch_size": bs, "workers": workers, "batches": n}


def loader_line(rate: dict) -> str:
    return (f"loader: {rate['batches_per_s']:.2f} batches/s ({rate['items_per_s']:.1f} items/s) "
            f"at batch_size={rate['batch_size']} workers={rate['workers']} "
            f"({rate['ms_per_batch']:.1f} ms/batch)")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="The port's benchmark on one card.")
    parser.add_argument("mode", nargs="?", default="bench", choices=("bench", "loader"),
                        help="bench: the JSON line on the card; loader: the host data path")
    parser.add_argument("--config", default="configs/shapes.yaml", help="loader: config yaml")
    parser.add_argument("--batches", type=int, default=50, help="loader: batches timed")
    parser.add_argument("--workers", type=int, default=4, help="loader: worker threads")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="loader: batch size (default: the config's)")
    args = parser.parse_args(argv)
    if args.mode == "loader":
        print(loader_line(loader_rate(args.config, args.batches, args.workers,
                                      args.batch_size)), flush=True)
        return 0
    require_device("cuda")
    with contextlib.redirect_stdout(sys.stderr):
        sustained_config = _load("configs/actions.yaml")
        line = run(_load("configs/taichi.yaml"), sustained_config, _dataset(sustained_config))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
