#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's taichi-64^2 paths.

    python3 scripts/profile_torch_port.py [--path transfer|train|train_graph]
        [--dtype bf16|f32] [--frames 256] [--batch 32]
        [--config configs/taichi.yaml] [--steps 30]

Builds the config's networks (configs/taichi.yaml by default; random
weights from a seed). With `--path transfer` it runs TransferEngine once to
warm up and traces one more call; with `--path train` it takes three train
steps with Trainer (Adam, uint8 batches made on the card) and traces a
fourth; with `--path train_graph` it trains as train() does with the
config's own train_params (its batch, dtype and feed): Trainer.run captures
the step in a CUDA graph over a warm-up chunk, and one chunk of `--steps`
replays is traced, its batches made on the card by the device feed from the
config's dataset where the config sets `device_feed`, else uint8 batches
made on the card (`--dtype` does not apply). The trace comes from
torch.profiler (CPU and CUDA activities). Prints one JSON object: the top
kernels by device time, device time grouped by kind (convolution, the port's
kernels, elementwise, ...: the kinds of benchmarks/kernels.py, which the
benchmark's readers use), and the device's busy share of the traced window. Needs one CUDA card; exits non-zero if the trace holds no device
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def summarize(device_events, wall_us: float) -> dict:
    """device_events: (name, start_us, end_us) of every device activity."""
    from benchmarks import kernels, trace

    by_name = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(float)
    for name, s, e in device_events:
        by_name[name][0] += e - s
        by_name[name][1] += 1
        by_kind[kernels.kind_of(name)] += e - s
    total = sum(v[0] for v in by_name.values())
    start = min(s for _, s, _ in device_events)
    stop = max(e for _, _, e in device_events)
    busy = trace.union([(s, e) for _, s, e in device_events])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    # the port's own kernels, each with its time inside this run: what a
    # kernel takes where the path calls it, beside chip_smoke.py's times of
    # the same kernel alone
    port = defaultdict(lambda: [0.0, 0])
    for name, (us, calls) in by_name.items():
        kernel = kernels.port_kernel(name)
        if kernel:
            port[kernel][0] += us
            port[kernel][1] += calls
    return {
        "device_time_us": total,
        "device_window_us": stop - start,
        "busy_share_of_device_window": busy / (stop - start),
        "host_wall_us": wall_us,
        "busy_share_of_host_wall": busy / wall_us,
        "by_kind_us": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "by_kind_share": {k: v / total for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "port_kernels": [{"name": n, "us": v[0], "calls": v[1], "us_per_call": v[0] / v[1]}
                         for n, v in sorted(port.items())],
        "top_kernels": [{"name": n[:120], "us": v[0], "calls": v[1]} for n, v in top],
    }


def graphed_chunk(config, steps: int, gen):
    """(run, shape): run() takes one chunk of `steps` replays of the step's
    CUDA graph at the config's train_params, after a warm-up chunk that
    captured it."""
    import numpy as np
    import torch

    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer

    tp = config["train_params"]
    batch = tp["batch_size"]
    trainer = Trainer(build_train_models(config, device="cuda", seed=0), tp, device="cuda",
                      steps_per_epoch=100)
    augment = None
    if tp.get("device_feed"):
        from monkeynet_tpu_torch.data.dataset import FramesDataset
        from monkeynet_tpu_torch.data.device_feed import (
            build_video_cache, make_device_augment, plan_stream)

        params = dict(config["dataset_params"],
                      root_dir=str(REPO / config["dataset_params"]["root_dir"]))
        dataset = FramesDataset(is_train=True, **params)
        videos, lengths = build_video_cache(dataset)
        cache = torch.from_numpy(videos).cuda()
        execute = make_device_augment(dataset.transform, dataset.image_shape)
        plans = []
        for _, plan in plan_stream(dataset, dataset.transform, lengths, batch, 0, 0, 2 * steps):
            plans.append(plan)
            if len(plans) == 2 * steps:
                break
        chunk = {k: torch.from_numpy(np.stack([p[k] for p in plans])).cuda() for k in plans[0]}

        def augment(plan):
            return execute(cache, plan)
    else:
        h, w, c = config["dataset_params"].get("image_shape", (64, 64, 3))
        chunk = {k: torch.randint(0, 256, (2 * steps, batch, 1, h, w, c), dtype=torch.uint8,
                                  generator=gen).cuda() for k in ("source", "video")}
    trainer.run(chunk, 0, steps, augment=augment)

    def run():
        trainer.run(chunk, steps, 2 * steps, augment=augment)

    return run, {"batch": batch, "steps": steps, "device_feed": augment is not None,
                 "compute_dtype": tp.get("compute_dtype") or "float32"}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("transfer", "train", "train_graph"),
                        default="transfer")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--frames", type=int, default=256, help="transfer: driving frames")
    parser.add_argument("--chunk", type=int, default=128, help="transfer: frames per chunk")
    parser.add_argument("--batch", type=int, default=32, help="train: batch size")
    parser.add_argument("--config", default="configs/taichi.yaml")
    parser.add_argument("--steps", type=int, default=30, help="train_graph: steps traced")
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_port: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from monkeynet_tpu_torch.utils.config import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = load_config(str(REPO / args.config))
    gen = torch.Generator().manual_seed(0)
    if args.path == "transfer":
        from monkeynet_tpu_torch.tasks.animate import TransferEngine
        from monkeynet_tpu_torch.tasks.build import build_models

        dtype = torch.bfloat16 if args.dtype == "bf16" else None
        generator, kp_detector = build_models(config, device="cuda", seed=0)
        engine = TransferEngine(generator, kp_detector, chunk=args.chunk, dtype=dtype,
                                device="cuda")
        source = torch.rand(1, 1, 64, 64, 3, generator=gen).cuda()
        driving = torch.rand(1, args.frames, 64, 64, 3, generator=gen).cuda()
        shape = {"frames": args.frames, "chunk": args.chunk}

        def run():
            engine(source, driving)

        run()
    elif args.path == "train_graph":
        run, shape = graphed_chunk(config, args.steps, gen)
    else:
        from monkeynet_tpu_torch.tasks.build import build_train_models
        from monkeynet_tpu_torch.tasks.train import Trainer

        train_params = dict(config["train_params"],
                            compute_dtype="bfloat16" if args.dtype == "bf16" else None)
        trainer = Trainer(build_train_models(config, device="cuda", seed=0), train_params,
                          device="cuda", steps_per_epoch=100)
        batch = {k: torch.randint(0, 256, (args.batch, 1, 64, 64, 3), dtype=torch.uint8,
                                  generator=gen).cuda() for k in ("source", "video")}
        shape = {"batch": args.batch}

        def run():
            trainer.step(batch)

        for _ in range(3):
            run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        # device-side spans of host annotations (the optimizer's step) cover
        # kernels that are counted themselves
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Optimizer.")
    ]
    if not events:
        print("profile_torch_port: the trace holds no device events", file=sys.stderr)
        return 1
    result = summarize(events, wall_us)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    result.update({"path": args.path, "config": args.config, "dtype": args.dtype, **shape,
                   "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
