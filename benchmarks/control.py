"""Readings that the limits of `correct` are set from: the control and the
planted faults, at a cell's own size.

    python3 -m benchmarks.control --workload <cell> --seeds 1 2 3 [--out FILE]
    python3 -m benchmarks.control --workload <cell> --seeds 1 .. 12 --program-seconds 3

The second form reads the program's own numbers, a short run a seed in one
process: the lower readings.

The control is the reference put in the program's place and computed one
precision below the configuration's bfloat16: every layer's tensors in float8
e4m3 with a per-tensor scale (benchmarks/reference/model.py). It is compared
with the float32 reference exactly as a run compares the program, so its
numbers are the upper readings. For a train cell the planted fault
'half_batch' (each loss mean taken over half of the batch) is read the same
way, and so is the reference with its tensors rounded to bfloat16, a second
witness of what the configuration's rounding alone reads; a state left
unchanged reads 1 by `delta_gap_median` and needs no run. Each seed prints
one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from benchmarks import check, frames, harness, weights
from benchmarks.drive import transfer as transfer_traffic


def transfer_readings(config, traffic, seed, device, videos=None):
    """{'fp8': numbers} of the control on the traffic's videos: `videos`
    (default the traffic's check_videos) drawn from its lengths, and the
    longest."""
    H, W = config["image_size"]
    mp = config["model_params"]
    order = transfer_traffic.lengths(traffic, seed)
    k = traffic["check_videos"] if videos is None else videos
    chosen = order[:k] + [max(order)]
    clip_len = traffic["max_frames"] + traffic["max_frames"] // 4
    pool = frames.clips(traffic["pool_clips"], clip_len, (H, W), seed * 16 + 1, device)
    state = weights.draw(mp, seed * 16 + 2, pool[0, :16])
    host = pool.cpu()
    rng = np.random.default_rng(seed)
    f32 = check.reference_nets(mp, state, device)
    fp8 = check.reference_nets(mp, state, device, precision="fp8")
    pairs = []
    for n in chosen:
        c = int(rng.integers(0, traffic["pool_clips"]))
        start = int(rng.integers(0, clip_len - n + 1))
        source = host[1 - c if traffic["pool_clips"] > 1 else c, 0][None, None]
        driving = host[c, start:start + n][None]
        pairs.append((check.reference_transfer(fp8, source, driving, device),
                      check.reference_transfer(f32, source, driving, device)))
    return {"fp8": check.transfer_numbers(pairs)}


def train_readings(config, traffic, seed, device):
    """{'fp8': numbers, 'half_batch': numbers, 'bf16': numbers} of three
    steps of the cell's batch: the control, the planted fault, and the
    reference with each layer's tensors rounded to the configuration's
    bfloat16 (a second witness of what rounding alone reads)."""
    H, W = config["image_size"]
    mp, tp = config["model_params"], config["train_params"]
    B = tp["batch_size"]
    pool = frames.clips(traffic["pool_clips"], traffic["clip_frames"], (H, W), seed * 16 + 1,
                        device)
    state = weights.draw(mp, seed * 16 + 2, pool[0, :16])
    pool = frames.to_uint8(pool)
    gen = torch.Generator(device=device).manual_seed(seed * 16 + 3)
    batches = []
    for _ in range(3):
        clip = torch.randint(0, traffic["pool_clips"], (B,), generator=gen, device=device)
        pair = torch.randint(0, traffic["clip_frames"], (2, B), generator=gen, device=device)
        batches.append({"source": pool[clip, pair[0]][:, None].cpu(),
                        "video": pool[clip, pair[1]][:, None].cpu()})
    del pool
    ref = check.reference_train(mp, tp, state, batches, device)
    out = {}
    for name, kwargs in (("fp8", {"precision": "fp8"}), ("half_batch", {"half_batch": True}),
                         ("bf16", {"precision": "bf16"})):
        other = check.reference_train(mp, tp, state, batches, device, **kwargs)
        out[name] = check.train_numbers(*other, *ref)
    return out


def readings(spec, cell_name, seed, device):
    cell = spec.cell(cell_name)
    config, traffic = spec.config(cell), spec.traffic(cell)
    if traffic["kind"] == "transfer":
        return transfer_readings(config, traffic, seed, device)
    return train_readings(config, traffic, seed, device)


def program_readings(root, cell_name, seed, seconds, device):
    """The numbers of one run of the program (run.drive, not traced), with
    the numbers that are read but not compared."""
    from benchmarks import run

    line, _, notes = run.drive(root, cell_name, seed, seconds, 0, device)
    numbers = {}
    for text in notes:
        if text.startswith("reading "):
            _, name, value = text.split(" ", 2)
            numbers[name] = float(value)
    return {"program": numbers, "correct": json.loads(line)["correct"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program-seconds", type=float, default=0.0,
                        help="run the program on each seed for this long instead (one process)")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    check.set_float32_exact()
    root = Path.cwd()
    spec = harness.Spec(root)
    lines = []
    for seed in args.seeds:
        found = {"cell": args.workload, "seed": seed}
        if args.program_seconds:
            found.update(program_readings(root, args.workload, seed, args.program_seconds,
                                          "cuda"))
        else:
            found.update(readings(spec, args.workload, seed, torch.device("cuda")))
        line = json.dumps(found)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
