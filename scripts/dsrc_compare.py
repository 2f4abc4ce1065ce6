#!/usr/bin/env python3
"""The warp d_src kernel of two checkouts, side by side on one card.

    python3 scripts/dsrc_compare.py PARENT_ROOT CHANGE_ROOT [--order 0,1,1,0] [--steps 10]

Each root is a checkout's directory with its monkeynet_tpu_torch/ and
chip_smoke.py (one unpacked from `git archive` will do: a checkout of an
older commit needs only those two). Each run, in the order given (by
default parent, change, change, parent), is a process of its own that
imports that root's package and chip_smoke.py, builds its kernels into
that root, and measures, the data and configs coming from this checkout:

- d_src at the 64 x 128^2 encoder skip of the 256^2 configs' train step
  (batch 20, whatever plan the root's dsrc_plan takes there), f32 and bf16,
  on a random grid off the integers, a flow near the identity and a
  contracting grid (a batch element's points in one cell): held
  against the plain version, timed L2-warm (chip_smoke.time_ms); beside it
  F.grid_sample's backward for the input alone in the same dtype;
- d_src at the five d_src shapes of the taichi-64^2 train step (batch 32,
  'shared'), f32 and bf16, timed L2-warm and summed as a step calls them;
- unless --steps 0, the graphed remat step of configs/shapes-256.yaml as
  shipped (chip_smoke.py phase 7 (d)'s setup: the first 64 train videos of
  data/shapes256 on the device feed, the step's CUDA graph): the wall of
  `--steps` replays after the capture's chunk, synchronised, over the
  steps.

Prints one JSON line a run, then one with each root's mean of each number
over its runs and the change's mean over the parent's, then the card's name
and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SKIP = (20, 128, 64)  # batch, size, channels
TAICHI = ((64, 32), (128, 16), (256, 8), (512, 4), (1024, 2))


def measure(root: Path, steps: int) -> dict:
    """The numbers of one run, with `root`'s package and chip_smoke.py."""
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from monkeynet_tpu_torch.ops.cuda import warp
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    chip_smoke.REPO = REPO  # data and configs from this checkout
    chip_smoke.full_f32()
    gen = torch.Generator().manual_seed(13)
    B, h, C = SKIP
    shape = (B, h, h, C)
    grids = {"random": chip_smoke.grid_off_integers(B, h, gen).cuda(),
             "near_identity": (make_coordinate_grid((h, h))[None] + torch.rand(
                 B, h, h, 2, generator=gen) / (h - 1)).contiguous().cuda(),
             "contracting": chip_smoke._contracting_grid(B, h, gen).cuda()}
    out = {"root": str(root)}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        dout = torch.randn(shape, generator=gen).to("cuda", dtype)
        out[f"skip_plan_{tag}"] = warp.dsrc_plan(B, h * h, C, dtype, True, (h, h)).variant
        for name, grid in grids.items():
            ref = warp.warp_dsrc_plain(grid, dout.float(), shape)
            chip_smoke.check(f"{root} d_src {name} {tag}",
                             chip_smoke.max_err(warp.warp_dsrc(grid, dout, shape), ref),
                             chip_smoke._warp_tol(ref, rounded=dtype == torch.bfloat16))
            out[f"skip_{name}_{tag}_ms"] = chip_smoke.time_ms(
                lambda g=grid: warp.warp_dsrc(g, dout, shape))
            nchw = dout.new_zeros(B, C, h, h)
            d_nchw = dout.permute(0, 3, 1, 2)
            lib_grid = grid.to(dtype)

            def library():
                image = nchw.detach().requires_grad_(True)
                return torch.autograd.grad(F.grid_sample(image, lib_grid, align_corners=True,
                                                         padding_mode="zeros"), [image], d_nchw)

            forward = chip_smoke.time_ms(lambda: F.grid_sample(
                nchw, lib_grid, align_corners=True, padding_mode="zeros"))
            out[f"skip_{name}_{tag}_library_ms"] = chip_smoke.time_ms(library) - forward
        total = 0.0
        for C2, h2 in TAICHI:
            tshape = (32, h2, h2, C2)
            tgrid = chip_smoke.grid_off_integers(32, h2, gen).cuda()
            tdout = torch.randn(tshape, generator=gen).to("cuda", dtype)
            total += chip_smoke.time_ms(lambda: warp.warp_dsrc(tgrid, tdout, tshape))
        out[f"taichi_step_{tag}_ms"] = total
    if steps:
        out["graph_remat_step_s"] = remat_step_s(chip_smoke, steps)
    return out


def remat_step_s(chip_smoke, steps: int) -> float:
    """The graphed remat step of configs/shapes-256.yaml, as chip_smoke.py
    phase 7 (d) sets it up: seconds a replay over `steps` replays."""
    import torch

    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer
    from monkeynet_tpu_torch.utils.config import load_config

    config = load_config(str(REPO / "configs" / "shapes-256.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes256")
    tp = config["train_params"]
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    dataset.images = dataset.images[:chip_smoke.REMAT_VIDEOS]
    execute, cache, lengths = chip_smoke._device_feed_of(dataset, dataset.image_shape)
    chunk = chip_smoke._plan_chunk(dataset, lengths, tp["batch_size"], 1 + steps)

    def augment(plan):
        return execute(cache, plan)

    trainer = Trainer(build_train_models(config, device="cuda", seed=chip_smoke.SEED), tp,
                      device="cuda", steps_per_epoch=100)
    trainer.run(chunk, 0, 1, augment=augment)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, _ = trainer.run(chunk, 1, 1 + steps, augment=augment)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / steps
    if not torch.isfinite(metrics).all():
        raise AssertionError(f"dsrc_compare: remat metrics {metrics.tolist()}")
    return seconds


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*")
    parser.add_argument("--order", default="0,1,1,0")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dsrc_compare: CUDA is not available", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(measure(Path(args.worker).resolve(), args.steps)), flush=True)
        return 0
    if len(args.roots) != 2:
        parser.error("give two roots: the parent's and the change's")
    runs = []
    for i in (int(k) for k in args.order.split(",")):
        proc = subprocess.run([sys.executable, __file__, "--worker", args.roots[i],
                               "--steps", str(args.steps)],
                              capture_output=True, text=True, timeout=1800)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise RuntimeError(f"dsrc_compare: the run of {args.roots[i]} failed")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["which"] = ("parent", "change")[i]
        runs.append(run)
        print(json.dumps(run), flush=True)
    means = {}
    for which in ("parent", "change"):
        own = [r for r in runs if r["which"] == which]
        means[which] = {k: sum(r[k] for r in own) / len(own)
                        for k, v in own[0].items() if isinstance(v, float)}
    means["change_over_parent"] = {k: means["change"][k] / means["parent"][k]
                                   for k in means["parent"]}
    print(json.dumps(means), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
