#!/usr/bin/env python3
"""The warp d_src kernel's 'binned' plan and its launch options, on one card.

    python3 scripts/dsrc_binned_sweep.py [--reps 20] [--no-options]

At the 64 x 128^2 encoder skip of the 256^2 configs' train step (batch 20,
the shape where ops/cuda/warp.py `dsrc_plan` takes 'binned'), in f32 and
bf16, on three grids (random off the integers, a flow near the identity,
and a contracting grid that puts a batch element's points in one cell):
the planned call held against the plain version and run twice bit for bit,
timed L2-warm (chip_smoke.time_ms); the device time of its three kernels
(binning, sort, gather) from a profiler trace of a few calls;
and, unless --no-options, other launch options (cell rows a sort band,
lanes a quad of the gather, threads a gather block), each held against the
plain version and, bit for bit, against the planned call (no option moves
a pixel's order of summation), and timed on the random and near-identity
grids. Then 'binned'
forced at the taichi train step's (32, 32^2, 64), where 'shared' takes all
points in one chunk: both plans sum every pixel in the same order there,
so the two results must be equal bit for bit. Prints one JSON line per
case, the registers and spills ptxas reported for the d_src kernels, and
the card's name and power limit. Needs one CUDA card; rerun after a change
to csrc/warp_dsrc.cu or to the 'binned' rule of `dsrc_plan`.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
B, H, C = 20, 128, 64


def kernel_us(fn, calls: int) -> dict:
    """{kernel name: mean device microseconds a call} of the d_src kernels
    in a profiler trace of `calls` calls of fn."""
    import tempfile
    from collections import defaultdict

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    total = defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel" and "warp_dsrc" in e["name"]:
            total[re.search(r"warp_dsrc_\w+", e["name"]).group(0)] += e["dur"] / calls
    return dict(total)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--no-options", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dsrc_binned_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import chip_smoke
    from monkeynet_tpu_torch.ops.cuda import _build, warp
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid
    from warp_plan_sweep import ptxas_usage

    chip_smoke.full_f32()
    gen = torch.Generator().manual_seed(13)
    shape = (B, H, H, C)
    grids = {
        "random": chip_smoke.grid_off_integers(B, H, gen),
        "near_identity": make_coordinate_grid((H, H))[None]
        + torch.rand(B, H, H, 2, generator=gen) / (H - 1),
        "contracting": chip_smoke._contracting_grid(B, H, gen),
    }
    grids = {k: v.contiguous().cuda() for k, v in grids.items()}

    def run(plan, grid, dout, out):
        warp._launch_dsrc(grid, dout, out, shape, plan)
        return out

    def checked(label, got, ref, bf16):
        torch.cuda.synchronize()
        err = chip_smoke.max_err(got, ref)
        chip_smoke.check(label, err, chip_smoke._warp_tol(ref, rounded=bf16))
        return err

    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        dout = torch.randn(shape, generator=gen).to("cuda", dtype)
        plan = warp.dsrc_plan(B, H * H, C, dtype, True, (H, H))
        if plan.variant != "binned":
            raise AssertionError(f"dsrc_binned_sweep: planned {plan}")
        row = {"dtype": str(dtype), "shape": list(shape), "plan": plan._asdict(), "grids": {}}
        refs, planned = {}, {}
        for name, grid in grids.items():
            ref = refs[name] = warp.warp_dsrc_plain(grid, dout.float(), shape)
            first = planned[name] = warp.warp_dsrc(grid, dout, shape)
            chip_smoke._same_twice(f"binned {name} {dtype}", first,
                                   warp.warp_dsrc(grid, dout, shape))
            err = checked(f"binned {name} {dtype}", first, ref, bf16)
            row["grids"][name] = {"max_abs_err": err, "us": chip_smoke.time_ms(
                lambda g=grid: warp.warp_dsrc(g, dout, shape), reps=args.reps) * 1e3}
        # the three kernels' device time, from a trace of 10 calls on each grid
        for name, grid in grids.items():
            row["grids"][name]["kernels_us"] = kernel_us(
                lambda g=grid: warp.warp_dsrc(g, dout, shape), 10)
        print(json.dumps(row), flush=True)
        if not args.no_options:
            out = torch.empty(shape, dtype=dtype, device="cuda")
            row = {"dtype": str(dtype), "shape": list(shape), "options_us": {}}
            for rows in sorted({plan.rows // 2, plan.rows, 2 * plan.rows}):
                for lanes in sorted({plan.lanes // 2, plan.lanes}):
                    for threads in (128, 256):
                        # a block a strip of threads / lanes quads of a quad row
                        strips = -(-(-(-H // 2)) // (threads // lanes))
                        option = plan._replace(
                            rows=rows, lanes=lanes, threads=threads,
                            blocks=(-(-H // 2) * strips, B),
                            shared_bytes=warp.dsrc_sort_bytes(rows, H, plan.chunk))
                        key = f"rows={rows},lanes={lanes},threads={threads}"
                        timed = {}
                        for name in ("random", "near_identity"):
                            first = run(option, grids[name], dout, out).clone()
                            checked(f"binned {key} {name} {dtype}", first, refs[name], bf16)
                            # the options change no pixel's order of summation
                            chip_smoke._same_twice(f"binned {key} {name} {dtype} against the plan",
                                                   first, planned[name])
                            timed[name] = chip_smoke.time_ms(
                                lambda o=option, g=grids[name]: run(o, g, dout, out),
                                reps=args.reps) * 1e3
                        row["options_us"][key] = timed
            row["planned"] = f"rows={plan.rows},lanes={plan.lanes},threads={plan.threads}"
            print(json.dumps(row), flush=True)

        # 'binned' forced where 'shared' bins all points in one chunk: the
        # same order of summation, so equal bit for bit
        tb, th = 32, 32
        tshape = (tb, th, th, C)
        tgrid = chip_smoke.grid_off_integers(tb, th, gen).cuda()
        tdout = torch.randn(tshape, generator=gen).to("cuda", dtype)
        shared = warp.dsrc_plan(tb, th * th, C, dtype, True, (th, th))
        if shared.variant != "shared" or shared.chunk != th * th:
            raise AssertionError(f"dsrc_binned_sweep: planned {shared} at {tshape}")
        binned = warp._binned_plan(tb, th * th, C, shared.vector, shared.chunk, (th, th))
        a = torch.empty(tshape, dtype=dtype, device="cuda")
        b = torch.empty(tshape, dtype=dtype, device="cuda")
        warp._launch_dsrc(tgrid, tdout, a, tshape, shared)
        warp._launch_dsrc(tgrid, tdout, b, tshape, binned)
        chip_smoke._same_twice(f"binned against shared at {tshape} {dtype}", a, b)
        print(json.dumps({"dtype": str(dtype), "shape": list(tshape), "binned_equals_shared": True,
                          "shared": shared._asdict(), "binned": binned._asdict()}), flush=True)

    usage = ptxas_usage((_build.BUILD_DIR / "build.log").read_text(), kernels=("warp_dsrc",))
    print(json.dumps({"ptxas": {k: {"registers": r, "spill_store_bytes": st,
                                    "spill_load_bytes": ld}
                                for k, (r, st, ld) in usage.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
