#!/usr/bin/env python3
"""Sweep the launch plans of the warp forward, d_src and d_grid kernels on one card.

    python3 scripts/warp_plan_sweep.py [--reps 50]

At the six warps of the taichi-64^2 generator (its encoder skips), at a
128-frame transfer chunk (batch 1) and at the batch-32 train step, in f32 and
bf16: the forward with one, two or four packs a lane (C <= 4: the source
plane staged in shared memory or read in place), d_grid with one to eight
packs a lane ('grouped' up to 32 lanes a point, 'split' above), and d_src
(the skips past the source frame) with half, one, two and four times the
planned channels a block, 128, 256 or 512 threads a block and a gather
tile of one pixel or a 2 x 2 quad, each held
against its plain version and timed L2-warm (chip_smoke.time_ms:
CUDA-graph replays behind a sleep kernel). At the chunk shapes also what
bounds the forward: its time on a random, the identity and a constant grid
(every point at one pixel), and the time to zero-fill and to copy its
output. Prints one JSON line per shape with the plan that ops/cuda/warp.py
picks and the fastest option, then the registers and spills that ptxas
reported for each instantiation of the two kernels, and the card's name and
power limit. Needs one CUDA card.

The plan rules in ops/cuda/warp.py (lanes per point, staging, 'split', the
d_src slice and block) come from this sweep: rerun it after a change to
csrc/warp.cu, csrc/warp_dsrc.cu or csrc/warp_dgrid.cu, or for a new config's
warp shapes (add them to SHAPES), and correct the rules where the planned
option is no longer the fastest.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((3, 64), (64, 32), (128, 16), (256, 8), (512, 4), (1024, 2))
CHUNK = 128


def ptxas_usage(log_text, kernels=("warp_fwd_kernel", "warp_dsrc_kernel", "warp_dgrid_kernel")):
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v output, demangled where c++filt exists."""
    usage, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in kernels) else None
        elif name and "spill stores" in line:
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            usage[name] = [None] + spills
        elif name and "Used" in line and "registers" in line:
            usage[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    if shutil.which("c++filt") and usage:
        names = subprocess.run(["c++filt"], input="\n".join(usage), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(usage):
            usage = dict(zip(names, usage.values()))
    return usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("warp_plan_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from monkeynet_tpu_torch.ops.cuda import _build, warp
    from monkeynet_tpu_torch.ops.grid import make_coordinate_grid

    chip_smoke.full_f32()
    gen = torch.Generator().manual_seed(0)

    def us(fn):
        return chip_smoke.time_ms(fn, reps=args.reps) * 1e3

    def dsrc_options(grid, dout, dtype, h):
        """d_src under its plan and with other slices and block sizes."""
        shape = (dout.shape[0], h, h, dout.shape[-1])
        B, N, C = shape[0], h * h, shape[-1]
        plan = warp.dsrc_plan(B, N, C, dtype, True, (h, h))
        ref = warp.warp_dsrc_plain(grid, dout.float(), shape)
        out = torch.empty(shape, dtype=dtype, device="cuda")
        timed = {}
        for channels in sorted({plan.channels >> 1, plan.channels, plan.channels << 1,
                                plan.channels << 2}):
            if channels < plan.vector or channels > C:
                continue
            for threads in (128, 256, 512):
                for tile in (1, 2):
                    option = plan._replace(
                        channels=channels, threads=threads, tile=tile,
                        lanes=min(threads, 1 << (channels // plan.vector - 1).bit_length()),
                        blocks=(-(-C // channels) * -(-h // plan.rows), B),
                        shared_bytes=warp.dsrc_shared_bytes(plan.rows, h, channels, plan.chunk,
                                                            dtype.itemsize, N > plan.chunk))
                    if option.shared_bytes > warp.MAX_DYNAMIC_SHARED:
                        continue
                    warp._launch_dsrc(grid, dout, out, shape, option)
                    checked(f"d_src {option}", out, ref,
                            2.0**-8 if dtype == torch.bfloat16 else 2e-5)
                    timed[f"channels={channels},threads={threads},tile={tile}"] = us(
                        lambda o=option: warp._launch_dsrc(grid, dout, out, shape, o))
        planned = f"channels={plan.channels},threads={plan.threads},tile={plan.tile}"
        return {"dsrc_plan": plan._asdict(), "dsrc_us": timed, "dsrc_planned": planned,
                "dsrc_best": min(timed, key=timed.get)}

    def checked(name, got, ref, tol):
        torch.cuda.synchronize()
        err = chip_smoke.max_err(got, ref)
        chip_smoke.check(name, err, tol * max(1.0, ref.abs().max().item()))

    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for C, h in SHAPES:
            for where, B, N in (("chunk", 1, CHUNK * h * h), ("train", 32, h * h)):
                src = torch.randn(B, h, h, C, generator=gen).to("cuda", dtype)
                ident = make_coordinate_grid((h, h))
                if where == "chunk":
                    ident = ident[None, None].expand(1, CHUNK, h, h, 2)
                    grid = ident + 0.1 * torch.randn(1, CHUNK, h, h, 2, generator=gen)
                    grid = grid.reshape(1, CHUNK * h, h, 2).contiguous().cuda()
                    ident = ident.reshape(1, CHUNK * h, h, 2).contiguous().cuda()
                else:
                    grid = chip_smoke.grid_off_integers(B, h, gen).cuda()
                out = torch.empty(*grid.shape[:3], C, dtype=dtype, device="cuda")
                ref = warp.grid_sample(src.float(), grid)
                plan = warp.warp_plan(B, N, C, dtype, True, h * h)
                row = {"dtype": str(dtype), "where": where, "shape": [B, h, h, C],
                       "points": B * N, "plan": plan._asdict(), "forward_us": {}}
                if plan.variant == "small":
                    # the plane staged in shared memory (a block of 1024
                    # threads an SM walking the points), and read in place by
                    # blocks of 256 that cover the points once
                    options = {"in_place": plan._replace(
                        threads=256, shared_bytes=0, blocks=(-(-N // 256), B))}
                    if plan.shared_bytes:
                        options["staged"] = plan
                else:
                    most = 1 << (C // plan.vector - 1).bit_length()
                    options = {f"lanes={n}": plan._replace(
                        lanes=n, blocks=(-(-N // (plan.threads // n)), B))
                        for n in sorted({min(256, most >> k) for k in (0, 1, 2)} - {0})}
                for name, option in options.items():
                    out.zero_()
                    warp._launch_forward(src, grid, out, option)
                    checked(f"forward {option}", out, ref, 2.0**-8 if bf16 else 2e-5)
                    row["forward_us"][name] = us(
                        lambda o=option: warp._launch_forward(src, grid, out, o))
                row["forward_best"] = min(row["forward_us"], key=row["forward_us"].get)
                row["forward_planned"] = next((k for k, o in options.items() if o == plan), None)
                if where == "chunk":
                    const = torch.full_like(ident, 0.013)
                    row["forward_by_grid_us"] = {
                        name: us(lambda g=g: warp._launch_forward(src, g, out, plan))
                        for name, g in (("random", grid), ("identity", ident),
                                        ("constant", const))}
                    other = torch.empty_like(out)
                    row["output_zero_fill_us"] = us(lambda: out.zero_())
                    row["output_copy_us"] = us(lambda: out.copy_(other))
                    row["output_bytes"] = out.numel() * out.element_size()
                else:
                    dout = torch.randn(B, h, h, C, generator=gen).to("cuda", dtype)
                    dgrid = torch.empty(grid.shape, dtype=torch.float32, device="cuda")
                    dref = warp.warp_dgrid_plain(src.float(), grid, dout.float())
                    dplan = warp.dgrid_plan(B, N, C, dtype, True, h * h)
                    row["dgrid_plan"] = dplan._asdict()
                    row["dgrid_us"] = {}
                    if dplan.variant != "small":
                        most = min(1024, 1 << (C // dplan.vector - 1).bit_length())
                        for lane_count in sorted({most >> k for k in range(4)} - {0}):
                            threads = max(dplan.threads, lane_count)
                            option = dplan._replace(
                                variant="split" if lane_count > 32 else "grouped",
                                lanes=lane_count, threads=threads,
                                blocks=(-(-N // (threads // lane_count)), B))
                            warp._launch_dgrid(src, grid, dout, dgrid, option)
                            checked(f"d_grid {option}", dgrid, dref, 2e-5)
                            row["dgrid_us"][f"{option.variant},lanes={lane_count}"] = us(
                                lambda o=option: warp._launch_dgrid(src, grid, dout, dgrid, o))
                        row["dgrid_best"] = min(row["dgrid_us"], key=row["dgrid_us"].get)
                    if C > warp.SMALL_C:  # the raw source frame takes no d_src
                        row.update(dsrc_options(grid, dout, dtype, h))
                print(json.dumps(row), flush=True)
    log_text = (_build.BUILD_DIR / "build.log").read_text()
    print(json.dumps({"ptxas": {k: {"registers": r, "spill_store_bytes": st,
                                    "spill_load_bytes": ld}
                                for k, (r, st, ld) in ptxas_usage(log_text).items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
