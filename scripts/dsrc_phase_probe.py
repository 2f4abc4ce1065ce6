#!/usr/bin/env python3
"""Where the time of the warp d_src kernel's 'shared' variant goes, on one card.

    python3 scripts/dsrc_phase_probe.py [--reps 50]

Builds copies of monkeynet_tpu_torch/csrc/warp_dsrc.cu with nvcc, each
with more of the kernel's phases cut out: `full`, `no_gather` (the gather
from the binned points), `no_binning` (also the count, scan and placement)
and `writes_only` (also the staging of dout in shared memory). What is left
of the last one is the launch, the barriers and the output stores. One more
times the placement in point order: `atomic_placement` has in its place the
placement by atomicAdd on each cell's cursor that the kernel had before, in
no fixed order. At the
five d_src shapes of the taichi-64^2 train step (batch 32), in f32 and bf16,
each copy runs under the plan ops/cuda/warp.py picks and is timed L2-warm
(chip_smoke.time_ms); the differences between neighbours are the phases'
costs. Beside them, the time of a PyTorch zero fill of the same output. Only
`full` and `atomic_placement` compute the gradient and are held against the
plain version.
Prints one JSON line per shape, then the card's name and power limit. Needs
one CUDA card; rerun after a change to csrc/warp_dsrc.cu (the cuts are found
by the comments and statements they start at, and the script stops if one is
missing).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((64, 32), (128, 16), (256, 8), (512, 4), (1024, 2))
BATCH = 32
# (first line of a phase, first line after it) in the 'shared' kernel; the
# gather's walk over the cells is tile_sums' body
GATHER = ("#pragma unroll\n  for (int j = 0; j <= kTile; ++j) {",
          "}\n\n// Dynamic shared memory of a 'shared' block")
COUNT = ("    // count: a thread reads", "    __syncthreads();\n    block_exclusive_scan")
SCAN = "    block_exclusive_scan(cursor, start, cells, warp_total);\n"
PLACE = ("    // placement: each point's",
         "    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_wait(0);")
STAGE = ("    for (int q = row; q < n; q += rows) {\n      const Pack<T, V>* src",
         "    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_commit();")


def cut(text: str, span) -> str:
    """`text` without the lines from span[0] up to span[1]."""
    i = text.index(span[0])
    return text[:i] + text[text.index(span[1], i):]


# the placement in point order (one warp), and for timing it the placement
# this kernel had before: a thread a point taking the slot an atomicAdd on
# its cell's cursor returns (no fixed order)
SWEEP = """    if (threadIdx.x < 64)
      place_in_order(
          [&](int q) { return make_float2(chunk_grid[2 * q], chunk_grid[2 * q + 1]); },
          [&](int slot, float fx, float fy, int q) { binned[slot] = Binned{fx, fy, q, 0}; }, n,
          H, W, y_lo, Hb, cursor, masks, cells);
"""
ATOMIC = """    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const Taps tp = bilinear_taps(grid[2 * (q0 + q)], grid[2 * (q0 + q) + 1], H, W);
      const int cell = corner_cell(tp, W, y_lo, Hb);
      if (cell >= 0) binned[atomicAdd(cursor + cell, 1)] = Binned{tp.wx1, tp.wy1, q, 0};
    }
"""


def variants(source: str) -> dict:
    no_gather = cut(source, GATHER)
    for text in (SCAN, SWEEP):
        if text not in source:
            raise ValueError(f"dsrc_phase_probe: {text.strip()!r} is not in csrc/warp_dsrc.cu")
    no_binning = cut(cut(no_gather, COUNT).replace(SCAN, ""), PLACE)
    return {"full": source, "atomic_placement": source.replace(SWEEP, ATOMIC),
            "no_gather": no_gather, "no_binning": no_binning,
            "writes_only": cut(no_binning, STAGE)}


def build(name: str, text: str, build_dir: Path, nvcc: str) -> subprocess.Popen:
    d = build_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "warp_dsrc.cu").write_text(text)
    shutil.copy(REPO / "monkeynet_tpu_torch" / "csrc" / "common.cuh", d / "common.cuh")
    return subprocess.Popen([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                             "-O3", "-Xcompiler", "-fPIC", "-shared", str(d / "warp_dsrc.cu"),
                             "-o", str(d / "lib.so")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dsrc_phase_probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from monkeynet_tpu_torch.ops.cuda import _build, warp

    build_dir = _build.BUILD_DIR / "phase_probe"
    source = (REPO / "monkeynet_tpu_torch" / "csrc" / "warp_dsrc.cu").read_text()
    jobs = {name: build(name, text, build_dir, _build._nvcc())
            for name, text in variants(source).items()}
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"dsrc_phase_probe: nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(build_dir / name / "lib.so"))
        lib.mk_warp_dsrc.argtypes = _build._SIGNATURES["mk_warp_dsrc"]
        libs[name] = lib

    chip_smoke.full_f32()
    gen = torch.Generator().manual_seed(10)
    for dtype in (torch.float32, torch.bfloat16):
        for C, h in SHAPES:
            shape = (BATCH, h, h, C)
            dout = torch.randn(shape, generator=gen).to("cuda", dtype)
            grid = chip_smoke.grid_off_integers(BATCH, h, gen).cuda()
            out = torch.empty(shape, dtype=dtype, device="cuda")
            plan = warp.dsrc_plan(BATCH, h * h, C, dtype, True, (h, h))
            row = {"dtype": str(dtype), "shape": list(shape), "plan": plan._asdict(), "us": {}}
            for name, lib in libs.items():
                def call(lib=lib):
                    status = lib.mk_warp_dsrc(
                        grid.data_ptr(), dout.data_ptr(), out.data_ptr(), *shape[:3], C, h * h,
                        _build.DTYPE_CODES[dtype], plan.vector, plan.channels,
                        plan.lanes.bit_length() - 1, plan.chunk, plan.tile, plan.rows,
                        plan.threads,
                        plan.blocks[0], plan.shared_bytes, int(plan.index_bits == 64),
                        torch.cuda.current_stream().cuda_stream)
                    _build.check_launch(status, f"warp_dsrc ({name})")

                call()
                try:
                    torch.cuda.synchronize()
                except RuntimeError as err:
                    raise RuntimeError(f"dsrc_phase_probe: the {name} copy failed") from err
                if name in ("full", "atomic_placement"):
                    torch.cuda.synchronize()
                    ref = warp.warp_dsrc_plain(grid, dout.float(), shape)
                    tol = (2.0**-8 if dtype == torch.bfloat16 else 2e-5) * max(
                        1.0, ref.abs().max().item())
                    chip_smoke.check(f"dsrc_phase_probe {shape} {dtype}",
                                     chip_smoke.max_err(out, ref), tol)
                row["us"][name] = chip_smoke.time_ms(call, reps=args.reps) * 1e3
            row["us"]["torch_zero_fill"] = chip_smoke.time_ms(out.zero_, reps=args.reps) * 1e3
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
