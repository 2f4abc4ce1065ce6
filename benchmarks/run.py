"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, benchmarks/ and the
program (monkeynet_tpu_torch/). The run draws its weights and inputs from
`--seed` on the card, sets up and warms the cell's shapes, measures for
`--seconds`, then checks what the timed path produced against the
reference. `--trace 0` reports the cell's end-to-end metrics; `--trace 1`
traces a slice of the window with torch.profiler and reports the cell's
per-layer metrics. The last line of standard output is one JSON object;
the compared numbers and their limits are also the last lines of standard
error. Without a CUDA card, with fewer cards than the cell asks for, without
the program beside the benchmark, or with JAX or the JAX package loaded, it
prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import os
import sys
import time
from pathlib import Path

from benchmarks import harness

EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_FORBIDDEN = 2, 3, 4


def _process_start() -> float:
    """The epoch second this process started (Linux /proc), else now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


PROCESS_START = _process_start()


def _keep_caches_in(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv_compute"))


class Context:
    """What a traffic generator is handed: the cell, its data, the device,
    and the run's clock and memory helpers."""

    def __init__(self, spec, cell_name, seed, seconds, trace, device):
        import torch

        self.spec, self.cell = spec, spec.cell(cell_name)
        self.config, self.traffic = spec.config(self.cell), spec.traffic(self.cell)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.device_name = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        self.window_start = None
        self.notes = []

    def note(self, text: str) -> None:
        """A line for standard error, printed before the result."""
        self.notes.append(text)

    def subseed(self, k: int) -> int:
        """The seed of the run's k-th stream: distinct for every (seed, k)."""
        return (self.seed * 16 + k) % (2 ** 63)

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_memory_peak(self):
        import torch

        if self.cuda:
            self.sync()
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def open_window(self):
        """Set-up ends here: the trace window object for the slice to trace."""
        from benchmarks import trace

        self.sync()
        self.window_start = time.time()
        return trace.Window(self.device)

    def free(self):
        import torch

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def drive(root, cell_name, seed, seconds, trace, device, process_start=PROCESS_START):
    """Run the cell; return (result line, checks, notes). `device` 'cpu' runs the
    program's plain path (for tests); the benchmark's own runs take 'cuda'."""
    spec = harness.Spec(root)
    ctx = Context(spec, cell_name, seed, seconds, trace, device)
    generator = importlib.import_module(f"benchmarks.drive.{ctx.traffic['kind']}")
    out = generator.run(ctx)
    ctx.notes += [f"reading {k} {v}" for k, v in out["numbers"].items()]
    checks = harness.judge(out["numbers"], spec.limits(ctx.cell))
    correct = all(c["ok"] for c in checks.values()) and out["failed"] == 0
    device_info = {"platform": "gpu" if ctx.cuda else "cpu", "kind": ctx.device_name,
                   "count": int(ctx.cell["chips"]), "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if trace:
        from benchmarks import trace as trace_mod

        records = out["records"]
        records["cell"] = cell_name
        busy = trace_mod.union([(s, e) for _, s, e in records["trace"]["device"]])
        device_info.update(busy_s=busy, window_s=records["trace"]["window_s"])
        metrics = harness.read_per_layer(spec, cell_name, records)
        breakdown = trace_mod.breakdown(records["trace"])
    else:
        setup_s = ctx.window_start - process_start
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(cell_name) if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    line = harness.result_line(correct, out["attempted"], out["failed"], metrics, device_info,
                               checks, breakdown)
    return line, checks, ctx.notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    _keep_caches_in(root)

    import torch

    spec = harness.Spec(root)
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return EXIT_NO_CARD
    found = importlib.util.find_spec("monkeynet_tpu_torch")
    if found is None or not Path(found.origin).resolve().is_relative_to(root.resolve()):
        print("benchmark: the program (monkeynet_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return EXIT_NO_PROGRAM
    line, checks, notes = drive(root, args.workload, args.seed, args.seconds, args.trace, "cuda")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for text in notes:
        print(text, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']} {'ok' if c['ok'] else 'FAIL'}",
              file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
