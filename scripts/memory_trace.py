#!/usr/bin/env python3
"""Peak device memory of the port's main paths, and the allocations live
at each peak, for one or more checkouts on one card.

    python3 scripts/memory_trace.py ROOT [ROOT ...] [--remat] [--out DIR]

Each ROOT is a checkout's directory holding its monkeynet_tpu_torch/,
chip_smoke.py and configs/ (one unpacked from `git archive` will do; --remat
also reads its data/shapes256). Each runs in a process of its own that
imports that root's package and chip_smoke.py, builds its kernels into that
root, and runs what that root's own `chip_smoke.main` runs up to its train
path (the kernel phases, the parity phases, `main_path`: the taichi-64^2
transfer, and `train_path`: the eager batch-32 taichi train step, then,
where the root has it, the same steps through the step's CUDA graph), with
`torch.cuda.memory._record_memory_history` on from the process's start.
With --remat, where the root has it, it then runs phase 7 (d)
(`remat_phase`: a remat step of configs/shapes-256.yaml, two plain steps and
a graphed remat step).

A window is the stretch over which a path reads its peak: from the path's
`torch.cuda.reset_peak_memory_stats()` to the next one or to the path's
end, the first (bf16) call of each path; a graphed step's window opens at
its Trainer. At the first window's start the script takes the allocator's
state (every allocated block, with the Python stack that allocated it),
then replays the allocator's trace to each window's peak. Per window it
writes: the peak that `torch.cuda.max_memory_allocated` reads and the
replay's, which counts requested bytes (the difference is the
allocator's rounding of its blocks); the blocks live at the peak, grouped by the
innermost line of the root that allocated them and split into resident
(allocated before the window opened) and made in the window; each
allocation the kernel wrappers (`ops/cuda/`) made in the window, by site
and size, and whether it was live at the peak; for a graphed window the
bytes that the captured graph's private pool holds after the capture. One
JSON file a run under --out (default chiprun_out/memory), a JSON line a
window on stdout (each run's own output in a .log beside its JSON file),
then the card's name and power limit.

With --captures N, each root's process instead builds the taichi train
models (chip_smoke.py's train path: batch 32, bf16, its uint8 batches) N
times, each into a new Trainer whose `run` captures the step in a CUDA
graph and replays it twice, then drops the Trainer; it prints the bytes
allocated after each (garbage collected), the peak over the N, and the
bytes left after PyTorch's cuBLAS workspaces are cleared. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# A window opens with a marker: an allocation of MARK + 512 * k bytes, freed
# at once and left out of the replay's count.
MARK = 5 * 2**20 + 7 * 4096 + 512
MARK_SPAN = 512 * 64
TOP = 40
# The Trainer whose construction opens a path's graphed window: train_path
# builds one for its eager steps, then one for the graph; remat_phase one
# for each of its three eager steps, then the graphed one.
GRAPH_TRAINER = {"train": 2, "remat": 4}
LABELS = {"transfer": ["bf16"], "train": ["bf16 eager", "bf16 graph"],
          "remat": ["remat", "plain_1", "plain_2", "graph"]}


def site_of(frames, root: str) -> str:
    """The innermost frame of `root`'s files (not this script's) on an
    allocation's stack, as 'path:line function'; '<torch>' where the
    stack holds no such frame, '<none>' where it was not recorded."""
    for f in frames:
        name = f.get("filename", "")
        if name.startswith(root + "/") and not name.endswith("memory_trace.py"):
            return f"{name[len(root) + 1:]}:{f['line']} {f['name']}"
    return "<torch>" if frames else "<none>"


def marker(event):
    """'open' for a marker that opens a window, 'end' for one that ends a
    path, None for any other event."""
    if event["action"] != "alloc" or not MARK <= event["size"] < MARK + MARK_SPAN:
        return None
    return "end" if event["size"] == MARK else "open"


def live_blocks(segments) -> dict:
    """{address: (requested size, frames)} of the blocks allocated in a
    `torch.cuda.memory_snapshot()` (the trace's sizes are requested sizes
    too; the allocator's count is of blocks, rounded up)."""
    out = {}
    for seg in segments:
        addr = seg["address"]
        for block in seg["blocks"]:
            if block["state"] == "active_allocated":
                out[addr] = (block.get("requested_size", block["size"]), block.get("frames", []))
            addr += block["size"]
    return out


def replay(base: dict, events):
    """Walk the allocator's trace `events` from its first marker on, the
    blocks of `base` ({addr: (size, frames)}) allocated there. A window
    runs from an 'open' marker to the next marker; markers are not
    counted. Allocated bytes fall at 'free_completed', as the allocator's
    own count does. Returns, per window, (first event, peak bytes, {addr:
    (size, frames, event)} live at the peak, {(addr, event): (size,
    frames)} of the allocations made in the window); an event is an index
    into `events`, -1 for a block of `base`."""
    kinds = [marker(e) for e in events]
    marks = [i for i, k in enumerate(kinds) if k]
    bounds = [(i, next((j for j in marks if j > i), len(events)))
              for i, k in enumerate(kinds) if k == "open"]
    if not bounds:
        return []

    def walk(stop_at=()):
        live = {addr: (size, frames, -1) for addr, (size, frames) in base.items()}
        current = sum(size for size, _, _ in live.values())
        peaks = [(-1, -1)] * len(bounds)
        made = [{} for _ in bounds]
        copies, w = {}, -1
        for i in range(bounds[0][0], len(events)):
            while w + 1 < len(bounds) and i >= bounds[w + 1][0]:
                w += 1
            inside = bounds[w][0] <= i < bounds[w][1]
            e = events[i]
            if e["action"] == "alloc" and kinds[i] is None:
                live[e["addr"]] = (e["size"], e.get("frames", []), i)
                current += e["size"]
                if inside:
                    made[w][(e["addr"], i)] = (e["size"], e.get("frames", []))
            elif e["action"] == "free_completed" and e["addr"] in live:
                current -= live.pop(e["addr"])[0]
            if inside and current > peaks[w][0]:
                peaks[w] = (current, i)
            if i in stop_at:
                copies[i] = dict(live)
        return peaks, made, copies

    peaks, made, _ = walk()
    _, _, copies = walk({i for _, i in peaks})
    return [(lo, peak, copies.get(i, {}), made[w])
            for w, ((lo, _), (peak, i)) in enumerate(zip(bounds, peaks))]


def summarise(first: int, live: dict, made: dict, root: str) -> dict:
    """The blocks live at a window's peak grouped by site, largest first,
    resident (allocated before the window's `first` event) or made in it;
    the kernel wrappers' (`ops/cuda/`) allocations made in the window by
    site and size, and whether one of them was live at the peak."""
    groups = {}
    for size, frames, t in live.values():
        key = (site_of(frames, root), t < first)
        bytes_, count = groups.get(key, (0, 0))
        groups[key] = (bytes_ + size, count + 1)
    rows = sorted(groups.items(), key=lambda kv: -kv[1][0])
    wrappers = {}
    for (addr, t), (size, frames) in made.items():
        site = site_of(frames, root)
        if "/ops/cuda/" in "/" + site:
            count, held = wrappers.get((site, size), (0, False))
            wrappers[(site, size)] = (count + 1, held or live.get(addr, (0, 0, None))[2] == t)
    return {
        "resident_bytes": sum(b for (_, r), (b, _) in groups.items() if r),
        "made_bytes": sum(b for (_, r), (b, _) in groups.items() if not r),
        "sites": [{"site": s, "resident": r, "bytes": b, "blocks": n}
                  for (s, r), (b, n) in rows[:TOP]],
        "wrapper_allocs": [{"site": s, "bytes": size, "count": n, "live_at_peak": held}
                           for (s, size), (n, held) in sorted(wrappers.items())],
    }


def segments(torch):
    """The allocator's segments and blocks, without its trace."""
    try:
        return torch.cuda.memory_snapshot(include_traces=False)
    except TypeError:  # a PyTorch without the argument
        return torch.cuda.memory_snapshot()


def child(root: Path, out_dir: Path, remat: bool, tag: str) -> None:
    import torch

    torch.cuda.memory._record_memory_history("all", context="all", stacks="python",
                                             max_entries=4_000_000)
    sys.path.insert(0, str(root))
    import monkeynet_tpu_torch  # the root's package, before its chip_smoke puts its REPO first

    import chip_smoke
    from monkeynet_tpu_torch.tasks import train as train_mod

    for module in (monkeynet_tpu_torch, chip_smoke):
        if not Path(module.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {module.__file__}, not {root}'s")

    state = {"path": None, "windows": [], "base": None, "stats": [], "trainers": 0,
             "pools": {}}

    def close() -> None:
        """Read the open window's peak (the allocator's count)."""
        if state["windows"] and state["windows"][-1][0] == state["path"] \
                and len(state["stats"]) < len(state["windows"]):
            torch.cuda.synchronize()
            state["stats"].append(torch.cuda.max_memory_allocated())

    def open_window() -> None:
        close()
        if state["base"] is None:
            state["base"] = segments(torch)
        path = state["path"]
        n = sum(1 for p, _ in state["windows"] if p == path)
        state["windows"].append((path, f"{path} {LABELS[path][n]}"))
        torch.empty(MARK + 512 * (1 + len(state["windows"]) % 63), dtype=torch.uint8,
                    device="cuda")

    reset = torch.cuda.reset_peak_memory_stats

    def reset_peak(*args, **kwargs):
        if state["path"] is not None:
            open_window()
        return reset(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats = reset_peak
    trainer_init = train_mod.Trainer.__init__

    def init(self, *args, **kwargs):
        if state["path"] is not None:
            state["trainers"] += 1
            if state["trainers"] == GRAPH_TRAINER[state["path"]]:
                open_window()
                reset()
        trainer_init(self, *args, **kwargs)

    train_mod.Trainer.__init__ = init
    capture = getattr(train_mod.Trainer, "_capture", None)

    def captured(self, *args, **kwargs):
        out = capture(self, *args, **kwargs)
        torch.cuda.synchronize()
        pools = {}
        for seg in segments(torch):
            pool = tuple(seg.get("segment_pool_id", (0, 0)))
            if pool != (0, 0):
                pools[str(pool)] = pools.get(str(pool), 0) + seg["total_size"]
        state["pools"][state["windows"][-1][1] if state["windows"] else "-"] = pools
        return out

    if capture is not None:
        train_mod.Trainer._capture = captured

    def traced(name, fn):
        def run(*args, **kwargs):
            first = state["path"] is None and all(p != name for p, _ in state["windows"])
            if first:
                state["path"], state["trainers"] = name, 0
            try:
                return fn(*args, **kwargs)
            finally:
                if first:
                    close()
                    state["path"] = None
                    # the last window ends here
                    torch.empty(MARK, dtype=torch.uint8, device="cuda")
        return run

    chip_smoke.main_path = traced("transfer", chip_smoke.main_path)
    chip_smoke.train_path = traced("train", chip_smoke.train_path)
    if "--only" in Path(chip_smoke.__file__).read_text():
        rc = chip_smoke.main(["--only", "kernels", "parity", "main"])
    else:
        rc = chip_smoke.main()
    if rc:
        raise RuntimeError(f"{root}: chip_smoke.main returned {rc}")
    if remat and hasattr(chip_smoke, "remat_phase"):
        traced("remat", chip_smoke.remat_phase)()
    torch.cuda.synchronize()
    events = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(None)

    result = replay(live_blocks(state["base"]), events)
    if len(result) != len(state["windows"]):
        raise RuntimeError(f"{len(result)} windows in the trace, {len(state['windows'])} opened: "
                           "the trace lost its start (raise max_entries)")
    report = {"root": str(root), "torch": torch.__version__, "windows": []}
    for (_, name), stat, (first, peak, live, made) in zip(state["windows"], state["stats"],
                                                          result):
        row = {"window": name, "peak_bytes_allocator": stat, "peak_bytes_replay": peak,
               "rounding_bytes": stat - peak, **summarise(first, live, made, str(root))}
        if name in state["pools"]:
            row["graph_pool_bytes_after_capture"] = state["pools"][name]
        report["windows"].append(row)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(report, indent=1))


def capture_probe(root: Path, out_dir: Path, n: int, tag: str) -> None:
    import gc

    import torch

    sys.path.insert(0, str(root))
    import chip_smoke
    import monkeynet_tpu_torch
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer
    from monkeynet_tpu_torch.utils.config import load_config

    for module in (monkeynet_tpu_torch, chip_smoke):
        if not Path(module.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {module.__file__}, not {root}'s")
    chip_smoke.full_f32()
    chip_smoke.build_kernels()
    config = load_config(str(root / "configs" / "taichi.yaml"))
    train_params = dict(config["train_params"], compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 5)
    shape = (2, chip_smoke.TRAIN_BATCH, 1, chip_smoke.HW, chip_smoke.HW, 3)
    chunk = {k: torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
             for k in ("source", "video")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    after = []
    for _ in range(n):
        trainer = Trainer(build_train_models(config, device="cuda", seed=chip_smoke.SEED),
                          train_params, device="cuda", steps_per_epoch=100)
        trainer.run(chunk, 0, 2)
        torch.cuda.synchronize()
        del trainer
        gc.collect()
        after.append(torch.cuda.memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    row = {"run": tag, "root": str(root), "captures": n, "allocated_before": start,
           "allocated_after_each": after, "peak_bytes_allocator": peak,
           "allocated_after_clearing_cublas_workspaces": torch.cuda.memory_allocated()}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(row, indent=1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+", type=Path)
    parser.add_argument("--remat", action="store_true",
                        help="also trace phase 7 (d), where a root has it")
    parser.add_argument("--out", type=Path, default=REPO / "chiprun_out" / "memory")
    parser.add_argument("--captures", type=int, default=0, metavar="N",
                        help="instead: N captures of the taichi train step, a Trainer each")
    parser.add_argument("--child", metavar="TAG", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child and args.captures:
        capture_probe(args.roots[0].resolve(), args.out.resolve(), args.captures, args.child)
        return 0
    if args.child:
        child(args.roots[0].resolve(), args.out.resolve(), args.remat, args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("memory_trace: CUDA is not available", file=sys.stderr)
        return 2
    for i, root in enumerate(args.roots):
        tag = f"{'captures-' if args.captures else ''}{i}-{root.resolve().name}"
        print(json.dumps({"run": tag, "root": str(root)}), flush=True)
        cmd = [sys.executable, str(Path(__file__).resolve()), str(root.resolve()),
               "--child", tag, "--out", str(args.out.resolve()),
               "--captures", str(args.captures)] + (["--remat"] if args.remat else [])
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / f"{tag}.log", "w") as log:
            subprocess.run(cmd, check=True, cwd=root, stdout=log, stderr=subprocess.STDOUT)
        report = json.loads((args.out / f"{tag}.json").read_text())
        if args.captures:
            print(json.dumps(report), flush=True)
            continue
        for row in report["windows"]:
            print(json.dumps({"run": tag, **{k: v for k, v in row.items()
                                             if k not in ("sites", "wrapper_allocs")}}),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
