"""A tiny copy of the benchmark's data for CPU tests: the cells' traffic and
metrics at configurations small enough for the program's plain path. Every
configuration and cell that BENCHMARK.json names is taken as it is found,
so a configuration or a cell is added by files and entries alone."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Iterator, List

from benchmarks import harness

REPO = Path(__file__).resolve().parents[2]
# Each traffic kind's sizes, shrunk for the CPU; a kind not named here runs as
# its file says.
TINY_TRAFFIC = {
    "transfer": dict(min_frames=3, max_frames=20, videos=4, chunk=16, check_videos=2,
                     trace_seconds=0.5),
    "train": dict(pool_clips=4, clip_frames=4),
}


def _scale_factors(params: dict) -> Iterator[float]:
    for key, value in params.items():
        if isinstance(value, dict):
            yield from _scale_factors(value)
        elif key == "scale_factor":
            yield value


def frame_size(model_params: dict) -> int:
    """The smallest square frame of at least 32, in steps of 16 (whole under
    the tiny networks' halvings), at which every `scale_factor` of
    `model_params` still leaves 16."""
    scales = list(_scale_factors(model_params))
    size = 32
    while any(int(size * s) < 16 for s in scales):
        size += 16
    return size


def tiny_config(cfg: dict) -> dict:
    """The configuration `cfg` at tiny widths and the frame of `frame_size`."""
    mp = copy.deepcopy(cfg["model_params"])
    mp["common_params"]["num_kp"] = 4
    for params in (mp["kp_detector_params"], mp["generator_params"],
                   mp["generator_params"]["dense_motion_params"]):
        params.update(block_expansion=4, max_features=16, num_blocks=min(params["num_blocks"], 3))
    mp["generator_params"]["num_refinement_blocks"] = 1
    mp["discriminator_params"].update(block_expansion=4, max_features=16, num_blocks=2)
    tp = dict(cfg["train_params"], batch_size=2, steps_per_dispatch=2)
    size = frame_size(mp)
    return dict(cfg, image_size=[size, size], model_params=mp, train_params=tp)


def make_root(tmp: Path, limits: dict = None, source: Path = REPO) -> Path:
    """A checkout-like root in `tmp`: BENCHMARK.json, the traffic, limits
    and metric readers as committed under `source`, and a tiny copy of every
    configuration that BENCHMARK.json names, at its entry's `file`."""
    root = Path(tmp)
    source = Path(source)
    shutil.copy(source / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(source / "benchmarks" / sub, root / "benchmarks" / sub, dirs_exist_ok=True)
    for entry in harness.Spec(root).data["configs"]:
        cfg = json.loads((source / entry["file"]).read_text())
        (root / entry["file"]).parent.mkdir(parents=True, exist_ok=True)
        (root / entry["file"]).write_text(json.dumps(tiny_config(cfg)))
    for path in (root / "benchmarks" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TINY_TRAFFIC.get(traffic["kind"], {}))
        path.write_text(json.dumps(traffic))
    for cell, numbers in (limits or {}).items():
        (root / "benchmarks" / "limits" / f"{cell}.json").write_text(
            json.dumps({"numbers": {k: {"limit": v} for k, v in numbers.items()}}))
    return root


def float32(root: Path) -> Path:
    """`root` with every configuration and transfer traffic in float32."""
    spec = harness.Spec(root)
    for entry in spec.data["configs"]:
        cfg = root / entry["file"]
        data = json.loads(cfg.read_text())
        data["train_params"]["compute_dtype"] = None
        cfg.write_text(json.dumps(data))
    for path in (root / "benchmarks" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if traffic["kind"] == "transfer":
            path.write_text(json.dumps(dict(traffic, dtype="float32")))
    return root


def cells(kind: str = None, root: Path = REPO) -> List[str]:
    """The cells of BENCHMARK.json under `root`, in its order; with `kind`,
    those whose traffic is of that kind ('transfer', 'train')."""
    spec = harness.Spec(root)
    return [c["name"] for c in spec.data["workloads"]
            if kind is None or spec.traffic(c)["kind"] == kind]


def span_metrics(cell: str, root: Path = REPO) -> List[str]:
    """The per-layer metrics of source `program_span` that list `cell`."""
    return [m["name"] for m in harness.Spec(root).per_layer(cell)
            if m["source"] == "program_span"]

