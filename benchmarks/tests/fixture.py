"""A tiny copy of the benchmark's data for CPU tests: the cells' traffic and
metrics at a configuration small enough for the program's plain path."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_config(name: str) -> dict:
    """The configuration `name` at tiny widths and a 32x32 frame."""
    cfg = json.loads((REPO / "benchmarks" / "configs" / f"{name}.json").read_text())
    mp = copy.deepcopy(cfg["model_params"])
    mp["common_params"]["num_kp"] = 4
    for params in (mp["kp_detector_params"], mp["generator_params"],
                   mp["generator_params"]["dense_motion_params"]):
        params.update(block_expansion=4, max_features=16, num_blocks=min(params["num_blocks"], 3))
    mp["generator_params"]["num_refinement_blocks"] = 1
    mp["discriminator_params"].update(block_expansion=4, max_features=16, num_blocks=2)
    tp = dict(cfg["train_params"], batch_size=2, steps_per_dispatch=2)
    return dict(cfg, image_size=[32, 32] if name == "taichi64" else [64, 64], model_params=mp,
                train_params=tp)


def make_root(tmp: Path, limits: dict = None) -> Path:
    """A checkout-like root in `tmp`: BENCHMARK.json, the traffic, limits
    and metric readers as committed, tiny configurations."""
    root = Path(tmp)
    (root / "benchmarks" / "configs").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(REPO / "benchmarks" / sub, root / "benchmarks" / sub, dirs_exist_ok=True)
    for name in ("taichi64", "vox256"):
        (root / "benchmarks" / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
    for path in (root / "benchmarks" / "traffic").glob("transfer_*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(min_frames=3, max_frames=20, videos=4, chunk=16, check_videos=2,
                       trace_seconds=0.5)
        path.write_text(json.dumps(traffic))
    train = root / "benchmarks" / "traffic" / "train_dispatches.json"
    train.write_text(json.dumps(dict(json.loads(train.read_text()), pool_clips=4, clip_frames=4)))
    for cell, numbers in (limits or {}).items():
        (root / "benchmarks" / "limits" / f"{cell}.json").write_text(
            json.dumps({"numbers": {k: {"limit": v} for k, v in numbers.items()}}))
    return root
