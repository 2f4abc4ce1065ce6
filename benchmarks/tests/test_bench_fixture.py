"""A configuration, a cell and a per-layer metric added as files and entries
only: the harness finds them without an edit."""

from __future__ import annotations

import json

from benchmarks import harness, run
from benchmarks.tests import fixture


def test_harness_finds_added_files(tmp_path):
    root = fixture.make_root(tmp_path)
    bench = root / "benchmarks"
    config = dict(json.loads((bench / "configs" / "taichi64.json").read_text()), name="fixture64")
    (bench / "configs" / "fixture64.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "train_dispatches.json").read_text())
    (bench / "traffic" / "train_fixture.json").write_text(json.dumps(dict(traffic, pool_clips=2)))
    numbers = ("loss_gap_first", "grad_gap_median", "delta_gap_median")
    (bench / "limits" / "fixture64.train.json").write_text(json.dumps(
        {"numbers": {n: {"limit": 1e9} for n in numbers}}))
    (bench / "metrics" / "fixture.steps_traced.train.py").write_text(
        "def read(records):\n    return float(records['traced_steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fixture64", "source": "https://example.org/fixture",
                            "file": "benchmarks/configs/fixture64.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "fixture64.train", "config": "fixture64",
                              "traffic": "train_fixture", "chips": 1, "why": "test"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "train_samples_per_s":
            metric["workloads"].append("fixture64.train")
    spec["per_layer"].append({"name": "fixture.steps_traced.train", "unit": "steps",
                              "better": "higher", "source": "host_clock", "layer": "test",
                              "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    assert "fixture.steps_traced.train" in {m["name"] for m in
                                            harness.Spec(root).per_layer("vox256.train")}
    untraced = json.loads(run.drive(root, "fixture64.train", 5, 0.3, 0, "cpu")[0])
    assert set(untraced["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert untraced["correct"] is True
    traced = json.loads(run.drive(root, "fixture64.train", 5, 0.3, 1, "cpu")[0])
    assert traced["metrics"]["fixture.steps_traced.train"]["value"] >= 2
