"""The reader of `driver.deliver_us_per_frame.transfer` on synthetic
records, and a traced CPU dry run, where the engine delivers nothing itself
and the line leaves the metric out."""

from __future__ import annotations

import json

import pytest

from benchmarks import harness, run
from benchmarks.tests import fixture

METRIC = "driver.deliver_us_per_frame.transfer"


def _records(host, frames=100):
    return {"trace": {"host": list(host), "device": [("k", 0.0, 0.5)], "window_s": 1.0},
            "traced_frames": frames, "traced_steps": None}


def test_reader_is_the_union_of_deliver_spans_per_frame():
    read = harness.Spec().reader(METRIC)
    records = _records([("transfer.video", 0.0, 1.0), ("transfer.deliver", 0.1, 0.2),
                        ("transfer.deliver", 0.15, 0.25),  # overlapping
                        ("transfer.deliver", 0.5, 0.6), ("transfer.chunk", 0.0, 0.9)])
    # (0.1, 0.25) and (0.5, 0.6): 0.25 s over 100 frames
    assert read(records) == pytest.approx(2500.0)
    assert read(dict(records, traced_frames=0)) is None


def test_reader_reports_nothing_without_the_span():
    """A program whose engine returns device tensors records no
    `transfer.deliver`: no value, and no error."""
    read = harness.Spec().reader(METRIC)
    assert read(_records([("transfer.video", 0.0, 1.0), ("transfer.gather", 0.2, 0.3)])) is None


def test_the_transfer_cells_list_the_metric():
    spec = harness.Spec()
    (entry,) = [m for m in spec.data["per_layer"] if m["name"] == METRIC]
    assert entry["workloads"] == fixture.cells("transfer")
    for cell in entry["workloads"]:
        assert METRIC in {m["name"] for m in spec.per_layer(cell)}
        assert entry["moves"] in {m["name"] for m in spec.end_to_end(cell)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture.make_root(tmp_path_factory.mktemp("bench"))


def test_traced_cpu_dry_run_leaves_the_metric_out(root):
    line, _, _ = run.drive(root, "taichi64.transfer", 2 ** 31 + 97531, 0.5, 1, "cpu")
    out = json.loads(line)
    assert "driver.engine_host_us_per_frame.transfer" in out["metrics"]
    assert METRIC not in out["metrics"]
