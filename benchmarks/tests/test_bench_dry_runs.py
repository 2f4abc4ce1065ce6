"""Every cell of BENCHMARK.json, run at tiny sizes on the program's plain
path: the result line has the contract's keys and the cell's metrics, and
the window arithmetic holds over a synthetic window with a stall."""

from __future__ import annotations

import json

import pytest

from benchmarks import harness, run
from benchmarks.drive import transfer
from benchmarks.tests import fixture

CELLS = [c["name"] for c in harness.Spec().data["workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(root, cell, trace):
    line, checks, notes = run.drive(root, cell, 2 ** 31 + 12345, 0.5, trace, "cpu")
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = harness.Spec(root)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        names = {m["name"] for m in spec.per_layer(cell)}
        assert set(out["metrics"]) <= names and out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}
        assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(spec.limits(spec.cell(cell)))
    assert {text.split()[1] for text in notes if text.startswith("reading ")} >= set(checks)


def test_window_metrics_hold_a_stall():
    # 99 videos of 10 frames in 10 ms each, then one stalled for 1 s
    done, t = [], 100.0
    for _ in range(99):
        done.append((t, t + 0.01, 10))
        t += 0.01
    done.append((t, t + 1.0, 10))
    metrics = transfer.window_metrics(done, 100.0)
    assert metrics["transfer_fps"] == pytest.approx(1000 / 1.99)
    # the 95th percentile of 99 x 0.01 s and one 1 s: still 0.01 s
    assert metrics["transfer_video_p95_s"] == pytest.approx(0.01)
    done[-6:] = [(a, a + 1.0, n) for a, _, n in done[-6:]]
    assert transfer.window_metrics(done, 100.0)["transfer_video_p95_s"] == pytest.approx(1.0)


def test_lengths_are_one_set_in_the_seeds_order():
    traffic = json.loads((fixture.REPO / "benchmarks/traffic/transfer_64_1024.json").read_text())
    a, b = transfer.lengths(traffic, 1), transfer.lengths(traffic, 2 ** 32 + 7)
    assert sorted(a) == sorted(b) and a != b
    assert min(a) >= 64 and max(a) <= 1024 and len(a) == traffic["videos"]


def test_chunk_sizes_pad_the_tail_to_16():
    assert transfer.chunk_sizes(300, 128) == [128, 128, 48]
    assert transfer.chunk_sizes(256, 128) == [128, 128]
    assert transfer.chunk_sizes(5, 128) == [16]
