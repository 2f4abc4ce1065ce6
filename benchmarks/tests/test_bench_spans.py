"""The span arithmetic (benchmarks/spans.py) on synthetic records, its
readers on records with and without the program's spans, and a traced CPU
dry run of each cell that reports the cell's span metrics: the per-layer
metrics of source `program_span` that list it in BENCHMARK.json."""

from __future__ import annotations

import json

import pytest

from benchmarks import harness, run, spans, trace
from benchmarks.tests import fixture

CELLS = fixture.cells()
# A span that the program records only on a CUDA device: on the CPU the engine
# hands back its own tensors and delivers nothing (test_bench_deliver_span.py
# checks that the line leaves the metric out there).
CARD_ONLY = {"driver.deliver_us_per_frame.transfer"}


def _trace(host, device=(), window_s=1.0):
    return {"host": list(host), "device": list(device), "window_s": window_s}


def test_nested_and_overlapping_spans_count_once():
    t = _trace([("transfer.video", 0.1, 0.5), ("transfer.video", 0.2, 0.3),  # nested
                ("transfer.video", 0.4, 0.6),  # overlapping
                ("transfer.video", 0.8, 0.9), ("transfer.chunk", 0.0, 1.0)])
    assert spans.intervals(t, "transfer.video") == [(0.1, 0.6), (0.8, 0.9)]
    assert spans.seconds(t, "transfer.video") == pytest.approx(0.6)
    assert spans.seconds(t, "transfer.upload") is None


def test_idle_counts_only_inside_the_span():
    # the device runs over [0.2, 0.3] and [0.5, 0.7]: idle [0, 0.2], [0.3, 0.5], [0.7, 1]
    device = [("k", 0.2, 0.3), ("k", 0.5, 0.7)]
    t = _trace([("transfer.video", 0.1, 0.4), ("transfer.video", 0.6, 0.8),
                ("transfer.video", 0.9, 0.95)], device)
    # inside the spans: [0.1, 0.2] + [0.3, 0.4] + [0.7, 0.8] + [0.9, 0.95]
    assert spans.idle_seconds(t, "transfer.video") == pytest.approx(0.35)
    assert spans.idle_seconds(_trace([("transfer.video", 0.2, 0.3)], device), "transfer.video") \
        == pytest.approx(0.0)
    assert spans.idle_seconds(t, "trainer.step") is None


def test_a_span_cut_by_the_window_counts_its_part_inside(monkeypatch):
    """`Window.records()` clips a span that began before the window; the
    reader counts what is left."""
    window = trace.Window.__new__(trace.Window)
    window._prof = None
    raw = [(trace.SPAN, False, "user_annotation", 1000, 2000),
           ("transfer.video", False, "user_annotation", 500, 1500),
           ("transfer.video", False, "user_annotation", 1800, 2600),
           ("transfer.video", True, "gpu_user_annotation", 1000, 2000),
           ("kernel", True, "kernel", 1200, 1300)]
    monkeypatch.setattr(trace, "_raw_events", lambda prof: raw)
    records = window.records()
    cut = [t for interval in spans.intervals(records, "transfer.video") for t in interval]
    assert cut == pytest.approx([0.0, 500e-9, 800e-9, 1000e-9])
    assert [d[0] for d in records["device"]] == ["kernel"]
    assert spans.seconds(records, "transfer.video") == pytest.approx(700e-9)
    # idle [0, 200] and [300, 1000] ns; spans [0, 500] and [800, 1000]
    assert spans.idle_seconds(records, "transfer.video") == pytest.approx(600e-9)


@pytest.mark.parametrize("metric", sorted({m for c in CELLS for m in fixture.span_metrics(c)}))
def test_readers_return_none_without_their_span(metric):
    spec = harness.Spec()
    records = {"trace": _trace([("aten::mul", 0.0, 0.5), ("bench.other", 0.1, 0.2)],
                               [("k", 0.0, 0.5)]),
               "traced_frames": 100, "traced_steps": 10}
    assert spec.reader(metric)(records) is None
    with_span = dict(records, trace=_trace(
        [("transfer.video", 0.0, 1.0), ("transfer.upload", 0.0, 0.1),
         ("transfer.deliver", 0.2, 0.3), ("trainer.step", 0.0, 0.5)], [("k", 0.0, 0.5)]))
    assert spec.reader(metric)(with_span) > 0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_dry_run_reports_the_span_metrics(root, cell):
    expected = set(fixture.span_metrics(cell, root)) - CARD_ONLY
    line, _, _ = run.drive(root, cell, 2 ** 31 + 54321, 0.5, 1, "cpu")
    out = json.loads(line)
    assert expected <= set(out["metrics"])
    assert all(out["metrics"][m]["value"] > 0 for m in expected)
    if cell in fixture.cells("transfer", root):
        assert (out["metrics"]["driver.upload_us_per_frame.transfer"]["value"]
                < out["metrics"]["driver.engine_host_us_per_frame.transfer"]["value"])
        # on the CPU nothing runs on a device: the engine's share of the
        # idle window is the engine's share of the window
        assert out["metrics"]["driver.engine_idle_pct.transfer"]["value"] <= 100.0
