"""The port's spans (monkeynet_tpu_torch/utils/tracing.py) on the CPU, at
the train-test widths of tests/torch_port_common.py (16^2 frames).

Without a profiler a span is the one shared no-op context and leaves nothing
behind; under torch.profiler the engine, the trainer and the train loop
record their phases, each child inside its parent, and the engine's outputs
do not change.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import monkeynet_tpu_torch.tasks.train_loop as tloop
from monkeynet_tpu_torch.data.dataset import FramesDataset
from monkeynet_tpu_torch.data.io import write_stacked_png
from monkeynet_tpu_torch.tasks.animate import TransferEngine
from monkeynet_tpu_torch.tasks.build import build_models, build_train_models
from monkeynet_tpu_torch.tasks.train import Trainer
from monkeynet_tpu_torch.utils import tracing

from .torch_port_common import train_config

HW = 16
CHUNK = 16
FRAMES = 20  # two chunks: 16 frames, then 4 padded to 16
ENGINE_SPANS = ("transfer.video", "transfer.upload", "transfer.chunk", "transfer.detect",
                "transfer.generate", "transfer.gather")


def _spans(prof, prefixes=("transfer.", "trainer.", "loop.")):
    """{name: [(start_us, end_us)]} of the profiler's events whose names
    start with one of `prefixes`, in order of start."""
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(prefixes):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.fixture(scope="module")
def engine():
    generator, kp_detector = build_models(train_config(), device="cpu")
    return TransferEngine(generator, kp_detector, chunk=CHUNK, dtype=torch.float32,
                          device="cpu")


def _video(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.rand(1, 1, HW, HW, 3).astype(np.float32)),
            torch.from_numpy(rng.rand(1, FRAMES, HW, HW, 3).astype(np.float32)))


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """The span reads torch.autograd.profiler's flag: off, every name gets
    the one no-op object and a profiler opened afterwards holds none of
    them; with the flag set, a RecordFunctionFast range, which the profiler
    keeps as a host op (not a user annotation, which the CUDA profiler
    copies onto the device's timeline)."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("transfer.video") is tracing.span("trainer.step") is tracing.OFF
    with tracing.span("transfer.video"), tracing.span("trainer.step"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
        on = tracing.span("loop.log")
        with tracing.span("loop.checkpoint"):
            pass
    assert list(_spans(prof)) == ["loop.checkpoint"]
    assert isinstance(on, torch._C._profiler._RecordFunctionFast)
    assert {str(e.activity_type()) for e in prof.profiler.kineto_results.events()
            if e.name() == "loop.checkpoint"} == {"cpu_op"}
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert isinstance(tracing.span("x"), torch._C._profiler._RecordFunctionFast)


def test_engine_spans_nest_and_leave_the_outputs_alone(engine):
    """One video of two chunks, the second padded: one transfer.video
    holding one transfer.upload and two transfer.chunk, each chunk holding
    one detect, one generate and one gather; the outputs bit for bit those
    of the call without a profiler."""
    source, driving = _video()
    want = engine(source, driving)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = engine(source, driving)
    spans = _spans(prof)
    assert sorted(spans) == sorted(ENGINE_SPANS)
    (video,) = spans["transfer.video"]
    (upload,) = spans["transfer.upload"]
    chunks = spans["transfer.chunk"]
    assert len(chunks) == 2 and _inside(upload, video) and upload[1] <= chunks[0][0]
    for name in ("transfer.detect", "transfer.generate", "transfer.gather"):
        assert len(spans[name]) == 2
        for child, chunk in zip(spans[name], chunks):
            assert _inside(chunk, video) and _inside(child, chunk), name
    assert got["video_prediction"].shape[1] == FRAMES
    flat = lambda out: [out["video_prediction"], out["video_deformed"],  # noqa: E731
                        *out["kp_driving"].values(), *out["kp_norm"].values(),
                        *out["kp_source"].values()]
    for a, b in zip(flat(want), flat(got)):
        assert torch.equal(a, b)


def test_trainer_run_holds_one_span_a_step():
    config = train_config()
    trainer = Trainer(build_train_models(config, device="cpu"), config["train_params"],
                      device="cpu", steps_per_epoch=2)
    rng = np.random.RandomState(1)
    chunk = {k: torch.from_numpy(rng.rand(2, 2, 1, HW, HW, 3).astype(np.float32))
             for k in ("source", "video")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics, _ = trainer.run(chunk, 0, 2)
    assert metrics.shape[0] == 2
    spans = _spans(prof)
    assert sorted(spans) == ["trainer.run", "trainer.step"]
    (run,) = spans["trainer.run"]
    steps = spans["trainer.step"]
    assert len(steps) == 2 and all(_inside(s, run) for s in steps)
    assert steps[0][1] <= steps[1][0]


def test_profile_trace_names_the_loop_phases(tmp_path):
    """train(..., profile_dir) past the profiled steps 10-20, on the CPU,
    two steps a dispatch: the chrome trace holds the trainer's steps, the
    feed's waits, the logger's and the epochs' ends."""
    root = tmp_path / "videos"
    for split, n in (("train", 4), ("test", 1)):
        os.makedirs(root / split)
        for i in range(n):
            write_stacked_png(str(root / split / f"{i:03d}.png"),
                              np.random.RandomState(i).rand(5, HW, HW, 3).astype(np.float32))
    config = train_config()
    config["dataset_params"] = {"root_dir": str(root), "image_shape": [HW, HW, 3]}
    config["train_params"].update(num_epochs=22, epoch_milestones=[100], batch_size=4,
                                  steps_per_dispatch=2,
                                  log_params={"log_freq_iter": 100, "cpk_freq_epoch": 100})
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    run = tloop.train(config, str(tmp_path / "log"), dataset, profile_dir=str(tmp_path / "trace"),
                      device="cpu")
    assert run.steps == 22
    with open(tmp_path / "trace" / "train_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"trainer.run", "trainer.step", "loop.feed_wait", "loop.log",
            "loop.checkpoint"} <= names
