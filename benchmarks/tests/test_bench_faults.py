"""A run with the timed path broken underneath comes out not correct under
each cell's committed limits: each fault a cell can have, planted in the
program, on its plain path at tiny sizes: a sound run of every cell, the
train faults in every cell of traffic kind 'train'. The configurations run
in float32 here, where a sound run reads far below every limit (the program
and the reference agree to ~1e-5 in transfer and in a step's outputs)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmarks import harness, run
from benchmarks.tests import fixture

CELLS = fixture.cells()
TRAIN_CELLS = fixture.cells("train")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return fixture.float32(fixture.make_root(tmp_path_factory.mktemp("faults")))


def _correct(root: Path, cell: str) -> bool:
    out = json.loads(run.drive(root, cell, 99, 0.3, 0, "cpu")[0])
    return out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    assert _correct(root, cell)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged(root, monkeypatch, cell):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not _correct(root, cell)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_the_batch_left_out(root, monkeypatch, cell):
    from monkeynet_tpu_torch.tasks import train

    monkeypatch.setattr(train, "_gmean", lambda v, world=1: v.float()[: v.shape[0] // 2].mean())
    assert not _correct(root, cell)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_gradient_left_out_where_it_is_produced(root, monkeypatch, cell):
    from monkeynet_tpu_torch.ops import sampling

    class Drop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return torch.zeros_like(g)

    warp = sampling.warp
    monkeypatch.setattr(sampling, "warp", lambda image, grid: Drop.apply(warp(image, grid)))
    assert not _correct(root, cell)


def _patch_generator(monkeypatch, change):
    from monkeynet_tpu_torch.models.generator import MotionTransferGenerator

    forward = MotionTransferGenerator.forward
    monkeypatch.setattr(MotionTransferGenerator, "forward",
                        lambda self, source, kp_driving, kp_source:
                        change(forward, self, source, kp_driving, kp_source))


@pytest.mark.parametrize("cell", ["taichi64.transfer", *TRAIN_CELLS])
def test_an_answer_altered_where_it_is_produced(root, monkeypatch, cell):
    def change(forward, self, *args):
        out = forward(self, *args)
        pred = out["video_prediction"].clone()
        pred[:, 0] = 1.0 - pred[:, 0]
        return dict(out, video_prediction=pred)

    _patch_generator(monkeypatch, change)
    assert not _correct(root, cell)


def test_half_the_frames_left_out(root, monkeypatch, tmp_path):
    # The generator sees a video's chunk padded to 16 frames: a video of 8
    # frames or fewer loses only padding, and a loaded CPU may finish one
    # video in the window. Every video here has 17-20 frames in a chunk of 32,
    # so the frames left out are real ones (read 0.21-0.23 against 0.12 on
    # seed 99 in windows that finish 1 to 25 videos).
    cell = "taichi64.transfer"
    root = Path(shutil.copytree(root, tmp_path / "root"))
    spec = harness.Spec(root)
    path = root / "benchmarks" / "traffic" / f"{spec.cell(cell)['traffic']}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), min_frames=17)))

    def change(forward, self, source, kp_driving, kp_source):
        d = kp_driving["mean"].shape[1]
        half = {k: v[:, : max(1, d // 2)] for k, v in kp_driving.items()}
        out = forward(self, source, half, kp_source)
        reps = -(-d // half["mean"].shape[1])
        return {k: v.repeat(1, reps, 1, 1, 1)[:, :d] for k, v in out.items()}

    _patch_generator(monkeypatch, change)
    assert not _correct(root, cell)
