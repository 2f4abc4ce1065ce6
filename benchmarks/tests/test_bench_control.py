"""The control, and for a train cell the half-batch fault, judged as a run
is: each comes out not correct under the cell's committed limits. The
taichi-64 transfer runs here on the CPU at the cell's widths on fewer and
shorter videos; the train cells, whose numbers depend on the batch, and the
256x256 transfer run on the card at their own size."""

from __future__ import annotations

import pytest
import torch

from benchmarks import check, control, harness
from benchmarks.tests import fixture

SPEC = harness.Spec()


def _fails(cell, numbers):
    checks = harness.judge(numbers, SPEC.limits(SPEC.cell(cell)))
    return not all(c["ok"] for c in checks.values())


def _device(cell):
    if cell == "taichi64.transfer":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        pytest.skip("this cell's control runs on the card at the cell's size")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["taichi64.transfer", pytest.param(
    "vox256.transfer", marks=pytest.mark.card)])
def test_transfer_control_is_not_correct(cell):
    device = _device(cell)
    check.set_float32_exact()
    c = SPEC.cell(cell)
    traffic = SPEC.traffic(c)
    if device.type == "cpu":
        traffic = dict(traffic, max_frames=24, min_frames=8, videos=4)
    found = control.transfer_readings(SPEC.config(c), traffic, 3, device, videos=1)
    assert _fails(cell, found["fp8"]), found


@pytest.mark.card
@pytest.mark.parametrize("cell", fixture.cells("train"))
def test_train_control_and_half_batch_are_not_correct(cell):
    device = _device(cell)
    check.set_float32_exact()
    c = SPEC.cell(cell)
    found = control.train_readings(SPEC.config(c), SPEC.traffic(c), 3, device)
    assert _fails(cell, found["fp8"]), found["fp8"]
    assert _fails(cell, found["half_batch"]), found["half_batch"]
