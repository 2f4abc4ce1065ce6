"""On the card: one short run of each cell through the command, correct and
with the contract's last line. Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmarks import harness
from benchmarks.tests import fixture

CELLS = [c["name"] for c in harness.Spec().data["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", cell,
                          "--seed", "2718281828", "--seconds", "3", "--trace", "0"],
                         cwd=fixture.REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
