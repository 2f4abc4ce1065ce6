#!/usr/bin/env python3
"""What chip_smoke.py's phase 8 (b) reads when the data-parallel step
reduces wrongly, beside what it reads on the sound step.

    python3 scripts/parallel_fault_probe.py

Phase 8 (b) runs two gloo ranks that share the card at configs/actions.yaml's
width (the global batch of 32 as two slabs of 16) against one process at
batch 32, and holds each step's update (from the one process's state before
that step) and the running statistics after it (chip_smoke.parallel_refusals).
Here the same comparison runs for the sound step, for two controls of one
process, and for each fault below, planted at run time in the ranks'
processes (the repository is not changed):

- no_gradient_sum: the ranks' gradients are not summed;
- local_batch_norm: the batch norms normalise with their rank's slab's
  statistics (what one process computes from two batch-16 halves with no
  collectives);
- no_world_division: the loss means are not divided by the group's size.

One JSON line per case, with each rank's gaps in bf16 and f32, the limits
and phase 8 (b)'s refusals. Fails unless the sound step and the controls pass and
every fault is refused in both dtypes. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _no_gradient_sum(train):
    train.Trainer._sum_gradients = lambda self: None


def _local_batch_norm(train):
    train.set_process_group = lambda module, group: module


def _no_world_division(train):
    train._gmean = lambda v, world=1: v.float().mean()


FAULTS = {"sound": None, "no_gradient_sum": _no_gradient_sum,
          "local_batch_norm": _local_batch_norm, "no_world_division": _no_world_division}


def fault_rank(rank: int, world: int, device, reference: str, fault: str) -> dict:
    """One rank of (b)'s steps with `fault` planted: its comparison with the
    one process's run in `reference`."""
    import torch
    import torch.distributed as dist

    from monkeynet_tpu_torch.tasks import train

    if FAULTS[fault] is not None:
        FAULTS[fault](train)
    chip_smoke.full_f32()
    want = torch.load(reference, weights_only=True)
    got = chip_smoke._parallel_steps(world, rank, torch.device(device), dist.group.WORLD,
                                     starts={d: w["starts"] for d, w in want.items()})
    return chip_smoke._compare_parallel(got, want)


def verdict(case: str, ranks: list, smi: str, seconds: float) -> dict:
    """Phase 8 (b)'s refusals of the ranks' comparisons, per dtype."""
    refusals = {dtype: chip_smoke.parallel_refusals([r[dtype] for r in ranks], dtype)
                for dtype in ranks[0]}
    row = {"case": case, "card": smi, "seconds": seconds,
           "tol": {"network_update_rel_l2": chip_smoke.PARALLEL_UPDATE_TOL,
                   "running_max_abs": chip_smoke.PARALLEL_BN_TOL,
                   "metrics_max_rel": chip_smoke.PARALLEL_METRICS_TOL},
           "refused": {dtype: bool(r) for dtype, r in refusals.items()},
           "refusals": refusals, "ranks": ranks}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    import subprocess

    import torch

    from monkeynet_tpu_torch.parallel.distributed import spawn

    if not torch.cuda.is_available():
        print("parallel_fault_probe: needs a CUDA card", file=sys.stderr)
        return 2
    chip_smoke.full_f32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    chip_smoke.build_kernels()
    rows = []
    with tempfile.TemporaryDirectory(prefix="monkeynet_faults_") as work:
        t0 = time.perf_counter()
        want, reference, swapped = chip_smoke.parallel_reference(Path(work))
        again = chip_smoke._compare_parallel(
            chip_smoke._parallel_steps(1, 0, torch.device("cuda"),
                                       starts={d: w["starts"] for d, w in want.items()}), want)
        seconds = time.perf_counter() - t0
        rows.append(verdict("control_one_process_again", [again], smi, seconds))
        rows.append(verdict("control_one_process_swapped_halves", [swapped], smi, seconds))
        del want
        torch.cuda.empty_cache()
        for fault in FAULTS:
            t0 = time.perf_counter()
            ranks = spawn(fault_rank, ["cuda:0"] * chip_smoke.PARALLEL_RANKS, "gloo",
                          args=(str(reference), fault), timeout=600)
            rows.append(verdict(fault, ranks, smi, time.perf_counter() - t0))

    def as_expected(row):  # a fault refused in every dtype, the rest in none
        refused = list(row["refused"].values())
        return all(refused) if FAULTS.get(row["case"]) else not any(refused)

    wrong = [row["case"] for row in rows if not as_expected(row)]
    print(json.dumps({"probe": "parallel_fault_probe", "card": smi, "ok": not wrong,
                      "wrong": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
