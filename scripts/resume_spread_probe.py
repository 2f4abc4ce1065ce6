#!/usr/bin/env python3
"""The spread of the JAX package's resumed train loop on the CPU, which
tests/test_torch_port_loop.py::test_resume_matches_jax bounds.

    JAX_PLATFORMS=cpu python3 scripts/resume_spread_probe.py [--threads 1 2 4 8]
        [--noise 1e-7] [--seeds 6] [--epochs 2] [--jobs 4] [--kink]

Each run is a process of its own at OMP_NUM_THREADS = t, for every thread
count t and for the checkpoint as written and `--seeds` noisy copies of it:
the loop test's `loop_runs` (both packages' fresh runs from one initial
checkpoint, `--epochs` epochs of 2 steps, then both resumed from the
port's epoch-0 checkpoint), the noisy ones resuming from a copy of that
checkpoint whose floating parameters are scaled by 1 + noise * N(0, 1)
(numpy seed s). Per run it prints both packages'
resumed log rows and the share of the resumed run's parameter entries
within 1e-6 of the JAX package's; then, per row after the resume, the
largest gap port - JAX, between two JAX runs and between two port runs,
and the range of the shares.

--kink: instead, one run at the first thread count: the port's run
resumed once more, its state before its second step, the gradient of the step's objective
there, and the same after scaling every parameter by 1 + 1e-7, 1e-6 and
1e-5 * N(0, 1) (four seeds each): the largest relative change of a
gradient tensor of the kp detector and generator, and the ReLU inputs
that changed sign. Imports JAX (the JAX package's initial weights and
loop); no card needed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _state_gaps(jax_state, trainer):
    """(largest gap, share of parameter entries within 1e-6) between the
    JAX package's final state and the port's, as the loop test counts
    them."""
    import jax
    import torch

    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES
    from monkeynet_tpu_torch.utils.weights import from_jax_variables

    worst, gaps = 0.0, []
    for name in MODEL_NAMES:
        want = from_jax_variables(jax.tree.map(np.asarray, jax_state.params[name]),
                                  jax.tree.map(np.asarray, jax_state.batch_stats.get(name, {})))
        got = trainer.models[name].state_dict()
        for key, w in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            gap = (got[key] - w).abs()
            worst = max(worst, gap.max().item())
            if "running_" not in key:
                gaps.append(gap.flatten())
    return worst, (torch.cat(gaps) <= 1e-6).float().mean().item()


def _scaled(noise: float, seed: int):
    """A `perturb` for the loop test's `loop_runs`: a copy of the checkpoint
    whose floating parameters are scaled by 1 + noise * N(0, 1)."""
    import torch

    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES
    from monkeynet_tpu_torch.utils.checkpoint import save_checkpoint

    def perturb(path: str) -> str:
        state = torch.load(path, map_location="cpu", weights_only=True)
        rng = np.random.RandomState(seed)
        for name in MODEL_NAMES:
            for key, v in state[name].items():
                if v.is_floating_point() and "running_" not in key:
                    scale = 1 + noise * rng.randn(*v.shape).astype(np.float32)
                    state[name][key] = v * torch.from_numpy(scale)
        out = str(Path(path).with_name("noisy-" + Path(path).name))
        save_checkpoint(out, state)
        return out

    return perturb


def _run(work: Path, epochs: int, noise: float, seed: int, kink: bool):
    """The loop test's runs in `work`; what the run reports."""
    from tests import test_torch_port_loop as loop

    def mkdir(name):
        (work / name).mkdir()
        return work / name

    runs = loop.loop_runs(mkdir, epochs, _scaled(noise, seed) if noise else None)
    if kink:
        return _kink(runs, work)
    rows = {name: {it: values for it, (_, values) in
                   sorted(loop._log_rows(runs["dirs"][name]).items())}
            for name in ("jax_resumed", "port_resumed")}
    worst, share = _state_gaps(runs["jax_resumed"], runs["port_resumed"].trainer)
    return {"rows": rows, "param_gap": worst, "share": share}


def _kink(runs, work):
    """The port's run resumed once more, up to its second step; that step's
    gradient under small parameter noise, and the ReLU inputs that change
    sign."""
    import torch
    import torch.nn.functional as F

    import monkeynet_tpu_torch.tasks.train_loop as tloop
    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import MODEL_NAMES, Trainer

    config = runs["config"]
    dataset = FramesDataset(is_train=True, **config["dataset_params"])

    seen = {"steps": 0}
    step = Trainer.step

    def recording(self, batch):
        if seen["steps"] == 1:  # the state before the second resumed step
            seen["state"] = {n: {k: v.clone() for k, v in self.models[n].state_dict().items()}
                             for n in MODEL_NAMES}
            seen["batch"] = {k: v.clone() for k, v in batch.items()}
        seen["steps"] += 1
        return step(self, batch)

    Trainer.step = recording
    try:
        tloop.train(config, str(work / "kink"), dataset, checkpoint=runs["resume_from"],
                    device="cpu")
    finally:
        Trainer.step = step
    relu_inputs = []
    relu = F.relu

    def recording_relu(x, *args, **kwargs):
        relu_inputs.append(x.detach().clone())
        return relu(x, *args, **kwargs)

    def grads(noise, seed):
        rng = np.random.RandomState(seed)
        models = build_train_models(config, device="cpu")
        for name in MODEL_NAMES:
            sd = {}
            for key, v in seen["state"][name].items():
                if noise and v.is_floating_point() and "running_" not in key:
                    v = v * torch.from_numpy(1 + noise * rng.randn(*v.shape).astype(np.float32))
                sd[key] = v
            models[name].load_state_dict(sd)
        trainer = Trainer(models, config["train_params"], device="cpu", steps_per_epoch=2)
        relu_inputs.clear()
        F.relu = recording_relu
        try:
            loss = trainer.objective(seen["batch"])[0]
        finally:
            F.relu = relu
        loss.backward()
        out = {f"{n}.{k}": p.grad.clone() for n in ("kp_detector", "generator")
               for k, p in trainer.models[n].named_parameters() if p.grad is not None}
        return out, list(relu_inputs)

    base, base_relu = grads(0.0, 0)
    top = max(g.norm().item() for g in base.values())
    rows = []
    for noise in (1e-7, 1e-6, 1e-5):
        for seed in range(4):
            got, got_relu = grads(noise, seed)
            change = max(((got[k] - g).norm() / g.norm()).item() for k, g in base.items()
                         if g.norm().item() > 1e-3 * top)
            flips = [{"relu": i, "shape": list(a.shape), "count": int(((a > 0) != (b > 0)).sum()),
                      "input": float(b[(a > 0) != (b > 0)].abs().min())}
                     for i, (a, b) in enumerate(zip(got_relu, base_relu)) if ((a > 0) != (b > 0)).any()]
            rows.append({"noise": noise, "seed": seed, "largest_relative_change": change,
                         "relu_sign_changes": flips})
    return {"kink": rows}


def _child(args) -> None:
    sys.path.insert(0, str(REPO))
    with tempfile.TemporaryDirectory(prefix="resume_spread_") as work:
        out = _run(Path(work), args.epochs, args.noise[0], args.seed, args.kink)
    print("RESULT " + json.dumps(out), flush=True)


def _summary(runs: dict) -> None:
    rows = {key: {name: np.array([v for _, v in sorted(r["rows"][name].items(),
                                                         key=lambda kv: int(kv[0]))])
                  for name in ("jax_resumed", "port_resumed")} for key, r in runs.items()}
    n = min(len(r["jax_resumed"]) for r in rows.values())
    for r in range(n):
        pj = max(np.abs(x["port_resumed"][r] - x["jax_resumed"][r]).max() for x in rows.values())
        pairs = list(itertools.combinations(rows.values(), 2))
        jj = max((np.abs(a["jax_resumed"][r] - b["jax_resumed"][r]).max() for a, b in pairs),
                 default=0.0)
        pp = max((np.abs(a["port_resumed"][r] - b["port_resumed"][r]).max() for a, b in pairs),
                 default=0.0)
        print(json.dumps({"row_after_resume": r, "port_vs_jax": float(pj),
                          "jax_vs_jax": float(jj), "port_vs_port": float(pp)}))
    shares = [r["share"] for r in runs.values()]
    print(json.dumps({"runs": len(runs), "share_min": min(shares), "share_max": max(shares),
                      "param_gap_max": max(r["param_gap"] for r in runs.values())}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--noise", type=float, nargs="+", default=[1e-7])
    parser.add_argument("--seeds", type=int, default=6)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--jobs", type=int, default=4)
    parser.add_argument("--kink", action="store_true")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=0, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        _child(args)
        return 0
    runs = [(t, 0.0, 0) for t in args.threads]
    if not args.kink:
        runs += [(t, noise, s) for noise in args.noise for s in range(args.seeds)
                 for t in args.threads]
    else:
        runs = runs[:1]
    results, pending = {}, list(runs)
    while pending:
        batch, pending = pending[:args.jobs], pending[args.jobs:]
        procs = []
        for t, noise, seed in batch:
            env = dict(os.environ, OMP_NUM_THREADS=str(t), JAX_PLATFORMS="cpu")
            cmd = [sys.executable, __file__, "--child", "--epochs", str(args.epochs),
                   "--noise", str(noise), "--seed", str(seed)] + (["--kink"] if args.kink else [])
            procs.append(((t, noise, seed), subprocess.Popen(
                cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)))
        for key, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"run {key} failed with {proc.returncode}")
            result = json.loads(out.split("RESULT ", 1)[1])
            results[key] = result
            print(json.dumps({"threads": key[0], "noise": key[1], "seed": key[2], **result}),
                  flush=True)
    if not args.kink:
        _summary(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
