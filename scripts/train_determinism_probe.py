#!/usr/bin/env python3
"""Is the port's train step reproducible run to run on the card?

    python3 scripts/train_determinism_probe.py [trainer] [loop] [kernels]

On configs/shapes.yaml at full width (batch 16, 64^2, device-fed from the
first 512 train videos of data/shapes, the step's CUDA graph), three
Trainers from the same seed take the same 32 steps: two unsharded, and one
over a one-rank NCCL process group (the data-parallel path). After 1, 4 and
32 steps the script prints how many parameter, buffer and optimizer tensors
differ between the two unsharded runs, and between the first and the group's,
and by how much, for f32 with cuDNN's deterministic algorithms, f32 with
`torch.use_deterministic_algorithms` too, and bf16.
'loop' runs train() itself three times on the same cut (bf16, 2 epochs of
32 steps, cuDNN deterministic): unsharded, unsharded again, and over a
one-rank NCCL group, and prints which checkpoint tensors differ between the
first and each other. 'kernels' runs each warp backward kernel twice on the
same inputs at the step's shapes (random grids, f32 and bf16) and prints
whether its outputs agree bit for bit. All three parts by default. One JSON
line per case. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
STEPS = (1, 4, 32)


def _differences(a, b) -> dict:
    bad = {k: (a[k].double() - b[k].double()).abs().max().item()
           for k in a if not torch.equal(a[k], b[k])}
    return {"differing": len(bad), "of": len(a), "max_abs": max(bad.values(), default=0.0),
            "first": sorted(bad)[:4]}


def _checkpoint_differences(a, b) -> dict:
    """The entries of two (nested) checkpoints that are not equal bit for
    bit, with their largest absolute difference; and the tensors compared."""
    out, count = {}, 0

    def walk(x, y, where):
        nonlocal count
        if isinstance(x, torch.Tensor):
            count += 1
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x.cpu(), y.cpu())):
                out[where] = ((x.double().cpu() - y.double().cpu()).abs().max().item()
                              if isinstance(y, torch.Tensor) and x.shape == y.shape else "shape")
        elif isinstance(x, dict):
            if set(x) != set(y):
                out[where] = "keys"
            for key in set(x) & set(y):
                walk(x[key], y[key], f"{where}.{key}")
        elif isinstance(x, (list, tuple)):
            for i, (p, q) in enumerate(zip(x, y)):
                walk(p, q, f"{where}[{i}]")
        elif x != y:
            out[where] = f"{x!r} != {y!r}"

    walk(a, b, "")
    return {"differing": out, "compared": count}


def _state(trainer) -> dict:
    out = {}
    for name, model in trainer.models.items():
        for key, value in model.state_dict().items():
            out[f"{name}.{key}"] = value.detach().clone()
        for i, entry in enumerate(trainer.optimizers[name].state.values()):
            for key, value in entry.items():
                if torch.is_tensor(value):
                    out[f"{name}.adam{i}.{key}"] = value.detach().clone()
    return out


def _loop(config, dataset, smi) -> None:
    import copy
    import tempfile

    import chip_smoke
    from monkeynet_tpu_torch.tasks.train_loop import train
    from monkeynet_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint

    config = copy.deepcopy(config)
    config["train_params"].update(num_epochs=chip_smoke.LOOP_EPOCHS, compute_dtype="bfloat16",
                                  log_params={"log_freq_iter": chip_smoke.LOOP_LOG_FREQ,
                                              "cpk_freq_epoch": 1})
    torch.backends.cudnn.deterministic = True
    states = {}
    with tempfile.TemporaryDirectory() as work:
        for run in ("unsharded", "again", "nccl_one_rank"):
            group = chip_smoke._process_group("nccl") if run == "nccl_one_rank" else None
            log_dir = Path(work) / run
            log_dir.mkdir()
            train(config, str(log_dir), dataset, seed=chip_smoke.SEED, group=group)
            if group is not None:
                dist.destroy_process_group()
            states[run] = [load_checkpoint(str(log_dir / checkpoint_name(e)))
                           for e in range(chip_smoke.LOOP_EPOCHS)]
    for run in ("again", "nccl_one_rank"):
        print(json.dumps({"case": f"train() bf16, unsharded against {run}", "card": smi, **{
            f"epoch_{e}": len(_checkpoint_differences(a, b)["differing"])
            for e, (a, b) in enumerate(zip(states["unsharded"], states[run]))}}), flush=True)


def main() -> int:
    parts = sys.argv[1:] or ["trainer", "loop", "kernels"]
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from monkeynet_tpu_torch.data.dataset import FramesDataset
    from monkeynet_tpu_torch.ops.cuda import warp
    from monkeynet_tpu_torch.tasks.build import build_train_models
    from monkeynet_tpu_torch.tasks.train import Trainer
    from monkeynet_tpu_torch.utils.config import load_config

    chip_smoke.full_f32()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    config = load_config(str(REPO / "configs" / "shapes.yaml"))
    config["dataset_params"]["root_dir"] = str(REPO / "data" / "shapes")
    tp = config["train_params"]
    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    dataset.images = dataset.images[:chip_smoke.LOOP_VIDEOS]
    if "loop" in parts:
        _loop(config, dataset, smi)
    execute, cache, lengths = chip_smoke._device_feed_of(dataset, dataset.image_shape)
    chunk = chip_smoke._plan_chunk(dataset, lengths, tp["batch_size"], STEPS[-1])

    def augment(plan):
        return execute(cache, plan)

    settings = {"f32 cudnn deterministic": (None, False),
                "f32 all deterministic": (None, True),
                "bf16 cudnn deterministic": ("bfloat16", False)}
    torch.backends.cudnn.deterministic = True
    for label, (dtype, everything) in (settings.items() if "trainer" in parts else ()):
        torch.use_deterministic_algorithms(everything, warn_only=True)
        states = []
        for run in ("unsharded", "again", "nccl_one_rank"):
            group = chip_smoke._process_group("nccl") if run == "nccl_one_rank" else None
            trainer = Trainer(build_train_models(config, seed=chip_smoke.SEED),
                              dict(tp, compute_dtype=dtype), steps_per_epoch=100, group=group)
            taken, snaps = 0, []
            for stop in STEPS:
                trainer.run(chunk, taken, stop, augment=augment)
                taken = stop
                torch.cuda.synchronize()
                snaps.append(_state(trainer))
            states.append(snaps)
            del trainer
            if group is not None:
                dist.destroy_process_group()
        plain, again, sharded = states
        print(json.dumps({"case": label, "card": smi, **{
            f"after_{n}": {"again": _differences(a, b), "nccl_one_rank": _differences(a, c)}
            for n, a, b, c in zip(STEPS, plain, again, sharded)}}), flush=True)
    torch.use_deterministic_algorithms(False)

    if "kernels" not in parts:
        return 0
    B, warps, _ = chip_smoke.shapes_train_shapes(config)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for C, h in warps:
            src, dout, grids = chip_smoke._warp_train_inputs(B, h, C, dtype, gen, "cuda")
            grid, shape = grids["random"], tuple(src.shape)
            same = {
                "warp_dsrc": torch.equal(warp.warp_dsrc(grid, dout, shape),
                                         warp.warp_dsrc(grid, dout, shape)),
                "warp_dgrid": torch.equal(warp.warp_dgrid(src, grid, dout),
                                          warp.warp_dgrid(src, grid, dout)),
            }
            print(json.dumps({"case": "kernel twice", "dtype": str(dtype), "shape": list(shape),
                              "bit_for_bit": same, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
