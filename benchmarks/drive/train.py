"""Traffic kind 'train': a trainer's GAN steps through Trainer.run.

The configuration's train_params set the batch, the dtype, remat and the
steps a dispatch (k). Each dispatch takes k steps, each on its own batch of
uint8 source and driving frames drawn on the card from a seeded pool of
clips (a source and a driving frame of one clip, as a train split's videos
give them), held on the card as the device feed holds its cache. After each
dispatch the host reads the k steps' losses, as a logger does, which waits
for the dispatch. Dispatches start while the window is open; the window
closes when the last has finished. A traced run times its window untraced
as every run does, then profiles `trace_dispatches` more dispatches.

Set-up builds one Trainer and takes its first three steps through
`Trainer.run` on three distinct batches (the first call captures the CUDA
graph): the steps the reference follows. Then one dispatch of k steps warms
the window's shapes. The window goes on training the same Trainer.

The traffic file's keys: kind, pool_clips, clip_frames, steps_per_epoch,
trace_dispatches.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmarks import check, flops, frames, kernels, program, weights

CHECK_STEPS = 3


def run(ctx) -> Dict:
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    H, W = cfg["image_size"]
    mp, tp = cfg["model_params"], cfg["train_params"]
    B, k = tp["batch_size"], tp["steps_per_dispatch"]
    pool = frames.clips(tr["pool_clips"], tr["clip_frames"], (H, W), ctx.subseed(1), device)
    state = weights.draw(mp, ctx.subseed(2), pool[0, :16])
    pool = frames.to_uint8(pool).reshape(-1, H, W, 3)
    ctx.reset_memory_peak()
    trainer = program.trainer(mp, tp, state, device, tr["steps_per_epoch"])
    gen = torch.Generator(device=device).manual_seed(ctx.subseed(3))
    L = tr["clip_frames"]

    def feed(steps: int) -> Dict[str, torch.Tensor]:
        clip = torch.randint(0, tr["pool_clips"], (steps, B), generator=gen, device=device) * L
        pair = torch.randint(0, L, (2, steps, B), generator=gen, device=device)
        return {"source": pool[clip + pair[0]][:, :, None],
                "video": pool[clip + pair[1]][:, :, None]}

    first = feed(CHECK_STEPS)
    batches = [{k_: v[j].cpu() for k_, v in first.items()} for j in range(CHECK_STEPS)]
    m1, vis = trainer.run(first, 0, 1, vis_steps=[0])
    outputs = (vis[0]["video_prediction"].float().cpu(),
               vis[0]["kp_joined"]["mean"].float().cpu())
    beta1 = trainer.optimizers["generator"].param_groups[0]["betas"][0]
    grads = {name: {leaf: _first_moment(trainer.optimizers[name], p) / (1.0 - beta1)
                    for leaf, p in trainer.models[name].named_parameters()}
             for name in trainer.models}
    m23, _ = trainer.run(first, 1, CHECK_STEPS)
    delta = {name: {leaf: p.detach().cpu() - state[name][leaf]
                    for leaf, p in trainer.models[name].named_parameters()}
             for name in trainer.models}
    losses = torch.cat([m1, m23]).tolist()
    trainer.run(feed(k), 0, k)[0].cpu()  # warm the window's dispatch
    ctx.sync()

    window = ctx.open_window()
    steps = failed = 0

    def dispatch() -> None:
        nonlocal failed
        metrics = trainer.run(feed(k), 0, k)[0].cpu()
        failed += int((~torch.isfinite(metrics).all(dim=1)).sum())

    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        dispatch()
        steps += k
    ctx.sync()
    window_s = time.perf_counter() - t0
    steps_run = steps
    out = {"end_to_end": {"train_samples_per_s": steps * B / window_s}}
    if ctx.trace:  # after the window, so that the profiler slows none of it
        window.start()
        for _ in range(tr["trace_dispatches"]):
            dispatch()
        window.stop()
        traced = k * tr["trace_dispatches"]
        steps_run += traced
        out["records"] = _records(ctx, window, traced, mp, tp, (H, W))
        out["records"].update(
            window_host_s=window_s,
            window_model_flops=flops.train_step_flops(mp, tp, (H, W), B) * steps)
    out.update(attempted=steps_run, failed=failed, memory_peak_bytes=ctx.memory_peak())
    del trainer, pool, first
    ctx.free()
    check.set_float32_exact()
    out["numbers"] = check.train_numbers(losses, grads, delta, outputs,
                                         *check.reference_train(mp, tp, state, batches, device))
    return out


def _first_moment(optimizer, p) -> torch.Tensor:
    """Adam's first moment of p on the host (zeros where it has taken no
    step): after one step, (1 - beta1) times the gradient it received."""
    moment = optimizer.state.get(p, {}).get("exp_avg")
    return (torch.zeros_like(p) if moment is None else moment).detach().cpu()


def _records(ctx, window, steps, mp, tp, hw) -> Dict:
    B = tp["batch_size"]
    ops = kernels.path_ops(mp, hw, "train_step", batch=B, remat=bool(tp.get("remat")))
    per_step = kernels.bytes_by_op(ops, kernels.itemsize_of(tp.get("compute_dtype")))
    return {"trace": window.records(), "traced_host_s": window.host_s,
            "traced_frames": None, "traced_steps": steps,
            "model_flops": flops.train_step_flops(mp, tp, hw, B) * steps,
            "kernel_bytes": {op: b * steps for op, b in per_step.items()},
            "device_name": ctx.device_name, "compute_dtype": tp.get("compute_dtype")}
