"""Traffic kind 'transfer': animators' videos through the TransferEngine.

One client in a closed loop: a video is handed to the engine when the one
before it has come back. A request is a source frame and a driving video of
float32 frames in pinned host memory, as a decoder leaves them, sliced from
one seeded pool of clips; its answer is the predicted frames and the
driving keypoints, copied back to the host. A video's time runs from being
handed to the engine to its answer being on the host.

Lengths: `videos` lengths spaced evenly in log between `min_frames` and
`max_frames` (the quantiles of a log-uniform draw, so every seed runs the
same set of sizes), shuffled by the seed and taken in turn, round after
round. Requests are issued while the window is open; the window closes when
the last of them has come back, so it holds whole videos only. A traced run
times its window untraced as every run does, then profiles `trace_seconds`
more of the same traffic.

The traffic file's keys: kind, chunk, dtype, min_frames, max_frames,
videos, pool_clips, check_videos, trace_seconds.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks import check, flops, frames, kernels, program, weights


def lengths(traffic: Dict, seed: int) -> List[int]:
    """The traffic's video lengths in the seed's order."""
    lo, hi, n = traffic["min_frames"], traffic["max_frames"], traffic["videos"]
    q = (np.arange(n) + 0.5) / n
    sizes = np.round(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))).astype(int)
    return [int(v) for v in np.random.default_rng(seed).permutation(sizes)]


def chunk_sizes(n: int, chunk: int, granularity: int = 16) -> List[int]:
    """The frames each chunk of an n-frame video runs: whole chunks, then
    the tail padded to a multiple of `granularity`."""
    full, tail = divmod(n, chunk)
    return [chunk] * full + ([min(chunk, -(-tail // granularity) * granularity)] if tail else [])


class Reservoir:
    """A uniform sample of `k` of the answers seen, drawn from a seeded
    generator, and the longest answer apart."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, np.random.default_rng(seed), 0
        self.items, self.longest = [], None

    def offer(self, item: Dict) -> None:
        if self.longest is None or item["frames"] > self.longest["frames"]:
            self.longest = item
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1

    def sample(self) -> List[Dict]:
        out = list(self.items)
        if all(item is not self.longest for item in out):
            out.append(self.longest)
        return out


def window_metrics(done: List, t0: float) -> Dict[str, float]:
    """transfer_fps and transfer_video_p95_s of a window that opened at t0
    and closed when the last of `done` (t_in, t_out, frames) came back."""
    window_s = max(t_out for _, t_out, _ in done) - t0
    return {"transfer_fps": sum(n for _, _, n in done) / window_s,
            "transfer_video_p95_s": float(np.percentile([b - a for a, b, _ in done], 95))}


def run(ctx) -> Dict:
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    H, W = cfg["image_size"]
    mp = cfg["model_params"]
    dtype = getattr(torch, tr["dtype"]) if tr["dtype"] != "float32" else None
    order = lengths(tr, ctx.seed)
    clip_len = tr["max_frames"] + tr["max_frames"] // 4
    pool = frames.clips(tr["pool_clips"], clip_len, (H, W), ctx.subseed(1), device)
    host_pool = pool.cpu().pin_memory() if device.type == "cuda" else pool
    state = weights.draw(mp, ctx.subseed(2), pool[0, :16])
    del pool
    ctx.reset_memory_peak()
    engine = program.transfer_engine(mp, state, device, tr["chunk"], dtype)
    rng = np.random.default_rng(ctx.subseed(3))

    def request(n: int) -> Dict:
        c_src, c_drv = rng.integers(0, tr["pool_clips"], size=2)
        start = int(rng.integers(0, clip_len - n + 1))
        src = int(rng.integers(0, clip_len))
        return {"frames": n, "source": host_pool[c_src, src][None, None],
                "driving": host_pool[c_drv, start:start + n][None]}

    def serve(req: Dict) -> Dict:
        out = engine(req["source"], req["driving"])
        req["prediction"] = out["video_prediction"][0].cpu()
        req["kp"] = out["kp_driving"]["mean"][0].cpu()
        return req

    # warm up every chunk shape the traffic runs, once each
    shapes = sorted({s for n in order for s in chunk_sizes(n, tr["chunk"])})
    for size in shapes:
        serve(request(size))
    ctx.sync()

    ran = [0]  # frames the generator ran in the window, padding included (traced runs)
    hook = None
    if ctx.trace:
        def count(module, args, output):
            ran[0] += args[1]["mean"].shape[1]

        hook = engine.generator.register_forward_hook(count)
    sample = Reservoir(tr["check_videos"], ctx.subseed(4))
    done, attempted, failed = [], 0, 0
    i = 0

    def issue():
        """Hand the next video to the engine: (t_in, t_out, request), or None."""
        nonlocal i, attempted, failed
        req = request(order[i % len(order)])
        i += 1
        attempted += 1
        t_in = time.perf_counter()
        try:
            serve(req)
        except RuntimeError as e:
            failed += 1
            ctx.note(f"request of {req['frames']} frames failed: {e}")
            return None
        return (t_in, time.perf_counter(), req)

    window = ctx.open_window()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        served = issue()
        if served is not None:
            t_in, t_out, req = served
            done.append((t_in, t_out, req["frames"]))
            sample.offer({k: req[k] for k in ("frames", "source", "driving", "prediction", "kp")})
    if hook is not None:
        hook.remove()
    out = {"end_to_end": window_metrics(done, t0)}
    if ctx.trace:  # after the window, so that the profiler slows none of it
        traced = []
        window.start()
        trace_until = time.perf_counter() + tr["trace_seconds"]
        while time.perf_counter() < trace_until:
            served = issue()
            if served is not None:
                traced.append(served[2]["frames"])
        window.stop()
        asked = sum(n for _, _, n in done)
        out["records"] = _records(ctx, window, traced, ran[0], asked, mp, (H, W), tr)
        per_video, per_frame = flops.transfer_flops(mp, (H, W))
        out["records"].update(
            window_host_s=max(t_out for _, t_out, _ in done) - t0,
            window_model_flops=sum(per_video + n * per_frame for _, _, n in done))
    out.update(attempted=attempted, failed=failed, memory_peak_bytes=ctx.memory_peak())
    del engine
    ctx.free()
    out["numbers"] = _check(ctx, mp, state, sample.sample())
    return out


def _records(ctx, window, videos, ran, asked, mp, hw, tr) -> Dict:
    itemsize = kernels.itemsize_of(tr["dtype"])
    per_video, per_frame = flops.transfer_flops(mp, hw)
    video_ops = kernels.bytes_by_op(kernels.path_ops(mp, hw, "transfer_video"), itemsize)
    chunk_ops = {}
    total = dict.fromkeys(kernels.OPS.values(), 0)
    model_flops = 0
    for n in videos:
        model_flops += per_video + n * per_frame
        for op, b in video_ops.items():
            total[op] += b
        for size in chunk_sizes(n, tr["chunk"]):
            if size not in chunk_ops:
                chunk_ops[size] = kernels.bytes_by_op(
                    kernels.path_ops(mp, hw, "transfer_chunk", frames=size), itemsize)
            for op, b in chunk_ops[size].items():
                total[op] += b
    return {"trace": window.records(), "traced_host_s": window.host_s,
            "traced_frames": sum(videos), "traced_steps": None,
            "model_flops": model_flops, "kernel_bytes": total,
            "padded_frames": ran - asked, "generator_frames": ran,
            "device_name": ctx.device_name, "compute_dtype": tr["dtype"]}


def _check(ctx, mp, state, sample) -> Dict[str, float]:
    check.set_float32_exact()
    nets = check.reference_nets(mp, state, ctx.device)
    pairs = []
    for item in sample:
        ref = check.reference_transfer(nets, item["source"], item["driving"], ctx.device)
        pairs.append(((item["prediction"], item["kp"]), ref))
    return check.transfer_numbers(pairs)
