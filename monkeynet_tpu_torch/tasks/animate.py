"""Frame-batched inference: TransferEngine, Animator and KPExtractor.

Counterpart of monkeynet_tpu/tasks/animate.py. Every frame is independent
given its keypoints, so the generator takes all driving frames of a chunk at
once (the frame axis folds into the conv batch). Long videos run in chunks of
`chunk` frames; a short tail is padded to a 16-frame bucket by repeating its
last frame, as the JAX package does to bound its compiled program count, so
both packages run the same batch shapes. Animator's and KPExtractor's
outputs stay on the device. On a CUDA device TransferEngine delivers its
answer to the host itself, a chunk at a time, into host tensors that the
caller owns: each chunk's outputs are copied on a copy stream while the
next chunk computes, straight from the device for small frames and through
a pinned staging ring of two slots for large ones (`_StagingRing`). On the
CPU its outputs are the chunks' tensors concatenated.

`dtype=torch.bfloat16` runs the networks in bf16 (weights, batch-norm
statistics and activations cast, as the JAX package casts its variables);
keypoint math, the mask softmax and every sampling grid stay f32, and the
outputs come back f32.

Frame sharding (`devices`, the JAX package's `mesh`): a replica of each
network is made on each device once, at construction; a chunk is padded to
a multiple of lcm(16, N) frames, split into N frame slabs, one run on each
device, and the results are gathered on the first device and trimmed. A
device may be named more than once (its slabs then share one replica).
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from monkeynet_tpu_torch.parallel.mesh import shard_batch
from monkeynet_tpu_torch.utils.device import require_device
from monkeynet_tpu_torch.utils.tracing import span


def _bucket(n: int, chunk: int, granularity: int = 16) -> int:
    """Frame-count bucket: a chunk shorter than `chunk` is padded to a
    multiple of `granularity`."""
    if n >= chunk:
        return chunk
    return min(chunk, -(-n // granularity) * granularity)


def _pad_frames(x, total: int):
    """Pad the frame axis (1) to `total` by repeating the last frame."""
    n = x.shape[1]
    if n == total:
        return x
    return torch.cat([x, x[:, -1:].expand(-1, total - n, *x.shape[2:])], dim=1)


def _pad_kp(kp: Dict, total: int) -> Dict:
    return {k: _pad_frames(v, total) for k, v in kp.items()}


def _cat(parts, dim=1):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def split_kp(kp_joined: Dict, detach: bool = False) -> Dict[str, Dict]:
    """Frame 0 of a joined keypoint batch is the source; the rest drive.
    `detach` cuts both parts from the autograd graph (the train step's
    detach_kp_generator / detach_kp_discriminator)."""
    def part(v):
        return v.detach() if detach else v

    return {
        "kp_driving": {k: part(v[:, 1:]) for k, v in kp_joined.items()},
        "kp_source": {k: part(v[:, :1]) for k, v in kp_joined.items()},
    }


def _for_inference(model: torch.nn.Module, device, dtype) -> torch.nn.Module:
    model = model.to(device).eval()
    if dtype is not None:
        model = copy.deepcopy(model).to(dtype)
    return model


def _replicas(model: torch.nn.Module, devices, dtype) -> List[torch.nn.Module]:
    """`model` ready for inference on each of `devices`: the first device
    takes `model` itself, each other distinct device a copy."""
    made = {}
    for device in devices:
        if device not in made:
            made[device] = _for_inference(copy.deepcopy(model) if made else model, device, dtype)
    return [made[device] for device in devices]


def _on(tree: Dict, device) -> Dict:
    return {k: v.to(device) for k, v in tree.items()}


class _Sharded:
    """The devices of an engine and its frame granularity, lcm(16, N)."""

    def __init__(self, chunk: int, dtype, device, devices):
        self.devices = [require_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.granularity = int(np.lcm(16, len(self.devices)))
        self.chunk = -(-chunk // self.granularity) * self.granularity
        self.dtype = dtype

    def _slabs(self, x) -> List[torch.Tensor]:
        """x split along its frame axis into one slab a device, each on its
        device."""
        return [slab["x"] for slab in self._kp_slabs({"x": x})]

    def _kp_slabs(self, kp: Dict) -> List[Dict]:
        return shard_batch(kp, self.devices, axis=1)

    def _gather(self, parts, n_valid: int):
        """The slabs' tensors gathered on the first device, trimmed to
        `n_valid` frames."""
        return _cat([p.to(self.device) for p in parts])[:, :n_valid]


class Animator(_Sharded):
    """The generator over fixed-size chunks of driving keypoints."""

    def __init__(self, generator, chunk: int = 128, dtype: Optional[torch.dtype] = None,
                 device="cuda", devices=None):
        super().__init__(chunk, dtype, device, devices)
        self.generators = _replicas(generator, self.devices, dtype)
        self.generator = self.generators[0]

    @torch.no_grad()
    def __call__(self, source, kp_driving, kp_source) -> Dict[str, torch.Tensor]:
        """source (B,1,H,W,C); kp dicts (B,D,...) and (B,1,...) ->
        {'video_prediction', 'video_deformed'}, f32 on the (first) device."""
        dev = self.device
        source = torch.as_tensor(source, device=dev)
        if self.dtype is not None:
            source = source.to(self.dtype)
        kp_driving = {k: torch.as_tensor(v, device=dev).float() for k, v in kp_driving.items()}
        kp_source = {k: torch.as_tensor(v, device=dev).float() for k, v in kp_source.items()}
        sources = [source.to(d) for d in self.devices]
        kp_sources = [_on(kp_source, d) for d in self.devices]
        d = kp_driving["mean"].shape[1]
        outs = {"video_prediction": [], "video_deformed": []}
        for start in range(0, d, self.chunk):
            part = {k: v[:, start : start + self.chunk] for k, v in kp_driving.items()}
            n_valid = part["mean"].shape[1]
            part = _pad_kp(part, _bucket(n_valid, self.chunk, self.granularity))
            slabs = [gen(src, kp, kp_src) for gen, src, kp, kp_src in
                     zip(self.generators, sources, self._kp_slabs(part), kp_sources)]
            for k in outs:
                outs[k].append(self._gather([o[k] for o in slabs], n_valid).float())
        return {k: _cat(v) for k, v in outs.items()}


def _map_rows(outs: List[np.ndarray], lo: int, hi: int) -> None:
    """Write frames lo:hi (axis 1) of each array once, so that the memory
    behind them is mapped before a copy into them: the first write to fresh
    host memory maps its pages, and on the H100 machine's host runs at 4-5
    GB/s against 24-33 GB/s into mapped pages. numpy's fill releases the
    interpreter lock and runs on one core."""
    for out in outs:
        out[:, lo:hi].fill(0)


class _StagingRing:
    """Delivers one call's outputs to host tensors, a chunk at a time.

    `begin(frames)` opens a call of a `frames`-frame video and makes its
    host outputs with `torch.empty` at the video's length, owned by the
    caller: no caller holds a slot. `put(outs)` takes a chunk's outputs,
    tensors (B, n, ...) on `device` whose frame axis runs on from the
    previous chunk's (n is `chunk` for each chunk but the last, which may
    be padded), and copies the first min(n, frames left) frames of the
    previous chunk's into its rows of the host outputs (span
    `transfer.deliver`): the engine puts a chunk once it has launched it,
    so on the card chunk i's copy to the host runs while chunk i + 1
    computes. `finish()` copies the last chunk's and returns the host
    outputs. Each copy waits until the device has made its chunk.

    How a chunk reaches the host follows its frames' size. A frame of
    `RING_FRAME_BYTES` or more (a 256x256 video's answer, 1.6 MB a frame)
    goes through a staging ring of two slots an output: chunk i is copied
    into slot i mod 2 (on a CUDA device on the ring's copy stream once the
    compute stream's work so far is done, non-blocking into pinned slots,
    ending in an event), and the host copies it out of its slot; a thread
    of the ring writes each chunk's rows of the host outputs once ahead of
    that copy (`_map_rows`), from `begin` on where the call's outputs have
    the frame shapes of the last call's, and the copy takes the rows only
    when that write is done or was never started. A smaller frame (a 64x64
    video's, 98 KB) is copied straight from the device into the host
    outputs, on the copy stream: an engine that small is held back by its
    host, which a slot's second copy and the thread's writes slow (on an
    H100 host, 64x64 answers of 2 to 8 chunks read 7-27% fewer frames/s
    through the ring than copied straight; 256x256 answers in chunks of
    128 frames 18-28% more, in smaller chunks within 3%; PERF.md §6).

    A slot is `chunk` frames wide, made at the first use of an output's
    size and dtype and kept, so pinned memory stays at two chunks an output
    whatever the videos' lengths. On another device the slots are plain
    host memory and every copy is synchronous.
    """

    RING_FRAME_BYTES = 1 << 20

    def __init__(self, chunk: int, device):
        self.chunk, self.device = chunk, device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.slots: List[List[torch.Tensor]] = []
        self.mapper = ThreadPoolExecutor(1, thread_name_prefix="transfer-deliver")
        self.rows = self.outs = self.pending = None
        self.ring, self.mapped = False, {}

    def begin(self, frames: int) -> None:
        self.frames, self.start, self.count = frames, 0, 0
        self.pending = None
        self._allocate(self.rows)

    def _allocate(self, rows) -> None:
        """The call's host outputs, one (B, frames, *shape) tensor of dtype
        for each (B, shape, dtype) of `rows`, and, for frames that take the
        ring, the mapper's jobs on them by chunk index."""
        for job in self.mapped.values():  # of a call that raised, or of other shapes
            job.cancel()
        self.rows, self.outs, self.mapped = rows, None, {}
        if rows is None:
            return
        self.outs = [torch.empty((b, self.frames, *shape), dtype=dtype)
                     for b, shape, dtype in rows]
        frame_bytes = sum(out[0, 0].numel() * out.element_size() for out in self.outs)
        self.ring = frame_bytes >= self.RING_FRAME_BYTES
        if self.ring:
            arrays = [out.view(torch.uint8).numpy() for out in self.outs]
            self.mapped = {i: self.mapper.submit(_map_rows, arrays, lo, lo + self.chunk)
                           for i, lo in enumerate(range(0, self.frames, self.chunk))}

    def _slot(self, j: int, x) -> torch.Tensor:
        """Slot count mod 2 of output j, viewed as x's shape."""
        size = x.shape[0] * self.chunk * x[0, 0].numel()
        if j == len(self.slots):
            self.slots.append([])
        ring = self.slots[j]
        if not ring or ring[0].numel() != size or ring[0].dtype != x.dtype:
            ring[:] = [torch.empty(size, dtype=x.dtype, pin_memory=self.cuda) for _ in range(2)]
        return ring[self.count % 2][: x.numel()].view(x.shape)

    def put(self, outs: List[torch.Tensor]) -> None:
        n = min(outs[0].shape[1], self.frames - self.start)
        outs = [x[:, :n] for x in outs]
        rows = [(x.shape[0], tuple(x.shape[2:]), x.dtype) for x in outs]
        if rows != self.rows:
            self._allocate(rows)
        staged, done = outs, None
        if self.ring:
            staged = [self._slot(j, x) for j, x in enumerate(outs)]
            if self.cuda:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    for slot, x in zip(staged, outs):
                        # the allocator may not hand x's memory to the next
                        # chunk before this stream has read it
                        x.record_stream(self.stream)
                        slot.copy_(x, non_blocking=True)
                    done = self.stream.record_event()
            else:
                for slot, x in zip(staged, outs):
                    slot.copy_(x)
        elif self.cuda:
            done = torch.cuda.current_stream(self.device).record_event()
        previous, self.pending = self.pending, (self.count, done, staged, self.start, n)
        self.start += n
        self.count += 1
        if previous is not None:
            self._deliver(*previous)

    def _deliver(self, i: int, done, staged, start: int, n: int) -> None:
        """Chunk i into its rows, from its slots or (copied straight into
        pageable memory, which returns once the copy is done) from the
        device."""
        if done is not None:
            done.synchronize()
        job = self.mapped.get(i)
        if job is not None and not job.cancel():  # the mapper is on these rows or done
            job.result()
        with span("transfer.deliver"), torch.cuda.stream(self.stream):
            for out, x in zip(self.outs, staged):
                out[:, start : start + n].copy_(x)

    def finish(self) -> List[torch.Tensor]:
        self._deliver(*self.pending)
        outs, self.outs, self.pending, self.mapped = self.outs, None, None, {}
        return outs


class TransferEngine(_Sharded):
    """The whole transfer pipeline per frame chunk: driving-kp detection,
    the relative move_location normalisation, and generation.

    Covers the normalisations that are tensor math (move_location /
    clip_mean, reference transfer.py:42-50); the convex-hull scale and
    covariance adaptations run on the host between a KPExtractor and an
    Animator (tasks/transfer.py `transfer_one`). Sharded, the source's
    keypoints and the first driving frame's come from the first device and
    are copied to the others.
    """

    def __init__(self, generator, kp_detector, chunk: int = 128,
                 dtype: Optional[torch.dtype] = None, move_location: bool = True,
                 clip_mean: bool = False, device="cuda", devices=None):
        super().__init__(chunk, dtype, device, devices)
        self.move_location = move_location
        self.clip_mean = clip_mean
        self.generators = _replicas(generator, self.devices, dtype)
        self.kp_detectors = _replicas(kp_detector, self.devices, dtype)
        self.generator, self.kp_detector = self.generators[0], self.kp_detectors[0]
        self._ring = _StagingRing(self.chunk, self.device) if self.device.type == "cuda" else None

    def _normalize(self, kp_chunk, kp_first, kp_source):
        if not self.move_location:
            return kp_chunk
        out = dict(kp_chunk)
        out["mean"] = kp_chunk["mean"] - kp_first["mean"] + kp_source["mean"]
        if self.clip_mean:
            out["mean"] = torch.clamp(out["mean"], -1.0, 1.0)
        return out

    @torch.no_grad()
    def __call__(self, source, driving) -> Dict:
        """source (B,1,H,W,C), driving (B,D,H,W,C) -> dict of f32 tensors
        {'video_prediction', 'video_deformed', 'kp_driving', 'kp_source',
        'kp_norm'}. On a CUDA device they are host tensors that the caller
        owns, each chunk's copied out while the next computes (span
        `transfer.deliver` a chunk), and the call returns once the answer
        is on the host; on the CPU they are the chunks' tensors
        concatenated."""
        with span("transfer.video"):
            with span("transfer.upload"):
                source = torch.as_tensor(source, device=self.device)
                driving = torch.as_tensor(driving, device=self.device)
                if self.dtype is not None:
                    source = source.to(self.dtype)
            d = driving.shape[1]
            sources = [source.to(dev) for dev in self.devices]
            ring, parts = self._ring, []
            if ring is not None:
                ring.begin(d)
            kp_source = kp_sources = kp_firsts = None
            for start in range(0, d, self.chunk):
                with span("transfer.chunk"):
                    frames = driving[:, start : start + self.chunk]
                    n_valid = frames.shape[1]
                    frames = _pad_frames(frames, _bucket(n_valid, self.chunk, self.granularity))
                    if self.dtype is not None:
                        frames = frames.to(self.dtype)
                    with span("transfer.detect"):
                        if kp_source is None:
                            kp_source = self.kp_detector(source)
                            kp_sources = [_on(kp_source, dev) for dev in self.devices]
                        kp_chunks = [det(slab) for det, slab in
                                     zip(self.kp_detectors, self._slabs(frames))]
                    with span("transfer.generate"):
                        if kp_firsts is None:
                            kp_first = {k: v[:, :1] for k, v in kp_chunks[0].items()}
                            kp_firsts = [_on(kp_first, dev) for dev in self.devices]
                        kp_norms = [self._normalize(*args)
                                    for args in zip(kp_chunks, kp_firsts, kp_sources)]
                        outs = [gen(*args) for gen, *args in
                                zip(self.generators, sources, kp_norms, kp_sources)]
                    with span("transfer.gather"):
                        keys = list(kp_chunks[0])
                        part = [self._gather([o[k] for o in outs], n_valid).float()
                                for k in ("video_prediction", "video_deformed")]
                        part += [self._gather([c[k] for c in group], n_valid)
                                 for group in (kp_chunks, kp_norms) for k in keys]
                    if ring is None:
                        parts.append(part)
                    else:
                        ring.put(part)
            if ring is None:
                pred, deformed, *kps = [_cat(list(chunks)) for chunks in zip(*parts)]
            else:
                pred, deformed, *kps = ring.finish()
                kp_source = {k: v.cpu() for k, v in kp_source.items()}
            return {
                "video_prediction": pred,
                "video_deformed": deformed,
                "kp_driving": dict(zip(keys, kps[:len(keys)])),
                "kp_norm": dict(zip(keys, kps[len(keys):])),
                "kp_source": kp_source,
            }


class KPExtractor(_Sharded):
    """The keypoint detector over fixed-size chunks of frames."""

    def __init__(self, kp_detector, chunk: int = 128, dtype: Optional[torch.dtype] = None,
                 device="cuda", devices=None):
        super().__init__(chunk, dtype, device, devices)
        self.kp_detectors = _replicas(kp_detector, self.devices, dtype)
        self.kp_detector = self.kp_detectors[0]

    def __call__(self, video) -> Dict[str, np.ndarray]:
        """video (B, D, H, W, C) -> kp dict of numpy (B, D, K, ...)."""
        return {k: v.cpu().numpy() for k, v in self.device_call(video).items()}

    @torch.no_grad()
    def device_call(self, video) -> Dict[str, torch.Tensor]:
        """video (B, D, H, W, C), numpy or a tensor -> kp dict of f32 device
        tensors (B, D, K, ...)."""
        video = torch.as_tensor(video, device=self.device)
        if self.dtype is not None:
            video = video.to(self.dtype)
        d = video.shape[1]
        outs = []
        for start in range(0, d, self.chunk):
            part = video[:, start : start + self.chunk]
            n_valid = part.shape[1]
            part = _pad_frames(part, _bucket(n_valid, self.chunk, self.granularity))
            kps = [det(slab) for det, slab in zip(self.kp_detectors, self._slabs(part))]
            outs.append({k: self._gather([kp[k] for kp in kps], n_valid).float()
                         for k in kps[0]})
        return {k: _cat([o[k] for o in outs]) for k in outs[0]}
