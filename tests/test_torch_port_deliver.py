"""TransferEngine's delivery of its answer to the host
(monkeynet_tpu_torch/tasks/animate.py `_StagingRing`).

On the CPU: the delivery on CPU tensors, straight and through the staging
ring, at the train-test widths of tests/torch_port_common.py (16^2
frames). On the card (marker `card`, skips without one; this file imports
no JAX, so on the card it runs with `python -m pytest
tests/test_torch_port_deliver.py --noconftest`): the engine's host outputs
against its device path's, both ways, and one `transfer.deliver` span a
chunk.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monkeynet_tpu_torch.tasks.animate import TransferEngine, _StagingRing
from monkeynet_tpu_torch.tasks.build import build_models

from .torch_port_common import train_config

HW = 16
CHUNK = 16
FRAMES = 40  # three chunks: 16, 16, then 8 padded to 16


def _chunks(seed: int, frames: int = FRAMES, batch: int = 2):
    """A video's outputs in chunks as an engine hands them over: a frame
    video (B, D, H, W, C) and keypoints (B, D, K, 2), each chunk padded to
    CHUNK frames by repeating its last frame."""
    rng = np.random.RandomState(seed)
    video = torch.from_numpy(rng.rand(batch, frames, HW, HW, 3).astype(np.float32))
    kp = torch.from_numpy(rng.rand(batch, frames, 3, 2).astype(np.float32))
    chunks = []
    for start in range(0, frames, CHUNK):
        part = [x[:, start : start + CHUNK] for x in (video, kp)]
        pad = CHUNK - part[0].shape[1]
        chunks.append([torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], dim=1)
                       for x in part])
    return [video, kp], chunks


def _deliver(ring, frames, chunks):
    """One call through the ring; the slots each chunk was staged in (none
    where it is copied straight)."""
    ring.begin(frames)
    staged = []
    for part in chunks:
        ring.put(part)
        staged.append([x.data_ptr() for x in ring.pending[2]] if ring.ring else [])
    return ring.finish(), staged


def _leaves(out):
    return [out["video_prediction"], out["video_deformed"], *out["kp_driving"].values(),
            *out["kp_norm"].values(), *out["kp_source"].values()]


def _spans(prof, names):
    return {name: sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.name == name) for name in names}


def test_ring_rotates_two_slots_and_trims_the_tail():
    """Three chunks, the last padded: chunk i is staged in slot i mod 2 of
    each output, the slots are made once and kept across calls, and the
    host outputs hold the video's frames exactly, trimmed to its length.
    The rows mapped ahead from `begin` on. Every frame takes the ring here
    (a 256x256 answer's way)."""
    ring = _StagingRing(CHUNK, torch.device("cpu"))
    ring.RING_FRAME_BYTES = 0
    want, chunks = _chunks(0)
    assert len(chunks) == 3 and chunks[-1][0].shape[1] == CHUNK
    got, staged = _deliver(ring, FRAMES, chunks)
    slots = [[s.data_ptr() for s in ring.slots[j]] for j in range(2)]
    assert all(len(set(pair)) == 2 for pair in slots)
    assert staged == [[slots[j][i % 2] for j in range(2)] for i in range(3)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] == FRAMES
        assert torch.equal(g, w)
    # a shorter video: its outputs made and mapped from `begin` on, in the
    # same slots, nothing left of the longer one
    ring.begin(CHUNK + 5)
    assert [out.shape[1] for out in ring.outs] == [CHUNK + 5] * 2 and list(ring.mapped) == [0, 1]
    want2, chunks2 = _chunks(1, frames=CHUNK + 5)
    got2, staged2 = _deliver(ring, CHUNK + 5, chunks2)
    assert [[s.data_ptr() for s in ring.slots[j]] for j in range(2)] == slots
    assert staged2 == staged[:2]
    assert all(torch.equal(g, w) for g, w in zip(got2, want2))
    assert ring.pending is None and ring.outs is None
    # other shapes than the last call's: outputs and slots made anew
    want3, chunks3 = _chunks(6, batch=1)
    got3, _ = _deliver(ring, FRAMES, chunks3)
    assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got3, want3))
    assert ring.slots[0][0].numel() == CHUNK * HW * HW * 3


@pytest.mark.parametrize("through_ring", [True, False], ids=["ring", "straight"])
def test_two_calls_return_tensors_that_do_not_alias(through_ring):
    """The second call's outputs are tensors of their own: the first call's
    values stay as they were, and neither shares memory with a slot or a
    chunk handed over."""
    ring = _StagingRing(CHUNK, torch.device("cpu"))
    if through_ring:
        ring.RING_FRAME_BYTES = 0
    want, chunks = _chunks(2)
    first, _ = _deliver(ring, FRAMES, chunks)
    kept = [x.clone() for x in first]
    chunks3 = _chunks(3)[1]
    second, _ = _deliver(ring, FRAMES, chunks3)
    for a, b, k, w in zip(first, second, kept, want):
        assert torch.equal(a, k) and torch.equal(a, w)
        assert not torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert bool(ring.slots) == through_ring
    held = {s.data_ptr() for pair in ring.slots for s in pair}
    held |= {x.untyped_storage().data_ptr() for part in chunks + chunks3 for x in part}
    assert not held & {x.untyped_storage().data_ptr() for x in first + second}


def test_small_frames_are_copied_straight_to_the_host():
    """Frames under `RING_FRAME_BYTES` (a 64x64 answer's way): a padded
    one-chunk video and a three-chunk one copied straight into the host
    outputs, trimmed, chunk i once chunk i + 1 is put, one
    `transfer.deliver` a chunk; no slot made and no row written ahead.
    Frames of `RING_FRAME_BYTES` take the ring, their rows written ahead."""
    ring = _StagingRing(CHUNK, torch.device("cpu"))
    for seed, frames in ((7, CHUNK - 6), (8, FRAMES)):
        want, chunks = _chunks(seed, frames=frames)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got, staged = _deliver(ring, frames, chunks)
        assert staged == [[]] * len(chunks) and ring.slots == [] and ring.mapped == {}
        assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
        assert len(_spans(prof, ("transfer.deliver",))["transfer.deliver"]) == len(chunks)
    ring.begin(FRAMES)
    for out in ring.outs:
        out.fill_(float("nan"))
    ring.put(chunks[0])
    assert all(o[:, :CHUNK].isnan().all() for o in ring.outs)
    ring.put(chunks[1])
    assert all(torch.equal(o[:, :CHUNK], w[:, :CHUNK]) for o, w in zip(ring.outs, want))
    assert all(o[:, CHUNK:].isnan().all() for o in ring.outs)
    ring.finish()
    want, chunks = _chunks(9, frames=CHUNK - 6)
    ring.RING_FRAME_BYTES = sum(x[0, 0].numel() * 4 for x in want)
    ring.begin(CHUNK - 6)
    assert ring.ring and list(ring.mapped) == [0]
    got, staged = _deliver(ring, CHUNK - 6, chunks)
    assert all(staged) and ring.slots
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rows_are_copied_only_after_the_mapper_is_done_with_them(monkeypatch):
    """The mapper's write of a chunk's rows, slowed here, is waited for (or
    cancelled before it starts) ahead of the copy into those rows: no zero
    of it lands on a delivered frame, and none is pending after the call."""
    import monkeynet_tpu_torch.tasks.animate as animate

    map_rows = animate._map_rows

    def slow(outs, lo, hi):
        time.sleep(0.02)
        map_rows(outs, lo, hi)

    monkeypatch.setattr(animate, "_map_rows", slow)
    ring = _StagingRing(CHUNK, torch.device("cpu"))
    ring.RING_FRAME_BYTES = 0
    want, chunks = _chunks(5)
    ring.begin(FRAMES)
    for part in chunks:
        ring.put(part)
    jobs = dict(ring.mapped)
    got = ring.finish()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert sorted(jobs) == [0, 1, 2] and all(job.done() for job in jobs.values())


def test_engine_on_the_cpu_keeps_the_path_without_a_ring():
    generator, kp_detector = build_models(train_config(), device="cpu")
    engine = TransferEngine(generator, kp_detector, chunk=CHUNK, device="cpu")
    assert engine._ring is None


@pytest.mark.card
def test_engine_delivers_to_the_host_on_the_card():
    """Three-chunk and one-chunk videos on the card, copied straight (small
    frames) and through the ring with its rows written ahead (as for a
    256x256 answer): every output a host tensor, bit for bit the device
    path's (the engine without its ring) copied with `.cpu()`; a second call
    leaves the first's answer as it was; under a profiler one
    `transfer.deliver` a chunk, inside `transfer.video`; pinned memory two
    slots an output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        generator, kp_detector = build_models(train_config(), device="cuda")
        engine = TransferEngine(generator, kp_detector, chunk=CHUNK, device="cuda")
        ring = engine._ring
        rng = np.random.RandomState(4)
        source = torch.from_numpy(rng.rand(1, 1, HW, HW, 3).astype(np.float32))
        driving = torch.from_numpy(rng.rand(1, FRAMES, HW, HW, 3).astype(np.float32))
        for frame_bytes in (_StagingRing.RING_FRAME_BYTES, 0):
            ring.RING_FRAME_BYTES = frame_bytes
            for frames, chunks in ((FRAMES, 3), (CHUNK - 6, 1)):
                video = driving[:, :frames]
                got = engine(source, video)
                assert ring.ring == (frame_bytes == 0)
                engine._ring = None
                on_device = engine(source, video)
                engine._ring = ring
                assert on_device["video_prediction"].is_cuda
                assert got["video_prediction"].shape == (1, frames, HW, HW, 3)
                for g, d in zip(_leaves(got), _leaves(on_device)):
                    assert not g.is_cuda and g.dtype == d.dtype
                    assert torch.equal(g, d.cpu())
                kept = [x.clone() for x in _leaves(got)]
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    again = engine(source, torch.flip(video, dims=(1,)))
                torch.cuda.synchronize()
                assert all(torch.equal(a, k) for a, k in zip(_leaves(got), kept))
                assert not torch.equal(again["video_prediction"], got["video_prediction"])
                spans = _spans(prof, ("transfer.video", "transfer.deliver"))
                (call,) = spans["transfer.video"]
                assert len(spans["transfer.deliver"]) == chunks
                assert all(call[0] <= s and e <= call[1] for s, e in spans["transfer.deliver"])
        pinned = sum(s.numel() * s.element_size() for pair in ring.slots for s in pair)
        per_frame = sum(x[0, 0].numel() * x.element_size() for x in _leaves(got)[:-2])
        assert pinned == 2 * CHUNK * per_frame
    finally:
        torch.backends.cudnn.deterministic = deterministic
