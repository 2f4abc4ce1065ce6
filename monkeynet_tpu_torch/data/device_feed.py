"""The device feed: the dataset stays on the card as uint8, the host builds
each step's augmentation as a small plan, and the card carries it out.

Counterpart of monkeynet_tpu/data/device_feed.py. The host feed decodes,
augments and copies every batch's pixels; here the whole train split is
decoded once into one (N, Tmax, H, W, C) uint8 tensor on the card
(`build_video_cache`), and a step ships only its plans: the frame indices,
flip, angle, resize-and-crop gather indices and jitter slots of each item
(`AllAugmentationTransform.plan`, a few hundred bytes an item).

Plans draw from the DataLoader's generators, keyed (seed, epoch, batch,
position) after the same (seed + epoch) shuffle (`plan_stream`), so a
device-fed run sees the frames, flips, angles, crops and jitter of the
host-fed one. On the card (`make_device_augment`) the frame gather, the flips
and the resize and crop are integer gathers, exact apart from the division
by 255; the rotation is one bilinear warp of the batch's frames through the
port's warp kernel (align corners, zeros padding: the exact bilinear sample,
which the host's cv2 rotation approximates with fixed-point weights); the
colour jitter is elementwise HSV math in f32. None of it is differentiated.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from monkeynet_tpu_torch.data.augmentation import (
    JITTER_BRIGHT,
    JITTER_CONTRAST,
    JITTER_HUE,
    JITTER_SAT,
)
from monkeynet_tpu_torch.data.io import read_video
from monkeynet_tpu_torch.ops.cuda.warp import warp

# The keys of a collated plan batch, in the order a chunk stacks them.
PLAN_KEYS = ("video_idx", "frame_idx", "hflip", "angle", "rows", "cols",
             "jitter_ops", "jitter_factors")


class CacheOverBudget(Exception):
    """The padded cache would exceed the device-memory budget.

    Carries (estimated_bytes, budget_bytes); estimated_bytes is a lower
    bound when raised during the decode (N x the longest video so far x a
    frame's bytes)."""

    def __init__(self, estimated_bytes: int, budget_bytes: int):
        self.estimated_bytes = int(estimated_bytes)
        self.budget_bytes = int(budget_bytes)
        super().__init__(
            f"device-feed cache needs >= {estimated_bytes / 2**30:.2f} GiB "
            f"padded, budget is {budget_bytes / 2**30:.2f} GiB"
        )


def build_video_cache(dataset, budget_bytes: Optional[int] = None):
    """Decode every video of `dataset` once: (videos, lengths) in numpy.

    videos: (N, Tmax, H, W, C) uint8, zero past each video's length (plans
    index real frames only). The dataset's own uint8 cache is reused where
    it holds a video. With `budget_bytes`, raises CacheOverBudget as soon as
    the running lower bound N x Tmax-so-far x frame bytes exceeds it, before
    decoding the rest of a dataset that cannot fit.
    """
    h, w, c = dataset.image_shape
    n = len(dataset)
    frame_bytes = h * w * c
    clips = []
    tmax = 0
    for i in range(n):
        cached = dataset._cache.get(i) if dataset.cache_videos else None
        if cached is None:
            path = os.path.join(dataset.root_dir, dataset.images[i])
            video = read_video(path, image_shape=dataset.image_shape)
            cached = (video * 255.0 + 0.5).astype(np.uint8)
            if dataset.cache_videos:
                dataset._cache[i] = cached
        clips.append(cached)
        tmax = max(tmax, len(cached))
        if budget_bytes is not None and n * tmax * frame_bytes > budget_bytes:
            raise CacheOverBudget(n * tmax * frame_bytes, budget_bytes)
    lengths = np.asarray([len(v) for v in clips], np.int32)
    videos = np.zeros((len(clips), tmax, h, w, c), np.uint8)
    for i, v in enumerate(clips):
        videos[i, : len(v)] = v
    return videos, lengths


def cache_budget_bytes(train_params, device="cuda") -> int:
    """Device-memory budget of the video cache, in bytes.

    `train_params.device_feed_hbm_gb` sets it; otherwise it is half of the
    card's memory, so that the cache never crowds out the model, its
    optimizer state and the step's activations, and 8 GB where `device` is
    not a card. A dataset over budget trains on the host feed instead: the
    reference streams from disk and never assumes the data fits on the
    device (reference frames_dataset.py:14-40).
    """
    explicit = (train_params or {}).get("device_feed_hbm_gb")
    if explicit is not None:
        return int(float(explicit) * (1 << 30))
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory) // 2
    return 8 << 30


def padding_overhead(lengths, image_shape):
    """(padded_bytes, real_bytes) of the (N, Tmax, H, W, C) uint8 cache: a
    ragged dataset pays for Tmax frames a video."""
    h, w, c = image_shape
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.shape[0])
    tmax = int(lengths.max()) if n else 0
    frame = h * w * c
    return n * tmax * frame, int(lengths.sum()) * frame


def collate_plans(video_idx, plans):
    """Stack per-item plan dicts into batched arrays, with the video indices."""
    out = {"video_idx": np.asarray(video_idx, np.int32)}
    for key in plans[0]:
        out[key] = np.stack([p[key] for p in plans])
    return out


def plan_stream(dataset, transform, lengths, batch_size: int, seed: int,
                start_epoch: int, num_epochs: int, num_shards: int = 1,
                shard_index: int = 0, shuffle: bool = True):
    """Yield (epoch, plan batch) in the order and with the generators of
    data/loader.DataLoader: the (seed + epoch) shuffle, the last partial
    batch dropped, and each item's generator keyed (seed, epoch, batch,
    global position). `batch_size` is the local batch: with num_shards > 1
    each shard takes its slab of each global batch, as the loader does."""
    h, w, _ = dataset.image_shape
    n = len(dataset)
    global_bs = batch_size * num_shards
    for ep in range(start_epoch, start_epoch + num_epochs):
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + ep).shuffle(order)
        stop = (n // global_bs) * global_bs
        for bi, i in enumerate(range(0, stop, global_bs)):
            lo = i + shard_index * batch_size
            idxs = order[lo : lo + batch_size]
            plans = [transform.plan(int(lengths[j]), h, w,
                                    np.random.default_rng((seed, ep, bi,
                                                           shard_index * batch_size + pos)))
                     for pos, j in enumerate(idxs)]
            yield ep, collate_plans(idxs, plans)


# ---------------------------------------------------------------- on the card


def _gray(x):
    """ITU-R 601-2 luma, as ColorJitter._gray."""
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def _shift_hue(x, amount):
    """Rotate the hue of RGB values in [0, 1] by `amount` turns, through
    cv2's float HSV formulas. x (..., 3); amount broadcasts against x[..., 0]."""
    r, g, b = x.unbind(-1)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    hh = torch.where(
        v == r,
        (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c),
    )
    hue = torch.where(c > 0, hh * 60.0, 0.0)
    hue = torch.where(hue < 0, hue + 360.0, hue)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)

    hue = (hue + amount * 360.0) % 360.0

    h6 = torch.clamp(hue / 60.0, 0.0, 6.0) % 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def select(choices, default):
        out = default
        for k in range(len(choices) - 1, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    rr = select([v, q, p, p, t], v)
    gg = select([t, v, v, q, p], p)
    bb = select([p, p, t, v, v], q)
    return torch.stack([rr, gg, bb], dim=-1)


def _apply_jitter_slots(x, op_ids, factors, ops):
    """Apply each item's jitter slots in order, as ColorJitter.__call__
    does: the input clipped to [0, 1], and a clip after every op. x (B, F,
    h, w, C); op_ids (B, 4) int, factors (B, 4) f32; `ops` the op ids the
    transform can draw, which fill the first len(ops) slots (the rest are
    unused, and no other op is computed)."""
    x = torch.clamp(x, 0.0, 1.0)
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    for s in range(len(ops)):
        op = op_ids[:, s].reshape(shape)
        f = factors[:, s].reshape(shape)
        y = x
        if JITTER_BRIGHT in ops:
            y = torch.where(op == JITTER_BRIGHT, x * f, y)
        if JITTER_SAT in ops:
            y = torch.where(op == JITTER_SAT, _gray(x) * (1.0 - f) + x * f, y)
        if JITTER_HUE in ops:
            y = torch.where(op == JITTER_HUE, _shift_hue(x, f[..., 0]), y)
        if JITTER_CONTRAST in ops:
            mean = _gray(x).mean(dim=(2, 3, 4), keepdim=True)
            y = torch.where(op == JITTER_CONTRAST, mean * (1.0 - f) + x * f, y)
        x = torch.clamp(y, 0.0, 1.0)
    return x


def _rotation_grid(angle_deg, h: int, w: int):
    """(B, h, w, 2) align-corners sampling grid of a rotation by each item's
    angle about the pixel centre ((w - 1) / 2, (h - 1) / 2): output pixel
    (i, j) reads the source at the inverse rotation of its offset from the
    centre, as skimage.transform.rotate and cv2.warpAffine do."""
    theta = angle_deg.float() * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ii = torch.arange(h, dtype=torch.float32, device=angle_deg.device)[:, None] - cy
    jj = torch.arange(w, dtype=torch.float32, device=angle_deg.device)[None, :] - cx
    sx = cos * jj - sin * ii + cx
    sy = sin * jj + cos * ii + cy
    return torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], dim=-1)


def rotate_frames(x, angle_deg):
    """Bilinear rotation of each item's frames by its angle, zeros outside.
    x (B, F, H, W, C) f32, angle_deg (B,) -> (B, F, H, W, C): one warp over
    the B * F frames (the warp kernel on the card, its plain gather on the
    CPU)."""
    B, F, H, W, C = x.shape
    grid = _rotation_grid(angle_deg, H, W)[:, None].expand(B, F, H, W, 2)
    out = warp(x.reshape(B * F, H, W, C).contiguous(), grid.reshape(B * F, H, W, 2).contiguous())
    return out.reshape(B, F, H, W, C)


def _jitter_ops(jitter):
    """The op ids a ColorJitter can draw."""
    ops = []
    if jitter.brightness > 0:
        ops.append(JITTER_BRIGHT)
    if jitter.saturation > 0:
        ops.append(JITTER_SAT)
    if jitter.hue > 0:
        ops.append(JITTER_HUE)
    if jitter.contrast > 0:
        ops.append(JITTER_CONTRAST)
    return ops


def make_device_augment(transform, image_shape):
    """The plan executor of `transform` (an AllAugmentationTransform).

    Returns augment(videos, plan) -> {'source': (B, 1, h, w, C), 'video':
    (B, F-1, h, w, C)} f32 in [0, 1], where videos is the (N, Tmax, H, W, C)
    uint8 cache and plan one step's `collate_plans` as tensors on the same
    device. Only the configured ops run. It synchronises nothing with the
    host, so it can be captured in a CUDA graph.
    """
    has_rotation = transform.rotation is not None
    has_hflip = transform.flip is not None and transform.flip.horizontal_flip
    ops = _jitter_ops(transform.jitter) if transform.jitter is not None else []

    def augment(videos, plan):
        vid = plan["video_idx"].long()
        frames = plan["frame_idx"].long()
        B, F = frames.shape
        # Divided by a tensor, not a Python number: the card would multiply
        # by the reciprocal, an ulp off the host's quotient.
        scale = torch.full((), 255.0, device=videos.device)
        x = videos[vid[:, None], frames].float() / scale  # (B, F, H, W, C)
        if has_hflip:
            x = torch.where(plan["hflip"].reshape(B, 1, 1, 1, 1) > 0, x.flip(3), x)
        if has_rotation:
            x = rotate_frames(x, plan["angle"])
        _, _, H, W, C = x.shape
        rows, cols = plan["rows"].long(), plan["cols"].long()
        h, w = rows.shape[1], cols.shape[1]
        x = torch.gather(x, 2, rows[:, None, :, None, None].expand(B, F, h, W, C))
        x = torch.gather(x, 3, cols[:, None, None, :, None].expand(B, F, h, w, C))
        if ops:
            x = _apply_jitter_slots(x, plan["jitter_ops"], plan["jitter_factors"], ops)
        return {"source": x[:, :1], "video": x[:, 1:]}

    return augment
