"""Train-time video clip augmentation (host-side, numpy/cv2/PIL).

Counterpart of monkeynet_tpu/data/augmentation.py, whose ops it copies so that
the port's loader gives the JAX package's batches exactly. Capability parity
with the reference pipeline (augmentation.py:91-389, itself
vendored from torch_videovision): frame-pair selection, time/horizontal flip,
rotation, scale jitter, pad+crop, color jitter, source/driving split. Clips
are (T, H, W, C) float32 in [0, 1] throughout; channels-last end to end (the
reference converts to CTHW torch layout — we feed NDHWC straight to device).

Randomness comes from an explicit np.random.Generator so the pipeline is
seedable per-worker (the reference leans on the global `random` module).
`AllAugmentationTransform.plan` gives an item's draws as a plan instead,
which the device feed carries out on the card (data/device_feed.py).
"""

from __future__ import annotations

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def _to_float(clip):
    """uint8 [0,255] -> float32 [0,1]; float passes through as float32.

    Conversion sits AFTER frame selection so a cached uint8 video only pays
    for the frames actually used (the select-2-of-T train path)."""
    clip = np.asarray(clip)
    if clip.dtype == np.uint8:
        return clip.astype(np.float32) / 255.0
    return clip.astype(np.float32, copy=False)


class SelectRandomFrames:
    """Pick `number_of_frames` frames: sorted-with-replacement, or a
    consecutive window (used by the kp-sequence predictor)."""

    def __init__(self, consequent=False, number_of_frames=2):
        self.consequent = consequent
        self.number_of_frames = number_of_frames

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        n = len(clip)
        k = self.number_of_frames
        if self.consequent:
            first = rng.integers(0, max(1, n - k + 1))
            return _to_float(clip[first : first + k])
        idx = np.sort(rng.choice(n, size=k, replace=True))
        if isinstance(clip, np.ndarray):
            return _to_float(clip[idx])
        return _to_float([clip[i] for i in idx])


class RandomFlip:
    def __init__(self, time_flip=False, horizontal_flip=False):
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        if self.time_flip and rng.random() < 0.5:
            return clip[::-1]
        if self.horizontal_flip and rng.random() < 0.5:
            return clip[:, :, ::-1]
        return clip


class RandomRotation:
    """Rotate the whole clip by one random angle (bilinear, keep shape)."""

    def __init__(self, degrees):
        if isinstance(degrees, (int, float)):
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        angle = rng.uniform(*self.degrees)
        import cv2

        # Same bilinear rotation as the reference's skimage.transform.rotate
        # (reference augmentation.py:207: order=1, resize=False, constant-0
        # fill, center (w-1)/2,(h-1)/2) — pinned vs the equivalent
        # scipy.ndimage.rotate(mode='grid-constant') to <=1e-5 in
        # tests/test_data.py (cv2's fixed-point bilinear weights cap the
        # match at ~4e-6) — but ~10x faster on the single-core host that
        # feeds the chip.
        h, w = np.asarray(clip[0]).shape[:2]
        M = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0), angle, 1.0)
        return np.stack(
            [
                cv2.warpAffine(
                    img, M, (w, h), flags=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0.0,
                )
                for img in clip
            ]
        )


def _nearest_resize_like_skimage(clip, new_h, new_w):
    """Nearest resize with the reference's exact semantics.

    The reference's nearest path is skimage.transform.resize(order=0,
    anti_aliasing=True, mode='constant') (reference augmentation.py:57-59,
    121-130), which (a) Gaussian-prefilters each DOWNSCALED axis with
    sigma=(factor-1)/2, then (b) samples via ndi.zoom(grid_mode=True):
    output pixel i reads input floor((i+0.5)*factor - 0.5 + 0.5). cv2's
    INTER_NEAREST uses the legacy floor(i*factor) mapping — off by half a
    pixel, a different image — so we implement skimage's convention
    directly: the sampling step is pure fancy indexing, vectorized over the
    whole (T, H, W, C) clip at once (faster than per-frame cv2 here).
    Value parity vs an ndi.zoom oracle is pinned in tests/test_data.py.
    """
    clip = np.asarray(clip)
    t, h, w = clip.shape[:3]
    fy, fx = h / new_h, w / new_w
    sig_y, sig_x = max(0.0, (fy - 1) / 2), max(0.0, (fx - 1) / 2)
    # scipy's gaussian_filter1d kernel radius is int(truncate*sigma + 0.5)
    # (truncate=4.0); a radius-0 kernel is the identity, so skipping the
    # filter below that threshold is EXACT — and it is the common case for
    # mild scale jitter (ratio 0.9-1.1 -> sigma <= 0.056, radius 0), where
    # the full grid-constant pass was ~30% of the per-item augmentation cost.
    if int(4.0 * sig_y + 0.5) > 0 or int(4.0 * sig_x + 0.5) > 0:
        from scipy import ndimage as ndi

        sigma = (0.0, sig_y, sig_x) + (0.0,) * (clip.ndim - 3)
        clip = ndi.gaussian_filter(clip, sigma, mode="grid-constant", cval=0.0)
    rows = np.clip(np.floor((np.arange(new_h) + 0.5) * fy).astype(np.intp), 0, h - 1)
    cols = np.clip(np.floor((np.arange(new_w) + 0.5) * fx).astype(np.intp), 0, w - 1)
    return clip[:, rows][:, :, cols]


class RandomResize:
    """Scale the clip by a random factor drawn from `ratio`."""

    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation="nearest"):
        self.ratio = tuple(ratio)
        self.interpolation = interpolation

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        scale = rng.uniform(*self.ratio)
        h, w = clip[0].shape[:2]
        new_h, new_w = int(h * scale), int(w * scale)
        if self.interpolation == "nearest":
            return _nearest_resize_like_skimage(clip, new_h, new_w)
        import cv2

        return np.stack(
            [cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
             for img in clip]
        )


class RandomCrop:
    """Edge-pad to at least `size`, then crop the same random window from
    every frame."""

    def __init__(self, size):
        if isinstance(size, (int, float)):
            size = (size, size)
        self.size = tuple(size)

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        h, w = self.size
        clip = np.asarray(clip)
        im_h, im_w = clip.shape[1:3]
        pad_h = max(0, h - im_h)
        pad_w = max(0, w - im_w)
        if pad_h or pad_w:
            clip = np.pad(
                clip,
                (
                    (0, 0),
                    (pad_h // 2, (pad_h + 1) // 2),
                    (pad_w // 2, (pad_w + 1) // 2),
                    (0, 0),
                ),
                mode="edge",
            )
            im_h, im_w = clip.shape[1:3]
        y = 0 if im_h == h else int(rng.integers(0, im_h - h + 1))
        x = 0 if im_w == w else int(rng.integers(0, im_w - w + 1))
        return clip[:, y : y + h, x : x + w]


class ColorJitter:
    """Random brightness / contrast / saturation / hue, one draw per clip,
    applied in shuffled order (PIL-backed like the reference's ndarray path)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _factors(self, rng):
        def around_one(amount):
            return rng.uniform(max(0.0, 1.0 - amount), 1.0 + amount) if amount > 0 else None

        hue = rng.uniform(-self.hue, self.hue) if self.hue > 0 else None
        return around_one(self.brightness), around_one(self.contrast), around_one(self.saturation), hue

    @staticmethod
    def _gray(x):
        """ITU-R 601-2 luma — what PIL's L mode uses for Color/Contrast."""
        return (
            0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
        )

    @staticmethod
    def _shift_hue(x, amount):
        """RGB -> HSV hue rotation -> RGB on [0, 1] float32 clips.

        cv2.cvtColor is pixelwise, so the (T, H, W, 3) clip folds into one
        (T*H, W, 3) image and converts in a single C call per direction."""
        import cv2

        t, h, w, _ = x.shape
        flat = np.ascontiguousarray(x.reshape(t * h, w, 3), dtype=np.float32)
        hsv = cv2.cvtColor(flat, cv2.COLOR_RGB2HSV)  # H in [0, 360)
        hsv[..., 0] = (hsv[..., 0] + amount * 360.0) % 360.0
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).reshape(t, h, w, 3)

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        bright, contrast, sat, hue = self._factors(rng)

        # Vectorized float equivalents of the PIL enhancers the reference's
        # ndarray path uses (same blend formulas, no uint8 round-trips —
        # one numpy pass over the whole clip instead of per-frame PIL).
        ops = []
        if bright is not None:
            ops.append(lambda x: x * bright)
        if sat is not None:
            ops.append(lambda x: self._gray(x) * (1.0 - sat) + x * sat)
        if hue is not None:
            ops.append(lambda x: self._shift_hue(x, hue))
        if contrast is not None:
            # per-frame mean gray, like PIL Contrast on each frame
            ops.append(
                lambda x: self._gray(x).mean(axis=(1, 2, 3), keepdims=True)
                * (1.0 - contrast)
                + x * contrast
            )
        order = rng.permutation(len(ops))

        out = np.clip(np.asarray(clip, dtype=np.float32), 0.0, 1.0)
        for i in order:
            out = np.clip(ops[i](out), 0.0, 1.0)
        return out.astype(np.float32, copy=False)


class SplitSourceDriving:
    """Frame 0 -> 'source' (1, H, W, C); the rest -> 'video' (T-1, H, W, C)."""

    def __call__(self, video, rng=None):
        video = _to_float(video)
        return {"source": video[:1], "video": video[1:]}


class VideoToTensor:
    """Whole clip as float32 [0, 1] (T, H, W, C) under key 'video'."""

    def __call__(self, video, rng=None):
        return {"video": np.ascontiguousarray(_to_float(video))}


# --------------------------------------------------------------------------
# Plans for the device feed: each transform also expresses itself as a plan,
# its random draws plus the gather indices they imply, instead of doing the
# numpy work. A plan consumes the same rng calls in the same order as
# __call__, so a planned item sees the host pipeline's frames, flips, angle,
# crop and jitter; data/device_feed.py carries the plans out on the card.
# Copies of the JAX package's plan functions.
# --------------------------------------------------------------------------


def plan_select(select: SelectRandomFrames, n: int, rng) -> np.ndarray:
    """SelectRandomFrames.__call__'s draws; returns the frame indices."""
    k = select.number_of_frames
    if select.consequent:
        first = rng.integers(0, max(1, n - k + 1))
        return np.arange(first, first + k)
    return np.sort(rng.choice(n, size=k, replace=True))


def plan_flip(flip: RandomFlip, frame_idx: np.ndarray, rng):
    """RandomFlip's draws: a time flip takes one draw and returns early, so
    it skips the horizontal draw, as __call__ does."""
    if flip.time_flip and rng.random() < 0.5:
        return frame_idx[::-1], False
    if flip.horizontal_flip and rng.random() < 0.5:
        return frame_idx, True
    return frame_idx, False


def plan_rotation(rot: RandomRotation, rng) -> float:
    return float(rng.uniform(*rot.degrees))


def plan_resize_crop(resize, crop, h: int, w: int, rng):
    """RandomResize (skimage's nearest rule) then RandomCrop (edge pad, then
    a window) as per-axis gather indices into the image before the resize.

    Both are integer gathers, so their composition is one. The resize ratio
    must keep the Gaussian prefilter at radius 0 (int(4 * sigma + 0.5) == 0,
    a scale above ~0.8), as `supports_device_feed` checks.
    """
    new_h, new_w = h, w
    if resize is not None:
        scale = rng.uniform(*resize.ratio)
        new_h, new_w = int(h * scale), int(w * scale)
        sig = max(0.0, (max(h / new_h, w / new_w) - 1) / 2)
        if int(4.0 * sig + 0.5) > 0:
            raise ValueError("device-feed plan requires prefilter-free resize ratios")
        rows = np.clip(np.floor((np.arange(new_h) + 0.5) * (h / new_h)).astype(np.int64),
                       0, h - 1)
        cols = np.clip(np.floor((np.arange(new_w) + 0.5) * (w / new_w)).astype(np.int64),
                       0, w - 1)
    else:
        rows = np.arange(h)
        cols = np.arange(w)

    if crop is None:
        return rows, cols

    ch, cw = crop.size
    pad_h = max(0, ch - new_h)
    pad_w = max(0, cw - new_w)
    im_h, im_w = new_h + pad_h, new_w + pad_w
    y = 0 if im_h == ch else int(rng.integers(0, im_h - ch + 1))
    x = 0 if im_w == cw else int(rng.integers(0, im_w - cw + 1))
    # Row p of the padded image is row clip(p - pad_top, 0, new - 1) of the
    # resized one (edge mode); the window reads rows y .. y + ch - 1.
    rr = np.clip(y + np.arange(ch) - pad_h // 2, 0, new_h - 1)
    cc = np.clip(x + np.arange(cw) - pad_w // 2, 0, new_w - 1)
    return rows[rr], cols[cc]


# Jitter slot op ids of the device feed (0 leaves a slot unused).
JITTER_NONE, JITTER_BRIGHT, JITTER_SAT, JITTER_HUE, JITTER_CONTRAST = range(5)


def plan_jitter(jit: ColorJitter, rng):
    """ColorJitter.__call__'s draws (hue, then brightness / contrast /
    saturation, then the permutation of the ops); returns (op_ids[4],
    factors[4]), the ops in the order they apply."""
    bright, contrast, sat, hue = jit._factors(rng)
    ops = []
    if bright is not None:
        ops.append((JITTER_BRIGHT, bright))
    if sat is not None:
        ops.append((JITTER_SAT, sat))
    if hue is not None:
        ops.append((JITTER_HUE, hue))
    if contrast is not None:
        ops.append((JITTER_CONTRAST, contrast))
    order = rng.permutation(len(ops))
    op_ids = np.zeros(4, np.int32)
    factors = np.zeros(4, np.float32)
    for slot, i in enumerate(order):
        op_ids[slot], factors[slot] = ops[i]
    return op_ids, factors


class AllAugmentationTransform:
    """Select -> flip -> rotate -> resize -> crop -> jitter -> split
    (pipeline order per reference augmentation.py:363-389)."""

    def __init__(
        self,
        resize_param=None,
        rotation_param=None,
        flip_param=None,
        crop_param=None,
        jitter_param=None,
        select_param=None,
    ):
        self.select = SelectRandomFrames(**(select_param or {}))
        self.flip = RandomFlip(**flip_param) if flip_param is not None else None
        self.rotation = (
            RandomRotation(**rotation_param) if rotation_param is not None else None
        )
        self.resize = RandomResize(**resize_param) if resize_param is not None else None
        self.crop = RandomCrop(**crop_param) if crop_param is not None else None
        self.jitter = ColorJitter(**jitter_param) if jitter_param is not None else None

        self.transforms = [self.select]
        for t in (self.flip, self.rotation, self.resize, self.crop, self.jitter):
            if t is not None:
                self.transforms.append(t)
        self.transforms.append(SplitSourceDriving())

    def __call__(self, clip, rng=None):
        rng = _rng(rng)
        for t in self.transforms:
            clip = t(clip, rng=rng)
        return clip

    # ---------------------------------------------------------- device plans
    def supports_device_feed(self, h: int, w: int) -> bool:
        """True when every configured transform has an exact or near-exact
        form on the card: a nearest resize whose smallest ratio keeps
        skimage's Gaussian prefilter at radius 0 (a scale above ~0.8)."""
        if self.resize is not None:
            if self.resize.interpolation != "nearest":
                return False
            lo = min(self.resize.ratio)
            sig = max(0.0, (1.0 / lo - 1) / 2)
            if int(4.0 * sig + 0.5) > 0:
                return False
        return True

    def plan(self, n_frames: int, h: int, w: int, rng):
        """One item's augmentation as a plan (see data/device_feed.py), its
        draws taken in __call__'s order: select, flip, rotation, resize
        scale, crop offsets, jitter factors and permutation."""
        frame_idx = plan_select(self.select, n_frames, rng)
        hflip = False
        if self.flip is not None:
            frame_idx, hflip = plan_flip(self.flip, frame_idx, rng)
        angle = plan_rotation(self.rotation, rng) if self.rotation is not None else 0.0
        rows, cols = plan_resize_crop(self.resize, self.crop, h, w, rng)
        if self.jitter is not None:
            op_ids, factors = plan_jitter(self.jitter, rng)
        else:
            op_ids = np.zeros(4, np.int32)
            factors = np.zeros(4, np.float32)
        return {
            "frame_idx": np.asarray(frame_idx, np.int32),
            "hflip": np.int32(hflip),
            "angle": np.float32(angle),
            "rows": np.asarray(rows, np.int32),
            "cols": np.asarray(cols, np.int32),
            "jitter_ops": op_ids,
            "jitter_factors": factors,
        }
