"""Visualization: keypoint overlays and labeled comparison grids.

Counterpart of monkeynet_tpu/utils/visualizer.py. Capability parity with
the reference Visualizer (logger.py:91-175): colored keypoint dots
(colormap over kp index), per-video columns, optional white
borders, side-by-side grids for train-vis / reconstruction / transfer. The
circle rasterizer is a numpy disk (the reference's skimage.draw.circle was
removed upstream). The keypoint colours come from matplotlib's
'gist_rainbow' lookup table, rebuilt here so the port needs no matplotlib.

All videos here are (B, D, H, W, C) float32 [0, 1] numpy; keypoints are
(B, D, K, 2) xy in [-1, 1].
"""

from __future__ import annotations

import numpy as np


# matplotlib's 'gist_rainbow' (matplotlib/_cm.py): (position, (r, g, b)).
_GIST_RAINBOW = (
    (0.000, (1.00, 0.00, 0.16)),
    (0.030, (1.00, 0.00, 0.00)),
    (0.215, (1.00, 1.00, 0.00)),
    (0.400, (0.00, 1.00, 0.00)),
    (0.586, (0.00, 1.00, 1.00)),
    (0.770, (0.00, 0.00, 1.00)),
    (0.954, (1.00, 0.00, 1.00)),
    (1.000, (1.00, 0.00, 0.75)),
)
_LUT_SIZE = 256  # matplotlib's default colormap resolution


class _GistRainbow:
    """colormap(x) -> (r, g, b, 1.0) for x in [0, 1], from the table that
    matplotlib's LinearSegmentedColormap.from_list builds, indexed as
    matplotlib indexes it."""

    def __init__(self, n: int = _LUT_SIZE):
        x = np.array([p for p, _ in _GIST_RAINBOW]) * (n - 1)
        y = np.array([c for _, c in _GIST_RAINBOW])
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = ((xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1]))[:, None]
        lut = np.concatenate([y[:1], distance * (y[ind] - y[ind - 1]) + y[ind - 1], y[-1:]])
        self.lut = np.concatenate([np.clip(lut, 0.0, 1.0), np.ones((n, 1))], axis=1)
        self.n = n

    def __call__(self, x: float):
        return tuple(self.lut[min(int(x * self.n), self.n - 1)])


def _disk(center_y, center_x, radius, shape):
    yy, xx = np.ogrid[: shape[0], : shape[1]]
    return (yy - center_y) ** 2 + (xx - center_x) ** 2 <= radius**2


class Visualizer:
    def __init__(self, kp_size=2, draw_border=False, colormap="gist_rainbow"):
        self.kp_size = kp_size
        self.draw_border = draw_border
        if colormap != "gist_rainbow":
            raise ValueError(f"colormap {colormap!r}: the port carries 'gist_rainbow', "
                             "the one every config uses")
        self.colormap = _GistRainbow()

    def draw_video_with_kp(self, video, kp_array):
        """video (D, H, W, C); kp_array (D, K, 2) in [-1, 1] xy."""
        video = np.copy(video)
        h, w = video.shape[1:3]
        spatial = np.array([[w, h]], dtype=np.float32)
        kp = spatial * (kp_array + 1) / 2  # pixels, xy
        num_kp = kp.shape[1]
        for d in range(len(video)):
            for k in range(num_kp):
                x, y = kp[d, k]
                mask = _disk(y, x, self.kp_size, (video.shape[1], video.shape[2]))
                video[d][mask] = np.array(self.colormap(k / num_kp))[:3]
        return video

    def create_video_column(self, videos):
        """(B, D, H, W, C) -> one column (D, B*H, W, C)."""
        videos = np.asarray(videos)
        if self.draw_border:
            videos = np.copy(videos)
            videos[:, :, [0, -1]] = 1.0
            videos[:, :, :, [0, -1]] = 1.0
        return np.concatenate(list(videos), axis=1)

    def create_video_column_with_kp(self, videos, kps):
        drawn = np.stack(
            [self.draw_video_with_kp(v, k) for v, k in zip(videos, kps)]
        )
        return self.create_video_column(drawn)

    def create_image_grid(self, *args):
        """Each arg is a (B,D,H,W,C) video batch or a (video, kp) tuple; the
        columns are tiled horizontally: (D, B*H, ncols*W, C)."""
        cols = []
        for arg in args:
            if isinstance(arg, tuple):
                cols.append(self.create_video_column_with_kp(*arg))
            else:
                cols.append(self.create_video_column(arg))
        return np.concatenate(cols, axis=2)

    @staticmethod
    def _rep(frame_batch, d):
        """Repeat a (B, 1, H, W, C) frame along the time axis d times."""
        return np.repeat(frame_batch, d, axis=1)

    def visualize_reconstruction(self, inp, out):
        """inp: {'source' (B,1,H,W,C), 'video' (B,D,H,W,C)};
        out: {'video_prediction', 'video_deformed', 'kp_driving', 'kp_source'}."""
        pred = np.asarray(out["video_prediction"])
        gt = np.asarray(inp.get("driving", inp["video"]))
        deformed = np.asarray(out["video_deformed"])
        d = pred.shape[1]
        source = self._rep(np.asarray(inp["source"]), d)

        kp_video = np.asarray(out["kp_driving"]["mean"])
        kp_appearance = np.repeat(np.asarray(out["kp_source"]["mean"]), d, axis=1)

        image = self.create_image_grid(
            (source, kp_appearance), (gt, kp_video), pred, deformed, gt
        )
        return (255 * np.clip(image, 0, 1)).astype(np.uint8)

    def visualize_transfer(self, driving_video, source_image, out):
        """driving_video (B,D,H,W,C), source_image (B,1,H,W,C); out:
        {'video_prediction', 'video_deformed', 'kp_driving', 'kp_source',
        'kp_norm'}."""
        pred = np.asarray(out["video_prediction"])
        deformed = np.asarray(out["video_deformed"])
        driving = np.asarray(driving_video)
        d = pred.shape[1]
        source = self._rep(np.asarray(source_image)[:, :1], d)
        driving_first = self._rep(driving[:, :1], d)

        kp_video = np.asarray(out["kp_driving"]["mean"])
        kp_appearance = np.repeat(np.asarray(out["kp_source"]["mean"]), d, axis=1)
        kp_norm = np.asarray(out["kp_norm"]["mean"])
        kp_video_first = np.repeat(kp_video[:, :1], d, axis=1)

        image = self.create_image_grid(
            (source, kp_appearance),
            (driving_first, kp_video_first),
            (driving, kp_video),
            (pred, kp_norm),
            pred,
            deformed,
        )
        return (255 * np.clip(image, 0, 1)).astype(np.uint8)
