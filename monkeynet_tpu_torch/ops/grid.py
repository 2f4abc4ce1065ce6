"""Coordinate grids and closed-form 2x2 matrix math.

Counterpart of monkeynet_tpu/ops/grid.py. Shape-polymorphic over leading
batch dims.
"""

from __future__ import annotations

import torch


def make_coordinate_grid(spatial_size, dtype=torch.float32, device=None):
    """Return an (h, w, 2) grid of xy coordinates spanning [-1, 1]^2.

    Last-dim order is (x, y): out[i, j] = (x_j, y_i), the keypoint convention
    (x = width axis).
    """
    h, w = spatial_size
    x = 2.0 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1.0
    xx = x[None, :].expand(h, w)
    yy = y[:, None].expand(h, w)
    return torch.stack([xx, yy], dim=-1)


def _unpack2x2(m):
    return m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]


def mat2_inverse(m):
    """Closed-form inverse of a batch of 2x2 matrices."""
    a, b, c, d = _unpack2x2(m)
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def mat2_smallest_singular(m):
    """Smallest singular value of a batch of 2x2 matrices, closed form.

    Returns shape m.shape[:-2] + (1,), keepdim on the last axis.
    """
    a, b, c, d = _unpack2x2(m)
    s1 = a**2 + b**2 + c**2 + d**2
    s2 = torch.sqrt((a**2 + b**2 - c**2 - d**2) ** 2 + 4.0 * (a * c + b * d) ** 2)
    return torch.sqrt((s1 - s2) / 2.0)[..., None]
