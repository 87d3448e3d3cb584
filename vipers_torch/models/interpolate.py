"""Positional-embedding interpolation weights (port of
``resize_weight_matrix_np`` in ``vipers/models/interpolate.py``).

torchvision's ``F.interpolate(mode="bicubic", align_corners=True)`` as a
dense (out, in) matrix per axis: Keys cubic kernel a=-0.75, coordinate map
``x_in = x_out * (in-1)/(out-1)``, edge clamp. The DINO path's half-pixel
centers (align_corners=False) are provided too. The LOST driver applies the
two matrices on the device (``driver.LostFeatureExtractor._pos_and_mask``).
"""

from __future__ import annotations

import numpy as np


def resize_weight_matrix_np(in_size: int, out_size: int, align_corners: bool):
    """The dense (out, in) f32 bicubic resample matrix, a function of sizes
    only. ``out == in`` yields the exact identity."""
    out_idx = np.arange(out_size, dtype=np.float32)
    if align_corners and out_size > 1:
        src = out_idx * (in_size - 1) / (out_size - 1)
    elif align_corners:
        src = np.zeros_like(out_idx)
    else:
        scale = in_size / out_size
        src = (out_idx + 0.5) * scale - 0.5
    base = np.floor(src)
    in_idx = np.arange(-1, 3, dtype=np.float32)[None, :] + base[:, None]
    x_abs = np.abs((src[:, None] - in_idx).astype(np.float32))
    a = np.float32(-0.75)
    x2 = x_abs * x_abs
    x3 = x2 * x_abs
    f1 = (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0
    f2 = a * x3 - 5.0 * a * x2 + 8.0 * a * x_abs - 4.0 * a
    w = np.where(x_abs <= 1.0, f1,
                 np.where(x_abs < 2.0, f2, 0.0)).astype(np.float32)
    in_clamped = np.clip(in_idx, 0, in_size - 1).astype(np.int32)
    mat = np.zeros((out_size, in_size), np.float32)
    np.add.at(mat, (np.arange(out_size)[:, None], in_clamped), w)
    return mat

