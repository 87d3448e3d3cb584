"""Positional-embedding interpolation weights (port of
``resize_weight_matrix_np`` in ``vipers/models/interpolate.py``).

torchvision's ``F.interpolate(mode="bicubic", align_corners=True)`` as a
dense (out, in) matrix per axis: Keys cubic kernel a=-0.75, coordinate map
``x_in = x_out * (in-1)/(out-1)``, edge clamp. The DINO path's half-pixel
centers (align_corners=False) are provided too. The LOST driver applies the
two matrices on the device (``driver.LostFeatureExtractor._pos_and_mask``),
the explain driver through ``interpolate_pos_embedding``.

``jax.image.resize(..., "bilinear")`` (the explain heatmaps' resize) as a
dense matrix per axis too: ``bilinear_weight_matrix_np``, applied by
``resize_bilinear``.
"""

from __future__ import annotations

import numpy as np
import torch


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


def interpolate_pos_embedding(pos_embedding: torch.Tensor, new_grid_hw,
                              align_corners: bool = True) -> torch.Tensor:
    """A (1, 1 + side*side, D) pos-embedding (CLS first) resized to the
    (gh, gw) token grid, bicubic, one axis at a time as the JAX package's
    ``interpolate_pos_embedding`` does it (an axis that keeps its size is
    left as it is); returned unchanged when the grid already fits."""
    _, seq_len, dim = pos_embedding.shape
    side = int(round((seq_len - 1) ** 0.5))
    if side * side != seq_len - 1:
        raise ValueError(f"stored pos-embedding grid is not square: {seq_len - 1}")
    gh, gw = new_grid_hw
    if (gh, gw) == (side, side):
        return pos_embedding
    grid = pos_embedding[0, 1:].float().reshape(side, side, dim)
    dev = pos_embedding.device
    if gh != side:
        mh = torch.from_numpy(resize_weight_matrix_np(side, gh, align_corners)).to(dev)
        grid = torch.einsum("oi,iwd->owd", mh, grid)
    if gw != side:
        mw = torch.from_numpy(resize_weight_matrix_np(side, gw, align_corners)).to(dev)
        grid = torch.einsum("oi,hid->hod", mw, grid)
    grid = grid.reshape(1, gh * gw, dim).to(pos_embedding.dtype)
    return torch.cat([pos_embedding[:, :1], grid], dim=1)


def bilinear_weight_matrix_np(in_size: int, out_size: int, antialias: bool = True):
    """The (in, out) f32 matrix of ``jax.image.resize``'s "bilinear" along
    one axis: half-pixel sample centers ``(o + 0.5) * in/out - 0.5``, the
    triangle kernel widened by in/out on a downscale (antialiasing), each
    column normalized by its sum (so an edge sample keeps its full weight),
    columns that sample outside the input zeroed. Computed in f32 in the
    order ``jax._src.image.scale.compute_weight_mat`` computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    safe = np.where(total != 0, total, f32(1.0))
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps), w / safe, f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` for an f32 tensor: every
    axis whose size changes is contracted with its
    ``bilinear_weight_matrix_np`` (an axis that keeps its size is the
    identity there and is skipped, as in JAX)."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match the rank of x {tuple(x.shape)}")
    for d, n in enumerate(shape):
        m = x.shape[d]
        if m == n:
            continue
        w = torch.from_numpy(bilinear_weight_matrix_np(m, n)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x
