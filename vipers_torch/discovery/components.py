"""Seed flood fill and component box on a batch of grids (port of
``flood_fill_from_seed`` and ``component_bbox`` in
``vipers/discovery/components.py``).

4-connectivity, as ``scipy.ndimage.label``'s default structure. The fill is
a monotone dilation from the seed; all B grids dilate together and the host
checks convergence only every ``CHECK_EVERY`` steps, so a batch costs one
host sync per ``CHECK_EVERY`` dilations instead of one per step. Extra steps
past the fixed point change nothing (dilation there is idempotent), so the
result equals the JAX ``while_loop``'s.
"""

from __future__ import annotations

import torch

CHECK_EVERY = 8


def _dilate4(x):
    """One 4-connected binary dilation of (B, H, W) bool grids."""
    out = x.clone()
    out[:, :-1, :] |= x[:, 1:, :]
    out[:, 1:, :] |= x[:, :-1, :]
    out[:, :, :-1] |= x[:, :, 1:]
    out[:, :, 1:] |= x[:, :, :-1]
    return out


def flood_fill_from_seed(mask, seed_rc):
    """Bool (B, H, W) component of each ``mask`` containing its seed
    ``seed_rc`` (B, 2) = (row, col); all-False where the seed itself is
    background."""
    b = mask.shape[0]
    cur = torch.zeros_like(mask)
    cur[torch.arange(b, device=mask.device), seed_rc[:, 0], seed_rc[:, 1]] = True
    cur &= mask
    while True:
        for _ in range(CHECK_EVERY):
            prev, cur = cur, _dilate4(cur) & mask
        if torch.equal(cur, prev):
            return cur


def component_bbox(mask):
    """(B, 4) int64 (ymin, ymax_excl, xmin, xmax_excl) of the True cells of
    each (H, W) grid, the reference's min/max+1 convention; an all-False
    grid yields (0, 0, 0, 0)."""
    _, h, w = mask.shape
    rows = mask.any(dim=2)
    cols = mask.any(dim=1)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    big_h = torch.full_like(ridx, h)
    big_w = torch.full_like(cidx, w)
    neg = torch.full((), -1, device=mask.device)
    ymin = torch.where(rows, ridx, big_h).amin(dim=1)
    ymax = torch.where(rows, ridx, neg).amax(dim=1) + 1
    xmin = torch.where(cols, cidx, big_w).amin(dim=1)
    xmax = torch.where(cols, cidx, neg).amax(dim=1) + 1
    box = torch.stack([ymin, ymax, xmin, xmax], dim=1)
    return torch.where(rows.any(dim=1)[:, None], box, torch.zeros_like(box))
