"""One round of global L1 magnitude pruning (port of
``vipers/pruning/magnitude.py``).

Candidates are the weights still unpruned under ``masks``; exactly
``k = round(amount * n_remaining)`` of them with the smallest |w| are
pruned. The ranking is a stable ascending argsort over the concatenation
of every masked kernel in sorted-path order, each flattened in the flax
layout, so ties at the cutoff fall exactly as in the JAX package.
"""

from __future__ import annotations

import torch

from vipers_torch.core.checkpoint import as_tensor
from vipers_torch.core.tree import flatten_dict
from vipers_torch.pruning import masks as M


def magnitude_prune(params, masks: dict, amount: float = 0.2) -> dict:
    """One global L1 pruning round over the currently unpruned weights;
    returns the new masks (old mask AND keep)."""
    if not 0.0 <= amount <= 1.0:
        raise ValueError(f"amount must be in [0,1], got {amount}")
    flat = flatten_dict(params)
    abs_w = {p: as_tensor(flat[p]).float().abs() for p in masks}
    vec, layout = M.concat_masked_scores(abs_w)
    mvec, _ = M.concat_masked_scores(
        {p: as_tensor(masks[p]).to(torch.bool) for p in masks})
    n_remaining = int(mvec.sum())
    k = int(round(amount * n_remaining))
    if k <= 0:
        return dict(masks)
    ranked = torch.where(mvec, vec, torch.full((), float("inf")))
    order = torch.argsort(ranked, stable=True)  # ascending |w|, ties by index
    keep = torch.ones_like(mvec)
    keep[order[:k]] = False
    return M.split_vector(mvec & keep, layout)
