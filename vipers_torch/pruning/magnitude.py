"""One round of global L1 magnitude pruning (port of
``vipers/pruning/magnitude.py``).

Candidates are the weights still unpruned under ``masks``; exactly
``k = round(amount * n_remaining)`` of them with the smallest |w| are
pruned. The ranking is a stable ascending argsort over the concatenation
of every masked kernel in sorted-path order, each flattened in the flax
layout, so ties at the cutoff fall exactly as in the JAX package. The port
selects the same k without a stable sort: every score below the k-th
smallest (``masks.kth_smallest``), then the scores equal to it in index
order, which is where a stable sort puts them (a full stable sort of a
ViT-B/16's 86M weights takes the host seconds), indexed only when some of
them stay.
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
    # a NaN ranks last, as in a sort
    ranked = torch.where(mvec & ~torch.isnan(vec), vec, torch.full((), float("inf")))
    cut = M.kth_smallest(ranked, k)
    prune = ranked < cut
    tied = ranked == cut
    need = k - int(prune.sum())
    if need >= int(tied.sum()):  # every tie goes (the usual one): no order to keep
        prune |= tied
    else:
        ties = torch.nonzero(tied).flatten()  # ascending index: the stable order
        prune[ties[:need]] = True
    return M.split_vector(mvec & ~prune, layout)
