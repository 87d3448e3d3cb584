"""Pruning masks as a flat ``{path tuple: bool tensor}`` dict (port of
``vipers/pruning/masks.py``).

Paths and layouts are the JAX package's (flax keys; conv HWIO, dense
(in, out)), so masks pass between the two packages unchanged and global
rankings visit the weights in the same order. Prunable: every leaf named
``kernel`` with 2 (Dense) or 4 (Conv) dims, minus ``exclude`` substrings.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from vipers_torch.core.checkpoint import as_tensor
from vipers_torch.core.tree import flatten_dict, unflatten_dict

Path = Tuple[str, ...]
MaskTree = Dict[Path, torch.Tensor]


def prunable_paths(params, exclude: Sequence[str] = ()) -> list:
    """Paths of prunable kernels, in deterministic (sorted) order."""
    out = []
    for path, leaf in sorted(flatten_dict(params).items()):
        if path[-1] != "kernel" or as_tensor(leaf).dim() not in (2, 4):
            continue
        if any(pat in "/".join(path) for pat in exclude):
            continue
        out.append(path)
    return out


def init_masks(params, exclude: Sequence[str] = ()) -> MaskTree:
    """All-ones (keep everything) masks for every prunable kernel."""
    flat = flatten_dict(params)
    return {p: torch.ones(as_tensor(flat[p]).shape, dtype=torch.bool,
                          device=as_tensor(flat[p]).device)
            for p in prunable_paths(params, exclude)}


def apply_masks(params, masks: MaskTree):
    """Params with masked kernels zeroed: ``where(mask, w, 0)``."""
    if not masks:
        return params
    flat = dict(flatten_dict(params))
    for path, mask in masks.items():
        w = as_tensor(flat[path])
        flat[path] = torch.where(as_tensor(mask).to(torch.bool), w,
                                 torch.zeros((), dtype=w.dtype))
    return unflatten_dict(flat)


def compute_sparsity_global(params, masks: MaskTree) -> float:
    """Global % of zero weights over the masked kernels, counted on the
    effective weight ``where(mask, w, 0)`` (pruned slots plus kept weights
    that are exactly zero)."""
    flat = flatten_dict(params)
    total = zeros = 0
    for path, mask in masks.items():
        w = as_tensor(flat[path])
        w_eff = torch.where(as_tensor(mask).to(torch.bool), w, torch.zeros((), dtype=w.dtype))
        total += w_eff.numel()
        zeros += int((w_eff == 0).sum())
    return 100.0 * zeros / total if total else 0.0


def concat_masked_scores(scores: MaskTree):
    """Flatten score tensors into one vector in sorted-path order. Returns
    (vector, layout) with layout = [(path, shape, size)]."""
    vec, layout = [], []
    for path in sorted(scores):
        s = as_tensor(scores[path]).reshape(-1)
        vec.append(s)
        layout.append((path, tuple(as_tensor(scores[path]).shape), s.numel()))
    return torch.cat(vec), layout


def split_vector(vec, layout) -> MaskTree:
    out, off = {}, 0
    for path, shape, size in layout:
        out[path] = vec[off: off + size].reshape(shape)
        off += size
    return out
