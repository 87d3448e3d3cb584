"""Weights carried across from the JAX package (port of the ViT part of
``vipers/core/checkpoint.py``).

A flax ViT parameter tree (nested dict of numpy arrays or tensors, conv
kernels HWIO, dense kernels (in, out)) plus optional pruning masks (flat
``{path tuple: bool array}`` in the same layout) becomes a state dict of
``vipers_torch.models.vit.VisionTransformer``: conv OIHW, linear (out, in),
``encoder_layer_i`` -> ``layers.i``, LayerNorm ``scale`` -> ``weight``.
Masks are baked as ``where(mask, w, 0)`` before the layout change, exactly
as the JAX extractor bakes them.

The reverse direction serves training and its tests:
``flax_tree_from_vit_state_dict`` turns the module's parameters back into a
flax tree (the layout magnitude pruning ranks in), and
``vit_masks_to_state_dict`` / ``vit_masks_from_state_dict`` move masks
between flax paths and state-dict keys with their layouts.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from vipers_torch.core.tree import flatten_dict, unflatten_dict


def as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def _to_state_layout(w):
    """A flax kernel in the module's layout: conv HWIO -> OIHW, linear
    (in, out) -> (out, in)."""
    return w.permute(3, 2, 0, 1) if w.dim() == 4 else w.t()


def _to_flax_layout(w):
    """A module weight back in the flax kernel layout (HWIO, (in, out))."""
    return w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()


def _state_key(path) -> str:
    parts = list(path)
    m = re.fullmatch(r"encoder_layer_(\d+)", parts[0])
    if m:
        parts[0:1] = ["layers", m.group(1)]
    if parts[-1] in ("scale", "kernel"):
        parts[-1] = "weight"
    return ".".join(parts)


def vit_state_dict_from_flax(params: dict, masks: Optional[dict] = None
                             ) -> Dict[str, torch.Tensor]:
    """State dict for ``VisionTransformer.load_state_dict`` from a flax ViT
    parameter tree, with ``masks`` baked in."""
    flat = {p: as_tensor(a) for p, a in flatten_dict(params).items()}
    for path, m in (masks or {}).items():
        w = flat[path]
        flat[path] = torch.where(as_tensor(m).to(torch.bool), w,
                                 torch.zeros((), dtype=w.dtype))
    sd = {}
    for path, w in flat.items():
        if path[-1] == "kernel":
            w = _to_state_layout(w)
        sd[_state_key(path)] = w.contiguous()
    return sd


def _flax_path(key: str, ndim: int):
    parts = key.split(".")
    if parts[0] == "layers":
        parts[0:2] = [f"encoder_layer_{parts[1]}"]
    if parts[-1] == "weight":
        parts[-1] = "scale" if ndim == 1 else "kernel"
    return tuple(parts)


def flax_tree_from_vit_state_dict(sd) -> dict:
    """The inverse of ``vit_state_dict_from_flax`` (without masks): a flax
    ViT parameter tree of tensors from a state dict or ``named_parameters``
    mapping; one-dimensional ``weight``s are LayerNorm scales."""
    flat = {}
    for key, w in dict(sd).items():
        w = w.detach()
        path = _flax_path(key, w.dim())
        if path[-1] == "kernel":
            w = _to_flax_layout(w)
        flat[path] = w.contiguous()
    return unflatten_dict(flat)


def vit_masks_to_state_dict(masks: dict) -> Dict[str, torch.Tensor]:
    """Flax-path masks -> {state-dict key: bool mask in the module's layout}."""
    return {_state_key(p): _to_state_layout(as_tensor(m).to(torch.bool)).contiguous()
            for p, m in masks.items()}


def vit_masks_from_state_dict(masks: dict) -> dict:
    """The inverse of ``vit_masks_to_state_dict``."""
    return {_flax_path(k, m.dim()): _to_flax_layout(m).contiguous()
            for k, m in masks.items()}
