"""Weights carried across from the JAX package (port of the ViT part of
``vipers/core/checkpoint.py``).

A flax ViT parameter tree (nested dict of numpy arrays or tensors, conv
kernels HWIO, dense kernels (in, out)) plus optional pruning masks (flat
``{path tuple: bool array}`` in the same layout) becomes a state dict of
``vipers_torch.models.vit.VisionTransformer``: conv OIHW, linear (out, in),
``encoder_layer_i`` -> ``layers.i``, LayerNorm ``scale`` -> ``weight``.
Masks are baked as ``where(mask, w, 0)`` before the layout change, exactly
as the JAX extractor bakes them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

from vipers_torch.core.tree import flatten_dict


def as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def _conv_w(w):  # HWIO -> OIHW
    return w.permute(3, 2, 0, 1)


def _lin_w(w):  # (in, out) -> (out, in)
    return w.t()


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
            w = _conv_w(w) if w.dim() == 4 else _lin_w(w)
        sd[_state_key(path)] = w.contiguous()
    return sd
