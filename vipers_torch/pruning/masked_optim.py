"""Masked gradients and updates: pruned slots never move (port of
``vipers/pruning/masked_optim.py``).

Gradients and masks are ``{state-dict key: tensor}`` dicts in the module's
layout (``core.checkpoint.vit_masks_to_state_dict``). ``mask_gradients``
zeros the gradient at pruned slots before clipping and momentum;
``masked_updates`` is the last link of the update: after the optimizer has
stepped, every pruned slot gets back its value from before the step, bit
for bit, so neither momentum nor a decay term moves it, whether or not the
weight there is zero.
"""

from __future__ import annotations

from typing import Dict

import torch


def mask_gradients(grads: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor]):
    """Gradients with pruned slots zeroed: ``where(mask, g, 0)``."""
    if not masks:
        return grads
    return {k: (torch.where(masks[k], g, torch.zeros((), dtype=g.dtype, device=g.device))
                if k in masks else g)
            for k, g in grads.items()}


def masked_updates(params: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor],
                   masks: Dict[str, torch.Tensor]):
    """In place, after an optimizer step: ``p = where(mask, p, before)`` for
    every masked parameter. ``before`` holds the masked parameters' values
    from before the step."""
    with torch.no_grad():
        for k, mask in masks.items():
            p = params[k]
            p.copy_(torch.where(mask, p, before[k]))
