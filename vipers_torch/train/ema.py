"""Exponential moving average of model parameters (port of
``vipers/train/ema.py``): ``ema = decay * ema + (1 - decay) * param``, with
the reference's world-size / batch / steps adjustment of the decay."""

from __future__ import annotations

from typing import Dict

import torch


def ema_decay_for(model_ema_decay: float, world_size: int, batch_size: int,
                  model_ema_steps: int, epochs: int) -> float:
    adjust = world_size * batch_size * model_ema_steps / epochs
    alpha = 1.0 - model_ema_decay
    alpha = min(1.0, alpha * adjust)
    return 1.0 - alpha


def ema_update_(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], decay: float):
    """In place: ``ema <- decay * ema + (1 - decay) * new``, with decay and
    1 - decay taken in float32 as the JAX step takes them."""
    d = torch.tensor(decay, dtype=torch.float32)
    one_minus = 1.0 - d
    with torch.no_grad():
        for k, e in ema.items():
            e.copy_(d.to(e.device) * e + one_minus.to(e.device) * new[k].detach())


def ema_reset(new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the weights (the average restarts, as during LR warmup)."""
    return {k: p.detach().clone() for k, p in new.items()}
