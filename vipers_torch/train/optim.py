"""Optimizer, LR schedule and weight-decay grouping (port of
``vipers/train/optim.py``) on ``torch.optim``.

The JAX package builds one optax chain: [clip] -> per-leaf decay ->
optimizer -> lr schedule -> masked update. Here ``MaskedOptimizer`` holds a
``torch.optim`` optimizer whose parameter groups carry the per-leaf decay
rates, and steps in the same order: gradients masked, clipped by their
global norm as ``optax.clip_by_global_norm`` does, the learning rate set
from the schedule at the optimizer's own step count, the optimizer's step
(decay, momentum or moments, lr), and pruned slots restored.

torch.optim's update rules are the optax chains' (held step for step by
``tests/test_optim.py``): SGD couples decay into the gradient before
momentum; RMSprop adds eps=0.0316 outside the sqrt with alpha 0.9; AdamW
decays by lr * rate before the Adam step.

Decay rates are decided on flax paths, as in the JAX package (a ResNet's
``bn1`` and ``downsample_bn`` are norm layers there), and mapped to the
module's parameter names through the family's ``state_key``
(``core.checkpoint.Family``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from vipers_torch.core.tree import flatten_dict
from vipers_torch.pruning.masked_optim import mask_gradients, masked_updates


@dataclasses.dataclass
class OptimConfig:
    opt: str = "sgd"  # sgd | sgd_nesterov | rmsprop | adamw
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    norm_weight_decay: Optional[float] = None
    bias_weight_decay: Optional[float] = None
    transformer_embedding_decay: Optional[float] = None
    label_smoothing: float = 0.0
    clip_grad_norm: Optional[float] = None
    # schedule
    lr_scheduler: str = "steplr"  # steplr | cosineannealinglr | exponentiallr
    lr_step_size: int = 30
    lr_gamma: float = 0.1
    lr_min: float = 0.0
    lr_warmup_epochs: int = 0
    lr_warmup_method: str = "constant"  # linear | constant
    lr_warmup_decay: float = 0.01
    epochs: int = 90


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer's step, with per-epoch
    semantics (the reference steps its scheduler once per epoch)."""

    def main_lr(epoch):
        e = epoch - cfg.lr_warmup_epochs
        sch = cfg.lr_scheduler.lower()
        if sch == "steplr":
            return cfg.lr * cfg.lr_gamma ** math.floor(e / cfg.lr_step_size)
        if sch == "cosineannealinglr":
            t_max = max(cfg.epochs - cfg.lr_warmup_epochs, 1)
            cos = 0.5 * (1 + math.cos(math.pi * min(e, t_max) / t_max))
            return cfg.lr_min + (cfg.lr - cfg.lr_min) * cos
        if sch == "exponentiallr":
            return cfg.lr * cfg.lr_gamma ** e
        raise RuntimeError(f"Invalid lr scheduler {cfg.lr_scheduler!r}")

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if cfg.lr_warmup_epochs > 0:
            w = cfg.lr_warmup_epochs
            if cfg.lr_warmup_method == "linear":
                frac = min(epoch, w) / w
                warm = cfg.lr * (cfg.lr_warmup_decay + (1.0 - cfg.lr_warmup_decay) * frac)
            elif cfg.lr_warmup_method == "constant":
                warm = cfg.lr * cfg.lr_warmup_decay
            else:
                raise RuntimeError(f"Invalid warmup method {cfg.lr_warmup_method!r}")
            return warm if epoch < w else main_lr(epoch)
        return main_lr(epoch)

    return schedule


_NORM_HINTS = ("bn", "norm", "ln")


def _is_norm_param(path) -> bool:
    """Norm layers are named bn*/ln*/norm*; a ``scale`` leaf is a norm."""
    if path[-1] not in ("scale", "bias"):
        return False
    parent = path[-2] if len(path) > 1 else ""
    return any(h in parent.lower() for h in _NORM_HINTS) or path[-1] == "scale"


def weight_decay_rates(params, cfg: OptimConfig) -> Dict[tuple, float]:
    """{flax path: decay rate} with set_weight_decay semantics: custom keys
    win over norm grouping, which wins over the default."""
    rates = {}
    for path in flatten_dict(params):
        joined = "/".join(path)
        rate = cfg.weight_decay
        if _is_norm_param(path) and cfg.norm_weight_decay is not None:
            rate = cfg.norm_weight_decay
        if path[-1] == "bias" and cfg.bias_weight_decay is not None:
            rate = cfg.bias_weight_decay
        if cfg.transformer_embedding_decay is not None and any(
                k in joined for k in ("class_token", "pos_embedding", "cls_token",
                                      "pos_embed", "relative_position_bias")):
            rate = cfg.transformer_embedding_decay
        rates[path] = rate
    return rates


def clip_by_global_norm_(grads: Dict[str, torch.Tensor], max_norm: float,
                         sq_norm: Optional[Callable] = None):
    """In place, as ``optax.clip_by_global_norm``: if the global norm is not
    below ``max_norm``, every gradient becomes ``g / norm * max_norm`` (no
    epsilon). Decided on the device: no host sync. ``sq_norm(grads)``: the
    squared global norm where ``grads`` are one rank's part of the model's
    (tensor or pipeline parallelism)."""
    gs = list(grads.values())
    if sq_norm is None:
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in gs))
    else:
        norm = torch.sqrt(sq_norm(grads))
    keep = norm < max_norm
    for g in gs:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


class MaskedOptimizer:
    """The port's counterpart of ``make_optimizer``'s optax chain for one
    module: ``step(grads, masks)`` applies [clip] -> decay + optimizer at
    lr = schedule(step count) -> masked update, and counts the step;
    ``reset()`` drops the optimizer state and the count (a new LRR round).

    ``flax_params`` is the module's parameter tree in flax paths (e.g.
    ``core.checkpoint.flax_tree_from_vit_state_dict``), which decides the
    decay rate of each parameter; ``state_key`` maps a flax path to the
    module's parameter name. ``sq_norm`` (None: the module's own) gives the
    clip's squared global norm when the module holds part of the model
    (``parallel.tp``, ``parallel.pp``)."""

    sq_norm: Optional[Callable] = None

    def __init__(self, cfg: OptimConfig, module: torch.nn.Module, flax_params,
                 schedule: Callable[[int], float], state_key: Callable[[tuple], str]):
        self.cfg = cfg
        self.schedule = schedule
        self.params = dict(module.named_parameters())
        rates = {state_key(p): r for p, r in weight_decay_rates(flax_params, cfg).items()}
        if set(rates) != set(self.params):
            raise ValueError(f"decay rates and module parameters differ: "
                             f"{sorted(set(rates) ^ set(self.params))}")
        groups: Dict[float, list] = {}
        for name, p in self.params.items():
            groups.setdefault(rates[name], []).append(p)
        self._groups = [{"params": ps, "weight_decay": r} for r, ps in groups.items()]
        self.reset()

    def reset(self):
        cfg = self.cfg
        opt = cfg.opt.lower()
        if opt.startswith("sgd"):
            self.opt = torch.optim.SGD(self._groups, lr=cfg.lr, momentum=cfg.momentum,
                                       nesterov="nesterov" in opt)
        elif opt == "rmsprop":
            self.opt = torch.optim.RMSprop(self._groups, lr=cfg.lr, alpha=0.9,
                                           eps=0.0316, momentum=cfg.momentum)
        elif opt == "adamw":
            self.opt = torch.optim.AdamW(self._groups, lr=cfg.lr,
                                         betas=(0.9, 0.999), eps=1e-8)
        else:
            raise RuntimeError(f"Invalid optimizer {cfg.opt!r}; sgd/rmsprop/adamw only")
        self.count = 0

    def state_dict(self) -> dict:
        """The optimizer's state (momentum or moments) and its step count,
        for a checkpoint."""
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict):
        """Restore what ``state_dict`` returned (tensors move to the
        parameters' device)."""
        self.opt.load_state_dict(sd["opt"])
        self.count = int(sd["count"])

    def _order(self):
        """The parameter names in the order ``state_dict`` numbers them."""
        names = {id(p): n for n, p in self.params.items()}
        return [names[id(p)] for g in self.opt.param_groups for p in g["params"]]

    def named_state(self, sd: Optional[dict] = None) -> Dict[str, dict]:
        """{parameter name: its state (momentum or moments)} of this
        optimizer, or of ``sd`` (a ``state_dict`` of an optimizer over the
        same parameters)."""
        if sd is None:
            names = {id(p): n for n, p in self.params.items()}
            return {names[id(p)]: st for p, st in self.opt.state.items()}
        order = self._order()
        return {order[int(i)]: st for i, st in sd["opt"]["state"].items()}

    def load_named_state(self, named: Dict[str, dict], count: int):
        """Restore ``named_state``'s form (tensors move to the parameters'
        device) and the step count."""
        self.opt.state.clear()
        for n, st in named.items():
            p = self.params[n]
            self.opt.state[p] = {k: (v.to(p.device) if torch.is_tensor(v) and v.dim() else v)
                                 for k, v in st.items()}
        self.count = int(count)

    def state_dict_from(self, named: Dict[str, dict], count: int) -> dict:
        """``state_dict``'s form of ``named`` state for this optimizer's
        parameters (a whole model's, assembled from its ranks' parts)."""
        sd = self.opt.state_dict()
        sd["state"] = {i: named[n] for i, n in enumerate(self._order()) if n in named}
        return {"opt": sd, "count": int(count)}

    def step(self, grads: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor]):
        grads = mask_gradients(grads, masks)
        if self.cfg.clip_grad_norm is not None:
            clip_by_global_norm_(grads, self.cfg.clip_grad_norm, self.sq_norm)
        for name, p in self.params.items():
            p.grad = grads[name]
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        before = {k: self.params[k].detach().clone() for k in masks}
        self.opt.step()
        masked_updates(self.params, before, masks)
        for p in self.params.values():
            p.grad = None
        self.count += 1
