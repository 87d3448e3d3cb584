"""Train and eval steps (port of ``vipers/train/steps.py``).

The masks are applied inside the forward, so gradients flow to the raw f32
master parameters: ``where(mask, w, 0)`` on each masked weight, then, for a
bf16 step, a cast of EVERY float parameter (LayerNorm scales and biases
too) to bf16, and the forward runs on that copy through
``torch.func.functional_call``. Autograd through the casts brings the
gradients back in f32 to the masters. No ``torch.autocast``: it keeps some
operations in f32 and rounds elsewhere than the JAX package does.

After the backward: masked gradients, [clip], decay + optimizer, masked
update (``train.optim.MaskedOptimizer``), then the EMA. Metrics stay on the
device; the loops fetch them in groups.

Parameters and masks are keyed by the module's state-dict names, masks in
the module's layout (``core.checkpoint.vit_masks_to_state_dict``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from vipers_torch.core.checkpoint import (flax_tree_from_vit_state_dict,
                                          vit_masks_to_state_dict,
                                          vit_state_dict_from_flax)
from vipers_torch.core.device import resolve_device
from vipers_torch.train.ema import ema_reset, ema_update_
from vipers_torch.train.optim import MaskedOptimizer, OptimConfig, make_lr_schedule


@dataclasses.dataclass
class TrainState:
    """``model`` holds the f32 master parameters; ``masks`` {state-dict key:
    bool mask}; ``opt`` the optimizer chain with its own step count;
    ``step`` the train step count (EMA schedule); ``ema_params`` {state-dict
    key: f32 tensor} or None."""

    step: int
    model: torch.nn.Module
    masks: Dict[str, torch.Tensor]
    opt: MaskedOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(spec, params, masks, ocfg: OptimConfig, steps_per_epoch: int,
                       device=None, ema: bool = False) -> TrainState:
    """A TrainState on ``device`` (default ``cuda``) from a ViT parameter
    tree and flax-path masks in the JAX package's layouts. The parameters
    are loaded unbaked, as the JAX train state holds them."""
    dev = resolve_device(device)
    model = spec.module()
    model.load_state_dict(vit_state_dict_from_flax(params))
    model = model.to(dev).train()
    sd_masks = {k: m.to(dev) for k, m in vit_masks_to_state_dict(masks or {}).items()}
    opt = MaskedOptimizer(ocfg, model, flax_tree_from_vit_state_dict(model.state_dict()),
                          make_lr_schedule(ocfg, steps_per_epoch))
    return TrainState(step=0, model=model, masks=sd_masks, opt=opt,
                      ema_params=ema_reset(dict(model.named_parameters())) if ema else None)


def cross_entropy(logits, labels, num_classes: int, label_smoothing: float = 0.0):
    """CE over int labels or soft targets (torch ``CrossEntropyLoss``
    semantics); the target is built in the logits' dtype, the log-softmax
    in f32, as in the JAX package."""
    if labels.dim() == 1:
        target = F.one_hot(labels, num_classes).to(logits.dtype)
    else:
        target = labels.to(logits.dtype)
    if label_smoothing > 0:
        target = target * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))


def _topk_indices(logits, k: int):
    """Top-k indices with ties toward the lower index, like ``lax.top_k``
    (bf16 logits do tie): a stable descending sort."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def accuracy_topk(logits, targets, topk=(1, 5)):
    """Top-k accuracy in %; one-hot targets are reduced by argmax."""
    if targets.dim() == 2:
        targets = torch.argmax(targets, dim=1)
    maxk = min(max(topk), logits.shape[-1])
    correct = _topk_indices(logits, maxk) == targets[:, None]
    return [100.0 * correct[:, :min(k, maxk)].float().sum() / targets.shape[0]
            for k in topk]


def forward_params(params: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor],
                   compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The tensors the forward runs on: masked weights ``where(mask, w, 0)``,
    then every float tensor cast to ``compute_dtype``."""
    out = {}
    for k, p in params.items():
        if k in masks:
            p = torch.where(masks[k], p, p.new_zeros(()))
        if compute_dtype != torch.float32 and p.is_floating_point():
            p = p.to(compute_dtype)
        out[k] = p
    return out


def train_loss(model, tensors: Dict[str, torch.Tensor], batch, num_classes: int,
               label_smoothing: float = 0.0, compute_dtype=torch.float32):
    """The training forward on ``tensors`` (state-dict names): ``model`` in
    train mode on images cast to ``compute_dtype``, then the cross-entropy.
    Returns (loss, logits)."""
    images, labels = batch
    model.train()
    logits, _ = functional_call(model, tensors, (images.to(compute_dtype),),
                                {"need_attn": False})
    return cross_entropy(logits, labels, num_classes, label_smoothing), logits


def loss_and_grads(model, masks, batch, num_classes: int, label_smoothing: float = 0.0,
                   compute_dtype=torch.float32):
    """One training forward and backward: (loss, logits, {name: f32 grad})."""
    params = dict(model.named_parameters())
    loss, logits = train_loss(model, forward_params(params, masks, compute_dtype), batch,
                              num_classes, label_smoothing, compute_dtype)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), logits.detach(), dict(zip(params, grads))


def make_train_step(num_classes: int, label_smoothing: float = 0.0,
                    compute_dtype=torch.float32, ema_decay: Optional[float] = None,
                    ema_every: int = 1, ema_warmup_steps: int = 0):
    """Returns ``step(state, (images, labels)) -> (state, metrics)``; the
    state is updated in place and returned. Metrics are device scalars."""

    def step(state: TrainState, batch):
        loss, logits, grads = loss_and_grads(state.model, state.masks, batch, num_classes,
                                             label_smoothing, compute_dtype)
        state.opt.step(grads, state.masks)
        if ema_decay is not None and state.ema_params is not None \
                and state.step % ema_every == 0:
            # during LR warmup the EMA keeps copying the weights
            decay = 0.0 if state.step < ema_warmup_steps else ema_decay
            ema_update_(state.ema_params, state.params, decay)
        acc1, acc5 = accuracy_topk(logits, batch[1])
        state.step += 1
        return state, {"loss": loss, "acc1": acc1, "acc5": acc5}

    return step


def make_eval_step(num_classes: int, label_smoothing: float = 0.0,
                   compute_dtype=torch.float32, use_ema: bool = False):
    """Returns ``step(state, (images, labels)) -> {loss_sum, top1, top5, n}``
    (device scalars). Rows with label -1 are sentinel padding and are left
    out of every sum."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        images, labels = batch
        model = state.model
        src = state.ema_params if use_ema else state.params
        was_training = model.training
        model.eval()
        try:
            logits, _ = functional_call(model, forward_params(src, state.masks, compute_dtype),
                                        (images.to(compute_dtype),), {"need_attn": False})
        finally:
            model.train(was_training)
        if labels.dim() == 2:
            valid = labels.amax(dim=1) >= 0
            target = labels.float()
            safe = torch.argmax(labels, dim=1)
        else:
            valid = labels >= 0
            safe = labels.clamp(min=0)
            target = F.one_hot(safe, num_classes).float()
        if label_smoothing > 0:
            target = target * (1.0 - label_smoothing) + label_smoothing / num_classes
        logp = torch.log_softmax(logits.float(), dim=-1)
        per_example = -torch.sum(target * logp, dim=-1)
        loss_sum = torch.where(valid, per_example, per_example.new_zeros(())).sum()
        correct = (_topk_indices(logits, min(5, logits.shape[-1])) == safe[:, None]) \
            & valid[:, None]
        return {"loss_sum": loss_sum, "top1": correct[:, :1].sum(),
                "top5": correct.sum(), "n": valid.sum()}

    return step
