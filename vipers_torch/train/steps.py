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

In a data-parallel run (``parallel.mesh``) each rank's gradients and
metrics are averaged over the data group before the optimizer (the
global-batch mean's, as under the JAX package's mesh), so every rank takes
the same update; BatchNorm's batch statistics are the global batch's
(``models.cnn``). A tensor-parallel rank (``parallel.tp``) runs the same
step on its shard module: its split gradients are its shard's, the
replicated ones whole. The pipelined step is ``parallel.pp``'s.

Parameters and masks are keyed by the module's state-dict names, masks in
the module's layout (``core.checkpoint.Family.masks_to_state_dict``).

BatchNorm models (the ResNets) keep their running statistics in the
module's buffers (``TrainState.batch_stats``). The train forward returns
the statistics updated from the compute-dtype forward and the step writes
them back, as the JAX step takes ``new_bs`` from ``mutable=["batch_stats"]``;
the EMA averages them too, and the EMA eval reads ``ema_batch_stats``. The
statistics are never cast to bf16 (the JAX step casts ``params`` only). An
f32 step's or eval's convolutions run as exact f32 on the card
(``models.cnn.exact_f32_convs``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from vipers_torch.core.checkpoint import Family, family
from vipers_torch.core.device import resolve_device
from vipers_torch.core.registry import build_module
from vipers_torch.models import cnn
from vipers_torch.models.stochastic import dropout_generator, has_random_layers
from vipers_torch.parallel import mesh as parallel
from vipers_torch.train.ema import ema_reset, ema_update_
from vipers_torch.train.optim import MaskedOptimizer, OptimConfig, make_lr_schedule


@dataclasses.dataclass
class TrainState:
    """``model`` holds the f32 master parameters and the running statistics
    (its buffers); ``masks`` {state-dict key: bool mask}; ``opt`` the
    optimizer chain with its own step count; ``step`` the train step count
    (EMA schedule); ``ema_params`` and ``ema_batch_stats`` {state-dict key:
    f32 tensor} or None; ``family`` the converters of the model's family."""

    step: int
    model: torch.nn.Module
    masks: Dict[str, torch.Tensor]
    opt: MaskedOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    family: Optional[Family] = None

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running statistics, {state-dict key: f32 buffer}; empty for
        a model without BatchNorm."""
        return dict(self.model.named_buffers())


def load_weights(model: torch.nn.Module, fam: Family, params, batch_stats=None, masks=None):
    """Load flax trees into ``model`` (strictly); without ``batch_stats``
    the buffers keep their values."""
    sd = fam.state_dict(params, batch_stats, masks)
    model.load_state_dict({**dict(model.named_buffers()), **sd})


def create_train_state(spec, params, masks, ocfg: OptimConfig, steps_per_epoch: int,
                       device=None, ema: bool = False, batch_stats=None) -> TrainState:
    """A TrainState on ``device`` (default ``cuda``) from a parameter tree,
    flax-path masks and (BatchNorm models) running statistics in the JAX
    package's layouts; without ``batch_stats`` the statistics start at
    their initial values. The parameters are loaded unbaked, as the JAX
    train state holds them."""
    dev = resolve_device(device)
    fam = family(spec)
    model = build_module(spec)
    load_weights(model, fam, params, batch_stats)
    model = model.to(dev).train()
    sd_masks = {k: m.to(dev) for k, m in fam.masks_to_state_dict(masks or {}).items()}
    opt = MaskedOptimizer(ocfg, model, fam.trees(dict(model.named_parameters()))[0],
                          make_lr_schedule(ocfg, steps_per_epoch), fam.state_key)
    state = TrainState(step=0, model=model, masks=sd_masks, opt=opt, family=fam)
    if ema:
        state.ema_params = ema_reset(state.params)
        state.ema_batch_stats = ema_reset(state.batch_stats) if state.batch_stats else None
    return state


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
               label_smoothing: float = 0.0, compute_dtype=torch.float32,
               generator: Optional[torch.Generator] = None):
    """The training forward on ``tensors`` (state-dict names): ``model`` in
    train mode on images cast to ``compute_dtype``, then the cross-entropy.
    ``generator`` feeds a model's random layers (``models.stochastic``).
    Returns (loss, logits, the updated running statistics or None)."""
    images, labels = batch
    model.train()
    kw = {"need_attn": False}
    if generator is not None:
        kw["generator"] = generator
    logits, aux = functional_call(model, tensors, (images.to(compute_dtype),), kw)
    return (cross_entropy(logits, labels, num_classes, label_smoothing), logits,
            aux.get("batch_stats"))


def _forward_backward(model, masks, batch, num_classes: int, label_smoothing: float,
                      compute_dtype, generator=None):
    """(loss, logits, {name: f32 grad}, updated running statistics or None)."""
    params = dict(model.named_parameters())
    with cnn.exact_f32_convs(compute_dtype):
        loss, logits, stats = train_loss(model, forward_params(params, masks, compute_dtype),
                                         batch, num_classes, label_smoothing, compute_dtype,
                                         generator)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), logits.detach(), dict(zip(params, grads)), stats


def loss_and_grads(model, masks, batch, num_classes: int, label_smoothing: float = 0.0,
                   compute_dtype=torch.float32):
    """One training forward and backward: (loss, logits, {name: f32 grad})."""
    return _forward_backward(model, masks, batch, num_classes, label_smoothing,
                             compute_dtype)[:3]


def make_train_step(num_classes: int, label_smoothing: float = 0.0,
                    compute_dtype=torch.float32, ema_decay: Optional[float] = None,
                    ema_every: int = 1, ema_warmup_steps: int = 0, seed: int = 0):
    """Returns ``step(state, (images, labels)) -> (state, metrics)``; the
    state is updated in place and returned. Metrics are device scalars. A
    model with a random layer at a rate above 0 (a Swin's stochastic depth,
    VGG's and the ViT's dropout) draws from a generator seeded from
    (``seed``, the state's step), the counterpart of the JAX step's
    ``fold_in(rng, step)``."""

    def step(state: TrainState, batch):
        gen = None
        if has_random_layers(state.model):
            gen = dropout_generator(seed, state.step, batch[0].device)
        loss, logits, grads, stats = _forward_backward(state.model, state.masks, batch,
                                                       num_classes, label_smoothing,
                                                       compute_dtype, gen)
        acc1, acc5 = accuracy_topk(logits, batch[1])
        # data-parallel: the global-batch mean's gradient and metrics, one all-reduce
        grads, (loss, acc1, acc5) = parallel.average_gradients(grads, (loss, acc1, acc5))
        state.opt.step(grads, state.masks)
        if stats:
            buffers = state.batch_stats
            with torch.no_grad():
                for k, v in stats.items():
                    buffers[k].copy_(v)
        if ema_decay is not None and state.ema_params is not None \
                and state.step % ema_every == 0:
            # during LR warmup the EMA keeps copying the weights
            decay = 0.0 if state.step < ema_warmup_steps else ema_decay
            ema_update_(state.ema_params, state.params, decay)
            if state.ema_batch_stats is not None and stats:
                ema_update_(state.ema_batch_stats, stats, decay)
        state.step += 1
        return state, {"loss": loss, "acc1": acc1, "acc5": acc5}

    return step


def make_eval_step(num_classes: int, label_smoothing: float = 0.0,
                   compute_dtype=torch.float32, use_ema: bool = False):
    """Returns ``step(state, (images, labels)) -> {loss_sum, top1, top5, n}``
    (device scalars). Rows with label -1 are sentinel padding and are left
    out of every sum. With ``use_ema`` the EMA weights and running
    statistics."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        images, labels = batch
        model = state.model
        tensors = forward_params(state.ema_params if use_ema else state.params, state.masks,
                                 compute_dtype)
        if use_ema and state.ema_batch_stats is not None:
            tensors.update(state.ema_batch_stats)
        was_training = model.training
        model.eval()
        try:
            with cnn.exact_f32_convs(compute_dtype):
                logits, _ = functional_call(model, tensors, (images.to(compute_dtype),),
                                            {"need_attn": False})
        finally:
            model.train(was_training)
        return eval_sums(logits, labels, num_classes, label_smoothing)

    return step


def eval_sums(logits, labels, num_classes: int, label_smoothing: float = 0.0) -> dict:
    """{loss_sum, top1, top5, n} of a batch's logits (device scalars), rows
    with label -1 (sentinel padding) left out of every sum."""
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
