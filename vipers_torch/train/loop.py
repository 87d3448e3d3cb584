"""Epoch loops and one LRR pruning round (port of ``vipers/train/loop.py``
and of the magnitude-pruning iteration of ``vipers/train/driver.py``).

Host code here only moves batches and aggregates metrics. Steps enqueue
their work without waiting; their metric scalars stay on the device and
come back in one copy per print window (and once at the end), so the host
does not wait on the card every step.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from vipers_torch.core.checkpoint import (flax_tree_from_vit_state_dict,
                                          vit_masks_from_state_dict,
                                          vit_masks_to_state_dict)
from vipers_torch.core.metrics import MeterSet
from vipers_torch.pruning import compute_sparsity_global, magnitude_prune
from vipers_torch.train.steps import TrainState


def train_one_epoch(train_step, state: TrainState, loader: Iterable, epoch: int,
                    normalize_fn=None, print_freq: int = 100):
    meters = MeterSet()
    header = f"Epoch: [{epoch}]"
    flush_every = print_freq if print_freq and print_freq > 0 else 32
    pending: list = []

    def flush():
        if not pending:
            return
        vals = torch.stack([torch.stack([m["loss"].float(), m["acc1"], m["acc5"]])
                            for _, m in pending]).cpu().tolist()
        for (bsz, _), (loss, acc1, acc5) in zip(pending, vals):
            meters.update(n=bsz, loss=loss, acc1=acc1, acc5=acc5)
        pending.clear()

    t_prev = time.time()
    for images, labels in meters.log_every(loader, print_freq, header, pre_print=flush):
        if normalize_fn is not None:
            images = normalize_fn(images)
        state, metrics = train_step(state, (images, labels))
        bsz = images.shape[0]
        pending.append((bsz, metrics))
        if len(pending) >= flush_every:
            flush()
        # pace between enqueues; the flushes absorb the device time
        now = time.time()
        meters.update(**{"img/s": bsz / max(now - t_prev, 1e-9)})
        t_prev = now
    flush()
    return state, meters


def evaluate(eval_step, state: TrainState, loader: Iterable, epoch: Optional[int] = None,
             normalize_fn=None, log_suffix: str = "",
             expected_samples: Optional[int] = None):
    """Full-split eval; returns (acc1, acc5, loss) from exact sums."""
    outs = []
    for images, labels in loader:
        if normalize_fn is not None:
            images = normalize_fn(images)
        out = eval_step(state, (images, labels))
        outs.append(torch.stack([out["loss_sum"].double(), out["top1"].double(),
                                 out["top5"].double(), out["n"].double()]))
    loss_sum, top1, top5, n_seen = (torch.stack(outs).sum(dim=0).cpu().tolist()
                                    if outs else (0.0, 0.0, 0.0, 0.0))
    if expected_samples is not None and int(n_seen) != expected_samples:
        print(f"Warning: dataset has {expected_samples} samples but {int(n_seen)} "
              "were used for validation — results may be biased.")
    n = max(int(n_seen), 1)
    acc1, acc5, loss = 100.0 * top1 / n, 100.0 * top5 / n, loss_sum / n
    print(f"Test:{log_suffix} Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
    return acc1, acc5, loss


def train_model_to_completion(train_step, eval_step, state: TrainState,
                              make_train_loader: Callable[[int], Iterable],
                              eval_loader_fn: Callable[[], Iterable], epochs: int,
                              initial_epoch: int = 0, normalize_fn=None,
                              print_freq: int = 100, eval_step_ema=None,
                              expected_eval_samples: Optional[int] = None):
    """Per epoch: train -> eval (-> EMA eval). Returns (state, last acc1).
    Checkpoints are not ported yet."""
    t_start = time.time()
    last_acc1 = float("nan")
    for epoch in range(initial_epoch, epochs):
        state, _ = train_one_epoch(train_step, state, make_train_loader(epoch), epoch,
                                   normalize_fn=normalize_fn, print_freq=print_freq)
        last_acc1, _, _ = evaluate(eval_step, state, eval_loader_fn(), epoch,
                                   normalize_fn=normalize_fn,
                                   expected_samples=expected_eval_samples)
        if eval_step_ema is not None and state.ema_params is not None:
            evaluate(eval_step_ema, state, eval_loader_fn(), epoch,
                     normalize_fn=normalize_fn, log_suffix="EMA")
    print(f"Training time {time.time() - t_start:.0f}s")
    return state, last_acc1


def reset_for_round(state: TrainState) -> TrainState:
    """A new pruning round restarts the step count, the LR schedule and the
    optimizer's state (momentum, moments)."""
    state.step = 0
    state.opt.reset()
    return state


def prune_and_bake(state: TrainState, pruning_rate: float) -> float:
    """One global magnitude round over the still-unpruned weights (ranked in
    the flax layout and path order, as in the JAX package), the new masks
    baked into the weights; returns the new global sparsity in %."""
    tree = flax_tree_from_vit_state_dict(state.model.named_parameters())
    masks = magnitude_prune(tree, vit_masks_from_state_dict(state.masks), pruning_rate)
    state.masks = vit_masks_to_state_dict(masks)
    params = state.params
    with torch.no_grad():
        for k, m in state.masks.items():
            params[k].copy_(torch.where(m, params[k], params[k].new_zeros(())))
    return compute_sparsity_global(flax_tree_from_vit_state_dict(state.params), masks)


def magnitude_pruning_round(train_step, eval_step, state: TrainState,
                            make_train_loader: Callable[[int], Iterable],
                            eval_loader_fn: Callable[[], Iterable], epochs: int,
                            pruning_rate: float, normalize_fn=None,
                            print_freq: int = 100, eval_step_ema=None):
    """One LRR iteration of the JAX driver's magnitude path: reset the step
    count and optimizer state, train to completion, prune ``pruning_rate``
    of the remaining weights by global magnitude, bake the masks. Returns
    (state, acc1 before pruning, sparsity after)."""
    reset_for_round(state)
    state, acc1 = train_model_to_completion(
        train_step, eval_step, state, make_train_loader, eval_loader_fn, epochs,
        normalize_fn=normalize_fn, print_freq=print_freq, eval_step_ema=eval_step_ema)
    return state, acc1, prune_and_bake(state, pruning_rate)
