"""Epoch loops and one LRR pruning round (port of ``vipers/train/loop.py``
and of the magnitude-pruning iteration of ``vipers/train/driver.py``, whose
whole driver is ``train.driver``).

Host code here only moves batches and aggregates metrics. Steps enqueue
their work without waiting; their metric scalars stay on the device and
come back in one copy per print window (and once at the end), so the host
does not wait on the card every step.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from vipers_torch.core.metrics import MeterSet, MetricsWriter
from vipers_torch.parallel import mesh as parallel
from vipers_torch.pruning import compute_sparsity_global, magnitude_prune
from vipers_torch.train.steps import TrainState


def epoch_generator(seed, epoch: int) -> torch.Generator:
    """The CPU generator an epoch's RandomErasing and mixup/cutmix draw
    from, seeded from (``seed``, epoch); ``seed`` is an int or a tuple of
    ints (the LRR driver's (run seed, iteration)). A resumed run draws what
    the uninterrupted run drew."""
    entropy = list(seed) if isinstance(seed, tuple) else [seed]
    sub = int(np.random.SeedSequence([*entropy, epoch]).generate_state(1)[0])
    return torch.Generator().manual_seed(sub)


def train_one_epoch(train_step, state: TrainState, loader: Iterable, epoch: int,
                    normalize_fn=None, print_freq: int = 100, mixup_fn=None,
                    generator: Optional[torch.Generator] = None,
                    writer: Optional[MetricsWriter] = None):
    """One pass over ``loader``: normalize (with RandomErasing drawn from
    ``generator``), ``mixup_fn(generator, images, labels)``, step. Writes
    the epoch's mean loss and accuracies as a ``train`` record."""
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
            images = normalize_fn(images, generator=generator)
        if mixup_fn is not None:
            images, labels = mixup_fn(generator, images, labels)
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
    if writer:
        writer.write("train", step=epoch, acc1=meters.meters["acc1"].global_avg,
                     acc5=meters.meters["acc5"].global_avg,
                     loss=meters.meters["loss"].global_avg)
    return state, meters


def evaluate(eval_step, state: TrainState, loader: Iterable, epoch: Optional[int] = None,
             normalize_fn=None, log_suffix: str = "",
             expected_samples: Optional[int] = None, writer: Optional[MetricsWriter] = None):
    """Full-split eval; returns (acc1, acc5, loss) from exact sums (summed
    over the ranks of a data-parallel run, sentinel rows left out by the
    eval step) and writes them as a ``test`` (+ ``log_suffix``) record."""
    outs = []
    for images, labels in loader:
        if normalize_fn is not None:
            images = normalize_fn(images)
        out = eval_step(state, (images, labels))
        outs.append(torch.stack([out["loss_sum"].double(), out["top1"].double(),
                                 out["top5"].double(), out["n"].double()]))
    sums = torch.stack(outs).sum(dim=0) if outs else torch.zeros(4, dtype=torch.float64)
    # a data-parallel run's ranks evaluate disjoint shares: every rank prints the global sums
    loss_sum, top1, top5, n_seen = parallel.all_reduce_(sums, group=parallel.data_group()).cpu().tolist()
    if expected_samples is not None and int(n_seen) != expected_samples:
        print(f"Warning: dataset has {expected_samples} samples but {int(n_seen)} "
              "were used for validation — results may be biased.")
    n = max(int(n_seen), 1)
    acc1, acc5, loss = 100.0 * top1 / n, 100.0 * top5 / n, loss_sum / n
    print(f"Test:{log_suffix} Acc@1 {acc1:.3f} Acc@5 {acc5:.3f}")
    if writer:
        writer.write("test" + log_suffix, step=epoch, acc1=acc1, acc5=acc5, loss=loss)
    return acc1, acc5, loss


def train_model_to_completion(train_step, eval_step, state: TrainState,
                              make_train_loader: Callable[[int], Iterable],
                              eval_loader_fn: Callable[[], Iterable], epochs: int,
                              initial_epoch: int = 0, normalize_fn=None,
                              print_freq: int = 100, eval_step_ema=None,
                              expected_eval_samples: Optional[int] = None, mixup_fn=None,
                              seed=0, checkpoint_fn=None, sparsity: float = 0.0,
                              writer: Optional[MetricsWriter] = None):
    """Per epoch: train -> eval (-> EMA eval) -> ``checkpoint_fn(state,
    epoch, sparsity)`` every 10 epochs and at the last, then
    ``checkpoint_fn(..., latest=True)`` (the rolling latest). Each epoch's
    draws come from ``epoch_generator(seed, epoch)``. Returns (state, last
    acc1)."""
    t_start = time.time()
    last_acc1 = float("nan")
    for epoch in range(initial_epoch, epochs):
        state, _ = train_one_epoch(train_step, state, make_train_loader(epoch), epoch,
                                   normalize_fn=normalize_fn, print_freq=print_freq,
                                   mixup_fn=mixup_fn, generator=epoch_generator(seed, epoch),
                                   writer=writer)
        last_acc1, _, _ = evaluate(eval_step, state, eval_loader_fn(), epoch,
                                   normalize_fn=normalize_fn,
                                   expected_samples=expected_eval_samples, writer=writer)
        if eval_step_ema is not None and state.ema_params is not None:
            evaluate(eval_step_ema, state, eval_loader_fn(), epoch,
                     normalize_fn=normalize_fn, log_suffix="EMA", writer=writer)
        if checkpoint_fn is not None and (epoch % 10 == 0 or epoch == epochs - 1):
            checkpoint_fn(state, epoch, sparsity)
        if checkpoint_fn is not None:
            checkpoint_fn(state, epoch, sparsity, latest=True)
    print(f"Training time {time.time() - t_start:.0f}s")
    return state, last_acc1


def reset_for_round(state: TrainState) -> TrainState:
    """A new pruning round restarts the step count, the LR schedule and the
    optimizer's state (momentum, moments)."""
    state.step = 0
    state.opt.reset()
    return state


def prune_and_bake(state: TrainState, pruning_rate: float, layout=None) -> float:
    """One global magnitude round over the still-unpruned weights (ranked in
    the flax layout and path order, as in the JAX package), the new masks
    baked into the weights; returns the new global sparsity in %. Under a
    ``layout`` (``parallel.tp``, ``parallel.pp``) the whole model's weights
    and masks are gathered from the ranks' parts, so the threshold is the
    one process's, and each rank keeps its part of the new masks."""
    fam = state.family
    params = {k: v.detach() for k, v in state.params.items()}
    masks = state.masks
    if layout is not None:
        params, masks = layout.full(params), layout.full(masks)
    full = fam.trees(params)[0]
    new = magnitude_prune(full, fam.masks_from_state_dict(masks), pruning_rate)
    sd = fam.masks_to_state_dict(new)
    dev = next(iter(state.masks.values())).device
    state.masks = {k: m.to(dev) for k, m in (sd if layout is None else layout.part(sd)).items()}
    live = state.params
    with torch.no_grad():
        for k, m in state.masks.items():
            live[k].copy_(torch.where(m, live[k], live[k].new_zeros(())))
    return compute_sparsity_global(full, new)


def magnitude_pruning_round(train_step, eval_step, state: TrainState,
                            make_train_loader: Callable[[int], Iterable],
                            eval_loader_fn: Callable[[], Iterable], epochs: int,
                            pruning_rate: float, reset: bool = True, layout=None, **kw):
    """One LRR iteration of the JAX driver's magnitude path: reset the step
    count and optimizer state (unless ``reset`` is False: a resumed
    iteration), train to completion (``kw`` as ``train_model_to_completion``
    takes them), prune ``pruning_rate`` of the remaining weights by global
    magnitude (over the whole model under a ``layout``), bake the masks.
    Returns (state, acc1 before pruning, sparsity after)."""
    if reset:
        reset_for_round(state)
    state, acc1 = train_model_to_completion(
        train_step, eval_step, state, make_train_loader, eval_loader_fn, epochs, **kw)
    return state, acc1, prune_and_bake(state, pruning_rate, layout)
