"""SNIP single-shot pruning (port of ``vipers/pruning/snip.py``).

One forward and backward over one batch gives every prunable weight a
saliency |w| * |dL/dw|; the global threshold is the k-th smallest of all
saliencies, ``k = int(n * target_sparsity)`` (``k <= 0`` keeps every
weight, ``k >= n`` prunes every one), and the mask keeps ``saliency >
threshold``: strict, so ties at the threshold are pruned. Saliencies are
taken in at least f32. Paths and layouts are the JAX package's (flax
keys, dense kernels (in, out)), so the masks pass between the two
packages unchanged.

The gradient is ``torch.autograd.grad`` of ``loss_fn(params, batch)``
with respect to the prunable leaves of ``params`` (a flax-layout tree of
tensors), on the device the params and batch lie on: no hooks and no
module state. ``snip_loss`` builds the loss a spec trains with, for every
family: the model in train mode at the params' dtype through the train
step's forward.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from vipers_torch.core.checkpoint import as_tensor, family
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.pruning import masks as M


def snip_saliency(loss_fn: Callable, params, batch, masks=None) -> dict:
    """{path: |w| * |g|} for every prunable kernel (the keys of ``masks``
    when given). ``loss_fn(params, batch) -> scalar`` runs the model in
    train mode, with the masks applied inside if the caller wants them, so
    gradients flow to the raw params."""
    keys = list(masks) if masks else M.prunable_paths(params)
    flat = {p: as_tensor(w).detach() for p, w in flatten_dict(params).items()}
    leaves = {p: flat[p].requires_grad_(True) for p in keys}
    loss = loss_fn(unflatten_dict({**flat, **leaves}), batch)
    grads = torch.autograd.grad(loss, [leaves[p] for p in keys])
    out = {}
    for p, g in zip(keys, grads):
        # at least f32: f64 params keep their precision
        acc = torch.promote_types(flat[p].dtype, torch.float32)
        out[p] = flat[p].detach().to(acc).abs() * g.to(acc).abs()
    return out


def snip_threshold(saliencies: dict, target_sparsity: float) -> torch.Tensor:
    """The k-th smallest saliency, ``k = int(n * target_sparsity)``; inf
    (prune all) at ``k >= n``, -1 (keep all) at ``k <= 0``."""
    vec, _ = M.concat_masked_scores(saliencies)
    n = vec.numel()
    k = int(n * float(target_sparsity))
    if k >= n:
        return torch.tensor(float("inf"), dtype=vec.dtype, device=vec.device)
    if k <= 0:
        return torch.tensor(-1.0, dtype=vec.dtype, device=vec.device)
    return M.kth_smallest(vec, k)


def snip_prune(loss_fn: Callable, params, batch, target_sparsity: float,
               exclude: Sequence[str] = ()) -> dict:
    """One-shot SNIP: boolean masks {path: saliency > threshold} for every
    prunable kernel."""
    base = M.init_masks(params, exclude)
    sal = snip_saliency(loss_fn, params, batch, masks=base)
    thr = snip_threshold(sal, target_sparsity)
    return {p: s > thr for p, s in sal.items()}


def snip_loss(spec, num_classes: int, label_smoothing: float = 0.0,
              batch_stats=None, seed: int = 0) -> Callable:
    """``loss_fn(params, (images, labels))`` of ``spec``, any family: the
    train step's forward and loss (``train.steps.train_loss``) on the flax
    tree's tensors (no masks: SNIP ranks the dense model) at their dtype,
    as the JAX driver's SNIP loss. A BatchNorm model normalizes with the
    batch's statistics (train mode) and the updated running statistics are
    dropped; ``batch_stats`` ({state-dict key: tensor}, default the
    initial mean 0 and var 1) only feeds that discarded update. On a ViT
    at T >= ``flash_min_t()`` every block runs the flash kernels forward
    and backward; the JAX driver's SNIP loss also asks for the last block's
    attention probabilities, which routes that block through the einsum:
    the same function, another kernel. A model with a random layer at
    a rate above 0 (a Swin's stochastic depth, VGG's and the ViT's dropout) draws from a
    generator seeded from ``seed`` at each call, as the JAX driver's SNIP loss uses ``PRNGKey(cfg.seed)``."""
    from vipers_torch.models.stochastic import dropout_generator, has_random_layers
    from vipers_torch.train.steps import train_loss

    with torch.device("meta"):  # its tensors come from params at each call
        model = spec.module()
    fam = family(spec)
    if batch_stats is None:
        batch_stats = {k: (torch.ones(b.shape) if k.endswith("running_var")
                           else torch.zeros(b.shape)) for k, b in model.named_buffers()}

    random = has_random_layers(model)

    def loss_fn(params, batch):
        sd = fam.state_dict(params)
        w = next(iter(sd.values()))
        sd.update({k: v.to(w.device) for k, v in batch_stats.items()})
        gen = dropout_generator(seed, None, w.device) if random else None
        return train_loss(model, sd, batch, num_classes, label_smoothing, w.dtype, gen)[0]

    return loss_fn
