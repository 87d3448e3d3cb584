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
module state. ``vit_snip_loss`` builds the loss a ViT spec trains with:
the model in train mode at the params' dtype through the train step's
forward, so at T >= ``flash_min_t()`` every block's attention runs the
flash kernels forward and backward.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from vipers_torch.core.checkpoint import as_tensor, vit_state_dict_from_flax
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
    return torch.kthvalue(vec, k).values


def snip_prune(loss_fn: Callable, params, batch, target_sparsity: float,
               exclude: Sequence[str] = ()) -> dict:
    """One-shot SNIP: boolean masks {path: saliency > threshold} for every
    prunable kernel."""
    base = M.init_masks(params, exclude)
    sal = snip_saliency(loss_fn, params, batch, masks=base)
    thr = snip_threshold(sal, target_sparsity)
    return {p: s > thr for p, s in sal.items()}


def vit_snip_loss(spec, num_classes: int, label_smoothing: float = 0.0) -> Callable:
    """``loss_fn(params, (images, labels))`` of a ViT ``spec``: the train
    step's forward and loss (``train.steps.train_loss``) on the flax tree's
    tensors (no masks: SNIP ranks the dense model) at their dtype. The JAX
    driver's SNIP loss also asks for the last block's attention
    probabilities, which routes that block through the einsum: the same
    function, another kernel."""
    from vipers_torch.train.steps import train_loss

    with torch.device("meta"):  # its tensors come from params at each call
        model = spec.module()

    def loss_fn(params, batch):
        sd = vit_state_dict_from_flax(params)
        dtype = next(iter(sd.values())).dtype
        return train_loss(model, sd, batch, num_classes, label_smoothing, dtype)[0]

    return loss_fn
