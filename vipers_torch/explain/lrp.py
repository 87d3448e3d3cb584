"""Layer-wise Relevance Propagation, epsilon rule (port of
``vipers/explain/lrp.py``).

Epsilon-LRP as modified backprop: inside ``epsilon_rule(model)`` every
layer that was a flax ``nn.Dense`` or ``nn.Conv`` in the JAX model has its
backward replaced (``_EpsilonRule``, a ``torch.autograd.Function`` around
the layer's forward) by

    s   = R_out / (y + eps * sign(y))
    R_x = x * vjp_layer(s)

and ReLUs pass relevance through unchanged. The input's attribution is the
"gradient" of the target logit under this backward.

Which layers: the JAX interceptor wraps ``nn.Dense`` and ``nn.Conv`` calls
only, so the skips are per family (``_not_dense``), never one suffix rule
for all:
  * ViT: the patch embedding (``conv_proj``, here the ``patch_embed``
    product), ``mlp.fc1``, ``mlp.fc2``, ``pre_logits`` and ``head``; not
    ``attention.qkv`` and ``attention.out``, which the JAX model applies by
    einsum from parameter containers;
  * Swin: every linear layer and the patch convolution except
    ``attn.qkv`` (a custom module in the JAX model): ``proj``, ``fc1``,
    ``fc2``, ``reduction``, ``cpb_fc1``, ``cpb_fc2``, ``head``;
  * DINO ViT: every layer, ``attn.qkv`` and ``attn.proj`` included (the JAX
    ``DinoAttention`` computes both with ``nn.Dense``): the patch
    convolution, qkv, proj, fc1, fc2 and, with ``num_classes``, the head;
  * ResNet, VGG and MobileNetV2: every convolution (MobileNetV2's stem,
    expand, depthwise, project and head convolutions) and linear layer;
    BatchNorm is no site.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

LRP_EPS = 1e-6


def _not_dense(model: nn.Module):
    """Suffixes of ``model``'s module names whose JAX counterpart is not an
    ``nn.Dense`` / ``nn.Conv`` call."""
    from vipers_torch.models.swin import SwinTransformerV2
    from vipers_torch.models.vit import VisionTransformer

    if isinstance(model, VisionTransformer):
        return ("attention.qkv", "attention.out")
    if isinstance(model, SwinTransformerV2):
        return ("attn.qkv",)
    return ()


class _EpsilonRule(torch.autograd.Function):
    """y = fn(x) with the epsilon rule as its backward (x only)."""

    @staticmethod
    def forward(ctx, x, fn, eps):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            y = fn(xr)
        ctx.graph = (xr, y)
        ctx.eps = eps
        return y.detach()

    @staticmethod
    def backward(ctx, g):
        xr, y = ctx.graph
        yd = y.detach()
        stab = yd + ctx.eps * torch.where(yd >= 0, 1.0, -1.0)
        (r,) = torch.autograd.grad(y, xr, g / stab)
        return xr.detach() * r, None, None


def _wrap(fn: Callable, eps: float):
    def layer(x, *args, **kwargs):
        return _EpsilonRule.apply(x, lambda xx: fn(xx, *args, **kwargs), eps)

    return layer


def lrp_sites(model: nn.Module):
    """(owner, attribute) of every call the epsilon rule replaces."""
    from vipers_torch.models.vit import VisionTransformer

    sites = []
    skip = set()
    not_dense = _not_dense(model)
    if isinstance(model, VisionTransformer):
        sites.append((model, "patch_embed"))
        skip.add(id(model.conv_proj))  # read by patch_embed, never called
    for name, m in model.named_modules():
        if (isinstance(m, (nn.Linear, nn.Conv2d)) and id(m) not in skip
                and not name.endswith(not_dense)):
            sites.append((m, "forward"))
    return sites


@contextlib.contextmanager
def epsilon_rule(model: nn.Module, eps: float = LRP_EPS):
    """Forwards run inside this context apply the epsilon rule's backward
    at every ``lrp_sites`` layer of ``model``."""
    sites = lrp_sites(model)
    for owner, attr in sites:
        setattr(owner, attr, _wrap(getattr(owner, attr), eps))
    try:
        yield
    finally:
        for owner, attr in sites:
            delattr(owner, attr)  # the class's method again


def lrp_attribution(model_apply, model: nn.Module, x, target=None, eps: float = LRP_EPS):
    """Input relevance map for the (argmax or given) target class.

    ``model_apply(x) -> (logits, aux)`` runs ``model``. Returns (relevance
    (H, W, C) numpy for batch item 0, target).
    """
    xr = x.detach().requires_grad_(True)
    with epsilon_rule(model, eps), torch.enable_grad():
        logits, _aux = model_apply(xr)
        t = torch.argmax(logits[0]) if target is None else target
        (rel,) = torch.autograd.grad(logits[0, t], xr)
    return rel[0].cpu().numpy(), int(t)
