"""ReLU indirection for guided backprop (port of
``vipers/models/activations.py``).

Captum's GuidedGradCam rewrites every ReLU's backward to pass only
positive gradients at positive inputs. Here that is ``guided_relu``, a
``torch.autograd.Function``; the ResNet and VGG call sites use this
module's ``relu`` (or ``ReLU``), which becomes ``guided_relu`` inside a
``guided_backprop()`` context.

In eager PyTorch the flag is read when the forward runs, so a forward run
inside the context records guided ReLUs and its backward is guided, one run
outside is not. The JAX package's caveat (a function jitted before the
context keeps its un-guided trace) does not carry over.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn

_GUIDED = False


class _GuidedReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, min=0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # pass the gradient only where the input was positive AND the
        # gradient is positive
        return torch.where((x > 0) & (g > 0), g, torch.zeros_like(g))


def guided_relu(x):
    return _GuidedReLU.apply(x)


def relu(x):
    """ReLU that becomes ``guided_relu`` inside a ``guided_backprop()``
    context."""
    if _GUIDED:
        return guided_relu(x)
    return torch.relu(x)


class ReLU(nn.Module):
    """``nn.ReLU`` through this module's ``relu``."""

    def forward(self, x):
        return relu(x)


def is_guided() -> bool:
    return _GUIDED


@contextmanager
def guided_backprop():
    """Forwards run inside this context record guided ReLUs."""
    global _GUIDED
    prev = _GUIDED
    _GUIDED = True
    try:
        yield
    finally:
        _GUIDED = prev
