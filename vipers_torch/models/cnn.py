"""Layers the CNN families share, with the JAX package's (flax's) semantics.

- ``Conv2d`` and ``Linear`` promote their input and weights to a common
  dtype, as flax's ``nn.Conv`` and ``nn.Dense`` do. A bf16 step casts every
  parameter to bf16, but a ResNet's BatchNorm outputs f32, so every
  convolution after the stem (and the classifier) runs in f32 on
  bf16-rounded weights: 1 of resnet18's 20 convolutions runs in bf16 in
  the JAX package's bf16 step, and here too.
- ``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=float32)``: the output in f32 whatever the input dtype (at least
  f32: an f64 reference run, which the JAX package never makes, stays
  f64); in train
  mode the batch mean and the BIASED variance over N, H, W, and running
  statistics ``0.9 * running + 0.1 * batch`` (torch's ``BatchNorm2d``
  would update the variance with the unbiased one). In a data-parallel run
  (``parallel.mesh``) the batch statistics are the global batch's, as under
  the JAX package's mesh. A train forward does
  not write its statistics back: it returns them (``new_stats``) and the
  caller decides. ``promote_output`` is flax's ``nn.BatchNorm`` with no
  ``dtype`` (MobileNetV2's): the same f32 arithmetic, the output cast to
  the promoted dtype of the input and the scale.
- ``exact_f32_convs``: cuDNN convolutions without TF32 inside the scope
  when the compute dtype is f32 (cuDNN allows TF32 by default), around a
  forward and its backward; a bf16 run keeps cuDNN's default for the
  convolutions that the JAX package runs in f32. ``deterministic_convs``:
  cuDNN's deterministic algorithms (SNIP's one pass, so that its masks
  repeat bit for bit).

Tensors are NCHW (channels-last in memory when the input came NHWC).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.parallel import mesh as parallel


def conv_extent(n: int, kernel: int, stride: int, padding: int, dilation: int = 1) -> int:
    """Output cells along one axis of a convolution or pooling window."""
    return (n + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's dtype rule: input, weight and bias cast to
    their common dtype."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` with flax's dtype rule."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """flax BatchNorm over the channels of an NCHW tensor (see the module
    docstring). ``state_name`` is the layer's state-dict prefix, set by the
    model that owns it; a train forward given a ``new_stats`` dict stores
    the updated running statistics there under the state-dict keys."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 promote_output: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.promote_output = promote_output
        self.state_name = ""
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, new_stats: Optional[dict] = None):
        out_dt = (torch.promote_types(x.dtype, self.weight.dtype) if self.promote_output
                  else None)
        y = self._normalize(x, new_stats)
        return y if out_dt is None else y.to(out_dt)

    def _normalize(self, x, new_stats):
        dt = torch.promote_types(x.dtype, torch.float32)
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, w, b, False, 0.0,
                                self.eps)
        # flax's statistics: mean and E[x^2] - mean^2 clamped at 0, in f32
        if parallel.data_world() > 1:
            mean, ex2 = _global_moments(x)
        else:
            mean, ex2 = x.mean(dim=(0, 2, 3)), (x * x).mean(dim=(0, 2, 3))
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        if new_stats is not None:
            m = self.momentum
            new_stats[f"{self.state_name}.running_mean"] = \
                m * self.running_mean + (1 - m) * mean.detach()
            new_stats[f"{self.state_name}.running_var"] = \
                m * self.running_var + (1 - m) * var.detach()
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * w
        return (x - mean.reshape(shape)) * mul.reshape(shape) + b.reshape(shape)


def _global_moments(x):
    """(mean, E[x^2]) per channel over the global batch of a data-parallel
    run: one differentiable all-reduce of [sum, sum of squares, count]
    (``parallel.mesh.all_reduce_sum``), as the JAX mesh reduces a batch's
    statistics over every device."""
    c = x.shape[1]
    count = x.new_full((1,), float(x.numel() // c))
    packed = parallel.all_reduce_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                                (x * x).sum(dim=(0, 2, 3)), count]))
    n = packed[-1]
    return packed[:c] / n, packed[c:2 * c] / n


def name_batch_norms(model: nn.Module):
    """Give every ``BatchNorm`` of ``model`` its state-dict prefix."""
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.state_name = name


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms inside the scope (its default
    backward-weight algorithms may accumulate with atomics, so two runs of
    one pass can differ in the last bit)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def exact_f32_convs(dtype=torch.float32):
    """cuDNN convolutions in exact f32 (no TF32) inside the scope when
    ``dtype`` is f32; otherwise nothing changes."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
