"""Integrated Gradients + SmoothGrad noise tunnel (port of
``vipers/explain/attribution.py``).

Captum's defaults, as the JAX package reproduces them:
  * baseline = zeros, n_steps = 50, method = "gausslegendre"
    (Gauss-Legendre nodes rescaled from [-1, 1] to [0, 1]),
  * attribution = (x - baseline) * sum_i w_i * grad(f_target)(baseline +
    a_i * (x - baseline)),
  * SmoothGrad: the mean of the attributions of x + N(0, stdev^2) noise,
    stdev = nt_stdev * (max(x) - min(x)).

The steps run one gradient each, in the nodes' order, as the JAX
``lax.scan`` does. SmoothGrad is a deterministic body
(``smoothgrad_from_noise``: the mean over the given noise tensors of the
attribution of x + noise) and a draw (``draw_smoothgrad_noise``). The draw
comes from a ``torch.Generator`` on the CPU, moved to x's device, so that
the card and the CPU see the same noise; the JAX package draws it with
``jax.random.normal``, whose bits the port cannot reproduce. So ``ig`` maps
differ from the JAX package's by the noise draw alone.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def _gauss_legendre_01(n_steps: int):
    xs, ws = np.polynomial.legendre.leggauss(n_steps)
    # rescale from [-1, 1] to [0, 1]
    return (0.5 * (xs + 1)).astype(np.float32), (0.5 * ws).astype(np.float32)


def _riemann_trapezoid_01(n_steps: int):
    xs = np.linspace(0.0, 1.0, n_steps, dtype=np.float32)
    ws = np.full((n_steps,), 1.0 / (n_steps - 1), dtype=np.float32)
    ws[0] *= 0.5
    ws[-1] *= 0.5
    return xs, ws


def make_integrated_gradients(
    score_fn: Callable,
    n_steps: int = 50,
    method: str = "gausslegendre",
):
    """score_fn(x, target) -> per-example score (e.g. the target's logit).
    Returns ig(x, target, baseline=None) -> attribution with x's shape."""
    if method == "gausslegendre":
        alphas, weights = _gauss_legendre_01(n_steps)
    elif method == "riemann_trapezoid":
        alphas, weights = _riemann_trapezoid_01(n_steps)
    else:
        raise ValueError(f"unknown IG method {method!r}")
    # python floats holding the f32 values exactly
    nodes = [(float(a), float(w)) for a, w in zip(alphas, weights)]

    def grad_fn(x, target):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(torch.sum(score_fn(xr, target)), xr)
        return g

    def ig(x, target, baseline=None):
        if baseline is None:
            baseline = torch.zeros_like(x)
        delta = x - baseline
        total = torch.zeros_like(x)
        for a, w in nodes:
            total = total + w * grad_fn(baseline + a * delta, target)
        return delta * total

    return ig


def draw_smoothgrad_noise(x, nt_samples: int = 2, nt_stdev: float = 1.0,
                          generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    """``nt_samples`` noise tensors N(0, 1) * spread with x's shape on x's
    device, spread = (max(x) - min(x)) * nt_stdev; drawn from ``generator``
    (a CPU generator; None = seed 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    spread = (torch.max(x) - torch.min(x)) * nt_stdev
    z = torch.randn((nt_samples, *x.shape), generator=generator, dtype=torch.float32)
    z = z.to(device=x.device, dtype=x.dtype)
    return [z[i] * spread for i in range(nt_samples)]


def smoothgrad_from_noise(attr_fn: Callable, x, target, noises) -> torch.Tensor:
    """The mean over ``noises`` of ``attr_fn(x + noise, target)``."""
    total = torch.zeros_like(x)
    for noise in noises:
        total = total + attr_fn(x + noise, target)
    return total / len(noises)


def make_smoothgrad(
    attr_fn: Callable,
    nt_samples: int = 2,
    nt_stdev: float = 1.0,
):
    """Captum NoiseTunnel(smoothgrad): sg(generator, x, target), the mean of
    ``attr_fn`` over noisy inputs."""

    def sg(generator, x, target):
        noises = draw_smoothgrad_noise(x, nt_samples, nt_stdev, generator)
        return smoothgrad_from_noise(attr_fn, x, target, noises)

    return sg

