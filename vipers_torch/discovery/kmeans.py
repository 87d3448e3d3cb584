"""k-means (Lloyd) and whitening for box pseudo-labels (port of
``vipers/discovery/kmeans.py``): ``scipy.cluster.vq.whiten`` and
``kmeans2`` with ``minit='points'``.

A fixed number of iterations; squared distances by the |a|^2 - 2ab +
|b|^2 expansion (one matmul an iteration); an empty cluster keeps its
centroid; the labels returned are the last assignment, the one the final
centroids were computed from. The initial points are ``initial_points``'s
draw from a ``torch.Generator`` seeded by the caller: the one place the
port differs from the JAX package, whose draw is ``jax.random``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def whiten(x, eps: float = 1e-8):
    """Each feature (column) divided by its standard deviation (ddof 0),
    floored at ``eps``."""
    return x / torch.clamp(torch.std(x, dim=0, correction=0), min=eps)


def initial_points(n: int, k: int, seed: int) -> torch.Tensor:
    """``k`` distinct row indices of ``n``, drawn from ``seed``."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(int(seed)))[:k]


def kmeans2_init(x, cent, iters: int = 10):
    """``iters`` Lloyd rounds on x (N, D) from the initial centroids
    ``cent`` (k, D): (centroids, labels (N,) of the last assignment)."""
    if iters < 1:
        raise ValueError("iters must be >= 1 (scipy kmeans2 semantics)")
    k = cent.shape[0]
    x_sq = torch.sum(x * x, dim=1, keepdim=True)
    for _ in range(iters):
        d2 = x_sq - 2.0 * (x @ cent.T) + torch.sum(cent * cent, dim=1)[None, :]
        labels = torch.argmin(d2, dim=1)  # ties: the first centroid
        one_hot = F.one_hot(labels, k).to(x.dtype)
        counts = one_hot.sum(dim=0)[:, None]
        cent = torch.where(counts > 0, (one_hot.T @ x) / torch.clamp(counts, min=1.0), cent)
    return cent, labels


def kmeans2(x, k: int, iters: int = 10, seed: int = 0):
    """k-means of x (N, D) from ``k`` of its rows drawn from ``seed``:
    (centroids (k, D), labels (N,))."""
    idx = initial_points(x.shape[0], k, seed).to(x.device)
    return kmeans2_init(x, x[idx], iters=iters)
