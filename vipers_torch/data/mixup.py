"""MixUp / CutMix on a batch (port of ``vipers/data/mixup.py``).

Semantics of the JAX package: with both enabled, one of the two is chosen
50/50 per batch; the batch is paired with itself rolled by one; mixup
blends images and one-hot targets by lam ~ Beta(alpha, alpha); cutmix
pastes the rolled batch into a box of half-extent 0.5 * sqrt(1 - lam)
around a uniform centre, clipped to the image, and takes lam from the
clipped area.

The random draws (``draw_mixup_cutmix``, on a CPU ``torch.Generator``) are
apart from the transform (``apply_mixup_cutmix``, a function of the drawn
choice, lam and box on the batch's device), so a test can feed both
packages the same draws. In a data-parallel run every rank draws the same
choice, lam and box, and the roll is the global batch's
(``parallel.mesh.roll_batch``), as the JAX package mixes the global batch
after assembling it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vipers_torch.parallel import mesh as parallel


def _gamma(gen: torch.Generator, alpha: float) -> float:
    """A Gamma(alpha, 1) draw by Marsaglia and Tsang's method (alpha < 1
    through Gamma(alpha + 1) * U^(1/alpha))."""
    boost = 1.0
    if alpha < 1.0:
        boost = float(torch.rand((), generator=gen)) ** (1.0 / alpha)
        alpha += 1.0
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen))
        v = (1.0 + c * x) ** 3
        if v <= 0:
            continue
        u = float(torch.rand((), generator=gen))
        if math.log(max(u, 1e-300)) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


def _beta(gen: torch.Generator, alpha: float) -> float:
    a, b = _gamma(gen, alpha), _gamma(gen, alpha)
    return a / (a + b)


def draw_mixup_cutmix(gen: torch.Generator, h: int, w: int, mixup_alpha: float,
                      cutmix_alpha: float) -> Tuple[bool, float, Optional[tuple]]:
    """(use mixup, lam, cutmix box (x1, y1, x2, y2) or None) for one batch
    of h x w images: the choice (50/50 when both are on), lam ~ Beta(alpha,
    alpha) of the chosen one, and for cutmix a uniform integer centre and the
    box of half-extent int(0.5 * sqrt(1 - lam) * side), clipped."""
    use_mixup = mixup_alpha > 0
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_mixup = bool(torch.rand((), generator=gen) < 0.5)
    lam = _beta(gen, mixup_alpha if use_mixup else cutmix_alpha)
    if use_mixup:
        return True, lam, None
    r_x = int(torch.randint(0, w, (), generator=gen))
    r_y = int(torch.randint(0, h, (), generator=gen))
    r = 0.5 * math.sqrt(1.0 - lam)
    rw, rh = int(r * w), int(r * h)
    box = (min(max(r_x - rw, 0), w), min(max(r_y - rh, 0), h),
           min(max(r_x + rw, 0), w), min(max(r_y + rh, 0), h))
    return False, lam, box


def apply_mixup_cutmix(images, labels, num_classes: int, use_mixup: bool, lam: float,
                       box: Optional[tuple] = None):
    """The transform for drawn values: (N, H, W, C) ``images``, (N,) int or
    (N, K) soft ``labels`` -> (images, (N, K) soft targets in the images'
    dtype). Mixup blends with the batch rolled by one at ``lam``; cutmix
    pastes the rolled batch into ``box`` and weighs the targets by the
    box's area."""
    if labels.dim() == 1:
        labels = F.one_hot(labels.long(), num_classes).to(images.dtype)
    # the global batch's roll: a data-parallel rank's first row is the
    # previous rank's last (the draws come from the same generator on every rank)
    x_roll = parallel.roll_batch(images)
    y_roll = parallel.roll_batch(labels)
    lam_t = torch.tensor(lam, dtype=torch.float32)
    if use_mixup:
        one_minus = (1 - lam_t).to(images.dtype)
        lam_i = lam_t.to(images.dtype)
        return images * lam_i + x_roll * one_minus, labels * lam_i + y_roll * one_minus
    n, h, w, _ = images.shape
    x1, y1, x2, y2 = box
    mixed = images.clone()
    mixed[:, y1:y2, x1:x2] = x_roll[:, y1:y2, x1:x2]
    area = torch.tensor((x2 - x1) * (y2 - y1), dtype=images.dtype) / (w * h)
    lam_adj = (1.0 - area).to(images.device)
    return mixed, labels * lam_adj + y_roll * (1 - lam_adj)


def mixup_cutmix_batch(gen: torch.Generator, images, labels, num_classes: int,
                       mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0):
    """Draw from ``gen`` and apply: mixup or cutmix (50/50 when both are
    enabled); with neither, the images and one-hot targets as they are."""
    if mixup_alpha <= 0 and cutmix_alpha <= 0:
        if labels.dim() == 1:
            labels = F.one_hot(labels.long(), num_classes).to(images.dtype)
        return images, labels
    n, h, w, _ = images.shape
    use_mixup, lam, box = draw_mixup_cutmix(gen, h, w, mixup_alpha, cutmix_alpha)
    return apply_mixup_cutmix(images, labels, num_classes, use_mixup, lam, box)
