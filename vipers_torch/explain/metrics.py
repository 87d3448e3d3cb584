"""Explanation-quality metrics: channel pooling + RMA / RRA (a numpy copy
of ``vipers/explain/metrics.py``, the reference's
``explainations_evaluation_metrics.py:185-304``):
  * six channel poolings (sum,abs / sum,pos / max-norm / l1-norm / l2-norm /
    l2-norm,sq),
  * RMA (relevance mass accuracy) = relevance inside the GT mask / total,
  * RRA (relevance rank accuracy) = |top-N pixels ∩ GT| / N with N = |GT|,
  * the reference's GT handling: crop heatmap to GT size (3D) or zero-pad GT
    to heatmap size (2D), min-max-normalize GT then binarize at 0.5.
All float64 on the host, like the reference.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

import numpy as np


def pool_heatmap(heatmap: np.ndarray, pooling_type: str) -> np.ndarray:
    """(C, H, W) -> (H, W) non-negative pooled relevance
    (`explainations_evaluation_metrics.py:185-210`)."""
    C, H, W = heatmap.shape
    if pooling_type == "sum,abs":
        pooled = np.abs(np.sum(heatmap, axis=0))
    elif pooling_type == "sum,pos":
        pooled = np.sum(heatmap, axis=0)
        pooled = np.where(pooled > 0.0, pooled, 0.0)
    elif pooling_type == "max-norm":
        pooled = np.amax(np.abs(heatmap), axis=0)
    elif pooling_type == "l1-norm":
        pooled = np.linalg.norm(heatmap, ord=1, axis=0)
    elif pooling_type == "l2-norm":
        pooled = np.linalg.norm(heatmap, ord=2, axis=0)
    elif pooling_type == "l2-norm,sq":
        pooled = np.linalg.norm(heatmap, ord=2, axis=0) ** 2
    else:
        raise ValueError(f"unknown pooling_type {pooling_type!r}")
    assert pooled.shape == (H, W) and np.all(pooled >= 0.0)
    return pooled


def evaluate_single(
    heatmap: np.ndarray,
    ground_truth: np.ndarray,
    pooling_type: Optional[str],
) -> Dict[str, np.float64]:
    """RMA + RRA for one heatmap/GT pair
    (`explainations_evaluation_metrics.py:213-304`). Returns
    ({"mass": RMA, "rank": RRA}, binarized_gt)."""
    heatmap = np.asarray(heatmap)
    ground_truth = np.asarray(ground_truth)

    if heatmap.ndim > 2:
        # crop heatmap to GT spatial size (`:236-238`)
        heatmap = heatmap[:, : ground_truth.shape[0], : ground_truth.shape[1]]
        _, H, W = heatmap.shape
    else:
        # zero-pad GT to heatmap size (`:240-255`)
        padded = np.zeros(heatmap.shape[:2], dtype=np.float64)
        padded[: ground_truth.shape[0], : ground_truth.shape[1]] = ground_truth
        ground_truth = padded
        H, W = heatmap.shape
    assert ground_truth.shape == (H, W)

    heatmap = heatmap.astype(np.float64)

    if pooling_type is not None:
        pooled = pool_heatmap(heatmap, pooling_type)
    else:
        pooled = (heatmap - np.min(heatmap)) / (
            (np.max(heatmap) - np.min(heatmap)) + sys.float_info.epsilon
        )

    # GT: min-max normalize then binarize at 0.5 (`:278-281`)
    gmin, gmax = np.min(ground_truth), np.max(ground_truth)
    gt = (ground_truth - gmin) / max(gmax - gmin, sys.float_info.epsilon)
    gt = np.where(gt >= 0.5, 1.0, 0.0)

    # RMA (`:284-291`)
    inside = np.sum(pooled * gt)
    total = np.sum(pooled) + sys.float_info.epsilon
    rma = inside / total

    # RRA (`:295-302`)
    order = np.argsort(np.ravel(pooled))[::-1]
    gt_flat = np.ravel(gt)
    N = np.sum(gt_flat) + sys.float_info.epsilon
    n_gt = np.sum(gt_flat[order[: int(N)]])
    rra = n_gt / N
    return {"mass": np.float64(rma), "rank": np.float64(rra)}, gt


ALL_POOLINGS = ("sum,abs", "sum,pos", "max-norm", "l1-norm", "l2-norm", "l2-norm,sq")


def evaluate_heatmap_all_poolings(heatmap, ground_truth):
    """Per-pooling {pooling: {mass, rank}} summary — the batch ``evaluate``
    flow (`explainations_evaluation_metrics.py:307-373`) reduced to one
    call site; its summary statistics live in the explain driver."""
    out = {}
    for p in ALL_POOLINGS:
        scores, _ = evaluate_single(heatmap, ground_truth, p)
        out[p] = scores
    return out
