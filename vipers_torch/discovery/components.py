"""Connected components on a batch of grids (port of
``vipers/discovery/components.py``): the seed flood fill and component box
LOST reads, and the full labelling and largest component ``dino_seg``
reads.

4-connectivity, as ``scipy.ndimage.label``'s default structure. The fill is
a monotone dilation from the seed, the labelling a min-label propagation;
all B grids step together and convergence is checked only every
``CHECK_EVERY`` steps, so a batch costs one host sync per ``CHECK_EVERY``
steps instead of one per step (the fill's loop is a ``while_loop``, which
``torch.export`` keeps on the device). Extra steps past the fixed point
change nothing (both steps are idempotent there), so the results equal the
JAX ``while_loop``'s.
"""

from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop_op

CHECK_EVERY = 8


def _dilate4(x):
    """One 4-connected binary dilation of (B, H, W) bool grids."""
    out = x.clone()
    out[:, :-1, :] |= x[:, 1:, :]
    out[:, 1:, :] |= x[:, :-1, :]
    out[:, :, :-1] |= x[:, :, 1:]
    out[:, :, 1:] |= x[:, :, :-1]
    return out


def _changed(prev, cur, _mask):
    return (prev != cur).any()


def _dilate_steps(prev, cur, mask):
    for _ in range(CHECK_EVERY):
        prev, cur = cur, _dilate4(cur) & mask
    return prev, cur


def flood_fill_from_seed(mask, seed_rc):
    """Bool (B, H, W) component of each ``mask`` containing its seed
    ``seed_rc`` (B, 2) = (row, col); all-False where the seed itself is
    background.

    The loop is torch's ``while_loop`` higher-order op: the body takes
    ``CHECK_EVERY`` dilations and the condition is "the last one changed
    something". An eager run reads the condition once a body (one host
    sync per ``CHECK_EVERY`` steps); ``torch.export`` keeps the loop in
    the graph, so an exported LOST program fills with no host sync. The op
    is called directly, with ``mask`` as its additional input: the
    ``while_loop`` function would compile the loop with dynamo on every
    eager call."""
    b = mask.shape[0]
    cur = torch.zeros_like(mask)
    cur[torch.arange(b, device=mask.device), seed_rc[:, 0], seed_rc[:, 1]] = True
    cur = cur & mask
    # (~cur, cur) differ everywhere, so the first body always runs
    return while_loop_op(_changed, _dilate_steps, (~cur, cur), (mask,))[1]


def _min4(lbl, big: int):
    """One min-label step: each cell's label and its 4 neighbours' (outside
    the grid ``big``), on (B, H, W) int grids."""
    out = lbl.clone()
    out[:, :-1, :] = torch.minimum(out[:, :-1, :], lbl[:, 1:, :])
    out[:, 1:, :] = torch.minimum(out[:, 1:, :], lbl[:, :-1, :])
    out[:, :, :-1] = torch.minimum(out[:, :, :-1], lbl[:, :, 1:])
    out[:, :, 1:] = torch.minimum(out[:, :, 1:], lbl[:, :, :-1])
    return out


def label_components(mask):
    """4-connected labelling of (B, H, W) bool grids: int64, 0 on the
    background, each component its smallest flat index + 1 (the JAX
    package's ids, not scipy's 1..N numbering)."""
    _, h, w = mask.shape
    big = h * w + 2
    idx = torch.arange(1, h * w + 1, device=mask.device).reshape(1, h, w)
    bg = torch.full((), big, device=mask.device)
    cur = torch.where(mask, idx, bg)
    while True:
        for _ in range(CHECK_EVERY):
            prev, cur = cur, torch.where(mask, _min4(cur, big), bg)
        if torch.equal(cur, prev):
            return torch.where(mask, cur, torch.zeros((), dtype=cur.dtype, device=mask.device))


def largest_component_mask(mask):
    """Bool (B, H, W): each grid's largest 4-connected component, ties to
    the smallest id (the earliest flat index). An all-False grid has no
    component: then, as in the JAX package, id 0 wins and the whole grid
    comes back True."""
    b, h, w = mask.shape
    labels = label_components(mask).reshape(b, -1)
    counts = torch.zeros((b, h * w + 2), dtype=torch.int64, device=mask.device)
    counts.scatter_add_(1, labels, torch.ones_like(labels))
    counts[:, 0] = 0
    best = torch.argmax(counts, dim=1)  # the first maximum: the smallest id
    return (labels == best[:, None]).reshape(b, h, w)


def component_bbox(mask):
    """(B, 4) int64 (ymin, ymax_excl, xmin, xmax_excl) of the True cells of
    each (H, W) grid, the reference's min/max+1 convention; an all-False
    grid yields (0, 0, 0, 0)."""
    _, h, w = mask.shape
    rows = mask.any(dim=2)
    cols = mask.any(dim=1)
    ridx = torch.arange(h, device=mask.device)
    cidx = torch.arange(w, device=mask.device)
    big_h = torch.full_like(ridx, h)
    big_w = torch.full_like(cidx, w)
    neg = torch.full((), -1, device=mask.device)
    ymin = torch.where(rows, ridx, big_h).amin(dim=1)
    ymax = torch.where(rows, ridx, neg).amax(dim=1) + 1
    xmin = torch.where(cols, cidx, big_w).amin(dim=1)
    xmax = torch.where(cols, cidx, neg).amax(dim=1) + 1
    box = torch.stack([ymin, ymax, xmin, xmax], dim=1)
    return torch.where(rows.any(dim=1)[:, None], box, torch.zeros_like(box))
