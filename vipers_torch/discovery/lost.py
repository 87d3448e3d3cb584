"""LOST unsupervised object discovery and the DINO attention
segmentation baseline (port of ``patch_scoring``, ``lost_core``,
``box_feat_to_image``, ``lost``, ``detect_box``, ``dino_seg`` and
``_mass_threshold`` in ``vipers/discovery/lost.py``).

Everything from the affinity to the seed's connected component and its box
runs on the device for all B images at once; only the 4-int boxes, seeds
and background flags need to reach the host. Bucket-pad patches (outside
each image's valid (gh, gw) grid) are masked out everywhere, so results
equal per-image exact shapes. ``lost`` and ``detect_box`` keep the
reference's per-image signatures on top (``lost_core`` at B = 1), for the
per-image paths (``--arch swin``, ``--exact-shapes``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vipers_torch.discovery.components import (component_bbox, flood_fill_from_seed,
                                               label_components, largest_component_mask)


def patch_scoring(A, valid):
    """Inverse-degree patch scores on (B, T, T) affinities: score =
    -|{j : A[i,j] > 0}| with the diagonal zeroed and negatives
    clamped. The sort is descending and stable (ties -> lower index first);
    invalid patches score -inf and sort last. Returns (order, scores)."""
    t = A.shape[-1]
    ac = A * (1.0 - torch.eye(t, dtype=A.dtype, device=A.device))
    ac = torch.clamp(ac, min=0.0)
    over = (ac > 0.0) & valid[:, None, :]
    cent = -over.sum(dim=-1).to(torch.float32)
    cent = torch.where(valid, cent, torch.full((), float("-inf"), device=A.device))
    order = torch.argsort(-cent, dim=-1, stable=True)
    return order, cent


def lost_core(feats, valid_hw, grid_hw: Tuple[int, int], k_patches: int = 100,
              lean: bool = False):
    """LOST on (B, T, D) patch features laid out row-major over the (GH, GW)
    bucket grid; ``valid_hw`` (B, 2) is each image's participating (gh, gw)
    grid. Returns a dict of ``box_feat`` (B, 4) (ymin, ymax, xmin, xmax
    exclusive), ``seed`` (B,), ``seed_in_background`` (B,) and, unless
    ``lean``, ``scores``, ``mass`` and ``affinity``. The affinity is f32."""
    b, t, _ = feats.shape
    gh_, gw_ = grid_hw
    if t != gh_ * gw_:
        raise ValueError(f"T={t} != bucket grid {gh_}x{gw_}")
    dev = feats.device
    feats = feats.float()
    A = torch.matmul(feats, feats.transpose(1, 2))

    vhw = valid_hw.to(dev)
    ar = torch.arange(t, device=dev)
    valid = ((ar // gw_)[None, :] < vhw[:, 0:1]) & ((ar % gw_)[None, :] < vhw[:, 1:2])

    order, scores = patch_scoring(A, valid)
    seed = order[:, 0]

    # Seed expansion on the RAW A: potentials = top-k by score; similars =
    # those with positive affinity to the seed.
    bi = torch.arange(b, device=dev)[:, None]
    pot = order[:, :k_patches]
    pot_valid = valid.gather(1, pot) & (A[bi, seed[:, None], pot] > 0.0)
    mass = torch.where(pot_valid[:, :, None], A[bi, pot],
                       torch.zeros((), device=dev)).sum(dim=1)
    mass = torch.where(valid, mass, torch.zeros((), device=dev))

    fg = ((mass > 0.0) & valid).reshape(b, gh_, gw_)
    seed_rc = torch.stack([seed // gw_, seed % gw_], dim=1)
    comp = flood_fill_from_seed(fg, seed_rc)
    out = {
        "box_feat": component_bbox(comp),
        "seed": seed,
        "seed_in_background": ~fg[bi[:, 0], seed_rc[:, 0], seed_rc[:, 1]],
    }
    if not lean:
        out.update({"scores": scores, "mass": mass, "affinity": A})
    return out


def box_feat_to_image(box_feat, scales, init_image_size):
    """Feature-grid box (ymin, ymax, xmin, xmax) -> image-coords xyxy with
    the reference's scale + clip."""
    ymin, ymax, xmin, xmax = (float(v) for v in np.asarray(box_feat))
    pred = [scales[1] * xmin, scales[0] * ymin, scales[1] * xmax, scales[0] * ymax]
    if init_image_size is not None:
        pred[2] = min(pred[2], init_image_size[2] if len(init_image_size) == 3 else init_image_size[1])
        pred[3] = min(pred[3], init_image_size[1] if len(init_image_size) == 3 else init_image_size[0])
    return np.asarray(pred)


def lost(feats, dims: Tuple[int, int], scales, init_image_size, k_patches: int = 100,
         valid_dims: Tuple[int, int] = None):
    """The reference's per-image ``lost``: ``feats`` (1, T, D) or (T, D)
    on the grid ``dims`` = (w_featmap, h_featmap) (rows index the image's
    height), of which ``valid_dims`` (default ``dims``) take part;
    ``init_image_size`` = (C, H, W) of the unpadded image clips the box.
    Returns (pred box xyxy ndarray, affinity (T, T), scores (T,), seed);
    raises ValueError when the seed lies in the background component."""
    w_featmap, h_featmap = dims
    valid_dims = dims if valid_dims is None else valid_dims
    feats = torch.as_tensor(np.asarray(feats) if not isinstance(feats, torch.Tensor) else feats)
    if feats.dim() == 3:
        feats = feats[0]
    if feats.shape[0] != w_featmap * h_featmap:
        raise ValueError(f"feats T={feats.shape[0]} != grid {w_featmap}x{h_featmap}")
    valid = torch.tensor([[valid_dims[0], valid_dims[1]]], dtype=torch.int32)
    out = lost_core(feats[None], valid, (int(w_featmap), int(h_featmap)), k_patches=k_patches)
    if bool(out["seed_in_background"][0]):
        raise ValueError("The seed is in the background component.")
    pred = box_feat_to_image(out["box_feat"][0].cpu(), scales, init_image_size)
    return (pred, out["affinity"][0].cpu().numpy(), out["scores"][0].cpu().numpy(),
            int(out["seed"][0]))


def detect_box(M, seed, dims, initial_im_size=None, scales=None):
    """The reference's standalone box extraction: the seed's 4-connected
    component of ``M > 0`` on the (w_featmap, h_featmap) grid, scaled
    (and clipped to ``initial_im_size`` (H, W)). Returns (pred xyxy,
    [ymin, xmin, ymax, xmax] on the grid); raises ValueError when the seed
    is background."""
    w_featmap, h_featmap = dims
    fg = torch.as_tensor(np.asarray(M)).reshape(1, w_featmap, h_featmap) > 0.0
    seed = int(seed)
    r, c = seed // h_featmap, seed % h_featmap
    if not bool(fg[0, r, c]):
        raise ValueError("The seed is in the background component.")
    comp = flood_fill_from_seed(fg, torch.tensor([[r, c]]))
    ymin, ymax, xmin, xmax = (int(v) for v in component_bbox(comp)[0])
    pred = [scales[1] * xmin, scales[0] * ymin, scales[1] * xmax, scales[0] * ymax]
    if initial_im_size:
        pred[2] = min(pred[2], initial_im_size[1])
        pred[3] = min(pred[3], initial_im_size[0])
    return pred, [ymin, xmin, ymax, xmax]


def _mass_threshold(attentions, keep: float):
    """Per head (row of ``attentions``, (nh, T)): 1.0 on the entries whose
    ascending cumulative share of the row's mass exceeds ``1 - keep`` (the
    top ``keep`` of the mass), else 0.0; the sort is stable and the sums
    run in the attentions' dtype, as in the JAX package."""
    val, idx = torch.sort(attentions, dim=1, stable=True)
    val = val / torch.sum(val, dim=1, keepdim=True)
    th = torch.cumsum(val, dim=1) > (1 - keep)
    return torch.gather(th, 1, torch.argsort(idx, dim=1)).to(torch.float32)


def dino_seg(attn, dims, patch_size: int, head: int = 0, reference_bugs: bool = False):
    """The DINO attention-segmentation baseline: keep 60% of each head's
    CLS-attention mass (``attn`` (1, nh, T, T)), take the largest
    4-connected component of head ``head``'s map on the ``dims`` =
    (rows, cols) grid, and return its box ``[xmin, ymin, xmax, ymax]`` in
    pixels (not clipped to the image).

    ``reference_bugs`` reproduces the reference's component choice with its
    off-by-ones: ids renumbered in raster first-occurrence order (scipy's),
    the last id left out of the size scan, and a map of one component
    choosing id 0, the background."""
    w_featmap, h_featmap = dims
    attn = torch.as_tensor(attn)
    nh = attn.shape[1]
    grid = _mass_threshold(attn[0, :, 0, 1:].reshape(nh, -1), 0.6).reshape(
        nh, w_featmap, h_featmap)
    fg = grid[head][None] > 0.5
    if reference_bugs:
        labeled = label_components(fg)[0].cpu().numpy()
        flat = labeled.ravel()
        ids, first = np.unique(flat, return_index=True)
        is_fg = ids > 0
        order = np.argsort(first[is_fg])  # foreground ids by first raster occurrence
        remap = np.zeros(int(ids.max()) + 1, flat.dtype)
        remap[ids[is_fg][order]] = np.arange(1, is_fg.sum() + 1)
        labeled = remap[flat].reshape(labeled.shape)
        sizes = [int(np.sum(labeled == c)) for c in range(int(labeled.max()))]
        biggest = int(np.argmax(sizes[1:])) + 1 if len(sizes) > 1 else 0
        comp = torch.from_numpy(labeled == biggest)[None]
    else:
        comp = largest_component_mask(fg)
    ymin, ymax, xmin, xmax = (int(v) for v in component_bbox(comp)[0])
    return [xmin * patch_size, ymin * patch_size, xmax * patch_size, ymax * patch_size]
