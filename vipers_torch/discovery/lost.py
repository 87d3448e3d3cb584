"""LOST unsupervised object discovery on a batch of images (port of
``patch_scoring``, ``lost_core`` and ``box_feat_to_image`` in
``vipers/discovery/lost.py``).

Everything from the affinity to the seed's connected component and its box
runs on the device for all B images at once; only the 4-int boxes, seeds
and background flags need to reach the host. Bucket-pad patches (outside
each image's valid (gh, gw) grid) are masked out everywhere, so results
equal per-image exact shapes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vipers_torch.discovery.components import component_bbox, flood_fill_from_seed


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
