"""LOST preprocessing constants and shape rules (port of the parts of
``vipers/data/preprocess.py`` the LOST pipeline uses)."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def lost_pad_to_patch_multiple(img_hwc: np.ndarray, patch_size: int):
    """Zero-pad H and W up to the next patch multiple (the reference's
    tier-1 padding; pad pixels participate downstream)."""
    h, w = img_hwc.shape[:2]
    ph = int(np.ceil(h / patch_size) * patch_size)
    pw = int(np.ceil(w / patch_size) * patch_size)
    out = np.zeros((ph, pw) + img_hwc.shape[2:], dtype=img_hwc.dtype)
    out[:h, :w] = img_hwc
    return out


def bucket_hw(h: int, w: int, patch_size: int, bucket: int = 4):
    """Round padded sizes up to ``bucket`` patches so LOST batches share a
    small set of shapes."""
    gh = -(-h // patch_size)
    gw = -(-w // patch_size)
    gh = -(-gh // bucket) * bucket
    gw = -(-gw // bucket) * bucket
    return gh * patch_size, gw * patch_size
