"""Preprocessing constants, shape rules and the device-side normalize (port
of the parts of ``vipers/data/preprocess.py`` the LOST pipeline and the
train step use)."""

from __future__ import annotations

import numpy as np
import torch

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


def make_device_normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.float32,
                          random_erase_prob: float = 0.0):
    """uint8 (N, H, W, C) -> normalized (N, H, W, C) in ``dtype`` on the
    batch's device, in torch's op order (x/255, then (x - mean)/std in f32).
    RandomErasing is not ported yet: ``random_erase_prob`` > 0 raises."""
    if random_erase_prob > 0.0:
        raise NotImplementedError("RandomErasing is not ported to vipers_torch yet")
    mean32 = torch.tensor(mean, dtype=torch.float32)
    std32 = torch.tensor(std, dtype=torch.float32)

    def fn(batch_u8):
        dev = batch_u8.device
        x = (batch_u8.to(torch.float32) / 255.0 - mean32.to(dev)) / std32.to(dev)
        return x.to(dtype)

    return fn
