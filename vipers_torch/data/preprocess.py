"""Preprocessing (port of ``vipers/data/preprocess.py``): the host decode
of the train and eval presets, the LOST pad and bucket rules, and the
device-side normalize with RandomErasing.

Host side (PIL and numpy, in the decode threads), bit-equal to the JAX
package for the same numpy generator: eval is decode -> shorter side
resized (the long side truncated) -> center crop; train is
RandomResizedCrop -> horizontal flip -> the optional auto-augment policy.
Device side: uint8 (N, H, W, C) -> (x/255 - mean)/std in f32, then, in
training, RandomErasing drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vipers_torch.parallel import mesh as parallel

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# the --interpolation choices, as PIL resample names
INTERPOLATIONS = ("nearest", "bilinear", "bicubic", "lanczos", "hamming", "box")


# ----------------------------- host side ---------------------------------

def _pil_interp(name: str):
    from PIL import Image

    return {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS,
            "hamming": Image.HAMMING, "box": Image.BOX}[name]


def load_image_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def resize_shorter(img, size: int, interpolation: str = "bilinear"):
    """The shorter side to ``size``, the long side TRUNCATED to
    ``int(size * long / short)`` (torchvision's rule)."""
    w, h = img.size
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    return img.resize((nw, nh), _pil_interp(interpolation))


def center_crop(arr: np.ndarray, crop: int) -> np.ndarray:
    """torchvision's center crop: origin ``int(round((h - crop) / 2.0))``
    (Python's round half to even)."""
    h, w = arr.shape[:2]
    top = int(round((h - crop) / 2.0))
    left = int(round((w - crop) / 2.0))
    return arr[top: top + crop, left: left + crop]


def eval_decode(path: str, resize_size: int = 256, crop_size: int = 224,
                interpolation: str = "bilinear") -> np.ndarray:
    """The eval preset's host part: decode -> resize -> center crop, uint8
    HWC."""
    img = resize_shorter(load_image_rgb(path), resize_size, interpolation)
    return center_crop(np.asarray(img, dtype=np.uint8), crop_size)


def rrc_box(w: int, h: int, rng: np.random.Generator, scale=(0.08, 1.0),
            ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop's box (left, top, width, height) on a w x h image:
    10 tries at a random area and log-uniform aspect, then a center crop at
    the clamped aspect."""
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return left, top, cw, ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def random_resized_crop(img, crop_size: int, rng: np.random.Generator, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3), interpolation: str = "bilinear") -> np.ndarray:
    """torchvision's RandomResizedCrop on a PIL image: the box of
    ``rrc_box``, resized to crop_size x crop_size by PIL."""
    left, top, cw, ch = rrc_box(img.size[0], img.size[1], rng, scale, ratio)
    out = img.resize((crop_size, crop_size), _pil_interp(interpolation),
                     box=(left, top, left + cw, top + ch))
    return np.asarray(out, dtype=np.uint8)


def train_decode(path: str, rng: np.random.Generator, crop_size: int = 224,
                 hflip_prob: float = 0.5, auto_augment: str = "", ra_magnitude: int = 9,
                 augmix_severity: int = 3, interpolation: str = "bilinear") -> np.ndarray:
    """The train preset's host part: RandomResizedCrop, a horizontal flip
    with ``hflip_prob``, then the ``auto_augment`` policy; uint8 HWC."""
    arr = random_resized_crop(load_image_rgb(path), crop_size, rng,
                              interpolation=interpolation)
    if hflip_prob > 0 and rng.random() < hflip_prob:
        arr = arr[:, ::-1]
    if auto_augment:
        from vipers_torch.data.autoaugment import apply_policy

        arr = apply_policy(auto_augment, np.ascontiguousarray(arr), rng,
                           ra_magnitude=ra_magnitude, augmix_severity=augmix_severity)
    return np.ascontiguousarray(arr)


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


# ---------------------------- device side --------------------------------

def draw_random_erase(gen: torch.Generator, n: int, h: int, w: int, prob: float,
                      scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    """RandomErasing's draws for n images, from ``gen`` (a CPU generator):
    (apply (n,) bool, top, left, height, width (n,) int64), in the JAX
    package's arithmetic: area uniform in ``scale`` of h*w, log-uniform
    aspect, each side truncated and clipped to [1, side], the origin uniform
    over the positions that fit."""
    apply = torch.rand(n, generator=gen) < prob
    area = (torch.rand(n, generator=gen) * (scale[1] - scale[0]) + scale[0]) * (h * w)
    lo, hi = float(np.log(ratio[0])), float(np.log(ratio[1]))
    ar = torch.exp(torch.rand(n, generator=gen) * (hi - lo) + lo)
    eh = torch.sqrt(area / ar).to(torch.int64).clamp(1, h)
    ew = torch.sqrt(area * ar).to(torch.int64).clamp(1, w)
    top = (torch.rand(n, generator=gen) * (h - eh + 1)).to(torch.int64)
    left = (torch.rand(n, generator=gen) * (w - ew + 1)).to(torch.int64)
    return apply, top, left, eh, ew


def apply_random_erase(x, apply, top, left, eh, ew):
    """Zero, in each image whose ``apply`` is set, the rectangle rows [top,
    top + eh) x columns [left, left + ew) of (N, H, W, C) ``x``."""
    n, h, w, _ = x.shape
    dev = x.device
    top, left, eh, ew, apply = (t.to(dev) for t in (top, left, eh, ew, apply))
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    inside = ((rows >= top[:, None, None]) & (rows < (top + eh)[:, None, None])
              & (cols >= left[:, None, None]) & (cols < (left + ew)[:, None, None]))
    mask = inside & apply[:, None, None]
    return torch.where(mask[..., None], x.new_zeros(()), x)


def make_device_normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD, dtype=torch.float32,
                          random_erase_prob: float = 0.0):
    """``fn(batch_u8, generator=None)``: uint8 (N, H, W, C) -> normalized
    (N, H, W, C) in ``dtype`` on the batch's device, in torch's op order
    (x/255, then (x - mean)/std in f32). With ``random_erase_prob`` > 0 and
    a ``generator`` (the train loop passes one; evaluation does not), each
    image loses a random rectangle with that probability; in a
    data-parallel run the draws are the global batch's, this rank's rows
    kept."""
    mean32 = torch.tensor(mean, dtype=torch.float32)
    std32 = torch.tensor(std, dtype=torch.float32)

    def fn(batch_u8, generator: Optional[torch.Generator] = None):
        dev = batch_u8.device
        x = (batch_u8.to(torch.float32) / 255.0 - mean32.to(dev)) / std32.to(dev)
        if random_erase_prob > 0.0 and generator is not None:
            n, h, w, _ = x.shape
            # drawn for the global batch of a data-parallel run, this rank's rows kept
            rows = parallel.global_rows(n)
            draws = draw_random_erase(generator, n * parallel.data_world(), h, w, random_erase_prob)
            x = apply_random_erase(x, *(d[rows] for d in draws))
        return x.to(dtype)

    return fn
