"""Auto-augmentation policies (the port's own copy of
``vipers/data/autoaugment.py``): RandAugment, TrivialAugmentWide, AugMix
and the AutoAugment ImageNet policy, selected by ``--auto-augment ra |
ta_wide | augmix | imagenet``.

PIL operations on uint8 arrays, run in the decode threads; every random
choice comes from the sample's numpy generator, so for the same generator
the output equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

# ------------------------------ single ops ---------------------------------


def _affine(img, matrix):
    return img.transform(img.size, Image.AFFINE, matrix, resample=Image.BILINEAR)


def shear_x(img, mag):
    return _affine(img, (1, mag, 0, 0, 1, 0))


def shear_y(img, mag):
    return _affine(img, (1, 0, 0, mag, 1, 0))


def translate_x(img, mag):
    return _affine(img, (1, 0, mag * img.size[0], 0, 1, 0))


def translate_y(img, mag):
    return _affine(img, (1, 0, 0, 0, 1, mag * img.size[1]))


def rotate(img, mag):
    return img.rotate(mag, resample=Image.BILINEAR)


def auto_contrast(img, _mag):
    return ImageOps.autocontrast(img)


def invert(img, _mag):
    return ImageOps.invert(img)


def equalize(img, _mag):
    return ImageOps.equalize(img)


def solarize(img, mag):
    return ImageOps.solarize(img, int(mag))


def posterize(img, mag):
    return ImageOps.posterize(img, max(int(mag), 1))


def contrast(img, mag):
    return ImageEnhance.Contrast(img).enhance(1.0 + mag)


def color(img, mag):
    return ImageEnhance.Color(img).enhance(1.0 + mag)


def brightness(img, mag):
    return ImageEnhance.Brightness(img).enhance(1.0 + mag)


def sharpness(img, mag):
    return ImageEnhance.Sharpness(img).enhance(1.0 + mag)


def identity(img, _mag):
    return img


# (name, signed?, magnitude range at level 1.0) — torchvision RandAugment space
_RA_SPACE: List[Tuple[str, Callable, bool, Tuple[float, float]]] = [
    ("Identity", identity, False, (0.0, 0.0)),
    ("ShearX", shear_x, True, (0.0, 0.3)),
    ("ShearY", shear_y, True, (0.0, 0.3)),
    ("TranslateX", translate_x, True, (0.0, 150.0 / 331.0)),
    ("TranslateY", translate_y, True, (0.0, 150.0 / 331.0)),
    ("Rotate", rotate, True, (0.0, 30.0)),
    ("Brightness", brightness, True, (0.0, 0.9)),
    ("Color", color, True, (0.0, 0.9)),
    ("Contrast", contrast, True, (0.0, 0.9)),
    ("Sharpness", sharpness, True, (0.0, 0.9)),
    ("Posterize", posterize, False, (8.0, 4.0)),
    ("Solarize", solarize, False, (255.0, 0.0)),
    ("AutoContrast", auto_contrast, False, (0.0, 0.0)),
    ("Equalize", equalize, False, (0.0, 0.0)),
]


def _apply_op(img: Image.Image, name_fn_signed_range, level: float,
              rng: np.random.Generator) -> Image.Image:
    _name, fn, signed, (lo, hi) = name_fn_signed_range
    mag = lo + (hi - lo) * level
    if signed and rng.random() < 0.5:
        mag = -mag
    return fn(img, mag)


def rand_augment(img: Image.Image, rng: np.random.Generator,
                 num_ops: int = 2, magnitude: int = 9, num_bins: int = 31):
    """torchvision RandAugment: num_ops random ops at a fixed magnitude."""
    level = magnitude / (num_bins - 1)
    for _ in range(num_ops):
        op = _RA_SPACE[rng.integers(len(_RA_SPACE))]
        img = _apply_op(img, op, level, rng)
    return img


def trivial_augment_wide(img: Image.Image, rng: np.random.Generator,
                         num_bins: int = 31):
    """TrivialAugmentWide: one random op at a random magnitude (wide range)."""
    op = _RA_SPACE[rng.integers(len(_RA_SPACE))]
    level = float(rng.integers(num_bins)) / (num_bins - 1)
    # wide: double the geometric/enhance ranges like torchvision TA-Wide
    name, fn, signed, (lo, hi) = op
    wide = (name, fn, signed, (lo, hi * 2 if name not in
                               ("Posterize", "Solarize") else hi))
    return _apply_op(img, wide, level, rng)


def augmix(img: Image.Image, rng: np.random.Generator, severity: int = 3,
           width: int = 3, depth: int = -1, alpha: float = 1.0):
    """AugMix: mixture of augmentation chains blended with the original."""
    ws = rng.dirichlet([alpha] * width).astype(np.float32)
    m = float(rng.beta(alpha, alpha))
    base = np.asarray(img, np.float32)
    mix = np.zeros_like(base)
    level = severity / 30.0
    for i in range(width):
        aug = img
        d = depth if depth > 0 else int(rng.integers(1, 4))
        for _ in range(d):
            op = _RA_SPACE[rng.integers(len(_RA_SPACE))]
            aug = _apply_op(aug, op, level, rng)
        mix += ws[i] * np.asarray(aug, np.float32)
    out = (1 - m) * base + m * mix
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


# AutoAugment ImageNet policy (pairs of (op, prob, magnitude_bin/31))
_IMAGENET_POLICY = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
]

_BY_NAME: Dict[str, tuple] = {name: (name, fn, signed, rng_)
                              for name, fn, signed, rng_ in _RA_SPACE}
_BY_NAME["Invert"] = ("Invert", invert, False, (0.0, 0.0))


def auto_augment_imagenet(img: Image.Image, rng: np.random.Generator):
    pair = _IMAGENET_POLICY[rng.integers(len(_IMAGENET_POLICY))]
    for name, prob, mag_bin in pair:
        if rng.random() <= prob:
            # policy magnitudes are 10-bin indices (0..9)
            img = _apply_op(img, _BY_NAME[name], mag_bin / 9.0, rng)
    return img


POLICIES: Dict[str, Callable] = {
    "ra": rand_augment,
    "ta_wide": trivial_augment_wide,
    "augmix": augmix,
    "imagenet": auto_augment_imagenet,
}


def apply_policy(name: str, arr: np.ndarray, rng: np.random.Generator,
                 ra_magnitude: int = 9,
                 augmix_severity: int = 3) -> np.ndarray:
    """uint8 (H, W, 3) -> augmented uint8, by policy name.
    ``ra_magnitude``/``augmix_severity`` are the --ra-magnitude and
    --augmix-severity flags."""
    if name not in POLICIES:
        raise ValueError(f"unknown auto-augment policy {name!r}; "
                         f"choose from {sorted(POLICIES)}")
    img = Image.fromarray(arr)
    if name == "ra":
        out = rand_augment(img, rng, magnitude=ra_magnitude)
    elif name == "augmix":
        out = augmix(img, rng, severity=augmix_severity)
    else:
        out = POLICIES[name](img, rng)
    return np.asarray(out, dtype=np.uint8)
