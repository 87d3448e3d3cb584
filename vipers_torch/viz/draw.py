"""LOST visualizations: box overlays, degree and seed-affinity maps, seed
expansion (port of ``vipers/viz/draw.py``), on PIL.

``save_lost_visualization`` is what ``lost --visualize fms|seed_expansion|
pred`` calls for each image of the per-image path. ``pred`` and
``seed_expansion`` need PIL only; ``fms`` colours its maps with
matplotlib's jet, imported when a map is drawn (``_colormap``), and exits
naming matplotlib where it is absent. The torchvision-utils tail
(``draw_segmentation_masks``, ``draw_keypoints``, ``flow_to_image``) is
the JAX module's, HWC numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw


def draw_boxes(
    image: np.ndarray,  # uint8 (H, W, 3)
    boxes: Sequence,  # iterable of xyxy
    colors: Optional[Sequence] = None,
    width: int = 3,
) -> np.ndarray:
    img = Image.fromarray(image.astype(np.uint8))
    d = ImageDraw.Draw(img)
    for i, box in enumerate(boxes):
        color = (colors[i] if colors else (255, 0, 0))
        d.rectangle([float(box[0]), float(box[1]), float(box[2]), float(box[3])],
                    outline=tuple(color), width=width)
    return np.asarray(img)


def visualize_predictions(image, pred, gt_boxes=None, seed_box=None, out_path=None):
    """Pred box (red) + optional GT (green) + seed patch (blue)
    (`visualizations.py:24-60`)."""
    boxes = [pred]
    colors = [(255, 0, 0)]
    if gt_boxes is not None:
        for g in np.asarray(gt_boxes).reshape(-1, 4):
            boxes.append(g)
            colors.append((0, 255, 0))
    if seed_box is not None:
        boxes.append(seed_box)
        colors.append((0, 0, 255))
    out = draw_boxes(image, boxes, colors)
    if out_path:
        Image.fromarray(out).save(out_path)
    return out


def _colormap(gray: np.ndarray) -> np.ndarray:
    """Normalize to [0,1] and apply a jet-like map, uint8 (H, W, 3)."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit("lost --visualize fms colours its maps with matplotlib, "
                         "which this host does not have") from None

    matplotlib.use("Agg")
    import matplotlib.cm as cm

    g = gray.astype(np.float64)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return (cm.jet(g)[..., :3] * 255).astype(np.uint8)


def visualize_fms(A: np.ndarray, seed: int, scores: np.ndarray, dims, scales,
                  out_dir: str, im_name: str):
    """Degree map + seed-affinity map images (`visualizations.py:62-107`)."""
    os.makedirs(out_dir, exist_ok=True)
    gh, gw = dims
    deg = (-scores).reshape(gh, gw)
    Image.fromarray(_colormap(deg)).resize(
        (gw * int(scales[1]), gh * int(scales[0])), Image.NEAREST
    ).save(os.path.join(out_dir, f"{im_name}_degree.png"))
    aff = A[seed].reshape(gh, gw)
    Image.fromarray(_colormap(aff)).resize(
        (gw * int(scales[1]), gh * int(scales[0])), Image.NEAREST
    ).save(os.path.join(out_dir, f"{im_name}_seed_affinity.png"))


def visualize_seed_expansion(image, pred, seed: int, dims, scales, out_dir, im_name):
    """Seed patch box + final box (`visualizations.py:109-145`)."""
    os.makedirs(out_dir, exist_ok=True)
    gh, gw = dims
    r, c = seed // gw, seed % gw
    seed_box = [c * scales[1], r * scales[0], (c + 1) * scales[1], (r + 1) * scales[0]]
    out = visualize_predictions(image, pred, seed_box=seed_box)
    Image.fromarray(out).save(os.path.join(out_dir, f"{im_name}_seed_expansion.png"))


def save_lost_visualization(kind, image_path, pred, gt, A, scores, seed,
                            dims, scales, out_dir, im_name):
    """Dispatch used by the LOST driver (`main_lost.py:614-665`)."""
    image = np.asarray(Image.open(image_path).convert("RGB"))
    os.makedirs(out_dir, exist_ok=True)
    if kind == "pred":
        out = visualize_predictions(image, pred, gt_boxes=gt)
        Image.fromarray(out).save(os.path.join(out_dir, f"{im_name}_pred.png"))
    elif kind == "fms" and A is not None:
        visualize_fms(np.asarray(A), int(seed), np.asarray(scores), dims, scales,
                      out_dir, im_name)
    elif kind == "seed_expansion" and seed is not None:
        visualize_seed_expansion(image, pred, int(seed), dims, scales, out_dir, im_name)


# --- torchvision-utils parity tail (`torchvision_utils.py:257-611`) -------
# HWC numpy convention (the rest of this module), not torch's CHW.

def draw_segmentation_masks(image: np.ndarray, masks: np.ndarray,
                            alpha: float = 0.8, colors=None) -> np.ndarray:
    """Alpha-blend boolean masks onto a uint8 (H, W, 3) image
    (`torchvision_utils.py:257-324`): one color per mask, overlapping
    pixels drawn black, out = image*(1-alpha) + painted*alpha."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError("image must be (H, W, 3)")
    masks = np.asarray(masks, bool)
    if masks.ndim == 2:
        masks = masks[None]
    if masks.shape[-2:] != image.shape[:2]:
        raise ValueError("image and masks must share height/width")
    n = masks.shape[0]
    if n == 0:
        return image.copy()
    if colors is None:
        g = np.random.default_rng(0)
        colors = [tuple(int(c) for c in g.integers(0, 256, 3)) for _ in range(n)]
    elif isinstance(colors[0], (int, float)):
        colors = [tuple(colors)] * n
    painted = image.astype(np.float32).copy()
    for m, c in zip(masks, colors):
        painted[m] = np.asarray(c, np.float32)
    painted[masks.sum(0) > 1] = 0.0
    out = image.astype(np.float32) * (1 - alpha) + painted * alpha
    return out.astype(image.dtype)


def draw_keypoints(image: np.ndarray, keypoints: np.ndarray,
                   connectivity=None, colors=(255, 0, 0),
                   radius: int = 2, width: int = 3) -> np.ndarray:
    """Draw (num_instances, K, 2) keypoints (+ optional skeleton edges)
    on a uint8 (H, W, 3) image (`torchvision_utils.py:327-442`)."""
    img = Image.fromarray(np.asarray(image, np.uint8))
    d = ImageDraw.Draw(img)
    kpts = np.asarray(keypoints, np.float64)
    if kpts.ndim == 2:
        kpts = kpts[None]
    for inst in kpts:
        for x, y in inst:
            d.ellipse([x - radius, y - radius, x + radius, y + radius],
                      fill=tuple(colors), outline=None)
        if connectivity:
            for a, b in connectivity:
                d.line([tuple(inst[a]), tuple(inst[b])],
                       fill=tuple(colors), width=width)
    return np.asarray(img)


def _flow_colorwheel() -> np.ndarray:
    """Baker et al. optical-flow color wheel, 55 colors
    (`torchvision_utils.py:510-556`)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3), np.float32)
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255.0 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255.0 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255.0 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255.0 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255.0 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255.0 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(2, H, W) or (N, 2, H, W) float flow -> uint8 RGB
    (`torchvision_utils.py:445-508`): global max-norm normalization then
    color-wheel encoding of direction/magnitude."""
    flow = np.asarray(flow, np.float32)
    squeeze = flow.ndim == 3
    if squeeze:
        flow = flow[None]
    if flow.ndim != 4 or flow.shape[1] != 2:
        raise ValueError("flow must be (2, H, W) or (N, 2, H, W)")
    max_norm = np.sqrt((flow ** 2).sum(1)).max()
    nf = flow / (max_norm + np.finfo(np.float32).eps)

    wheel = _flow_colorwheel()
    ncols = wheel.shape[0]
    u, v = nf[:, 0], nf[:, 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col0 = wheel[k0] / 255.0
    col1 = wheel[k1] / 255.0
    col = (1 - f) * col0 + f * col1
    col = 1 - rad[..., None] * (1 - col)
    img = np.floor(255.0 * col).astype(np.uint8)  # (N, H, W, 3)
    img = np.transpose(img, (0, 3, 1, 2))
    return img[0] if squeeze else img
