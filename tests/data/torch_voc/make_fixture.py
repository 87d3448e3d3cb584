"""Draw the VOC07-layout JPEG fixture of the port's tests and chip_smoke.py.

Eight images at VOC's own sizes, from one seed: a flat, slightly noisy
ground with one or two textured objects (stripes or checks under noise),
saved as baseline JPEGs (quality 85) beside their VOC annotation XML (the
second object of 000007 is marked difficult, that of 000019 truncated) and
``ImageSets/Main/trainval.txt``. Run from the repository root to redraw:

    python tests/data/torch_voc/make_fixture.py
"""

import os

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.abspath(__file__))
# (name, width, height): VOC2007's common sizes, none of whose heights and
# few of whose widths are multiples of 16
SIZES = [("000005", 500, 375), ("000007", 500, 333), ("000009", 375, 500),
         ("000012", 500, 281), ("000016", 500, 375), ("000017", 353, 500),
         ("000019", 500, 366), ("000020", 375, 500)]
CLASSES = ("dog", "car", "bird", "chair", "cat", "person", "bottle", "horse")


def _object(rng, arr, x0, y0, x1, y1):
    """A textured box: stripes or checks in two random colours under noise."""
    h, w = y1 - y0, x1 - x0
    yy, xx = np.mgrid[0:h, 0:w]
    period = int(rng.integers(6, 14))
    if rng.random() < 0.5:
        pattern = ((xx + yy) // period) % 2
    else:
        pattern = (xx // period + yy // period) % 2
    c0, c1 = rng.integers(0, 256, (2, 3))
    tex = np.where(pattern[..., None] == 1, c1, c0).astype(np.float64)
    tex += rng.normal(0, 12, tex.shape)
    arr[y0:y1, x0:x1] = tex


def _xml(name, w, h, objects):
    objs = "".join(
        f"<object><name>{c}</name><pose>Unspecified</pose><truncated>{t}</truncated>"
        f"<difficult>{d}</difficult><bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin>"
        f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>\n"
        for c, x0, y0, x1, y1, t, d in objects)
    return (f"<annotation><folder>VOC2007</folder><filename>{name}.jpg</filename>\n"
            f"<size><width>{w}</width><height>{h}</height><depth>3</depth></size>\n"
            f"<segmented>0</segmented>\n{objs}</annotation>\n")


def main():
    rng = np.random.default_rng(2007)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(ROOT, sub), exist_ok=True)
    for i, (name, w, h) in enumerate(SIZES):
        ground = rng.integers(40, 216, 3).astype(np.float64)
        arr = np.broadcast_to(ground, (h, w, 3)) + rng.normal(0, 2, (h, w, 3))
        objects = []
        for k in range(2 if name in ("000007", "000019") else 1):
            bw = int(rng.integers(w // 5, w // 2))
            bh = int(rng.integers(h // 5, h // 2))
            x0 = int(rng.integers(0, w - bw))
            y0 = int(rng.integers(0, h - bh))
            _object(rng, arr, x0, y0, x0 + bw, y0 + bh)
            objects.append((CLASSES[(i + k) % len(CLASSES)], x0, y0, x0 + bw, y0 + bh,
                            int(name == "000019" and k == 1), int(name == "000007" and k == 1)))
        img = Image.fromarray(np.clip(np.rint(arr), 0, 255).astype(np.uint8))
        img.save(os.path.join(ROOT, "JPEGImages", f"{name}.jpg"), quality=85)
        with open(os.path.join(ROOT, "Annotations", f"{name}.xml"), "w") as f:
            f.write(_xml(name, w, h, objects))
    with open(os.path.join(ROOT, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name, _, _ in SIZES))


if __name__ == "__main__":
    main()
