"""Box IoU (port of ``bbox_iou`` in ``vipers/data/boxes.py``, the plain
IoU form CorLoc uses).

box1 is (4,) xyxy, box2 is (n, 4); the +eps terms sit on the heights and
the union exactly where the reference's vendored yolov5 function puts them,
so CorLoc hits match to float rounding.
"""

from __future__ import annotations

import numpy as np


def bbox_iou(box1, box2, eps: float = 1e-7):
    box1 = np.asarray(box1, dtype=np.float64)
    box2 = np.asarray(box2, dtype=np.float64).T  # (4, n)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1[0], box1[1], box1[2], box1[3]
    b2_x1, b2_y1, b2_x2, b2_y2 = box2[0], box2[1], box2[2], box2[3]
    inter = np.clip(np.minimum(b1_x2, b2_x2) - np.maximum(b1_x1, b2_x1), 0, None) * \
        np.clip(np.minimum(b1_y2, b2_y2) - np.maximum(b1_y1, b2_y1), 0, None)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    return inter / union
