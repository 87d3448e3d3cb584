"""CorLoc accounting (port of ``corloc_hit`` and ``CorLocAccumulator`` in
``vipers/discovery/corloc.py``): a hit when IoU with any ground-truth box is
at least 0.5; writes ``preds.pkl`` and ``results_iteration_NN.txt``."""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from vipers_torch.data.boxes import bbox_iou


def corloc_hit(pred_box, gt_boxes) -> bool:
    if gt_boxes is None or len(gt_boxes) == 0:
        return False
    ious = bbox_iou(np.asarray(pred_box, dtype=np.float64), np.asarray(gt_boxes))
    return bool(np.any(ious >= 0.5))


class CorLocAccumulator:
    def __init__(self):
        self.hits = 0
        self.count = 0
        self.preds: Dict[str, list] = {}

    def add(self, im_name: str, pred_box, gt_boxes):
        self.preds[im_name] = list(np.asarray(pred_box).tolist())
        self.count += 1
        if corloc_hit(pred_box, gt_boxes):
            self.hits += 1

    @property
    def corloc(self) -> float:
        return 100.0 * self.hits / max(self.count, 1)

    def save(self, output_dir: str, iteration: int):
        """Write preds.pkl and results_iteration_NN.txt; returns the
        latter's path."""
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "preds.pkl"), "wb") as f:
            pickle.dump(self.preds, f)
        txt = os.path.join(output_dir, f"results_iteration_{iteration:02d}.txt")
        with open(txt, "w") as f:
            f.write(f"corloc,{self.corloc:.1f},,\n")
        print(f"corloc: {self.corloc:.2f} ({self.hits}/{self.count})")
        return txt
