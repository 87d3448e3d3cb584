"""CorLoc accounting and the standalone re-scoring (port of
``vipers/discovery/corloc.py``): a hit when IoU with any ground-truth box is
at least 0.5; ``CorLocAccumulator.save`` writes ``preds.pkl`` and
``results_iteration_NN.txt``, and ``evaluate_predictions`` re-scores a
``preds.pkl`` or a detectron json against a dataset's ground truth with the
reference evaluator's counting (``vipers_torch corloc``)."""

from __future__ import annotations

import json
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

    def save(self, output_dir: str, iteration: int, save_preds: bool = True,
             save_results: bool = True):
        """Write preds.pkl (``save_preds``) and results_iteration_NN.txt
        (``save_results``), each on its own switch like the reference's
        --save-predictions and --no-evaluation; returns the txt's path or
        None."""
        os.makedirs(output_dir, exist_ok=True)
        if save_preds:
            with open(os.path.join(output_dir, "preds.pkl"), "wb") as f:
                pickle.dump(self.preds, f)
        txt = None
        if save_results:
            txt = os.path.join(output_dir, f"results_iteration_{iteration:02d}.txt")
            with open(txt, "w") as f:
                f.write(f"corloc,{self.corloc:.1f},,\n")
            print(f"corloc: {self.corloc:.2f} ({self.hits}/{self.count})")
        return txt


def _canonical_image_key(key) -> str:
    """Detectron ``image_id``s are ints where VOC names are zero-padded
    strings, and the reference matches them numerically: digit-like keys go
    through int, so ``image_id: 5`` finds ``000005.jpg``."""
    s = str(key)
    return str(int(s)) if s.lstrip("-").isdigit() else s


def evaluate_predictions(preds_path: str, dataset, detectron_format: bool = False) -> float:
    """Re-score saved predictions against ``dataset``'s ground truth (a
    ``DiscoveryDataset``) with the reference evaluator's counting:

    * zero-GT images are skipped only under ``no_hard``; without it they
      count, and miss;
    * a detectron json (``.json`` or ``detectron_format``) scores each
      image's most confident box; an image with no box counts as a miss;
    * an image missing from a preds.pkl is skipped with a warning, as the
      LOST driver skips its seed-in-background failures.
    Prints and returns the CorLoc in percent."""
    detectron = detectron_format or preds_path.endswith(".json")
    if detectron:
        with open(preds_path) as f:
            dets = json.load(f)
        by_img: Dict[str, list] = {}
        for d in dets:
            by_img.setdefault(_canonical_image_key(d["image_id"]), []).append(d)
    else:
        with open(preds_path, "rb") as f:
            preds = pickle.load(f)

    hits = cnt = missing = 0
    for _path, im_name in dataset:
        gt, _cls = dataset.extract_gt(im_name)
        if gt is not None and len(gt) == 0 and dataset.no_hard:
            continue
        if detectron:
            # VOC keys drop the extension
            name_ind = (os.path.splitext(im_name)[0]
                        if dataset.name.startswith("VOC") else im_name)
            cand = by_img.get(_canonical_image_key(name_ind), [])
            if not cand:
                cnt += 1
                continue
            best = max(cand, key=lambda d: d.get("score", 0.0))
            x, y, w, h = best["bbox"]
            pred = [x, y, x + w, y + h]
        else:
            key = im_name if im_name in preds else os.path.splitext(im_name)[0]
            if key not in preds:
                missing += 1
                continue
            pred = preds[key]
        cnt += 1
        if corloc_hit(pred, gt):
            hits += 1
    corloc = 100.0 * hits / max(cnt, 1)
    if missing:
        print(f"warning: {missing} image(s) had no prediction in the "
              "pickle (seed-in-background failures?) — skipped, matching "
              "the lost driver's own CorLoc counting")
    print(f"corloc: {corloc:.2f} ({hits}/{cnt})")
    return corloc


def run_corloc_cli(args) -> int:
    """``corloc`` subcommand: re-score ``args.preds`` on the dataset."""
    from vipers_torch.data.detection import DiscoveryDataset

    ds = DiscoveryDataset(args.dataset, args.set, args.data_path, no_hard=args.no_hard,
                          coco_annotations=getattr(args, "coco_annotations", None),
                          coco20k_list=getattr(args, "coco20k_list", None))
    evaluate_predictions(args.preds, ds)
    return 0
