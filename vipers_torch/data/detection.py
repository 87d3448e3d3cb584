"""Detection datasets for object discovery: VOC07/VOC12/COCO20k (port of
``vipers/data/detection.py``).

``DiscoveryDataset`` enumerates (image path, image name) in the dataset's
order and reads each image's ground truth with the reference's coordinate
conventions: VOC's 1-based inclusive ``xmin``/``ymin`` shifted to 0-based,
COCO's xywh to int-rounded xyxy with crowd boxes removed. ``no_hard`` drops
truncated and difficult VOC boxes. XML goes through the standard library;
images are read by ``vipers_torch.data.native`` (the LOST feed) or by PIL
(``load_image_normalized``, the host-normalized feed).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD


def _pil_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def load_image_normalized(path: str) -> np.ndarray:
    """PIL decode -> float32 (H, W, 3), x/255 then (x - mean)/std, no
    resize."""
    img = _pil_rgb(path).astype(np.float32) / 255.0
    return (img - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)


def extract_gt_VOC(annotation: Dict, remove_hards: bool = False):
    """1-based inclusive xmin/ymin shifted to 0-based; (boxes (n, 4), names)."""
    gt_bbxs, gt_clss = [], []
    for o in annotation["annotation"]["object"]:
        if remove_hards and (o.get("truncated") == "1" or o.get("difficult") == "1"):
            continue
        gt_clss.append(o["name"])
        b = o["bndbox"]
        gt_bbxs.append([int(b["xmin"]) - 1, int(b["ymin"]) - 1, int(b["xmax"]), int(b["ymax"])])
    return np.asarray(gt_bbxs), gt_clss


def extract_gt_COCO(targets: List[Dict], remove_iscrowd: bool = True):
    """xywh -> xyxy, int-rounded, crowd boxes removed; (boxes, category ids)."""
    gt_bbxs, gt_clss = [], []
    for o in targets:
        if remove_iscrowd and o.get("iscrowd") == 1:
            continue
        gt_clss.append(o["category_id"])
        x, y, w, h = o["bbox"]
        gt_bbxs.append([int(round(v)) for v in (x, y, x + w, y + h)])
    return np.asarray(gt_bbxs), gt_clss


def parse_voc_xml(path: str) -> Dict:
    """VOC annotation XML -> nested dict (the shape torchvision produces):
    ``object`` is always a list, empty when the image has no object."""

    def node_to_dict(node):
        children = list(node)
        if not children:
            return node.text
        out: Dict = {}
        for c in children:
            val = node_to_dict(c)
            if c.tag == "object":
                out.setdefault("object", []).append(val)
            else:
                out[c.tag] = val
        return out

    ann = node_to_dict(ET.parse(path).getroot())
    if "object" in ann and not isinstance(ann["object"], list):
        ann["object"] = [ann["object"]]
    ann.setdefault("object", [])
    return {"annotation": ann}


class DiscoveryDataset:
    """(image path, image name) of VOC07/VOC12/COCO20k in dataset order.

    VOC layout:  <root>/JPEGImages, <root>/Annotations,
                 <root>/ImageSets/Main/<set>.txt (else every JPEG, sorted)
    COCO layout: <root>/<file_name> with an instances json
    (``coco_annotations``); ``coco20k_list`` restricts it to the images of a
    filename list.
    """

    def __init__(self, name: str, set_name: str, root: str, no_hard: bool = False,
                 coco_annotations: Optional[str] = None,
                 coco20k_list: Optional[str] = None):
        self.name = name
        self.set_name = set_name
        self.root = root
        self.no_hard = no_hard
        self.items: List[Tuple[str, str]] = []
        if name.startswith("VOC"):
            self._init_voc()
        elif name.startswith("COCO"):
            self._init_coco(coco_annotations, coco20k_list)
        else:
            raise ValueError(f"Unknown dataset {name!r}")

    def _init_voc(self):
        setfile = os.path.join(self.root, "ImageSets", "Main", f"{self.set_name}.txt")
        if os.path.exists(setfile):
            with open(setfile) as f:
                ids = [line.strip().split()[0] for line in f if line.strip()]
        else:
            ids = sorted(os.path.splitext(p)[0]
                         for p in os.listdir(os.path.join(self.root, "JPEGImages")))
        for i in ids:
            self.items.append((os.path.join(self.root, "JPEGImages", i + ".jpg"), i + ".jpg"))

    def _init_coco(self, ann_file, sel_file):
        if not ann_file:
            raise ValueError("COCO datasets need coco_annotations= (instances json); "
                             "pass --coco-annotations on the CLI")
        with open(ann_file) as f:
            coco = json.load(f)
        anns_by_img: Dict[int, List] = {}
        for a in coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self._coco_anns = anns_by_img
        images = coco["images"]
        if sel_file:
            with open(sel_file) as f:
                sel = {str(int(s.strip().split("_")[-1].split(".")[0])) for s in f if s.strip()}
            images = [im for im in images if str(im["id"]) in sel]
        self._coco_images = {im["file_name"]: im for im in images}
        for im in images:
            self.items.append((os.path.join(self.root, im["file_name"]), im["file_name"]))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        yield from self.items

    def annotation(self, im_name: str):
        if self.name.startswith("VOC"):
            return parse_voc_xml(os.path.join(self.root, "Annotations",
                                              os.path.splitext(im_name)[0] + ".xml"))
        return self._coco_anns.get(self._coco_images[im_name]["id"], [])

    def extract_gt(self, im_name: str):
        """(gt boxes (n, 4) xyxy, classes); hard boxes removed under no_hard."""
        ann = self.annotation(im_name)
        if self.name.startswith("VOC"):
            return extract_gt_VOC(ann, remove_hards=self.no_hard)
        return extract_gt_COCO(ann)

    def load_image(self, im_name: str) -> np.ndarray:
        return _pil_rgb(os.path.join(os.path.dirname(self.items[0][0]), im_name))


def select_coco_20k(sel_file: str, all_annotations_file: str, out_file: str):
    """Write the annotation subset of the images in a filename list."""
    with open(all_annotations_file) as f:
        full = json.load(f)
    with open(sel_file) as f:
        sel = [s.strip() for s in f if s.strip()]
    ids = {int(s.split("_")[-1].split(".")[0]) for s in sel}
    out = {
        "images": [im for im in full["images"] if im["id"] in ids],
        "annotations": [a for a in full["annotations"] if a["image_id"] in ids],
        "categories": full["categories"],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out
