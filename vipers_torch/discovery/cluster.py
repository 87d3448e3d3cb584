"""Class-agnostic box clustering into pseudo-labels, ``vipers_torch
cluster`` (port of ``vipers/discovery/cluster.py``).

Each predicted box of a ``preds.pkl`` is cropped from its image, resized
to 256x256 BICUBIC (PIL, on a thread pool in the names' sorted order) and
normalized, then embedded by a DINO ViT's CLS feature in f32, 16 crops a
forward on the device, and normalized to unit length. The features are
whitened, each row normalized, and clustered by k-means
(``discovery.kmeans``) into ``--nb-clusters`` pseudo-labels. The features
may be cached as a pickle (``--feature-cache``); the labels go to
``<preds>_clusters_<k>.pkl`` as {image name: label}. Without
``--checkpoint`` the weights are random (seed 0) and a warning says the
labels mean nothing.
"""

from __future__ import annotations

import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch
from PIL import Image

from vipers_torch.core.checkpoint import family
from vipers_torch.core.device import resolve_device
from vipers_torch.core.registry import build_model, build_module
from vipers_torch.data.detection import DiscoveryDataset
from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from vipers_torch.discovery.kmeans import kmeans2, whiten

EMBED_BATCH = 16

# counts and seconds of the last cluster_boxes call, for callers that time it
LAST_RUN: dict = {}


def cluster_input(feats):
    """What k-means clusters: the whitened features, each row normalized
    to unit length."""
    white = whiten(feats)
    return white / torch.linalg.norm(white, dim=1, keepdim=True)


def _crop(path: str, box) -> np.ndarray:
    """The box's crop (at least a pixel a side), 256x256 BICUBIC,
    normalized f32 (256, 256, 3)."""
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    img = Image.open(path).convert("RGB")
    crop = img.crop((x1, y1, max(x2, x1 + 1), max(y2, y1 + 1))).resize((256, 256),
                                                                       Image.BICUBIC)
    arr = np.asarray(crop, np.float32) / 255.0
    return (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)


@torch.inference_mode()
def embed_crops(model, crops: np.ndarray, device) -> torch.Tensor:
    """(N, D) unit-length f32 embeddings of normalized (N, 256, 256, 3)
    crops, ``EMBED_BATCH`` a forward."""
    out = []
    for i in range(0, len(crops), EMBED_BATCH):
        x = torch.from_numpy(np.ascontiguousarray(crops[i:i + EMBED_BATCH])).to(device)
        f = model(x)[0]
        out.append(f / torch.linalg.norm(f, dim=-1, keepdim=True))
    return torch.cat(out)


def load_embedder(model_name: str, patch_size: int, checkpoint: str, device):
    """The embedding model in eval mode, f32, on ``device``: a checkpoint's
    weights (its masks are not applied, as in the JAX package) or seed-0
    random ones, with a warning."""
    spec = build_model(model_name, patch_size=patch_size)
    if checkpoint:
        from vipers_torch.discovery.driver import load_lost_checkpoint

        params = load_lost_checkpoint(checkpoint, spec)[0]
    else:
        print("[vipers_torch.cluster] WARNING: no --checkpoint given; embedding "
              "with RANDOM weights — pseudo-labels will be meaningless")
        params = spec.init(torch.Generator().manual_seed(0))
    model = build_module(spec)
    model.load_state_dict(family(spec).state_dict(params))
    return model.eval().requires_grad_(False).to(device)


def cluster_boxes(preds: Dict[str, list], dataset: DiscoveryDataset, nb_clusters: int = 20,
                  model_name: str = "dino_vit_small", checkpoint: str = "",
                  cache_path: str = "", seed: int = 0, patch_size: int = 16,
                  device=None) -> Dict[str, int]:
    """{image name: pseudo-label} for every predicted box, on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    model = load_embedder(model_name, patch_size, checkpoint, dev)
    names = sorted(preds)
    t0 = time.time()
    if cache_path and os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            feats = torch.from_numpy(np.asarray(pickle.load(f), np.float32)).to(dev)
    else:
        img_dir = os.path.dirname(dataset.items[0][0])
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as exe:
            crops = np.stack(list(exe.map(
                lambda n: _crop(os.path.join(img_dir, n), preds[n]), names)))
        t_crops = time.time()
        feats = embed_crops(model, crops, dev)
        if cache_path:
            with open(cache_path, "wb") as f:
                pickle.dump(feats.cpu().numpy(), f)
        LAST_RUN.update(crop_seconds=t_crops - t0)
    t_embed = time.time()
    _cent, labels = kmeans2(cluster_input(feats), min(nb_clusters, len(names)), seed=seed)
    labels = labels.cpu().numpy()
    LAST_RUN.update(crops=len(names), embed_seconds=t_embed - t0,
                    kmeans_seconds=time.time() - t_embed)
    return {name: int(label) for name, label in zip(names, labels)}


def run_cluster_cli(args) -> int:
    """``vipers_torch cluster``: ``vipers cluster``'s flags plus
    ``--device``."""
    with open(args.preds, "rb") as f:
        preds = pickle.load(f)
    ds = DiscoveryDataset(args.dataset, args.set, args.data_path,
                          no_hard=args.no_hard, coco_annotations=args.coco_annotations,
                          coco20k_list=args.coco20k_list)
    LAST_RUN.clear()
    labels = cluster_boxes(preds, ds, nb_clusters=args.nb_clusters, model_name=args.arch,
                           checkpoint=args.checkpoint, cache_path=args.feature_cache,
                           seed=args.random_seed, patch_size=args.patch_size,
                           device=args.device)
    out = os.path.splitext(args.preds)[0] + f"_clusters_{args.nb_clusters}.pkl"
    with open(out, "wb") as f:
        pickle.dump(labels, f)
    print(f"clustered {len(labels)} boxes into {args.nb_clusters} pseudo-labels -> {out}")
    return 0
