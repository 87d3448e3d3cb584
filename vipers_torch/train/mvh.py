"""Model-vs-human benchmark runner (port of ``vipers/train/mvh.py``).

Evaluates a (pruned) classifier on the 17 distortion benchmarks and writes
the reference's CSV contract ``{model}_pruning_step_{N}.csv`` in the exact
row structure ``mvh_performance_plot.py:71-87`` indexes into
(header row 0; edge at row 1 ... sketch at row 16; row 17 reserved;
stylized at row 18; the plot reads the LAST column of each row).

Parametric distortions are swept over the toolbox's parameter levels
(``data.distortions.DISTORTION_LEVELS``): each row carries one accuracy
column per level followed by the across-level mean, so ``row[-1]`` — what
the reference plot consumes — is the benchmark mean.  Stimulus-dataset
benchmarks (cue-conflict, edge, silhouette, sketch, stylized) are evaluated
from ``stimuli_root/<name>/`` ImageFolders when present and reported as NaN
otherwise.

The distortions run on the host (numpy, ``data.distortions``); each
distorted batch is normalized there and goes to the device as f32 for the
port's eval step (``train.steps.make_eval_step``). ``LAST_RUN`` holds the
seconds the last ``eval_mvh`` spent in the distortions and in the eval
steps, and the images it distorted, for callers that time it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Union

import time

import numpy as np
import torch

from vipers_torch.core.device import resolve_device
from vipers_torch.data.distortions import (
    DISTORTION_LEVELS,
    PARAMETRIC_DISTORTIONS,
    STIMULUS_DATASETS,
)
from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD

# seconds in the distortions and in the eval steps of the last eval_mvh
LAST_RUN: dict = {}

MVH_ORDER = [
    "colour", "contrast", "cue-conflict", "edge", "eidolonI", "eidolonII",
    "eidolonIII", "false-colour", "high-pass", "low-pass", "phase-scrambling",
    "power-equalisation", "rotation", "silhouette", "sketch", "stylized",
    "uniform-noise",
]

# Row order of the modelvshuman-toolbox CSV all four reference plot
# scripts consume: by row index with [17]=sketch-top5 skipped
# (`mvh_performance_plot.py:68-87`), by `row[1]+' '+row[2]` benchmark/metric
# name (`mvh_performance_plot_2.py:54-65` — fixing row[1]/row[2] as the
# benchmark and `accuracy (top-k)` columns), rows 2/4/10
# (`mvh_triple_comparison.py:29-38`), row 11
# (`mvh_performance_rn50_vs_rn18.py:29-45`). (benchmark, top-k) pairs;
# sketch/stylized carry separate top-5 rows like the toolbox reports.
REFERENCE_CSV_ROWS = [
    ("edge", 1), ("silhouette", 1), ("cue-conflict", 1), ("colour", 1),
    ("contrast", 1), ("high-pass", 1), ("low-pass", 1),
    ("phase-scrambling", 1), ("power-equalisation", 1), ("false-colour", 1),
    ("rotation", 1), ("eidolonI", 1), ("eidolonII", 1), ("eidolonIII", 1),
    ("uniform-noise", 1), ("sketch", 1), ("sketch", 5), ("stylized", 1),
    ("stylized", 5),
]


def eval_mvh(
    eval_step,
    state,
    batches: Iterable,  # yields (uint8 images (B,H,W,C), labels)
    seed: int = 0,
    stimuli_root: Optional[str] = None,
    stimuli_eval_fn=None,
    levels: Optional[Dict[str, list]] = None,
    device=None,
) -> Dict[str, Union[float, List[float]]]:
    """Per-benchmark accuracy. Parametric benchmarks return a list with one
    accuracy per parameter level; stimulus benchmarks a single float (or
    NaN when the stimuli are unavailable). ``batches`` must be re-iterable
    (numpy uint8 images, labels); ``eval_step(state, (images, labels))``
    gets them as tensors on ``device`` (None = the card)."""
    dev = resolve_device(device)
    LAST_RUN.clear()
    LAST_RUN.update(distort_s=0.0, eval_s=0.0, images=0)
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    levels = DISTORTION_LEVELS if levels is None else levels
    results: Dict[str, Union[float, List[float]]] = {}

    # (benchmark, level) pairs whose distortion fn is the identity — one
    # clean pass serves all of them instead of 6+ redundant evaluations
    identity = {
        ("colour", 0), ("false-colour", 0), ("power-equalisation", 0),
        ("low-pass", 0), ("rotation", 0), ("uniform-noise", 0.0),
        ("contrast", 1.0),  # 0.5 + (img - 0.5) * 1.0 == img
    }
    clean_acc: Dict[str, float] = {}

    def run_pass(fn, level):
        rng = np.random.default_rng(seed)
        top1 = n = 0
        for images, labels in batches:
            t0 = time.perf_counter()
            imgs = images.astype(np.float32) / 255.0
            if level is None:
                distorted = np.stack([fn(im, rng) for im in imgs])
            else:
                distorted = np.stack([fn(im, rng, level=level) for im in imgs])
            x = (distorted - mean) / std
            t1 = time.perf_counter()
            out = eval_step(state, (torch.from_numpy(x).to(dev),
                                    torch.from_numpy(np.asarray(labels)).long().to(dev)))
            top1 += int(out["top1"])
            n += int(out["n"])
            LAST_RUN["distort_s"] += t1 - t0
            LAST_RUN["eval_s"] += time.perf_counter() - t1
            LAST_RUN["images"] += len(labels)
        return 100.0 * top1 / max(n, 1)

    for name in MVH_ORDER:
        if name in STIMULUS_DATASETS:
            if stimuli_root and stimuli_eval_fn and os.path.isdir(
                os.path.join(stimuli_root, name)
            ):
                results[name] = stimuli_eval_fn(os.path.join(stimuli_root, name))
            else:
                results[name] = float("nan")
            continue
        fn = PARAMETRIC_DISTORTIONS[name]
        accs = []
        for level in levels.get(name, [None]):
            if (name, level) in identity:
                if "clean" not in clean_acc:
                    clean_acc["clean"] = run_pass(lambda im, r, level=0: im, 0)
                accs.append(clean_acc["clean"])
            else:
                accs.append(run_pass(fn, level))
        results[name] = accs
    return results


# The modelvshuman 16 entry-level categories the stimulus sets are labeled
# with (folder class names in cue-conflict/edge/silhouette/sketch/stylized).
SIXTEEN_CATEGORIES = [
    "airplane", "bear", "bicycle", "bird", "boat", "bottle", "car", "cat",
    "chair", "clock", "dog", "elephant", "keyboard", "knife", "oven", "truck",
]

# Name-substring seeds — retained ONLY as a last-resort fallback should the
# packaged category_map.json be unreadable; the shipped WordNet-derived map
# is the default (see imagenet_to_16_matrix).
_CATEGORY_NAME_SEEDS: Dict[str, List[str]] = {
    "airplane": ["airliner", "warplane", "airship", "plane"],
    "bear": ["bear", "panda"],
    "bicycle": ["bicycle", "tricycle", "unicycle", "mountain bike"],
    "bird": [
        "cock", "hen", "finch", "jay", "magpie", "chickadee", "ouzel",
        "kite", "eagle", "vulture", "owl", "peacock", "quail", "partridge",
        "parrot", "macaw", "cockatoo", "lorikeet", "hummingbird", "toucan",
        "drake", "merganser", "goose", "swan", "crane bird", "heron",
        "bittern", "egret", "stork", "spoonbill", "flamingo", "pelican",
        "penguin", "albatross", "grouse", "ptarmigan", "prairie chicken",
        "ostrich", "bulbul", "robin", "warbler", "wren", "hornbill",
        "jacamar", "bee eater", "kingfisher", "hoopoe", "woodpecker",
        "gallinule", "coot", "bustard", "turnstone", "sandpiper",
        "redshank", "dowitcher", "oystercatcher", "tern", "gull", "auk",
        "loon", "grebe",
    ],
    "boat": ["canoe", "yawl", "catamaran", "trimaran", "gondola", "lifeboat",
             "speedboat", "paddlewheel", "fireboat", "sailboat", "schooner"],
    "bottle": ["bottle", "jug", "flask", "pitcher"],
    "car": ["ambulance", "beach wagon", "cab", "convertible", "jeep",
            "limousine", "minivan", "model t", "racer", "sports car"],
    "cat": ["tabby", "tiger cat", "persian cat", "siamese cat",
            "egyptian cat", "lynx", "leopard", "snow leopard", "jaguar",
            "lion", "tiger", "cheetah", "cougar"],
    "chair": ["chair", "throne", "park bench"],
    "clock": ["clock", "sundial", "timer", "hourglass", "watch"],
    "dog": ["dog", "terrier", "retriever", "spaniel", "hound", "setter",
            "pointer", "sheepdog", "collie", "corgi", "poodle", "pug",
            "chihuahua", "pekinese", "shih", "mastiff", "bulldog", "husky",
            "malamute", "dalmatian", "pinscher", "schnauzer", "rottweiler",
            "shepherd", "boxer", "newfoundland", "pyrenees", "samoyed",
            "spitz", "keeshond", "griffon", "ridgeback", "beagle",
            "bloodhound", "whippet", "borzoi", "deerhound", "weimaraner",
            "dingo", "basenji", "affenpinscher", "papillon", "leonberg",
            "kuvasz", "komondor", "briard", "kelpie", "malinois",
            "greyhound", "saluki"],
    "elephant": ["elephant"],
    "keyboard": ["keyboard", "typewriter", "space bar"],
    "knife": ["cleaver", "letter opener", "knife"],
    "oven": ["oven", "stove", "rotisserie", "toaster", "waffle iron"],
    "truck": ["truck", "trailer truck", "moving van", "fire engine",
              "garbage truck", "pickup", "tow truck", "snowplow"],
}


def imagenet_to_16_matrix(stimuli_root: Optional[str] = None) -> np.ndarray:
    """(1000, 16) float mask aggregating ImageNet logits into the 16
    entry-level categories.

    Resolution order:
      1. ``{stimuli_root}/category_map.json`` when present (explicit
         per-dataset override, ``{"category": [imagenet indices...]}``),
      2. the packaged ``data/meta/category_map.json`` — the public
         WordNet-derived 16-class-ImageNet mapping (Geirhos et al.
         ``human_categories``, the same aggregation modelvshuman's
         ``probabilities_to_decision`` uses),
      3. name-synonym matching (documented seeds above) as a last resort.
    """
    import json

    m = np.zeros((1000, 16), np.float32)
    candidates = []
    if stimuli_root:
        candidates.append(os.path.join(stimuli_root, "category_map.json"))
    candidates.append(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "meta", "category_map.json",
    ))
    for map_path in candidates:
        if not os.path.exists(map_path):
            continue
        try:
            with open(map_path) as f:
                cat_map = json.load(f)
        except (OSError, ValueError):
            continue
        for ci, cat in enumerate(SIXTEEN_CATEGORIES):
            for idx in cat_map.get(cat, []):
                m[int(idx), ci] = 1.0
        return m
    import re

    from vipers_torch.data.imagenet_meta import imagenet_categories

    # whole-word matching: 'hotdog' must not match the 'dog' seed,
    # 'cocktail'/'cockroach' not 'cock', 'bearskin' not 'bear'
    excludes = {"hen-of-the-woods"}  # hyphen still word-bounds 'hen'
    names = [n.lower() for n in imagenet_categories()]
    compiled = {
        cat: [re.compile(r"\b" + re.escape(s) + r"\b") for s in seeds]
        for cat, seeds in _CATEGORY_NAME_SEEDS.items()
    }
    for ci, cat in enumerate(SIXTEEN_CATEGORIES):
        for ii, name in enumerate(names):
            if name in excludes:
                continue
            if any(p.search(name) for p in compiled[cat]):
                m[ii, ci] = 1.0
    return m


class StimulusAccuracy(float):
    """Top-1 accuracy (percent) that also carries the top-5 accuracy of the
    16-category decision: the toolbox CSV has separate `accuracy (top-5)`
    rows for sketch/stylized (`mvh_performance_plot_2.py:36,38`)."""

    top5: float

    def __new__(cls, top1: float, top5: float):
        self = super().__new__(cls, top1)
        self.top5 = float(top5)
        return self


def make_stimuli_eval_fn(logits_fn, batch_size: int = 32,
                         resize: int = 256, crop: int = 224,
                         stimuli_root: Optional[str] = None):
    """Evaluator for one stimulus-set directory (an ImageFolder whose class
    names are the 16 categories): eval-preset decode (threaded), 1000-class
    logits -> 16-category decision via probability aggregation (toolbox
    ``probabilities_to_decision`` semantics: MEAN probability over each
    category's mapped classes), accuracy against the folder label.
    ``logits_fn(images) -> (B, 1000)``: ``images`` a normalized f32
    (B, H, W, 3) CPU tensor, the logits a tensor on any device."""
    from concurrent.futures import ThreadPoolExecutor

    from vipers_torch.data.imagefolder import ImageFolder
    from vipers_torch.data.preprocess import eval_decode

    agg = imagenet_to_16_matrix(stimuli_root)
    agg_count = np.maximum(agg.sum(axis=0), 1.0)  # classes per category
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)

    def eval_dir(path: str) -> float:
        ds = ImageFolder(path)
        cat_of_class = []
        for cname in ds.classes:
            key = cname.lower()
            cat_of_class.append(
                SIXTEEN_CATEGORIES.index(key)
                if key in SIXTEEN_CATEGORIES else -1
            )
        work = [
            (img_path, cat_of_class[cls_idx])
            for img_path, cls_idx in ds.samples
            if cat_of_class[cls_idx] >= 0  # skip non-category dirs
        ]
        top1 = top5 = n = 0
        with ThreadPoolExecutor(8) as exe:  # decode overlaps device compute
            for start in range(0, len(work), batch_size):
                chunk = work[start : start + batch_size]
                imgs = list(exe.map(
                    lambda w: eval_decode(w[0], resize, crop), chunk
                ))
                labels = np.asarray([c for _p, c in chunk])
                x = (np.stack(imgs).astype(np.float32) / 255.0 - mean) / std
                logits = logits_fn(torch.from_numpy(x)).float().cpu().numpy()
                p = np.exp(logits - logits.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                # toolbox decision: MEAN prob over each category's classes
                cat_scores = (p @ agg) / agg_count[None]
                pred = cat_scores.argmax(-1)
                top1 += int((pred == labels).sum())
                label_score = cat_scores[np.arange(len(labels)), labels]
                rank = (cat_scores > label_score[:, None]).sum(-1)
                top5 += int((rank < 5).sum())
                n += len(labels)
        n = max(n, 1)
        return StimulusAccuracy(100.0 * top1 / n, 100.0 * top5 / n)

    return eval_dir


def write_mvh_csv(results: Dict[str, Union[float, List[float]]],
                  model: str, step: int, out_dir: str):
    """CSV values are 0-1 FRACTIONS, the modelvshuman toolbox convention:
    the reference's own plot scripts read the last column and draw with
    ``plt.ylim(0, 1)`` (`mvh_performance_plot.py:71-87,142`), so percent
    values would clip off-scale. The ``eval_*`` functions return percent
    for human-facing prints; this writer converts."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{model}_pruning_step_{step}.csv")

    def frac(v):
        return v / 100.0

    with open(path, "w") as f:
        f.write("model,benchmark,metric,accuracy_per_level...,mean\n")
        for name, topk in REFERENCE_CSV_ROWS:
            val = results.get(name, float("nan"))
            if topk == 5:  # StimulusAccuracy carries it; plain float -> nan
                val = getattr(val, "top5", float("nan"))
            if isinstance(val, (list, tuple)):
                levels = [frac(v) for v in val]
                cols = levels + [
                    float(np.mean(levels)) if levels else float("nan")
                ]
            else:
                cols = [frac(val)]
            f.write(f"{model},{name},accuracy (top-{topk}),"
                    + ",".join(str(v) for v in cols) + "\n")
    return path
