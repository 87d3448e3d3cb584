"""Explainability drivers: heatmap generation + RMA/RRA scoring (port of
``vipers/explain/driver.py``), on one device.

``run_explain`` is ``vipers_torch explain``: one val image per class, every
requested method, ``.npy`` maps and figures per method and class, for one
checkpoint, an untrained seed baseline or every checkpoint of a sweep.
``run_explain_eval`` is ``explain-eval``: RMA/RRA of GradCAM, IG (and a
ViT's or DINO ViT's attention map) over VOC JPEG/SegmentationClass pairs, written as
``{method}_{model}_pruning_iteration_{NN}.txt``. ``run_explain_eval_batch``
is ``explain-eval-batch``: saved heatmap directories scored under all six
poolings (numpy on the host). File names and contents are the JAX
package's.

The model runs in f32 on ``--device`` (the card unless ``cpu``), its
parameters frozen (``requires_grad=False``): every gradient is taken with
respect to the input or GradCAM's tap. Every registered classifier runs:
the ViTs, the DINO ViTs (with ``num_classes`` 0 the "logits" are the CLS
feature, as in the JAX package), Swin, the ResNets, VGG16 and
MobileNetV2 (its GradCAM tap the head convolution's map). A ViT runs at
each image's own padded size with the pos-embedding interpolated
bicubically (``align_corners=True``; a DINO ViT interpolates its own
table, half-pixel); below ``flash_min_t()`` tokens its blocks take
the einsum, above it blocks 0 to L-2 take the flash forward (the last block
returns its attention) and, under IG, Guided-GradCAM and LRP, the flash
backward. ``LAST_RUN`` holds the seconds each method took in the last
``compute_heatmaps`` calls and the images they covered, for callers that
time them.
"""

from __future__ import annotations

import glob as globlib
import os
import time
from typing import Dict, List

import numpy as np
import torch

from vipers_torch.core.checkpoint import (family, infer_num_classes,
                                          infer_representation_size, infer_vit_image_size)
from vipers_torch.core.device import resolve_device
from vipers_torch.core.registry import build_model, build_module
from vipers_torch.data.detection import load_image_normalized
from vipers_torch.explain.attribution import make_integrated_gradients, make_smoothgrad
from vipers_torch.explain.gradcam import input_gradient, make_gradcam, vit_attention_heatmap
from vipers_torch.explain.metrics import evaluate_single
from vipers_torch.models.activations import guided_backprop
from vipers_torch.models.cnn import exact_f32_convs
from vipers_torch.models.interpolate import interpolate_pos_embedding
from vipers_torch.pruning.structured import arch_sidecar

# seconds per method of the compute_heatmaps calls since the last reset
LAST_RUN: dict = {}

# the families explained on their token grid (the tap on the last block's
# norm1 output, the attention map)
TRANSFORMERS = ("vit", "dino_vit")


def _load_model(model_name: str, checkpoint: str = "", seed: int = 0, device=None,
                cmd: str = "explain"):
    """(spec, model): ``model_name`` on ``device`` in eval mode with frozen
    f32 parameters, the checkpoint's weights with its masks baked in (the
    module rebuilt at the checkpoint's head width and, for a ViT, its
    pos-table size; a slimmed checkpoint's at its ``.slim.json``
    sidecar's widths), or without a checkpoint random weights drawn from
    ``seed``."""
    dev = resolve_device(device)
    arch = arch_sidecar(checkpoint)
    slim = {"arch_overrides": arch} if arch else {}
    try:
        spec = build_model(model_name, **slim)
    except ValueError:
        raise SystemExit(f"vipers_torch {cmd}: unknown model {model_name!r}") from None
    batch_stats = masks = None
    if checkpoint:
        from vipers_torch.discovery.driver import load_lost_checkpoint

        params, batch_stats, masks, _ = load_lost_checkpoint(checkpoint, spec)
        n_cls = infer_num_classes(params)
        if spec.family == "vit":
            kw = {"num_classes": n_cls or 0,
                  "representation_size": infer_representation_size(params), **slim}
            size = infer_vit_image_size(params, spec.patch_size)
            if size is not None:
                kw["image_size"] = size
            spec = build_model(model_name, **kw)
        elif n_cls is not None:
            spec = build_model(model_name, num_classes=n_cls, **slim)
    else:
        params = spec.init(torch.Generator().manual_seed(seed))
    model = build_module(spec)
    sd = family(spec).state_dict(params, batch_stats, masks)
    model.load_state_dict({**dict(model.named_buffers()), **sd})
    model.eval().requires_grad_(False)
    return spec, model.to(dev)


def _apply_fn(spec, model, h: int, w: int):
    """model_apply(x, tap_delta=None) -> (logits, aux) at an (h, w) input
    (a ViT's pos-embedding interpolated to its grid; a DINO ViT
    interpolates its own table, so it gets no override)."""
    pos = None
    if spec.family == "vit":
        p = spec.patch_size
        pos = interpolate_pos_embedding(model.pos_embedding, (h // p, w // p),
                                        align_corners=True)

    def model_apply(x, tap_delta=None):
        kwargs = {"tap_delta": tap_delta}
        if pos is not None:
            kwargs["override_pos_embedding"] = pos
        return model(x, **kwargs)

    return model_apply


def _timed(method: str, t0: float):
    LAST_RUN.setdefault("method_s", {})
    LAST_RUN["method_s"][method] = LAST_RUN["method_s"].get(method, 0.0) + time.perf_counter() - t0


def compute_heatmaps(
    spec,
    model,
    img: np.ndarray,  # (H, W, 3) normalized, padded for ViT
    methods: List[str],
    generator=None,
    nt_samples: int = 2,
    ig_steps: int = 50,
) -> Dict[str, np.ndarray]:
    """All requested attribution maps for one image, on the model's
    device. Target class is the model's own argmax prediction. IG's
    SmoothGrad noise comes from ``generator`` (a CPU ``torch.Generator``;
    None = seed 0), so the card and the CPU see the same noise. Convolutions
    run in exact f32 (``models.cnn.exact_f32_convs``: cuDNN's TF32 off)."""
    with exact_f32_convs():
        return _compute_heatmaps(spec, model, img, methods, generator, nt_samples, ig_steps)


def _compute_heatmaps(spec, model, img, methods, generator, nt_samples, ig_steps):
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))[None].to(dev)
    h, w = img.shape[:2]
    model_apply = _apply_fn(spec, model, h, w)
    is_vit = spec.family in TRANSFORMERS
    grid = (h // spec.patch_size, w // spec.patch_size) if is_vit else None

    out: Dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, aux = model_apply(x)
    out["prediction"] = logits[0].cpu().numpy()
    _timed("forward", t0)

    if "gradcam" in methods or "guided_gradcam" in methods:
        t0 = time.perf_counter()
        if is_vit:
            tap_shape = (1, grid[0] * grid[1] + 1, aux["qkv_input"].shape[-1])
            aux_key = "qkv_input"
        else:
            tap_shape, aux_key = tuple(aux["features"].shape), "features"
        cam, target = make_gradcam(model_apply, tap_shape, grid, aux_key)(x)
        cam = cam.cpu().numpy()
        if "gradcam" in methods:
            out["gradcam"] = cam
        _timed("gradcam", t0)
        if "guided_gradcam" in methods:
            # ViT, DINO and Swin have no ReLUs, and MobileNetV2's relu6 is
            # no guided site (the JAX module clamps it with minimum and
            # maximum): "guided" is the plain input gradient there,
            # Captum's behaviour for ReLU-free models
            t0 = time.perf_counter()
            with guided_backprop():
                gbp = input_gradient(model_apply, x, int(target)).cpu().numpy()
            ggc = gbp * cam[None, :, :, None]
            out["guided_gradcam"] = np.transpose(ggc[0], (2, 0, 1))  # CHW
            _timed("guided_gradcam", t0)
    if "ig" in methods:
        t0 = time.perf_counter()

        def score_fn(xx, target):
            lg, _aux = model_apply(xx)
            return lg[torch.arange(xx.shape[0], device=lg.device), target]

        ig = make_integrated_gradients(score_fn, n_steps=ig_steps)
        sg = make_smoothgrad(ig, nt_samples=nt_samples)
        target = torch.tensor([int(np.argmax(out["prediction"]))], device=dev)
        attr = sg(generator, x, target)
        out["ig"] = np.transpose(attr[0].cpu().numpy(), (2, 0, 1))  # CHW like captum
        _timed("ig", t0)
    if "lrp" in methods:
        from vipers_torch.explain.lrp import lrp_attribution

        t0 = time.perf_counter()
        rel, _t = lrp_attribution(model_apply, model, x)
        out["lrp"] = np.transpose(rel, (2, 0, 1))  # CHW like captum
        _timed("lrp", t0)
    if "attention" in methods and is_vit:
        t0 = time.perf_counter()
        out["attention"] = vit_attention_heatmap(aux["attn"], grid, (h, w),
                                                 patch_size=spec.patch_size)
        _timed("attention", t0)
    LAST_RUN["images"] = LAST_RUN.get("images", 0) + 1
    return out


def run_explain(args) -> int:
    """One val image per class for N classes, all methods, save jpg+npy.

    Sweep mode: ``--pruning-iteration -1`` with ``--models-path`` explains
    every templated sweep checkpoint under
    ``{models_path}/{model}/model_epoch_*_pruning_iteration_*`` (or the ViT
    stem ``{model}_epoch_*``) into per-iteration output subdirectories."""
    untrained = getattr(args, "untrained", False)
    seed = getattr(args, "seed", 0)
    models_path = getattr(args, "models_path", "")
    device = getattr(args, "device", None)
    if getattr(args, "pruning_iteration", None) == -1 and models_path:
        import re

        patterns = [
            os.path.join(models_path, args.model, "model_epoch_*_pruning_iteration_*"),
            os.path.join(models_path, args.model, f"{args.model}_epoch_*_pruning_iteration_*"),
        ]
        # output dirs keyed by the iteration number parsed from the file
        # name; a .pth and a same-stem directory count once
        by_iter = {}
        for pat in patterns:
            for p in globlib.glob(pat):
                mt = re.search(r"pruning_iteration_(\d+)", os.path.basename(p))
                if mt is None:
                    continue
                by_iter.setdefault(int(mt.group(1)), p)
        if not by_iter:
            raise FileNotFoundError(f"no sweep checkpoints match {patterns}")
        for it in sorted(by_iter):
            ckpt = by_iter[it]
            print(f"Model filename: {ckpt}")
            spec, model = _load_model(args.model, ckpt, device=device)
            _explain_one(spec, model,
                         os.path.join(args.output_dir, f"pruning_iteration_{it:02d}"), args)
        return 0

    out_root = args.output_dir
    if untrained:
        # the untrained-seed baseline lands in a seed-stamped subdirectory
        spec, model = _load_model(args.model, "", seed=seed, device=device)
        out_root = os.path.join(args.output_dir, f"untrained_model_seed_{seed}")
        print(f"Using untrained vanilla model: {args.model} with seed: {seed}")
    else:
        spec, model = _load_model(args.model, args.checkpoint, device=device)
    return _explain_one(spec, model, out_root, args)


def _performance_title_bits(args, out_root: str):
    """(iteration, sparsity, acc1) for the figure titles: row
    ``iteration+1`` of ``{models_path}/{model}/performance.txt`` as
    ``acc1\\tsparsity``; untrained baselines get N/A."""
    import re

    if "untrained_model" in out_root:
        return None, "N/A", "N/A"
    it = None
    mt = re.search(r"pruning_iteration_(\d+)", out_root)
    if mt:
        it = int(mt.group(1))
    elif getattr(args, "pruning_iteration", None) not in (None, -1):
        it = int(args.pruning_iteration)
    models_path = getattr(args, "models_path", "")
    if models_path and it is not None:
        path = os.path.join(models_path, args.model, "performance.txt")
        try:
            with open(path) as fh:
                values = fh.readlines()
            acc1, sparsity = values[it + 1].split("\t")[:2]
            return it, sparsity.strip(), acc1.strip()
        except (OSError, IndexError, ValueError):
            pass
    return it, "N/A", "N/A"


def _figure_title(args, method, target_name, pred_name, it, sparsity, acc1, out_root):
    """The reference's multi-line figure title."""
    import re

    stage = ("Untrained" if "untrained_model" in out_root
             else f"pruning iteration {it if it is not None else 'n/a'}")
    seed_info = ""
    mt = re.search(r"seed_(\d+)", out_root)
    if "untrained_model" in out_root and mt:
        seed_info = f" - Seed: {mt.group(1)}"
    return (f"Target Class: {target_name} \n - Predicted Class: {pred_name} "
            f"\n - Model: {args.model} \n - {stage}{seed_info} - "
            f"Method: {method} \n Sparsity: {sparsity} - Acc1: {acc1}")


def _save_method_figures(d: str, base: str, method: str, hm, image01, title):
    """The per-method figures, as the JAX package draws them:

    * 2D maps (gradcam/ggc): ``blended_heatmap_{f}`` (jet attribution at
      alpha .95 with a bottom colorbar over the image at alpha .75) and the
      bare ``heatmap_{f}`` jet figure;
    * ``attention``: Reds RGBA with gamma-0.5 alpha
      (``attention_heatmap_{f}.png``) and the blended overlay figure;
    * CHW attributions (ig/lrp): positive-sign jet heat map at 1% outlier
      clipping, no ticks, spines or colorbar.

    matplotlib is imported here, when a figure is drawn.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H, W = image01.shape[:2]
    extent = (0.0, float(W), float(H), 0.0)
    if hm.ndim == 2:
        if method == "attention":
            from PIL import Image

            metric = np.asarray(hm, np.float64)
            rng = max(metric.max() - metric.min(), 1e-12)
            norm = (metric - metric.min()) / rng
            reds = plt.cm.Reds(norm)
            rgba = np.zeros(norm.shape + (4,))
            rgba[..., :3] = reds[..., :3]
            rgba[..., 3] = np.power(norm, 0.5)  # gamma-enhanced alpha
            Image.fromarray((rgba * 255).astype(np.uint8)).save(
                os.path.join(d, f"attention_heatmap_{base}.png"))
            fig = plt.figure(figsize=(11, 11))
            plt.imshow(image01, alpha=0.75, extent=extent)
            # cmap is a no-op for RGBA pixels but sets the colorbar's map
            attr = plt.imshow(rgba, alpha=0.95, cmap="jet", extent=extent)
            plt.colorbar(attr, location="bottom")
            plt.title(title)
            plt.tight_layout()
            plt.savefig(os.path.join(d, f"blended_heatmap_{base}.png"))
            plt.close(fig)
            return
        fig = plt.figure(figsize=(11, 11))
        attr = plt.imshow(hm, alpha=0.95, cmap="jet", extent=extent)
        plt.colorbar(attr, location="bottom")
        plt.imshow(image01, alpha=0.75, extent=extent)
        plt.title(title)
        plt.tight_layout()
        plt.savefig(os.path.join(d, f"blended_heatmap_{base}"))
        plt.close(fig)
        fig = plt.figure(figsize=(11, 11))
        attr = plt.imshow(hm, cmap="jet")
        plt.colorbar(attr, location="bottom")
        plt.title(title)
        plt.tight_layout()
        plt.savefig(os.path.join(d, f"heatmap_{base}"))
        plt.close(fig)
        return
    # CHW: positive sign, 1% outlier clip, jet, stripped axes. The scale is
    # captum's cumulative-sum threshold (the value where the sorted
    # cumulative mass reaches 99%), not a plain percentile.
    pos = np.maximum(np.asarray(hm, np.float64).sum(0), 0.0)
    sorted_vals = np.sort(pos.ravel())
    cum = np.cumsum(sorted_vals)
    if cum[-1] > 0:
        idx = np.searchsorted(cum, 0.99 * cum[-1])
        scale = sorted_vals[min(idx, sorted_vals.size - 1)] or 1.0
    else:
        scale = 1.0
    disp = np.clip(pos / scale, 0.0, 1.0)
    fig, axis = plt.subplots(figsize=(11, 11))
    axis.imshow(disp, cmap="jet", vmin=0.0, vmax=1.0)
    axis.set_xticks([])
    axis.set_yticks([])
    for side in ("top", "right", "bottom", "left"):
        axis.spines[side].set_visible(False)
    plt.tight_layout()
    plt.savefig(os.path.join(d, f"heatmap_{base}"))
    plt.close(fig)


def _explain_one(spec, model, out_root: str, args) -> int:
    from vipers_torch.data.imagefolder import ImageFolder
    from vipers_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD, eval_decode

    ds = ImageFolder(os.path.join(args.data_path, "val"))
    # human-readable class names for the titles; the directory names
    # otherwise
    names = None
    if len(ds.classes) == 1000:
        try:
            from vipers_torch.data.imagenet_meta import imagenet_categories

            names = imagenet_categories()
        except (OSError, ValueError, KeyError):
            names = None

    def class_name(idx):
        if names is not None and 0 <= idx < len(names):
            return names[idx]
        return ds.classes[idx] if 0 <= idx < len(ds.classes) else str(idx)

    it, sparsity, acc1 = _performance_title_bits(args, out_root)
    seen = set()
    n_done = 0
    for path, label in ds.samples:
        if label in seen:
            continue
        seen.add(label)
        if n_done >= args.num_classes_sample:
            break
        arr = eval_decode(path).astype(np.float32) / 255.0
        img = (arr - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        maps = compute_heatmaps(spec, model, img.astype(np.float32), args.methods)
        cls = ds.classes[label]
        pred_idx = int(np.argmax(maps["prediction"]))
        base = os.path.basename(path)
        for method, hm in maps.items():
            if method == "prediction":
                continue
            d = os.path.join(out_root, method, cls)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"{base}_nparray.npy"), hm)
            title = _figure_title(args, method, class_name(label), class_name(pred_idx), it,
                                  sparsity, acc1, out_root)
            _save_method_figures(d, base, method, np.asarray(hm), arr, title)
        n_done += 1
    print(f"explained {n_done} classes -> {out_root}")
    return 0


def evaluate_heatmap_dirs(heatmap_dir: str, ground_truth_dir: str, output_dir: str, idx_list,
                          output_name: str = "", evaluation_metric: str = "rank"):
    """Directory-batch heatmap evaluation, the reference's ``evaluate``:
    per-datapoint ``{idx}.npy`` heatmap/GT pairs scored under all six
    poolings, summary statistics (mean/std/min/max/median/perc-80/perc-20),
    two tables (mean-ordered and fixed-order) and two JSON dumps
    (per-datapoint and statistics), byte for byte the JAX package's."""
    import json

    from vipers_torch.explain.metrics import ALL_POOLINGS, evaluate_heatmap_all_poolings

    accuracy = {}
    for idx in idx_list:
        heatmap = np.load(os.path.join(heatmap_dir, f"{idx}.npy"))
        gt = np.load(os.path.join(ground_truth_dir, f"{idx}.npy"))
        per_pool = evaluate_heatmap_all_poolings(heatmap, gt)
        accuracy[str(idx)] = {p: float(per_pool[p][evaluation_metric]) for p in ALL_POOLINGS}

    stats = {}
    for p in ALL_POOLINGS:
        values = np.asarray([accuracy[str(i)][p] for i in idx_list])
        stats[p] = {
            "mean": float(np.mean(values)),
            "std": float(np.std(values)),
            "min": float(np.amin(values)),
            "max": float(np.amax(values)),
            "median": float(np.percentile(values, q=50)),
            "perc-80": float(np.percentile(values, q=80)),
            "perc-20": float(np.percentile(values, q=20)),
        }

    os.makedirs(output_dir, exist_ok=True)
    col = 17
    footer = ("\n\nRelevance accuracy metric:            " + evaluation_metric
              + "\n\nStatistics computed over data points: " + str(len(idx_list)))
    ordered = sorted(stats, key=lambda k: stats[k]["mean"], reverse=True)
    with open(os.path.join(output_dir, output_name + "_ORDERED.txt"), "w") as f:
        titles = ["pooling_type", "mean", "std", "min", "max", "median", "perc-80", "perc-20"]
        f.write("".join(t.ljust(col) for t in titles) + "\n")
        for k in ordered:
            row = [k] + ["{:4.2f}".format(stats[k][s]) for s in titles[1:]]
            f.write("".join(v.ljust(col) for v in row) + "\n")
        f.write(footer)
    with open(os.path.join(output_dir, output_name + "_FIXED.txt"), "w") as f:
        titles = ["pooling_type", "mean", "std", "median"]
        f.write("".join(t.ljust(col) for t in titles) + "\n")
        for k in ("max-norm", "l2-norm,sq", "l2-norm", "l1-norm", "sum,abs", "sum,pos"):
            row = [k] + ["{:4.2f}".format(stats[k][s]) for s in titles[1:]]
            row[2] = "(" + row[2] + ")"
            f.write("".join(v.ljust(col) for v in row) + "\n")
        f.write(footer)
    with open(os.path.join(output_dir, output_name + "_datapoint"), "w") as f:
        json.dump(accuracy, f, indent=4)
    with open(os.path.join(output_dir, output_name + "_statistic"), "w") as f:
        json.dump(stats, f, indent=4)
    return stats


def run_explain_eval_batch(args) -> int:
    """``explain-eval-batch``: score saved heatmap directories against saved
    GT masks with per-pooling statistics."""
    if getattr(args, "indices", None):
        idx_list = [int(i) for i in args.indices]
    else:
        found = sorted(
            int(os.path.splitext(os.path.basename(p))[0])
            for p in globlib.glob(os.path.join(args.heatmap_dir, "*.npy"))
            if os.path.splitext(os.path.basename(p))[0].isdigit()
        )
        idx_list = found[: args.num_images] if args.num_images else found
    if not idx_list:
        print(f"no <idx>.npy heatmaps under {args.heatmap_dir!r}")
        return 1
    evaluate_heatmap_dirs(args.heatmap_dir, args.ground_truth_dir, args.output_dir, idx_list,
                          output_name=args.output_name, evaluation_metric=args.metric)
    print(f"explain-eval-batch: {len(idx_list)} datapoints, metric "
          f"{args.metric} -> {args.output_dir}")
    return 0


def run_explain_eval(args) -> int:
    """RMA/RRA over VOC JPEG/SegmentationClass pairs; writes the
    ``{method}_{model}_pruning_iteration_{NN}.txt`` contract."""
    spec, model = _load_model(args.model, args.checkpoint, device=getattr(args, "device", None),
                              cmd="explain-eval")
    jpeg_dir = os.path.join(args.voc_root, "JPEGImages")
    pairs = []
    for i, jpg in enumerate(sorted(globlib.glob(os.path.join(jpeg_dir, "*.jpg")))):
        if i == 580:
            break
        mask = jpg.replace("JPEGImages", "SegmentationClass").replace("jpg", "png")
        if os.path.exists(mask):
            pairs.append((jpg, mask))
    pairs = pairs[: args.num_images]
    if not pairs:
        raise FileNotFoundError(f"no JPEG/SegmentationClass pairs under {args.voc_root!r}")

    methods = ["gradcam", "ig"] + (["attention"] if spec.family in TRANSFORMERS else [])
    sums = {m: {"mass": 0.0, "rank": 0.0} for m in methods}
    n = 0
    from PIL import Image

    for jpg, mask_path in pairs:
        img = load_image_normalized(jpg)
        gt = np.asarray(Image.open(mask_path).convert("L"), dtype=np.float64)
        if spec.family in TRANSFORMERS:
            p = spec.patch_size
            ph = int(np.ceil(img.shape[0] / p) * p)
            pw = int(np.ceil(img.shape[1] / p) * p)
            padded = np.zeros((ph, pw, 3), np.float32)
            padded[: img.shape[0], : img.shape[1]] = img
            img = padded
        maps = compute_heatmaps(spec, model, img.astype(np.float32), methods)
        for m in methods:
            hm = maps[m]
            # gradcam/attention: 2D -> pooling None; ig: CHW -> args.pooling
            pooling = None if hm.ndim == 2 else args.pooling
            scores, _gt = evaluate_single(hm, gt, pooling)
            sums[m]["mass"] += float(scores["mass"])
            sums[m]["rank"] += float(scores["rank"])
        n += 1

    os.makedirs(args.output_dir, exist_ok=True)
    name_map = {"gradcam": "gradCAM", "attention": "attention", "ig": "ig"}
    for m in methods:
        write_method_txt(args.output_dir, name_map[m], args.model, args.iteration,
                         sums[m]["mass"] / max(n, 1), sums[m]["rank"] / max(n, 1), n)
    print(f"explain-eval: {n} images, methods {methods} -> {args.output_dir}")
    return 0


def write_method_txt(output_dir: str, method: str, model: str, iteration: int, mass: float,
                     rank: float, n: int) -> str:
    """The per-method running-means txt the reference's plot stage parses
    line by line with ``split(':')[-1]``."""
    fname = f"{method}_{model}_pruning_iteration_{iteration:02}.txt"
    path = os.path.join(output_dir, fname)
    with open(path, "w") as f:
        f.write("Average Mass: " + str(mass) + "\n")
        f.write("Average Rank: " + str(rank) + "\n")
        f.write("On a total of " + str(n) + " images.\n")
    return path
