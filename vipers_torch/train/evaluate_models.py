"""Checkpoint sweep evaluation behind ``vipers_torch evaluate`` (port of
``vipers/train/evaluate_models.py``).

Find a pruning sweep's ``.pth`` files, load each (its masks from the
``weight_orig`` / ``weight_mask`` pairs), count the sparsity, evaluate
top-1/5 and append ``{split}/acc1 ... custom_x_axis {sparsity}`` lines to
``{output_dir}/{model}_dilation_{d}.txt``, then write ``performance.txt``.
Structurally slimmed checkpoints (``{model}_slim_*.pth``, flat or under
``{model}/``) are evaluated beside the dense ones, each at its
``.slim.json`` sidecar's widths.

The eval runs in f32 whatever ``--amp`` says, as the JAX sweep builds its
eval step at the default f32 (the train driver's epoch-end eval is the
one that follows ``--amp``); the f32 convolutions run as exact f32
(``models.cnn.exact_f32_convs``, inside the eval step), and on the card
no fused MLP runs (it serves bf16 only). The VOC branch
(``--eval-dataset voc``) scores the classifier on the eval preset of each
annotated VOC image against its first object's class index, as the JAX
package does.

In a data-parallel run (``parallel.mesh``) every rank evaluates its
strided share of the val split or VOC items, the tail padded with sentinel
rows (label -1, left out of every sum), the sums are all-reduced
(``train.loop.evaluate``), and rank 0 alone writes the txt and
``performance.txt``. ``--model-parallel`` and the ``--pp-*`` flags are
accepted and ignored: the sweep runs data-parallel over every rank, as
the JAX sweep builds a data-only mesh.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import re
import types

import numpy as np
import torch

from vipers_torch.core.checkpoint import reference_sweep_stem
from vipers_torch.core.config import TrainConfig, refuse_unported
from vipers_torch.core.device import resolve_device
from vipers_torch.core.metrics import MetricsWriter
from vipers_torch.data.imagefolder import ImageFolder
from vipers_torch.data.preprocess import eval_decode, make_device_normalize
from vipers_torch.data.sampler import shard_indices_for_host
from vipers_torch.parallel import mesh as parallel
from vipers_torch.pruning import compute_sparsity_global, init_masks
from vipers_torch.pruning.structured import arch_sidecar
from vipers_torch.train.loop import evaluate
from vipers_torch.train.optim import OptimConfig
from vipers_torch.train.steps import create_train_state, load_weights, make_eval_step

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _voc_eval_batches(cfg: TrainConfig, normalize_fn, device, dataset: str = "VOC07",
                      split: str = "trainval"):
    """(images, labels) batches of a VOC set on ``device``: the eval preset
    of every annotated image, labelled with its first object's VOC class
    index (0 for a name outside the 20)."""
    from vipers_torch.data.detection import DiscoveryDataset

    ds = DiscoveryDataset(dataset, split, cfg.data_path, no_hard=False)
    items = []
    for path, im_name in ds:
        gt, cls = ds.extract_gt(im_name)
        if gt is None or len(gt) == 0:
            continue
        items.append((path, VOC_CLASSES.index(cls[0]) if cls[0] in VOC_CLASSES else 0))
    world = parallel.world()
    idx = shard_indices_for_host(len(items), world, parallel.rank(), 0, shuffle=False,
                                 pad_with_sentinel=world > 1)
    blank = np.zeros((cfg.val_crop_size, cfg.val_crop_size, 3), np.uint8)
    for i in range(0, len(idx), cfg.batch_size):
        chunk = idx[i: i + cfg.batch_size]
        images = np.stack([blank if j < 0 else
                           eval_decode(items[j][0], cfg.val_resize_size, cfg.val_crop_size,
                                       interpolation=cfg.interpolation) for j in chunk])
        labels = torch.tensor([-1 if j < 0 else items[j][1] for j in chunk], dtype=torch.long,
                              device=device)
        yield normalize_fn(torch.from_numpy(images).to(device)), labels


def _eval_only_session(cfg: TrainConfig, with_val: bool = False,
                       arch_overrides: dict = None, val_ds=None):
    """The model at the EVAL crop (a ResNet with ``--resnet-dilate``; a
    slimmed checkpoint's widths with ``arch_overrides``), its all-ones
    masks, the f32 eval step and the normalize, without the training
    machinery; ``with_val`` also opens ``{data_path}/val`` as an
    ImageFolder (or takes ``val_ds``)."""
    from vipers_torch.train.driver import model_spec

    dev = resolve_device(cfg.device)
    spec = model_spec(cfg, cfg.val_crop_size, arch_overrides)
    params = spec.init(torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(spec, params, init_masks(params, exclude=spec.prune_exclude),
                               OptimConfig(), 1, device=dev)
    if with_val and val_ds is None:
        val_ds = ImageFolder(os.path.join(cfg.data_path, "val"), cache_dir=cfg.cache_dataset)
    return types.SimpleNamespace(cfg=cfg, spec=spec, state=state, val_ds=val_ds, device=dev,
                                 eval_step=make_eval_step(cfg.num_classes,
                                                          compute_dtype=torch.float32),
                                 normalize=make_device_normalize())


def sweep_checkpoints(sweep_dir: str, model: str) -> list:
    """A pruning sweep's checkpoints under ``sweep_dir``, sorted by pruning
    iteration: the reference's ``{sweep_dir}/{model}/model_epoch_*_
    pruning_iteration_NN.pth`` (CNNs) and ``{model}/{model}_epoch_*...``
    (ViTs) and the flat ``{sweep_dir}/{model}_epoch_*_pruning_iteration_*``
    the train driver writes; else any ``*_epoch_*`` checkpoint of the model.
    Then the structurally slimmed ones (``{model}_slim_*``, flat or under
    ``{model}/``; their ``.slim.json`` sidecars are not checkpoints)."""
    patterns = [os.path.join(sweep_dir, model, reference_sweep_stem(model, vit=False)),
                os.path.join(sweep_dir, model, reference_sweep_stem(model, vit=True)),
                os.path.join(sweep_dir, reference_sweep_stem(model, vit=True))]
    found = [p for pat in patterns for p in globlib.glob(pat)]
    ckpts = sorted({p for p in found if re.search(r"pruning_iteration_(\d+)(\.pth|\.pt)?$", p)},
                   key=lambda p: int(re.search(r"pruning_iteration_(\d+)", p).group(1)))
    if not ckpts:
        ckpts = sorted(set(globlib.glob(os.path.join(sweep_dir, f"{model}_epoch_*")))
                       | set(globlib.glob(os.path.join(sweep_dir, model, "*_epoch_*"))))
    ckpts += sorted(p for pat in (os.path.join(sweep_dir, f"{model}_slim_*"),
                                  os.path.join(sweep_dir, model, "*_slim_*"))
                    for p in globlib.glob(pat) if not p.endswith(".json") and p not in ckpts)
    return ckpts


def run_sweep(cfg: TrainConfig, dilation: int = None, models_path: str = "",
              voc_dataset: str = "VOC07", voc_set: str = "trainval"):
    """Evaluate every checkpoint of the sweep in ``models_path`` (default
    ``cfg.output_dir``); returns [(acc1, sparsity)] in sweep order."""
    from vipers_torch.discovery.driver import load_lost_checkpoint
    from vipers_torch.train.driver import DeviceBatches, val_loader

    refuse_unported(cfg, "evaluate")
    dilation = cfg.resnet_dilate if dilation is None else dilation
    voc = cfg.eval_dataset == "voc"
    if voc and cfg.num_classes != len(VOC_CLASSES):
        raise ValueError(
            f"--eval-dataset voc requires num_classes == {len(VOC_CLASSES)} "
            f"(got {cfg.num_classes}): the classifier head must emit VOC "
            "class logits for the accuracy rows to mean anything")
    s = _eval_only_session(cfg, with_val=not voc)
    ckpts = sweep_checkpoints(models_path or cfg.output_dir, cfg.model)
    out_txt = os.path.join(cfg.output_dir, f"{cfg.model}_dilation_{dilation}.txt")
    split = "voc" if voc else "test"
    sessions = {"": (s, s.state.masks)}
    rows = []
    main = parallel.is_main()  # the sums are every rank's: rank 0 writes
    if main:
        os.makedirs(cfg.output_dir, exist_ok=True)
    with open(out_txt if main else os.devnull, "a") as f:
        for ckpt in ckpts:
            # a slimmed checkpoint: a session at its widths, one a distinct
            # architecture in the sweep
            arch = arch_sidecar(ckpt)
            key = json.dumps(arch, sort_keys=True) if arch else ""
            if key not in sessions:
                sub = _eval_only_session(cfg, with_val=not voc, arch_overrides=arch,
                                         val_ds=s.val_ds)
                sessions[key] = (sub, sub.state.masks)
            sess, base_masks = sessions[key]
            params, batch_stats, masks, _ = load_lost_checkpoint(ckpt, sess.spec)
            fam = sess.state.family
            load_weights(sess.state.model, fam, params, batch_stats)
            sess.state.masks = ({k: m.to(sess.device)
                                 for k, m in fam.masks_to_state_dict(masks).items()}
                                if masks else base_masks)
            sparsity = compute_sparsity_global(fam.trees(sess.state.params)[0],
                                               fam.masks_from_state_dict(sess.state.masks))
            if voc:
                acc1, acc5, loss = evaluate(
                    sess.eval_step, sess.state,
                    _voc_eval_batches(cfg, sess.normalize, sess.device, voc_dataset, voc_set))
            else:
                acc1, acc5, loss = evaluate(
                    sess.eval_step, sess.state,
                    DeviceBatches(val_loader(cfg, sess.val_ds), sess.device, "val"),
                    normalize_fn=sess.normalize, expected_samples=len(sess.val_ds))
            for name, val in (("acc1", acc1), ("acc5", acc5), ("loss", loss)):
                f.write(f"{split}/{name} {val} custom_x_axis {sparsity}\n")
            rows.append((acc1, sparsity))
            print(f"{ckpt}: sparsity {sparsity:.2f}% acc1 {acc1:.3f}")
    if rows and main:
        MetricsWriter.export_performance_txt(os.path.join(cfg.output_dir, "performance.txt"),
                                             rows)
    parallel.barrier()
    return rows
