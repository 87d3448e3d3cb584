"""The pruning drivers behind ``vipers_torch train`` (port of
``vipers/train/driver.py``), one card a process, for every registered family
(``model_spec``: a ViT or a Swin at the train crop, a ResNet with
``--resnet-dilate``).

- SNIP (``run_snip``): prune once on the first train batch, then train to
  completion.
- Iterative magnitude pruning, LRR (``run_magnitude``): while the sparsity
  is below the threshold, train to completion with a fresh optimizer and LR
  schedule, prune ``pruning_rate`` of the remaining weights by global
  magnitude and bake the masks into the weights; ``performance.txt`` gets
  one (acc1, sparsity) row per iteration.

A ``Session`` holds the model built at the train crop, its masks,
optimizer and EMA, the train and eval steps (bf16 under ``--amp``), the
device-side normalize (RandomErasing), mixup/cutmix and the metrics
stream. Batches are decoded on the host (``data.imagefolder``) and go to
the device as uint8. Checkpoints are the port's ``.pth``
(``core.checkpoint.save_train_checkpoint``) under the JAX driver's stems:
``{model}_epoch_{e}_{method}_{tag}.pth`` every 10 epochs and at the last,
and the rolling ``{model}_checkpoint_{method}_{tag}.pth`` every epoch.
``resume_session`` reads one back. ``--resume`` of a structurally slimmed
checkpoint (``vipers_torch slim``) builds the model at its ``.slim.json``
sidecar's widths, and every checkpoint such a session writes carries the
same sidecar.

``--profile-dir`` wraps the first training run (SNIP's, LRR's first
pruning iteration) in ``core.profiling.device_trace`` and ``--debug-nans``
runs the session under ``enable_nan_check``, at the JAX driver's sites.

Data parallelism (``parallel.mesh``; torchrun or SLURM, one process a
card): ``--batch-size`` is per process and a step takes the global batch
of P * B; each rank decodes its batch-interleaved share
(``data.sampler.shard_indices_for_host``) with generators keyed on the
global stream position, so the ranks' batches are the single process's
global batch; the gradients are averaged over the ranks, BatchNorm reduces
over the global batch and the random draws are the global batch's, so P
ranks train as one process at P * B does. Steps per epoch and the EMA
decay count the global batch; SNIP's saliencies come from the first global
batch (``global_snip_masks``); LRR's masks come out the same on every rank, as the parameters do;
the eval shares are padded with sentinel rows and their sums all-reduced.
Rank 0 alone writes the checkpoints, ``metrics.jsonl`` and
``performance.txt``, and the others wait for it; ``--resume`` reads on
every rank. ``--data-parallel`` in one process is the plain run (one card
a process).

Model parallelism (``parallel_layout``; ViTs only, the JAX driver's checks
and messages): ``--model-parallel k`` factors the W processes into data
W / k x model k (``parallel.tp``: each rank holds H / k heads and F / k MLP
columns, momentum and masks split with their weights);
``--pipeline-parallel S [--pp-data D]`` into data D x pipe S
(``parallel.pp``: each rank one stage of L / S blocks, GPipe over
``--pp-microbatch``, ``--pp-remat``; the epoch-end eval pipelined too).
Ranks of one model group or pipeline read the same batch; the data group
shares the global batch as above. SNIP's saliencies come from rank 0's
pass of the whole model (gathered) on the gathered global batch, so the
masks are the one process's bit for bit; that pass needs the whole model
and the global batch on one card. LRR's threshold comes from the gathered
weights. A checkpoint is the whole model's (gathered; the keys and shapes
of a one-process run), and ``--resume`` of any checkpoint cuts it to the
rank's part. ``LAST_RUN`` holds the first train and val batches and the
times of the last ``run``, for callers that check or time it.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
import types
from functools import partial
from typing import Dict, Optional

import torch

from vipers_torch.core.checkpoint import family, load_train_checkpoint, save_train_checkpoint
from vipers_torch.core.config import TrainConfig, refuse_unported
from vipers_torch.core.profiling import device_trace, enable_nan_check, nan_errors
from vipers_torch.core.device import resolve_device
from vipers_torch.core.metrics import MetricsWriter
from vipers_torch.core.registry import build_model, build_module
from vipers_torch.data.imagefolder import ImageFolder, ImageFolderLoader
from vipers_torch.data.mixup import mixup_cutmix_batch
from vipers_torch.data.preprocess import eval_decode, make_device_normalize, train_decode
from vipers_torch.data.sampler import epoch_indices, ra_sampler_indices, shard_indices_for_host
from vipers_torch.pruning import compute_sparsity_global, init_masks
from vipers_torch.models import cnn
from vipers_torch.parallel import mesh as parallel
from vipers_torch.parallel.pp import (PipelineParallel, check_pipeline, make_pp_eval_step,
                                      make_pp_train_step)
from vipers_torch.parallel.tp import TensorParallel, check_tensor_parallel
from vipers_torch.pruning.snip import snip_loss, snip_saliency, snip_threshold
from vipers_torch.pruning.structured import arch_sidecar, write_sidecar
from vipers_torch.train.ema import ema_decay_for
from vipers_torch.train.loop import (evaluate, magnitude_pruning_round,
                                     train_model_to_completion)
from vipers_torch.train.optim import MaskedOptimizer
from vipers_torch.train.steps import (TrainState, create_train_state, load_weights,
                                      make_eval_step, make_train_step)

# the last run's first batches and times (see the module docstring)
LAST_RUN: dict = {}


@dataclasses.dataclass
class Session:
    """Everything a pruning run needs, wired once."""

    cfg: TrainConfig
    spec: object
    state: TrainState
    train_step: object
    eval_step: object
    eval_step_ema: object
    normalize: object
    mixup: Optional[object]
    writer: MetricsWriter
    train_ds: ImageFolder
    val_ds: ImageFolder
    device: torch.device
    # the widths of a session resumed from a slimmed checkpoint: every
    # checkpoint it writes carries them in a .slim.json sidecar
    arch_overrides: Optional[dict] = None
    # a model-parallel rank's view of the whole model (parallel.tp / .pp)
    layout: Optional[object] = None


def model_spec(cfg: TrainConfig, crop: int, arch_overrides: Optional[dict] = None):
    """``cfg.model`` at ``cfg.num_classes``: a ViT with its pos-embeddings
    at ``crop`` x ``crop``, a Swin built for ``crop`` x ``crop`` inputs, a
    ResNet with ``--resnet-dilate``; at a slimmed checkpoint's widths
    where ``arch_overrides`` are given."""
    kw = {"num_classes": cfg.num_classes}
    if arch_overrides:
        kw["arch_overrides"] = arch_overrides
    fam = build_model(cfg.model).family
    if fam == "vit":
        kw["image_size"] = (crop, crop)
    elif fam == "swin":
        kw["input_size"] = (crop, crop)
    elif cfg.resnet_dilate != 1 and cfg.model.startswith("resnet"):
        kw["dilate"] = cfg.resnet_dilate
    return build_model(cfg.model, **kw)


def parallel_layout(cfg: TrainConfig, spec):
    """The model-parallel layout of ``cfg`` (JAX's checks and messages) with
    its process grid made: a ``TensorParallel`` for ``--model-parallel``
    above 1, a ``PipelineParallel`` for ``--pipeline-parallel`` above 1,
    else None (the grid cleared: data parallelism over every rank)."""
    w = parallel.world()
    if cfg.pipeline_parallel > 1:
        check_pipeline(spec, cfg, w)
        parallel.make_grid(cfg.pipeline_parallel, "pipe")
        return PipelineParallel(spec, parallel.inner_group(), parallel.inner_rank(),
                                cfg.pipeline_parallel, cfg.pp_microbatch, cfg.pp_remat)
    if cfg.model_parallel > 1:
        k = cfg.model_parallel
        check_tensor_parallel(spec, k, w, cfg.model)
        parallel.make_grid(k, "model")
        print(f"train mesh: data={w // k} x model={k} over {w} devices, {w} processes")
        return TensorParallel(spec, parallel.inner_group(), parallel.inner_rank(), k)
    parallel.make_grid(1)
    return None


def build_session(cfg: TrainConfig, params=None, cmd: str = "train") -> Session:
    """The session of ``cfg``; ``params`` (a flax-layout tree) replaces
    the model's initial weights, which are otherwise drawn from
    ``cfg.seed``; running statistics start at mean 0 and var 1. ``cmd``
    names the subcommand in ``refuse_unported``'s message; only ``train``
    takes the model-parallel layouts (``evaluate`` and ``quantize`` run
    the plain or data-parallel session)."""
    refuse_unported(cfg, cmd)
    dev = resolve_device(cfg.device)
    arch = arch_sidecar(cfg.resume)
    if arch:
        print(f"slim architecture: {arch}")
    spec = model_spec(cfg, cfg.train_crop_size, arch)
    layout = parallel_layout(cfg, spec) if cmd == "train" else None
    if spec.family in ("vit", "swin") and cfg.val_crop_size != cfg.train_crop_size:
        # pos-embeddings are sized at construction: the epoch-end eval would
        # fail after a full epoch of training (the JAX driver refuses every
        # builder that takes the input size, Swin's too)
        raise SystemExit(
            f"{cfg.model}: --val-crop-size ({cfg.val_crop_size}) must equal "
            f"--train-crop-size ({cfg.train_crop_size}) — this family's "
            "pos-embeddings are sized at construction; pass matching crop sizes "
            "(CNN families accept any eval size)")
    if params is None:
        params = spec.init(torch.Generator().manual_seed(cfg.seed))
    masks = init_masks(params, exclude=spec.prune_exclude)
    train_ds = ImageFolder(os.path.join(cfg.data_path, "train"), cache_dir=cfg.cache_dataset)
    val_ds = ImageFolder(os.path.join(cfg.data_path, "val"), cache_dir=cfg.cache_dataset)
    # one step takes the global batch (--batch-size is per process and data rank)
    world = parallel.data_world()
    steps_per_epoch = max(len(train_ds) // (cfg.batch_size * world), 1)
    rank_spec = spec
    if layout is not None:
        # this rank's part of the whole model's initial weights and masks
        fam = family(spec)
        params = fam.trees(layout.part(fam.state_dict(params)))[0]
        masks = fam.masks_from_state_dict(layout.part(fam.masks_to_state_dict(masks)))
        rank_spec = layout.rank_spec
    state = create_train_state(rank_spec, params, masks, cfg.optim, steps_per_epoch,
                               device=dev, ema=cfg.model_ema)
    if layout is not None:
        layout.wire(state.model)
        state.opt.sq_norm = layout.sq_norm
    ema_decay = (ema_decay_for(cfg.model_ema_decay, world, cfg.batch_size, cfg.model_ema_steps,
                               cfg.optim.epochs) if cfg.model_ema else None)
    compute_dtype = torch.bfloat16 if cfg.amp else torch.float32
    ls = cfg.optim.label_smoothing
    mixup = None
    if cfg.mixup_alpha > 0 or cfg.cutmix_alpha > 0:
        mixup = partial(mixup_cutmix_batch, num_classes=cfg.num_classes,
                        mixup_alpha=cfg.mixup_alpha, cutmix_alpha=cfg.cutmix_alpha)
    if isinstance(layout, PipelineParallel):
        train_step = make_pp_train_step(layout, cfg.num_classes, ls, compute_dtype)
        eval_step = make_pp_eval_step(layout, cfg.num_classes, ls, compute_dtype)
    else:
        train_step = make_train_step(cfg.num_classes, ls, compute_dtype, ema_decay=ema_decay,
                                     ema_every=cfg.model_ema_steps,
                                     ema_warmup_steps=cfg.optim.lr_warmup_epochs
                                     * steps_per_epoch, seed=cfg.seed)
        eval_step = make_eval_step(cfg.num_classes, ls, compute_dtype)
    return Session(
        cfg=cfg, spec=spec, state=state, train_step=train_step, eval_step=eval_step,
        eval_step_ema=make_eval_step(cfg.num_classes, ls, compute_dtype, use_ema=True),
        normalize=make_device_normalize(random_erase_prob=cfg.random_erase), mixup=mixup,
        writer=MetricsWriter((cfg.metrics_path or os.path.join(cfg.output_dir, "metrics.jsonl"))
                             if parallel.is_main() else None),
        train_ds=train_ds, val_ds=val_ds, device=dev, arch_overrides=arch, layout=layout)


class DeviceBatches:
    """A loader's numpy batches as (uint8 images, int64 labels) tensors on
    ``device`` (pinned host copies, uploads that do not wait). Keeps the
    first batch of each ``kind`` and the time of the first decode in
    ``LAST_RUN``."""

    def __init__(self, loader: ImageFolderLoader, device: torch.device, kind: str):
        self.loader, self.device, self.kind = loader, device, kind

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        LAST_RUN.setdefault("t_first_decode", time.time())
        cuda = self.device.type == "cuda"
        for images, labels in self.loader:
            LAST_RUN.setdefault(f"first_{self.kind}_batch", (images, labels))
            LAST_RUN[f"{self.kind}_images"] = LAST_RUN.get(f"{self.kind}_images", 0) + len(labels)
            x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
            if cuda:
                x = x.pin_memory().to(self.device, non_blocking=True)
                y = y.pin_memory().to(self.device, non_blocking=True)
            yield x, y


def train_loader(cfg: TrainConfig, ds: ImageFolder, epoch: int) -> ImageFolderLoader:
    """Epoch ``epoch``'s train batches (numpy): the sampler's stream (with
    ``--ra-sampler`` the repeated-augmentation stream), this rank's share in
    a data-parallel run, RandomResizedCrop + flip (+ the auto-augment
    policy), the last partial batch dropped. The ranks of a model group or
    pipeline (one data rank) read the same batches."""
    world, rank = parallel.data_world(), parallel.data_rank()
    if cfg.ra_sampler:
        idx = ra_sampler_indices(len(ds), epoch, seed=cfg.seed, repetitions=cfg.ra_reps,
                                 num_replicas=world, rank=rank)
    elif world > 1:
        # drop_last as the loader: no padded global batch of repeats
        idx = shard_indices_for_host(len(ds), world, rank, epoch, seed=cfg.seed,
                                     batch_size=cfg.batch_size, drop_last=True)
    else:
        idx = epoch_indices(len(ds), epoch, seed=cfg.seed)
    kw = dict(crop_size=cfg.train_crop_size, auto_augment=cfg.auto_augment,
              ra_magnitude=cfg.ra_magnitude, augmix_severity=cfg.augmix_severity)
    if cfg.native_decode and cfg.interpolation == "bilinear":  # the C++ decode is bilinear only
        from vipers_torch.data import native

        decode = partial(native.decode_train, **kw)
    else:
        decode = partial(train_decode, interpolation=cfg.interpolation, **kw)
    return ImageFolderLoader(ds, idx, cfg.batch_size, decode_fn=decode, num_workers=cfg.workers,
                             drop_last=True, seed=cfg.seed + epoch, rank=rank, world=world)


def val_loader(cfg: TrainConfig, ds: ImageFolder) -> ImageFolderLoader:
    """The val split in order (numpy): resize, center crop, every image
    (a data-parallel rank's strided share, its tail padded with sentinel
    rows)."""
    world = parallel.data_world()
    idx = shard_indices_for_host(len(ds), world, parallel.data_rank(), 0, shuffle=False,
                                 pad_with_sentinel=world > 1)
    if cfg.native_decode and cfg.interpolation == "bilinear":
        from vipers_torch.data import native

        def decode(p, rng):
            return native.decode_eval(p, cfg.val_resize_size, cfg.val_crop_size)
    else:
        def decode(p, rng):
            return eval_decode(p, cfg.val_resize_size, cfg.val_crop_size,
                               interpolation=cfg.interpolation)
    return ImageFolderLoader(ds, idx, cfg.batch_size, decode_fn=decode,
                             num_workers=cfg.workers, drop_last=False)


def _train_loader(s: Session, epoch: int) -> DeviceBatches:
    return DeviceBatches(train_loader(s.cfg, s.train_ds, epoch), s.device, "train")


def _val_loader(s: Session) -> DeviceBatches:
    return DeviceBatches(val_loader(s.cfg, s.val_ds), s.device, "val")


def _snip_loss_fn(s: Session):
    """SNIP's loss: the train forward of the dense model in f32 (the
    params' dtype; BatchNorm on the batch's statistics, the updated running
    statistics dropped; stochastic depth drawn from ``--seed``) and the
    cross-entropy with the run's label smoothing."""
    return snip_loss(s.spec, s.cfg.num_classes, s.cfg.optim.label_smoothing,
                     batch_stats=s.state.batch_stats, seed=s.cfg.seed)


def _whole(s: Session, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole model's entries from this rank's ``sd`` (a collective
    under a model-parallel layout; ``sd`` itself otherwise)."""
    return sd if s.layout is None else s.layout.full(sd)


def _flax_params(s: Session) -> dict:
    """The whole model's parameters as a flax tree (gathered under a
    model-parallel layout: every rank of the group calls it)."""
    st = s.state
    return st.family.trees(_whole(s, {k: v.detach() for k, v in st.params.items()}))[0]


def _sparsity(s: Session) -> float:
    return compute_sparsity_global(_flax_params(s),
                                   s.state.family.masks_from_state_dict(_whole(s, s.state.masks)))


def _whole_optimizer(s: Session) -> MaskedOptimizer:
    """An optimizer over the whole model's parameters on the meta device:
    the numbering of a one-process checkpoint's optimizer state."""
    with torch.device("meta"):
        module = build_module(s.spec)
    fam = s.state.family
    return MaskedOptimizer(s.cfg.optim, module, fam.trees(dict(module.named_parameters()))[0],
                           lambda count: 0.0, fam.state_key)


def _map_named_state(named: Dict[str, dict], fn) -> Dict[str, dict]:
    """``fn`` ({name: tensor} -> {name: tensor}: a layout's ``full`` or
    ``part``) applied to each per-parameter state tensor of ``named``;
    scalars (step counts) and None entries are the same for every
    parameter and carried over."""
    keys = sorted({k for st in named.values() for k, v in st.items()
                   if torch.is_tensor(v) and v.dim()})
    scalars = {k: v for st in named.values() for k, v in st.items() if k not in keys}
    out: Dict[str, dict] = {}
    for key in keys:
        for n, t in fn({n: st[key] for n, st in named.items() if key in st}).items():
            out.setdefault(n, dict(scalars))[key] = t
    return out


def _whole_state(s: Session):
    """What ``save_train_checkpoint`` reads of the session's state, for the
    whole model: the state itself, or under a model-parallel layout its
    parts gathered (a collective: every rank calls it)."""
    st, lay = s.state, s.layout
    if lay is None:
        return st
    named = _map_named_state(st.opt.named_state(), lay.full)
    opt = _whole_optimizer(s).state_dict_from(named, st.opt.count)
    return types.SimpleNamespace(
        family=st.family, params=lay.full({k: v.detach() for k, v in st.params.items()}),
        batch_stats={}, masks=lay.full(st.masks), step=st.step,
        opt=types.SimpleNamespace(state_dict=lambda: opt),
        ema_params=None if st.ema_params is None else lay.full(st.ema_params),
        ema_batch_stats=None)


def _link_or_copy(src: str, dst: str):
    """``dst`` replaced atomically by another name of the file ``src`` (a
    hard link, or a copy where the file system has none): the rolling
    latest checkpoint written in the same epoch as the epoch's file."""
    tmp = dst + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _checkpoint_fn(s: Session, method: str, tag):
    """``save(state, epoch, sparsity, latest=False)``: the epoch's file, or
    the rolling latest (a hard link to the epoch's file when that was just
    written from the same state); with the session's ``.slim.json``
    sidecar beside it when it was resumed from a slimmed checkpoint."""
    cfg = s.cfg
    written = {}

    def save(state, epoch, sparsity, latest=False):
        name = (f"{cfg.model}_checkpoint_{method}_{tag}" if latest
                else f"{cfg.model}_epoch_{epoch}_{method}_{tag}")
        path = os.path.join(cfg.output_dir, name + ".pth")
        copy = latest and written.get("epoch") == epoch
        # the whole model's state (gathered from the ranks' parts under a
        # model-parallel layout): rank 0 writes, the others wait for the file
        whole = None if copy else _whole_state(s)
        if parallel.is_main():
            if copy:
                _link_or_copy(written["path"], path)
            else:
                save_train_checkpoint(path, whole, epoch, sparsity)
            if s.arch_overrides:
                write_sidecar(path, cfg.model, s.arch_overrides)
        if not latest:
            written.update(epoch=epoch, path=path)
        parallel.barrier()
        LAST_RUN["t_last_checkpoint"] = time.time()

    return save


def _loop_args(s: Session):
    """The positional arguments of ``train_model_to_completion`` (and of
    ``magnitude_pruning_round``) for the session, and the keywords every
    run shares."""
    cfg = s.cfg
    return ((s.train_step, s.eval_step, s.state, lambda e: _train_loader(s, e),
             lambda: _val_loader(s), cfg.optim.epochs),
            dict(normalize_fn=s.normalize, print_freq=cfg.print_freq,
                 eval_step_ema=s.eval_step_ema if cfg.model_ema else None,
                 expected_eval_samples=len(s.val_ds), mixup_fn=s.mixup, writer=s.writer))


def snip_saliencies(s: Session, batch=None, params=None) -> dict:
    """SNIP's saliencies {flax path: |w| * |dL/dw|} of the dense model
    (``params``, by default the session's) on ``batch`` (uint8 images,
    labels), by default epoch 0's first train batch."""
    images, labels = next(iter(_train_loader(s, 0))) if batch is None else batch
    params = _flax_params(s) if params is None else params
    # deterministic: the masks repeat run to run, and on rank 0 of a data-parallel run
    with cnn.exact_f32_convs(), cnn.deterministic_convs():
        return snip_saliency(_snip_loss_fn(s), params, (s.normalize(images), labels),
                             masks=init_masks(params, exclude=s.spec.prune_exclude))


def snip_masks(s: Session, saliencies: dict) -> dict:
    """The masks (state-dict keys) that keep the weights whose saliency lies
    above the threshold of ``--target-sparsity``."""
    thr = snip_threshold(saliencies, s.cfg.target_sparsity)
    return s.state.family.masks_to_state_dict({p: v > thr for p, v in saliencies.items()})


def train_snip(s: Session, initial_epoch: int = 0):
    """Train the session's SNIP masks to completion. Returns (sparsity,
    last acc1)."""
    cfg = s.cfg
    sparsity = _sparsity(s)
    print(f"Sparsity after SNIP pruning: {sparsity:.2f}%")
    s.writer.write("prune", step=0, method="snip", sparsity=sparsity)
    args, kw = _loop_args(s)
    with device_trace(cfg.profile_dir):
        s.state, acc1 = train_model_to_completion(
            *args, initial_epoch=initial_epoch, seed=cfg.seed,
            checkpoint_fn=_checkpoint_fn(s, "snip", cfg.target_sparsity), sparsity=sparsity,
            **kw)
    return sparsity, acc1


def global_snip_masks(s: Session) -> dict:
    """SNIP's masks from epoch 0's first global batch. In a data-parallel
    run the ranks' first batches are gathered, rank 0 takes the saliencies
    of the whole global batch alone (as one process at the global batch
    does, bit for bit where the kernels are deterministic) and hands the
    masks to every rank. Rank 0's pass holds the global batch's f32
    activations, P times a rank's: past what one card holds (README,
    "Data parallelism"), lower ``--batch-size``. Each rank taking its
    share with the gradients averaged would scale, but the sums' other
    order moves saliencies across the threshold (BatchNorm's f32 variance
    and the ReLU gates amplify it), so its masks would not be the one
    process's. Under a model-parallel layout the batch is gathered over the
    data group, the whole model's weights from the ranks' parts, and each
    rank keeps its part of the masks: the whole model and the global batch
    must fit rank 0's card."""
    if parallel.world() <= 1:
        return snip_masks(s, snip_saliencies(s))
    images, labels = next(iter(_train_loader(s, 0)))
    group = parallel.data_group()
    batch = (torch.cat(parallel.all_gather_tensor(images, group=group)),
             torch.cat(parallel.all_gather_tensor(labels, group=group)))
    params = _flax_params(s)
    masks = None
    if parallel.is_main():
        with parallel.solo():
            masks = {k: m.cpu() for k, m in
                     snip_masks(s, snip_saliencies(s, batch, params)).items()}
    masks = parallel.broadcast_object(masks)
    if s.layout is not None:
        masks = s.layout.part(masks)
    return {k: m.to(s.device) for k, m in masks.items()}


def run_snip(s: Session, initial_epoch: int = 0):
    """SNIP: prune once on the first (global) train batch unless resuming,
    then train to completion. Returns (sparsity, last acc1)."""
    if initial_epoch == 0:
        s.state.masks = global_snip_masks(s)
    return train_snip(s, initial_epoch)


def run_magnitude(s: Session, resuming: bool = False, initial_epoch: int = 0):
    """LRR: while the sparsity is below the threshold, train to completion
    (a fresh optimizer and schedule each iteration, except the first when
    resuming mid-iteration, which continues at ``initial_epoch``), prune
    ``pruning_rate`` of the remaining weights, bake. Writes
    ``performance.txt``; returns (sparsity, [(acc1, sparsity) per
    iteration])."""
    cfg = s.cfg
    sparsity = _sparsity(s)
    it = cfg.starting_pruning_iteration
    rows = []
    first = True
    while sparsity < cfg.pruning_threshold:
        print(f"Pruning iteration: {it} (sparsity {sparsity:.2f}%)")
        cont = first and resuming
        first = False
        args, kw = _loop_args(s)
        # --profile-dir traces the first pruning iteration
        with device_trace(cfg.profile_dir if it == cfg.starting_pruning_iteration else None):
            # the file-name contract: {model}_epoch_{e}_pruning_iteration_{NN}
            s.state, acc1, pruned = magnitude_pruning_round(
                *args, cfg.pruning_rate, reset=not cont,
                initial_epoch=initial_epoch if cont else 0, seed=(cfg.seed, it),
                checkpoint_fn=_checkpoint_fn(s, "pruning_iteration", f"{it:02d}"),
                sparsity=sparsity, layout=s.layout, **kw)
        rows.append((acc1, sparsity))
        sparsity = pruned
        s.writer.write("prune", step=it, method="magnitude", sparsity=sparsity)
        it += 1
    if parallel.is_main():
        MetricsWriter.export_performance_txt(os.path.join(cfg.output_dir, "performance.txt"),
                                             rows)
    return sparsity, rows


def resume_session(s: Session, path: str) -> int:
    """Restore the weights, running statistics, masks, optimizer, step
    count and EMA from the port's ``.pth``; returns the epoch to continue
    from. A checkpoint without the port's optimizer state (a reference
    ``.pth``) restores the weights, statistics and masks only."""
    ck = load_train_checkpoint(path, s.spec)
    st, lay = s.state, s.layout
    fam = st.family
    part = (lambda sd: sd) if lay is None else lay.part
    if lay is None:
        load_weights(st.model, fam, ck["params"], ck["batch_stats"])
    else:  # a whole model's checkpoint (one process's or gathered): this rank's part
        st.model.load_state_dict({**dict(st.model.named_buffers()),
                                  **part(fam.state_dict(ck["params"]))})
    st.masks = {**st.masks, **{k: m.to(s.device)
                               for k, m in part(fam.masks_to_state_dict(ck["masks"])).items()}}
    opt = ck["optimizer"]
    if isinstance(opt, dict) and "count" in opt:
        if lay is None:
            st.opt.load_state_dict(opt)
        else:
            named = _whole_optimizer(s).named_state(opt)
            st.opt.load_named_state(_map_named_state(named, part), opt["count"])
    st.step = ck["step"]
    if ck["ema_params"] is not None and st.ema_params is not None:
        ema = part(fam.state_dict(ck["ema_params"], ck["ema_batch_stats"]))
        with torch.no_grad():
            for k, v in ema.items():
                (st.ema_params if k in st.ema_params else st.ema_batch_stats)[k].copy_(v)
    start_epoch = ck["epoch"] + 1
    print(f"Resumed from {path} at epoch {start_epoch} (sparsity {ck['sparsity']:.2f}%)")
    return start_epoch


def run(cfg: TrainConfig):
    """``vipers_torch train``: build the session, resume if asked
    (``--resume``'s epoch overrides ``--start-epoch``), then ``--test-only``
    evaluation, SNIP or LRR. ``--debug-nans`` turns the NaN sanitizer on
    before the session is built, and off again when the run ends."""
    LAST_RUN.clear()
    refuse_unported(cfg)
    resolve_device(cfg.device)  # no card and no --device cpu: raise before writing anything
    try:
        if not cfg.debug_nans:
            return _run(cfg)
        enable_nan_check(True)
        try:
            with nan_errors():
                return _run(cfg)
        finally:
            enable_nan_check(False)
    finally:
        parallel.make_grid(1)  # the next command in this process starts without a grid


def _run(cfg: TrainConfig):
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = build_session(cfg)
    start_epoch = cfg.start_epoch if cfg.start_epoch >= 0 else 0
    if cfg.resume:
        start_epoch = resume_session(s, cfg.resume)
    if cfg.test_only:
        return evaluate(s.eval_step, s.state, _val_loader(s), normalize_fn=s.normalize)
    if cfg.pruning_method == "snip":
        return run_snip(s, initial_epoch=start_epoch)
    if cfg.pruning_method == "magnitude":
        return run_magnitude(s, resuming=bool(cfg.resume), initial_epoch=start_epoch)
    raise ValueError(f"Unsupported pruning method {cfg.pruning_method!r}")
