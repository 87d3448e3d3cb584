"""The train and evaluate configuration (port of ``vipers/core/config.py``):
``TrainConfig``, ``add_train_args`` and ``config_from_args`` with the JAX
package's flags and defaults, plus ``--device``.

The port runs one process a card. Data parallelism across processes
(torchrun or SLURM, ``parallel.mesh``; ``--data-parallel`` is accepted,
and in one process is the plain run), tensor parallelism
(``--model-parallel k``, ``parallel.tp``) and pipeline parallelism
(``--pipeline-parallel S``, ``--pp-microbatch``, ``--pp-remat``,
``--pp-data``, ``parallel.pp``) are ported; ``train.driver`` checks
their layouts with the JAX driver's messages, and ``evaluate`` ignores
them as the JAX sweep does. ``refuse_unported`` exits, naming the ROADMAP
item that ports it, for a flag that selects what the port does not have
yet: training a DINO backbone (A2, DINO training: they serve LOST and
``cluster`` frozen).
``--profile-dir`` traces the first training run and ``--debug-nans``
fails fast on a NaN (``core.profiling``). Every model of the JAX
registry builds, ``mobilenet_v2`` and the ``quantized_`` aliases
included. ``--resume`` of a
structurally slimmed checkpoint rebuilds the model at its sidecar's
widths (``train.driver.model_spec``). ``--resnet-dilate`` applies to the ResNets; the
other families ignore it, as the JAX package does.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from vipers_torch.data.preprocess import INTERPOLATIONS
from vipers_torch.train.optim import OptimConfig


@dataclasses.dataclass
class TrainConfig:
    # model and data
    model: str = "resnet18"
    data_path: str = "/data/imagenet"
    num_classes: int = 1000
    train_crop_size: int = 224
    val_resize_size: int = 256
    val_crop_size: int = 224
    batch_size: int = 32
    workers: int = 16
    # pruning
    pruning_method: str = "snip"  # snip | magnitude
    target_sparsity: float = 0.9  # SNIP
    pruning_rate: float = 0.2  # magnitude, each iteration
    pruning_threshold: float = 95.0  # magnitude: stop at this % sparsity
    starting_pruning_iteration: int = 0
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    # augmentation
    auto_augment: str = ""  # ra | ta_wide | augmix | imagenet
    ra_magnitude: int = 9
    augmix_severity: int = 3
    interpolation: str = "bilinear"
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    random_erase: float = 0.0
    ra_sampler: bool = False
    ra_reps: int = 3
    cache_dataset: str = ""
    resnet_dilate: int = 1
    eval_dataset: str = "imagenet"  # imagenet | voc
    # EMA
    model_ema: bool = False
    model_ema_steps: int = 32
    model_ema_decay: float = 0.99998
    # runtime
    seed: int = 42
    amp: bool = False  # bf16 compute
    pipeline_parallel: int = 0
    pp_microbatch: int = 0
    pp_remat: bool = False
    pp_data: int = 0
    data_parallel: bool = False
    model_parallel: int = 1
    native_decode: bool = False  # the C++ libjpeg decode (vipers_torch/csrc/decode.cc)
    profile_dir: str = ""
    debug_nans: bool = False
    print_freq: int = 100
    output_dir: str = "./output"
    resume: str = ""
    start_epoch: int = -1  # -1: the resumed checkpoint's epoch + 1
    test_only: bool = False
    metrics_path: Optional[str] = None
    device: str = "cuda"  # cuda | cpu (the kernels' plain versions)


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="resnet18")
    p.add_argument("--data-path", default="/data/imagenet")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--epochs", type=int, default=90)
    p.add_argument("--pruning-method", default="snip", choices=["snip", "magnitude"])
    p.add_argument("--target-sparsity", type=float, default=0.9)
    p.add_argument("--pruning-rate", type=float, default=0.2)
    p.add_argument("--pruning-threshold", type=float, default=95.0)
    p.add_argument("--starting-pruning-iteration", type=int, default=0)
    p.add_argument("--opt", default="sgd")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", "--wd", type=float, default=1e-4, dest="weight_decay")
    p.add_argument("--norm-weight-decay", type=float, default=None)
    p.add_argument("--bias-weight-decay", type=float, default=None)
    p.add_argument("--transformer-embedding-decay", type=float, default=None)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--clip-grad-norm", type=float, default=None)
    p.add_argument("--lr-scheduler", default="steplr")
    p.add_argument("--lr-step-size", type=int, default=30)
    p.add_argument("--lr-gamma", type=float, default=0.1)
    p.add_argument("--lr-min", type=float, default=0.0)
    p.add_argument("--lr-warmup-epochs", type=int, default=0)
    p.add_argument("--lr-warmup-method", default="constant")
    p.add_argument("--lr-warmup-decay", type=float, default=0.01)
    p.add_argument("--auto-augment", default="", help="ra | ta_wide | augmix | imagenet")
    p.add_argument("--ra-magnitude", type=int, default=9, help="RandAugment magnitude")
    p.add_argument("--augmix-severity", type=int, default=3, help="AugMix severity")
    p.add_argument("--interpolation", default="bilinear", choices=list(INTERPOLATIONS),
                   help="PIL resize mode of the train and eval presets; --native-decode "
                        "is bilinear only and uses PIL for the other modes")
    p.add_argument("--mixup-alpha", type=float, default=0.0)
    p.add_argument("--cutmix-alpha", type=float, default=0.0)
    p.add_argument("--random-erase", type=float, default=0.0)
    p.add_argument("--ra-sampler", action="store_true",
                   help="repeated-augmentation sampling")
    p.add_argument("--ra-reps", type=int, default=3,
                   help="repetitions per sample for --ra-sampler")
    p.add_argument("--cache-dataset", default="",
                   help="dir for the sha1-keyed file-listing cache")
    p.add_argument("--resnet-dilate", type=int, default=1, choices=[1, 2, 4],
                   help="replace_stride_with_dilation of the ResNets (dilated evaluation "
                        "sweeps); other families ignore it")
    p.add_argument("--eval-dataset", default="imagenet", choices=["imagenet", "voc"],
                   help="evaluate the sweep on the ImageFolder val split or on VOC")
    p.add_argument("--model-ema", action="store_true")
    p.add_argument("--model-ema-steps", type=int, default=32)
    p.add_argument("--model-ema-decay", type=float, default=0.99998)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--amp", action="store_true", help="bf16 compute")
    p.add_argument("--pipeline-parallel", type=int, default=0,
                   help="GPipe stages of a ViT's encoder, one process a stage")
    p.add_argument("--pp-microbatch", type=int, default=0,
                   help="pipeline microbatch (global rows; 0: the largest divisor of the "
                        "batch not above batch // stages)")
    p.add_argument("--pp-remat", action="store_true",
                   help="recompute each pipelined block in the backward")
    p.add_argument("--pp-data", type=int, default=0,
                   help="data-parallel pipelines (a (data, pipe) grid of processes)")
    p.add_argument("--data-parallel", action="store_true",
                   help="data parallelism over the processes of a torchrun or SLURM "
                        "launch (one card a process; alone, the plain run)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor parallelism: a ViT's heads and MLP split over k processes")
    p.add_argument("--native-decode", action="store_true",
                   help="C++ libjpeg decode (bilinear resize; PIL without libjpeg)")
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler trace (CPU and CUDA) of the first training run")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on the first NaN (FloatingPointError)")
    p.add_argument("--print-freq", type=int, default=100)
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--resume", default="")
    p.add_argument("--start-epoch", type=int, default=-1,
                   help="override the resume epoch; -1 = take it from the checkpoint")
    p.add_argument("--test-only", action="store_true")
    p.add_argument("--train-crop-size", type=int, default=224)
    p.add_argument("--val-resize-size", type=int, default=256)
    p.add_argument("--val-crop-size", type=int, default=224)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) runs the kernels; cpu their plain versions")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    optim = OptimConfig(
        opt=args.opt, lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
        norm_weight_decay=args.norm_weight_decay, bias_weight_decay=args.bias_weight_decay,
        transformer_embedding_decay=args.transformer_embedding_decay,
        label_smoothing=args.label_smoothing, clip_grad_norm=args.clip_grad_norm,
        lr_scheduler=args.lr_scheduler, lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma, lr_min=args.lr_min, lr_warmup_epochs=args.lr_warmup_epochs,
        lr_warmup_method=args.lr_warmup_method, lr_warmup_decay=args.lr_warmup_decay,
        epochs=args.epochs)
    fields = {f.name for f in dataclasses.fields(TrainConfig)} - {"optim", "metrics_path"}
    return TrainConfig(optim=optim, **{k: getattr(args, k) for k in fields})


def refuse_unported(cfg: TrainConfig, cmd: str = "train"):
    """SystemExit naming the ROADMAP item of the first flag in ``cfg`` that
    selects what the port cannot run yet."""
    def no(what, item):
        raise SystemExit(f"vipers_torch {cmd}: {what} is not ported yet (ROADMAP A{item})")

    from vipers_torch.core.registry import build_model

    try:
        spec = build_model(cfg.model)
    except ValueError:
        raise SystemExit(f"vipers_torch {cmd}: unknown model {cfg.model!r}") from None
    if spec.family == "dino_vit":
        no(f"--model {cfg.model} (DINO training)", 2)
