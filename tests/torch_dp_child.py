"""One process of ``tests/test_torch_multiprocess.py``: ``vipers_torch``'s
``train``, ``evaluate``, ``quantize --mode ptq`` and ``lost`` CLIs in a
row, on the CPU, one rank of a torchrun-style launch (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) or
a lone process::

    python tests/torch_dp_child.py DATA VOC OUT BATCH REF

DATA is a 2-class ImageFolder (train/, val/), VOC a VOC-style tree, OUT
this run's output root, BATCH the per-process batch and REF the root of
the one-process run whose train checkpoints ``evaluate``, ``quantize``
and ``lost`` read (OUT itself in the one-process run). A tiny ViT
(patch 8, 2 blocks, D 64, 2 heads, dropout 0.1) is registered as
``vit_dp_tiny``. Each stage's stdout lines starting with ``Test:``,
``PTQ`` or ``corloc`` are echoed as ``STAGE <name> <line>``.
"""

import contextlib
import io
import os
import sys

import torch

torch.set_num_threads(1)

import vipers_torch.core.registry as treg  # noqa: E402
import vipers_torch.models.vit as tvit  # noqa: E402
from vipers_torch.cli.main import main  # noqa: E402

NAME = "vit_dp_tiny"


def _register():
    treg._ensure_builtins_imported()

    def build(num_classes=1000, image_size=(224, 224), representation_size=None, **kw):
        cfg = tvit.ViTConfig(8, 2, 2, 64, 128, num_classes, dropout_rate=0.1,
                             representation_size=representation_size)
        return tvit._build(NAME, cfg, image_size)

    treg._BUILTIN_MODELS[NAME] = build


def _run(stage, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    for line in buf.getvalue().splitlines():
        if line.startswith(("Test:", "PTQ", "corloc")):
            print(f"STAGE {stage} {line}", flush=True)
    assert rc == 0, (stage, rc)


def run(data, voc, out, batch, ref):
    common = ["--data-path", data, "--num-classes", "2", "--batch-size", str(batch),
              "--train-crop-size", "32", "--val-resize-size", "40", "--val-crop-size", "32",
              "--workers", "1", "--seed", "0", "--device", "cpu", "--print-freq", "0"]
    # SNIP on a BatchNorm net, with RandomErasing and mixup/cutmix on the device side
    _run("train_resnet", ["train", "--model", "resnet18", *common, "--epochs", "2",
                          "--pruning-method", "snip", "--target-sparsity", "0.5",
                          "--lr", "0.01", "--random-erase", "0.5", "--mixup-alpha", "0.2",
                          "--cutmix-alpha", "1.0", "--data-parallel",
                          "--output-dir", os.path.join(out, "resnet")])
    # LRR on a BatchNorm-free net with dropout and SGD momentum
    _run("train_vit", ["train", "--model", NAME, *common, "--epochs", "1",
                       "--pruning-method", "magnitude", "--pruning-rate", "0.5",
                       "--pruning-threshold", "40", "--lr", "0.01",
                       "--output-dir", os.path.join(out, "vit")])
    _run("evaluate", ["evaluate", "--model", "resnet18", *common,
                      "--models-path", os.path.join(ref, "resnet"),
                      "--output-dir", os.path.join(out, "eval")])
    _run("quantize", ["quantize", "--model", "resnet18", *common, "--mode", "ptq",
                      "--calibration-batches", "2",
                      "--resume", os.path.join(ref, "resnet", "resnet18_epoch_1_snip_0.5.pth"),
                      "--output-dir", os.path.join(out, "quant")])
    _run("lost", ["lost", "--model", NAME, "--patch-size", "8", "--data-path", voc,
                  "--checkpoint",
                  os.path.join(ref, "vit", f"{NAME}_epoch_0_pruning_iteration_00.pth"),
                  "--batch-size", "2", "--workers", "1", "--device", "cpu",
                  "--data-parallel", "--output-dir", os.path.join(out, "lost")])
    import vipers_torch.parallel.mesh as mesh

    print(f"DONE rank {mesh.rank()} world {mesh.world()}", flush=True)


if __name__ == "__main__":
    _register()
    data, voc, out, batch, ref = sys.argv[1:6]
    run(data, voc, out, int(batch), ref)
