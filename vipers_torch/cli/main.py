"""The port's command line (the ``train``, ``evaluate``, ``lost``,
``corloc``, ``cluster``, ``explain``, ``explain-eval``,
``explain-eval-batch``, ``mvh``, ``slim``, ``quantize``, ``export`` and
``plot`` subcommands of ``vipers/cli/main.py``, with the same flags and
defaults, plus ``--device``)::

    python -m vipers_torch.cli.main train --model vit_b_16 --data-path imagenet \
        --pruning-method magnitude --pruning-rate 0.2 --amp --output-dir out
    python -m vipers_torch.cli.main evaluate --model vit_b_16 --data-path imagenet \
        --models-path out --output-dir eval
    python -m vipers_torch.cli.main lost --model vit_s_16 --arch vit \
        --dataset VOC07 --data-path VOC2007 --checkpoint model.pth --dtype bf16
    python -m vipers_torch.cli.main lost --arch resnet --model resnet50 \
        --resnet-dilate 2 --data-path VOC2007 --checkpoint model.pth [--exact-shapes]
    python -m vipers_torch.cli.main lost --arch mobilenet --model mobilenet_v2 \
        --data-path VOC2007 --checkpoint model.pth [--visualize pred] [--dtype int8]
    python -m vipers_torch.cli.main lost --arch swin --model swin_v2_t \
        --data-path VOC2007 --checkpoint swin.pth [--swin-all-windows]
    python -m vipers_torch.cli.main lost --arch dino --model dino_vit_small \
        --patch-size 16 --data-path VOC2007 --checkpoint dino.pth [--dinoseg]
    python -m vipers_torch.cli.main corloc --preds outputs/preds.pkl \
        --dataset VOC07 --data-path VOC2007
    python -m vipers_torch.cli.main cluster --preds outputs/preds.pkl \
        --data-path VOC2007 --checkpoint dino.pth --nb-clusters 20
    python -m vipers_torch.cli.main explain --model resnet50 --checkpoint model.pth \
        --data-path imagenet --methods gradcam guided_gradcam ig attention lrp
    python -m vipers_torch.cli.main explain-eval --model vit_b_16 --checkpoint model.pth \
        --voc-root VOC2012
    python -m vipers_torch.cli.main explain-eval-batch --heatmap-dir maps \
        --ground-truth-dir masks --output-name run
    python -m vipers_torch.cli.main mvh --model resnet50 --checkpoint model.pth \
        --data-path imagenet --pruning-step 3 --output-dir mvh [--stimuli-root stimuli]
    python -m vipers_torch.cli.main slim --model vit_s_16 --checkpoint model.pth \
        --mlp-keep 0.5 --heads-keep 0.5 --output-dir slim   # vit_s_16_slim_m768_h4.pth
    python -m vipers_torch.cli.main quantize --model quantized_mobilenet_v2 \
        --data-path imagenet --resume model.pth --mode ptq --output-dir q
    python -m vipers_torch.cli.main lost --model vit_s_16 --dtype int8 \
        --data-path VOC2007 --checkpoint q/quantized_post_train_model.pth
    python -m vipers_torch.cli.main export --model vit_b_16 --checkpoint model.pth \
        --pipeline lost --dtype bf16 --batch-size 128 --image-size 384 512 \
        --output-dir art --verify     # art/model.pt2 + art/meta.json
    python -m vipers_torch.cli.main plot --kind mass_rank --results-dir explanations_eval \
        --model vit_b_16 --out rma.png

``train``, ``evaluate``, ``lost``, ``cluster``, ``explain``,
``explain-eval``, ``mvh``, ``quantize`` and ``export`` run on the card
unless given ``--device cpu``; there is no silent fallback
(``explain-eval-batch`` scores saved maps with numpy on the host and only
accepts the flag; ``slim`` and ``plot`` are host work and have no flag).
A slimmed checkpoint's ``.slim.json`` sidecar rebuilds the model at its
widths in ``train --resume``, ``evaluate``, ``lost`` and ``explain``.

Every subcommand first joins the process group that torchrun's or SLURM's
environment describes (``parallel.mesh.maybe_initialize_distributed``;
nothing at world size 1), as the JAX CLI does: ``train``, ``evaluate``,
``quantize`` and ``lost`` then run data-parallel, one card a process::

    torchrun --nproc-per-node 8 -m vipers_torch.cli.main train --model resnet50 \
        --data-path imagenet --batch-size 32 --output-dir out   # global batch 256

``train --model-parallel k`` (a ViT's heads and MLP split over k ranks,
``parallel.tp``), ``train --pipeline-parallel S [--pp-microbatch m]
[--pp-remat] [--pp-data D]`` (GPipe over the encoder's layers,
``parallel.pp``) and ``lost --sequence-parallel`` (the tokens split over
the ranks, ``parallel.sp``) run across processes the same way::

    torchrun --nproc-per-node 8 -m vipers_torch.cli.main train --model vit_b_16 \
        --model-parallel 2 --batch-size 32 ...   # 4 data ranks x 2 model ranks

Flags that select what the port does not have yet exit with a message
naming the ROADMAP item that ports it (``quantize --model-parallel`` on a
ViT: A10; DINO training: A2).
"""

from __future__ import annotations

import argparse
import sys


def _save_predictions(s: str) -> bool:
    return s.lower() not in ("false", "0", "no")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vipers_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    from vipers_torch.core.config import add_train_args

    add_train_args(sub.add_parser("train", help="prune + fine-tune a classifier"))
    ev = sub.add_parser("evaluate", help="sweep checkpoints, eval top-1/5")
    add_train_args(ev)
    ev.add_argument("--models-path", default="",
                    help="dir holding the checkpoint sweep to glob; defaults to --output-dir")
    ev.add_argument("--dataset", default="VOC07", choices=["VOC07", "VOC12"],
                    help="detection dataset for --eval-dataset voc")
    ev.add_argument("--set", default="trainval", dest="voc_set",
                    help="detection split for --eval-dataset voc")

    lost = sub.add_parser("lost", help="LOST object discovery + CorLoc")
    lost.add_argument("--model", default="vit_s_16")
    lost.add_argument("--arch", default="vit",
                      help="feature family: vit|dino|swin; any other (resnet, vgg16, "
                           "mobilenet) runs the CNN path")
    lost.add_argument("--dataset", default="VOC07", choices=["VOC07", "VOC12", "COCO20k"])
    lost.add_argument("--set", default="trainval")
    lost.add_argument("--data-path", required=False, default="/data")
    lost.add_argument("--checkpoint", default="",
                      help="a reference .pth/.pt (pruned layers as weight_orig/weight_mask "
                           "or baked); random weights from seed 0 without one")
    lost.add_argument("--patch-size", type=int, default=16)
    lost.add_argument("--which-features", default="k", choices=["k", "q", "v"])
    lost.add_argument("--k-patches", type=int, default=100)
    lost.add_argument("--dinoseg", action="store_true")
    lost.add_argument("--dinoseg-head", type=int, default=4)
    lost.add_argument("--dinoseg-reference-bugs", action="store_true")
    lost.add_argument("--no-hard", action="store_true")
    lost.add_argument("--coco-annotations", default=None,
                      help="COCO instances json (required for COCO20k)")
    lost.add_argument("--coco20k-list", default=None, help="20k filename list")
    lost.add_argument("--output-dir", default="./outputs")
    lost.add_argument("--iteration", type=int, default=0)
    lost.add_argument("--visualize", default=None,
                      choices=[None, "fms", "seed_expansion", "pred"])
    lost.add_argument("--batch-size", type=int, default=8,
                      help="images per LOST batch (per bucket shape)")
    lost.add_argument("--workers", type=int, default=8,
                      help="host decode threads feeding the device")
    lost.add_argument("--host-normalize", action="store_true",
                      help="feed host-normalized float32 (PIL decode) instead of the "
                           "default uint8 feed (libjpeg decode, normalized on the device)")
    lost.add_argument("--image-path", default=None,
                      help="run LOST on one image instead of a dataset (no evaluation, "
                           "no preds.pkl)")
    lost.add_argument("--no-evaluation", action="store_true",
                      help="skip CorLoc scoring and the results txt")
    lost.add_argument("--save-predictions", default=True, type=_save_predictions,
                      help="write preds.pkl (default true)")
    lost.add_argument("--models-dir", default="",
                      help="root of the reference checkpoint sweep; with "
                           "--pruning-iteration, resolves the templated filename")
    lost.add_argument("--pruning-iteration", type=int, default=None,
                      help="sweep iteration: picks the checkpoint under --models-dir "
                           "and stamps results_iteration_NN.txt")
    lost.add_argument("--resnet-dilate", type=int, default=1, choices=[1, 2, 4])
    lost.add_argument("--cnn-bucket", type=int, default=4)
    lost.add_argument("--exact-shapes", action="store_true")
    lost.add_argument("--swin-all-windows", action="store_true")
    lost.add_argument("--strict", action="store_true",
                      help="raise on a seed-in-background image, as the reference does, "
                           "instead of collecting and reporting them at the end")
    lost.add_argument("--dtype", default="f32", choices=["f32", "bf16", "int8"],
                      help="compute dtype of the feature forward")
    lost.add_argument("--data-parallel", action="store_true",
                      help="split the images over the processes of a torchrun or SLURM "
                           "launch (one card a process; alone, the plain run)")
    lost.add_argument("--sequence-parallel", action="store_true",
                      help="shard every forward's tokens over the processes of a torchrun "
                           "or SLURM launch (vit and dino; batch-1 native-resolution LOST)")
    lost.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="cuda (default) runs the kernels; cpu their plain versions")

    corloc = sub.add_parser("corloc", help="re-score saved predictions vs GT")
    corloc.add_argument("--preds", "--pred-file", dest="preds", required=True,
                        help="preds.pkl or detectron json (auto-detected)")
    corloc.add_argument("--dataset", default="VOC07")
    corloc.add_argument("--set", default="trainval")
    corloc.add_argument("--data-path", default="/data")
    corloc.add_argument("--no-hard", action="store_true")
    corloc.add_argument("--coco-annotations", default=None)
    corloc.add_argument("--coco20k-list", default=None)

    device_help = "cuda (default) runs the kernels; cpu their plain versions"
    clus = sub.add_parser("cluster", help="k-means pseudo-labels for discovered boxes")
    clus.add_argument("--preds", "--pred-file", dest="preds", required=True)
    clus.add_argument("--nb-clusters", type=int, default=20)
    clus.add_argument("--data-path", default="/data")
    clus.add_argument("--dataset", default="VOC07")
    clus.add_argument("--set", default="trainval")
    clus.add_argument("--no-hard", action="store_true")
    clus.add_argument("--arch", default="dino_vit_small",
                      help="embedding backbone registry name")
    clus.add_argument("--patch-size", type=int, default=16)
    clus.add_argument("--random-seed", type=int, default=0, help="k-means init seed")
    clus.add_argument("--feature-cache", default="",
                      help="pkl path caching the crop embeddings")
    clus.add_argument("--checkpoint", default="",
                      help="pretrained DINO weights (facebookresearch/dino keys) for the "
                           "crop embedding")
    clus.add_argument("--coco-annotations", default=None)
    clus.add_argument("--coco20k-list", default=None)
    clus.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)

    expl = sub.add_parser("explain", help="attribution heatmaps per checkpoint")
    expl.add_argument("--model", default="resnet50")
    expl.add_argument("--checkpoint", default="")
    expl.add_argument("--data-path", default="/data/imagenet")
    expl.add_argument("--methods", nargs="+",
                      default=["gradcam", "guided_gradcam", "ig", "attention"],
                      help="any of: gradcam guided_gradcam ig attention lrp")
    expl.add_argument("--num-classes-sample", type=int, default=200)
    expl.add_argument("--output-dir", default="./explanations")
    expl.add_argument("--untrained", action="store_true",
                      help="random-init baseline model")
    expl.add_argument("--seed", type=int, default=0,
                      help="init seed for --untrained; stamps the output dir")
    expl.add_argument("--models-path", default="",
                      help="sweep root for --pruning-iteration -1")
    expl.add_argument("--pruning-iteration", type=int, default=None,
                      help="-1 with --models-path: explain every templated "
                           "sweep checkpoint into per-iteration subdirs")
    expl.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)

    ee = sub.add_parser("explain-eval", help="RMA/RRA scoring on VOC masks")
    ee.add_argument("--model", default="vit_b_32")
    ee.add_argument("--checkpoint", default="")
    ee.add_argument("--voc-root", default="/data/VOC2012")
    ee.add_argument("--num-images", type=int, default=101)
    ee.add_argument("--pooling", default="sum,abs")
    ee.add_argument("--iteration", type=int, default=0)
    ee.add_argument("--output-dir", default="./explanations_eval")
    ee.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)

    eeb = sub.add_parser(
        "explain-eval-batch",
        help="directory-batch heatmap evaluation: all six poolings with "
             "summary-statistic tables + JSON")
    eeb.add_argument("--heatmap-dir", required=True,
                     help="directory of <idx>.npy pooled/raw heatmaps")
    eeb.add_argument("--ground-truth-dir", required=True,
                     help="directory of <idx>.npy ground-truth masks")
    eeb.add_argument("--output-dir", default="./explanations_eval")
    eeb.add_argument("--output-name", default="",
                     help="prefix for the _ORDERED/_FIXED txt and "
                          "_datapoint/_statistic JSON artifacts")
    eeb.add_argument("--metric", default="rank", choices=["rank", "mass"])
    eeb.add_argument("--indices", nargs="*", default=None,
                     help="explicit datapoint indices (default: every "
                          "numeric .npy in --heatmap-dir)")
    eeb.add_argument("--num-images", type=int, default=0,
                     help="cap on auto-discovered indices (0 = all)")
    eeb.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="accepted like the other subcommands': the scoring is numpy on "
                          "the host")

    mvh = sub.add_parser("mvh", help="model-vs-human distortion benchmarks")
    add_train_args(mvh)
    mvh.add_argument("--pruning-step", type=int, default=0)
    mvh.add_argument("--checkpoint", default="")
    mvh.add_argument("--stimuli-root", default=None,
                     help="dir with cue-conflict/edge/... stimulus ImageFolders")
    mvh.add_argument("--max-batches", type=int, default=0)

    slim = sub.add_parser(
        "slim",
        help="structured slimming: physically remove MLP neurons / attention heads, "
             "conv channels or ResNet inner channels (pruning/structured.py)")
    slim.add_argument("--model", required=True)
    slim.add_argument("--checkpoint", required=True,
                      help="a .pth (masked weights ok; a slim one's sidecar is read)")
    slim.add_argument("--num-classes", type=int, default=1000)
    slim.add_argument("--mlp-keep", type=float, default=None,
                      help="ViT/Swin: fraction of MLP hidden neurons to keep")
    slim.add_argument("--heads-keep", type=float, default=None,
                      help="ViT: fraction of attention heads to keep")
    slim.add_argument("--conv-keep", type=float, default=None,
                      help="VGG: fraction of conv output channels to keep")
    slim.add_argument("--fc-keep", type=float, default=None,
                      help="VGG: fraction of fc1/fc2 hidden units to keep")
    slim.add_argument("--inner-keep", type=float, default=None,
                      help="ResNet: fraction of each block's residual-free "
                           "inner channels to keep")
    slim.add_argument("--round-to", type=int, default=128,
                      help="align slimmed widths to this multiple (1 disables)")
    slim.add_argument("--output-dir", default=".")

    quant = sub.add_parser("quantize", help="int8 QAT / PTQ")
    add_train_args(quant)
    quant.add_argument("--mode", default="qat", choices=["qat", "ptq"])
    quant.add_argument("--post-training-quantize", action="store_const", const="ptq",
                       dest="mode", help="alias for --mode ptq (train_quantization.py)")
    quant.add_argument("--calibration-batches", "--num-calibration-batches",
                       dest="calibration_batches", type=int, default=32)
    quant.add_argument("--num-observer-update-epochs", type=int, default=4,
                       help="epochs before freezing activation observers "
                            "(train_quantization.py:120-122)")
    quant.add_argument("--num-batch-norm-update-epochs", type=int, default=3,
                       help="epochs before freezing BN statistics "
                            "(train_quantization.py:123-125)")

    exp = sub.add_parser(
        "export",
        help="write a torch.export serving artifact from a (pruned / slimmed / "
             "quantize-calibrated) checkpoint (core/export.py)")
    exp.add_argument("--model", required=True)
    exp.add_argument("--checkpoint", default="",
                     help=".pth; masks baked in, .slim.json sidecar picked up automatically")
    exp.add_argument("--num-classes", type=int, default=0,
                     help="head width when exporting without a checkpoint "
                          "(0 = registry default)")
    exp.add_argument("--batch-size", type=int, default=8,
                     help="static serving batch (one artifact per batch shape)")
    exp.add_argument("--image-size", type=int, nargs=2, default=None, metavar=("H", "W"))
    exp.add_argument("--dtype", default="bf16", choices=["f32", "bf16", "int8"],
                     help="compute dtype; int8 = real integer Dense/Conv with "
                          "observer-calibrated or dynamic qparams")
    exp.add_argument("--platforms", nargs="+", default=None,
                     choices=["cpu", "tpu", "cuda", "rocm"],
                     help="a torch.export program is one device's: only the export "
                          "device's own name (cuda, or cpu under --device cpu) is accepted")
    exp.add_argument("--pipeline", default="classify", choices=["classify", "lost"],
                     help="classify = logits forward; lost = the batched LOST discovery "
                          "program (boxes/seeds out) at a fixed serving shape")
    exp.add_argument("--k-patches", type=int, default=100,
                     help="[lost] seed-expansion pool size")
    exp.add_argument("--which-features", default="k", choices=["k", "q", "v"],
                     help="[lost] qkv feature modality")
    exp.add_argument("--resnet-dilate", type=int, default=1)
    exp.add_argument("--output-dir", required=True)
    exp.add_argument("--verify", action="store_true",
                     help="load the artifact back and check its output against the "
                          "direct forward")
    exp.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)

    plot = sub.add_parser("plot", help="sparsity-vs-metric curves / heatmap reports")
    plot.add_argument("--kind", default="lost",
                      choices=["lost", "mass_rank", "mvh", "mvh-compare", "heatmaps"])
    plot.add_argument("--model", default="resnet50")
    plot.add_argument("--models", nargs="+", default=None,
                      help="[mvh-compare] models to overlay (e.g. resnet18 resnet50)")
    plot.add_argument("--benchmarks", nargs="+", default=None,
                      help="[mvh-compare] benchmark rows to overlay (e.g. silhouette "
                           "colour false-colour)")
    plot.add_argument("--max-prune", type=int, default=26,
                      help="[mvh-compare] pruning steps scanned")
    plot.add_argument("--results-dir", default="./outputs")
    plot.add_argument("--performance-txt", default="performance.txt")
    plot.add_argument("--out", default="plot.png")
    plot.add_argument("--method", default="gradcam",
                      help="[heatmaps] attribution method subdir")
    plot.add_argument("--cls", default="",
                      help="[heatmaps] class subdir; empty = every class found")
    plot.add_argument("--gif", action="store_true",
                      help="[heatmaps] also write animated GIFs")
    return p


def _refuse_unported(args):
    """SystemExit for an unknown ``--model`` (every flag of ``lost`` is
    ported; ``--sequence-parallel``'s checks are the driver's)."""
    from vipers_torch.core.registry import build_model

    try:
        build_model(args.model)
    except ValueError:
        raise SystemExit(f"vipers_torch lost: unknown model {args.model!r}") from None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the rendezvous before any device work (the JAX CLI's order); the host-only
    # subcommands have no --device and join over gloo
    from vipers_torch.parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed(getattr(args, "device", "cpu"))
    if args.cmd == "train":
        from vipers_torch.core.config import config_from_args
        from vipers_torch.train.driver import run

        run(config_from_args(args))
        return 0
    if args.cmd == "evaluate":
        from vipers_torch.core.config import config_from_args
        from vipers_torch.train.evaluate_models import run_sweep

        rows = run_sweep(config_from_args(args), models_path=args.models_path,
                         voc_dataset=args.dataset, voc_set=args.voc_set)
        for acc1, sparsity in rows:
            print(f"acc1 {acc1:.3f}\tsparsity {sparsity:.2f}")
        return 0
    if args.cmd == "lost":
        _refuse_unported(args)
        from vipers_torch.discovery.driver import run_lost

        return run_lost(args)
    if args.cmd == "cluster":
        from vipers_torch.discovery.cluster import run_cluster_cli

        return run_cluster_cli(args)
    if args.cmd == "explain":
        from vipers_torch.explain.driver import run_explain

        return run_explain(args)
    if args.cmd == "explain-eval":
        from vipers_torch.explain.driver import run_explain_eval

        return run_explain_eval(args)
    if args.cmd == "explain-eval-batch":
        from vipers_torch.explain.driver import run_explain_eval_batch

        return run_explain_eval_batch(args)
    if args.cmd == "mvh":
        from vipers_torch.train.mvh_cli import run_mvh_cli

        return run_mvh_cli(args)
    if args.cmd == "slim":
        from vipers_torch.pruning.structured import run_slim_cli

        return run_slim_cli(args)
    if args.cmd == "quantize":
        from vipers_torch.train.quantize import run_quantize

        return run_quantize(args)
    if args.cmd == "export":
        from vipers_torch.core.export import run_export

        return run_export(args)
    if args.cmd == "plot":
        from vipers_torch.viz.plots import run_plot_cli

        return run_plot_cli(args)
    from vipers_torch.discovery.corloc import run_corloc_cli

    return run_corloc_cli(args)


if __name__ == "__main__":
    sys.exit(main())
