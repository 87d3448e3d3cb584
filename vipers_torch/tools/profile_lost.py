"""Where the time goes in the port's LOST pipelines on one GPU.

Builds a full-width model of the registry (``--model``, default ViT-S/16 as
in ``chip_smoke.py``; random weights from a seed, 50% global magnitude
mask) and profiles ``make_batched_pipeline`` on uint8 images that fill the
VOC bucket of a 500x375 image at ``--patch-size`` (512x384 at patch 16 and
32, 504x392 at 14; ``--arch dino`` builds a DINO ViT at that patch size), or
with ``--arch resnet`` / ``vgg16``
``make_batched_cnn_pipeline`` on the canonical input of that bucket
(512x384 at ``--resnet-dilate`` 1, 2 or 4), with ``torch.profiler``: device
time by kernel, the device's busy share of the wall-clock window, and the
host time per call; a ViT or DINO ViT pipeline also prints its MFU (the
analytic forward FLOPs of ``core.flops`` at the measured img/s, against
the H100 SXM's dense bf16 peak). As with ``vipers lost``, the patch size is the
caller's to give. ``--arch swin`` (``--model swin_v2_t``, first window or
``--swin-all-windows``) and ``--exact-shapes`` (a CNN at the image's own
shape) profile the per-image path instead: one host-normalized 500x375
image, tier-1 padded, through ``extract`` -> ``lost`` a call (weights from
a seed with their biases drawn away from zero, so Swin's pad tokens do
not take the seed), and ``--dinoseg`` (a ViT or DINO ViT) through
``extract`` with the last block's attention -> ``dino_seg``. Needs a card:

    python -m vipers_torch.tools.profile_lost [--batch 128] [--dtype bf16|f32|int8] \
        [--model vit_b_16 --patch-size 16]
    python -m vipers_torch.tools.profile_lost --arch resnet --model resnet50 --resnet-dilate 2
    python -m vipers_torch.tools.profile_lost --arch dino --model dino_vit_small \
        [--patch-size 8] [--dinoseg]
    python -m vipers_torch.tools.profile_lost --arch swin --model swin_v2_t [--swin-all-windows]
    python -m vipers_torch.tools.profile_lost --arch resnet --model resnet50 --resnet-dilate 2 \
        --exact-shapes

Writes the full kernel table and a Chrome trace under ``--out``
(default ``build/profile_lost/``).
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _intervals_union(spans):
    spans = sorted(spans)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _biased(params, gen):
    """``params`` with every bias drawn from N(0, 0.02)."""
    from vipers_torch.core.tree import flatten_dict, unflatten_dict

    return unflatten_dict({p: (v + 0.02 * torch.randn(v.shape, generator=gen)
                               if p[-1] == "bias" else v)
                           for p, v in flatten_dict(params).items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", choices=("bf16", "f32", "int8"), default="bf16",
                    help="int8: lost --dtype int8's real int8 Dense/Conv, the rest bf16")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", default="vit_s_16")
    ap.add_argument("--patch-size", type=int, default=16)
    ap.add_argument("--arch", default="vit", choices=("vit", "dino", "resnet", "vgg16", "swin"))
    ap.add_argument("--resnet-dilate", type=int, default=1, choices=(1, 2, 4))
    ap.add_argument("--swin-all-windows", action="store_true")
    ap.add_argument("--exact-shapes", action="store_true",
                    help="a CNN one image at a time at its own shape")
    ap.add_argument("--dinoseg", action="store_true",
                    help="a ViT or DINO ViT one image at a time through dino_seg")
    ap.add_argument("--out", default=os.path.join("build", "profile_lost"),
                    help="directory for the kernel table and the Chrome trace")
    args = ap.parse_args(argv)

    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import bucket_hw
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.pruning import init_masks, magnitude_prune

    patch = args.patch_size
    H, W = bucket_hw(500, 375, patch)
    cnn = args.arch in ("resnet", "vgg16")
    per_image = args.arch == "swin" or args.exact_shapes or args.dinoseg
    kw = ({"dilate": args.resnet_dilate} if args.arch == "resnet" else {}) if cnn else (
        {"num_classes": 1000} if args.arch == "swin" else {"patch_size": patch}
        if args.arch == "dino" else {"num_classes": 1000, "image_size": (H, W)})
    spec = build_model(args.model, **kw)
    gen = torch.Generator().manual_seed(0)
    params = spec.init(gen)
    if per_image:
        params = _biased(params, gen)
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), 0.5)
    dtype = {"bf16": torch.bfloat16, "f32": None, "int8": "int8"}[args.dtype]
    ex = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype,
                              cnn_bucket=1 if per_image else 4,
                              swin_all_windows=args.swin_all_windows,
                              need_attn=args.dinoseg)
    rng = np.random.default_rng(1)
    if per_image:
        from vipers_torch.discovery.lost import dino_seg, lost

        # a 500x375 image (h x w), host-normalized, tier-1 padded
        img = np.zeros((H, W, 3), np.float32)
        img[:500, :375] = rng.normal(size=(500, 375, 3))

        def call():
            feats, dims, valid, scales, attn = ex.extract(img, patch)
            if args.dinoseg:
                dino_seg(attn, dims, patch, head=min(4, attn.shape[1] - 1))
                return
            try:
                lost(feats, dims, scales, (3, 500, 375), k_patches=100, valid_dims=valid)
            except ValueError:  # a seed in the background: the call is complete
                pass
    else:
        if cnn:
            H, W = ex.cnn_bucket_key(H, W)
        imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(args.batch)]
        if cnn:
            inp = ex.prepare_cnn_batch(imgs, (H, W), exact_hw=[(H, W)] * args.batch)
            pipe = ex.make_batched_cnn_pipeline(100)
        else:
            inp = ex.prepare_batch(imgs, patch, exact_hw=[(H, W)] * args.batch)
            pipe = ex.make_batched_pipeline(100)

        def call():
            pipe(*inp)[0].cpu()

    for _ in range(2):
        call()

    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            t1 = time.perf_counter()
            call()
            host.append(1e3 * (time.perf_counter() - t1))
        wall_ms = 1e3 * (time.perf_counter() - t0)

    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    busy_ms = _intervals_union(spans) / 1e3
    by_name: dict = {}
    for e in events:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    total = sum(v[0] for v in by_name.values())
    card = torch.cuda.get_device_name(0)
    shape = f"dilate {args.resnet_dilate}" if args.arch == "resnet" else (
        "" if cnn else f"patch {patch}")
    if per_image:
        shape += " per image" + (", all windows" if args.swin_all_windows else "") + (
            ", dino_seg" if args.dinoseg else "")
    print(f"{card}; {args.model} {H}x{W} {shape} {args.dtype} "
          f"B={1 if per_image else args.batch}: "
          f"{args.steps} calls, wall "
          f"{wall_ms / args.steps:.2f} ms/call (median host {statistics.median(host):.2f}), "
          f"device busy {busy_ms / args.steps:.2f} ms/call = "
          f"{100 * busy_ms / wall_ms:.1f}% of the window, {len(events) / args.steps:.0f} "
          f"kernels/call")
    if not cnn and not per_image:
        # the analytic forward FLOPs of the batch against the card's dense
        # bf16 peak, as tools/profile_lost.py reads a ViT's MFU
        from vipers_torch.core.flops import H100_SXM_BF16_DENSE_PEAK, vit_forward_flops_per_image

        c = spec.cfg
        d, layers, mlp_ratio = ((c.hidden_dim, c.num_layers, c.mlp_dim // c.hidden_dim)
                                if args.arch == "vit" else (c.embed_dim, c.depth, c.mlp_ratio))
        tput = args.batch / (wall_ms / args.steps) * 1e3
        flops = vit_forward_flops_per_image(d=d, layers=layers, mlp_ratio=mlp_ratio,
                                            grid_tokens=(H // patch) * (W // patch), patch=patch)
        print(f"{tput:.1f} img/s, {flops / 1e9:.1f} GFLOP an image: MFU "
              f"{100 * flops * tput / H100_SXM_BF16_DENSE_PEAK:.1f}% of the H100 SXM's dense "
              f"bf16 peak ({H100_SXM_BF16_DENSE_PEAK / 1e12:.0f} TFLOP/s)")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"profile_lost_{args.model}_{args.dtype}_b{args.batch}")
    with open(stem + ".txt", "w") as f:
        for name, (ms, n) in rows:
            f.write(f"{ms / args.steps:10.3f} ms/call {100 * ms / total:5.1f}% "
                    f"{n // args.steps:5d}x  {name}\n")
    prof.export_chrome_trace(stem + ".json")
    for name, (ms, n) in rows[:15]:
        print(f"  {ms / args.steps:9.3f} ms/call {100 * ms / total:5.1f}% "
              f"{n // args.steps:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
