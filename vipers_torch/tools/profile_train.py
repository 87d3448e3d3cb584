"""Where the time goes in the port's masked bf16 train step on one GPU.

Builds a full-width model of the registry (``--model``, default ViT-S/16 as
``chip_smoke.py``'s train phases; ``vit_h_14`` as its phase 11), at
224x224 by default or at ``--image-size`` (ViT-S/16 at 384: T = 577 takes
the flash forward and backward kernels; vit_h_14 at 392: T = 785) (random
weights from a seed, 50% global magnitude masks on unbaked f32 masters
ranked on the card, SGD momentum 0.9, wd 1e-4, lr 0.1 cosine, uint8 images
normalized on the card) and profiles
``make_train_step`` with ``torch.profiler``: device time by kernel, the
device's busy share of the wall-clock window, and the host time per step,
with the host's enqueue time against the wall time of unprofiled windows
beside them (img/s: the best of 3 windows of 6 steps, ``chip_smoke.py``'s
scheme). Needs a card:

    python -m vipers_torch.tools.profile_train [--batch 128] [--steps 3] [--image-size 224]
        [--model vit_h_14 --batch 32]
        [--model resnet50]  # ResNet-50: cuDNN convolutions, BatchNorm, no port kernel
        [--model swin_v2_t --image-size 256]  # Swin-V2-T: eager windows, no port kernel

With ``--data-path`` (an ImageFolder root with ``train/``) it profiles one
epoch of ``vipers_torch train --amp`` instead: the driver's session and
loader (host decode on ``--workers`` threads, uploads, normalize, steps),
and prints the epoch's img/s, the device's busy share of it and the
kernel table, beside the loader alone (decode-only img/s):

    python -m vipers_torch.tools.profile_train --model vit_b_16 --data-path imagenet

Writes the full kernel table and a Chrome trace under ``--out``
(default ``build/profile_train/``), and prints the rows of the port's own
kernels (the ``__global__`` functions of ``vipers_torch/csrc``, such as the
flash backward's row pass, dk/dv and dq kernels) with their sum.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vipers_torch.tools.profile_lost import _intervals_union


def port_kernels() -> set:
    """Names of the port's CUDA kernels: the ``__global__`` functions of
    ``vipers_torch/csrc``."""
    pat = re.compile(r"__global__ void (?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\(")
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    return {n for f in csrc.glob("*.cu*") for n in pat.findall(f.read_text())}


def port_kernel_pattern() -> re.Pattern:
    """Finds a port kernel's name in a profiler row (the name followed by
    its argument list or template arguments)."""
    return re.compile(r"\b(?:%s)[(<]" % "|".join(sorted(port_kernels())))


def _report(prof, wall_ms, n, unit, out_stem):
    """Device busy share of the window and the kernel table (per ``unit``,
    ``n`` of them); writes the table and the Chrome trace to ``out_stem``."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _intervals_union([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
    by_name: dict = {}
    for e in events:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    total = sum(v[0] for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(os.path.dirname(out_stem), exist_ok=True)
    with open(out_stem + ".txt", "w") as f:
        for name, (ms, k) in rows:
            f.write(f"{ms / n:10.3f} ms/{unit} {100 * ms / total:5.1f}% {k // n:5d}x  {name}\n")
    prof.export_chrome_trace(out_stem + ".json")
    return busy_ms, len(events), rows, total


def profile_epoch(args):
    """One epoch of the train CLI's loop (``--amp``) on ``--data-path``,
    profiled, beside the loader alone."""
    from vipers_torch.core.config import TrainConfig
    from vipers_torch.train import driver
    from vipers_torch.train.loop import train_one_epoch

    hw = args.image_size
    cfg = TrainConfig(model=args.model, data_path=args.data_path, batch_size=args.batch,
                      workers=args.workers, amp=True, train_crop_size=hw, val_crop_size=hw,
                      output_dir=os.path.join(args.out, "session"))
    s = driver.build_session(cfg)
    t0 = time.perf_counter()
    n_img = sum(len(lab) for _, lab in driver.train_loader(cfg, s.train_ds, 0))
    dec = n_img / (time.perf_counter() - t0)
    # a warm-up epoch, then the profiled one
    train_one_epoch(s.train_step, s.state, driver._train_loader(s, 0), 0,
                    normalize_fn=s.normalize, print_freq=0)
    torch.cuda.synchronize()
    loader = driver._train_loader(s, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_one_epoch(s.train_step, s.state, loader, 1, normalize_fn=s.normalize,
                        print_freq=0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    steps = len(loader)
    busy_ms, n_ev, rows, total = _report(prof, wall_ms, steps, "step", os.path.join(
        args.out, f"profile_train_epoch_{args.model}_{hw}_b{args.batch}"))
    print(f"{torch.cuda.get_device_name(0)}; train CLI epoch {args.model} bf16 {hw}x{hw} "
          f"B={args.batch}, {args.workers} decode threads: {steps} steps in {wall_ms:.1f} ms "
          f"({steps * args.batch * 1e3 / wall_ms:.1f} img/s, profiled), device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of the epoch, "
          f"{n_ev / steps:.0f} kernels/step; the loader alone {dec:.1f} img/s")
    for name, (ms, k) in rows[:12]:
        print(f"  {ms / steps:9.3f} ms/step {100 * ms / total:5.1f}% {k // steps:5d}x  "
              f"{name[:110]}")


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else v.cuda() for k, v in tree.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=224,
                    help="square training crop (224: the training attention kernels; "
                         "384 at patch 16, 392 at 14: the flash kernels)")
    ap.add_argument("--model", default="vit_s_16")
    ap.add_argument("--out", default=os.path.join("build", "profile_train"),
                    help="directory for the kernel table and the Chrome trace")
    ap.add_argument("--data-path", default="",
                    help="profile one epoch of the train CLI's loop on this ImageFolder")
    ap.add_argument("--workers", type=int, default=8, help="decode threads (--data-path)")
    args = ap.parse_args(argv)
    if args.data_path:
        return profile_epoch(args)

    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    hw = args.image_size
    kw = {"image_size": (hw, hw)} if build_model(args.model).family == "vit" else {}
    spec = build_model(args.model, num_classes=1000, **kw)
    if spec.patch_size and hw % spec.patch_size:
        raise SystemExit(f"--image-size {hw} is not a multiple of {args.model}'s patch "
                         f"size {spec.patch_size}")
    params = spec.init(torch.Generator().manual_seed(0))
    params = _to_cuda(params)  # the ranking's sort on the card
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), 0.5)
    ocfg = OptimConfig(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4, epochs=10,
                       lr_scheduler="cosineannealinglr")
    state = create_train_state(spec, params, masks, ocfg, steps_per_epoch=100)
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (args.batch, hw, hw, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (args.batch,))).cuda()
    x = make_device_normalize()(u8)
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    for _ in range(2):
        state, _ = step(state, (x, labels))
    torch.cuda.synchronize()

    # without the profiler: host time to enqueue the steps against the wall
    # time to finish them (enqueue close to wall = the host bounds the step),
    # in 3 windows of 6 steps
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(6):
            state, _ = step(state, (x, labels))
        enqueue_ms = 1e3 * (time.perf_counter() - t0) / 6
        torch.cuda.synchronize()
        plain_wall_ms = 1e3 * (time.perf_counter() - t0) / 6
        print(f"without the profiler ({hw}x{hw}): {plain_wall_ms:.2f} ms/step wall, host "
              f"enqueue {enqueue_ms:.2f} ms/step ({args.batch * 1e3 / plain_wall_ms:.1f} img/s)")

    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            t1 = time.perf_counter()
            state, m = step(state, (x, labels))
            host.append(1e3 * (time.perf_counter() - t1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    busy_ms, n_ev, rows, total = _report(
        prof, wall_ms, args.steps, "step",
        os.path.join(args.out, f"profile_train_bf16_{hw}_b{args.batch}"))
    card = torch.cuda.get_device_name(0)
    print(f"{card}; bf16 train {hw}x{hw} B={args.batch}: {args.steps} steps, wall "
          f"{wall_ms / args.steps:.2f} ms/step (median host enqueue "
          f"{statistics.median(host):.2f} ms), device busy {busy_ms / args.steps:.2f} ms/step "
          f"= {100 * busy_ms / wall_ms:.1f}% of the window, "
          f"{n_ev / args.steps:.0f} kernels/step, loss {float(m['loss']):.4f}")
    for name, (ms, n) in rows[:25]:
        print(f"  {ms / args.steps:9.3f} ms/step {100 * ms / total:5.1f}% "
              f"{n // args.steps:5d}x  {name[:110]}")
    own = port_kernel_pattern()
    mine = [(name, v) for name, v in rows if own.search(name)]
    print(f"the port's kernels: {sum(v[0] for _, v in mine) / args.steps:.3f} ms/step in "
          f"{sum(v[1] for _, v in mine) // args.steps} launches a step")
    for name, (ms, n) in mine:
        print(f"  {ms / args.steps:9.3f} ms/step {n // args.steps:5d}x  {name[:110]}")


if __name__ == "__main__":
    main()
