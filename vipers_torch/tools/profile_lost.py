"""Where the time goes in the port's batched LOST pipeline on one GPU.

Builds the same full-width ViT-S/16 (random weights from a seed, 50% global
magnitude mask, 512x384 uint8 images) as ``chip_smoke.py`` and profiles
``make_batched_pipeline`` with ``torch.profiler``: device time by kernel,
the device's busy share of the wall-clock window, and the host time per
call. Needs a card:

    python -m vipers_torch.tools.profile_lost [--batch 128] [--dtype bf16]

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

H, W, PATCH = 512, 384, 16


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "profile_lost"),
                    help="directory for the kernel table and the Chrome trace")
    args = ap.parse_args(argv)

    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.pruning import init_masks, magnitude_prune

    spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W))
    params = spec.init(torch.Generator().manual_seed(0))
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), 0.5)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    ex = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(args.batch)]
    inp = ex.prepare_batch(imgs, PATCH, exact_hw=[(H, W)] * args.batch)
    pipe = ex.make_batched_pipeline(100)
    for _ in range(2):
        pipe(*inp)[0].cpu()

    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            t1 = time.perf_counter()
            pipe(*inp)[0].cpu()
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
    print(f"{card}; {args.dtype} B={args.batch}: {args.steps} calls, wall "
          f"{wall_ms / args.steps:.2f} ms/call (median host {statistics.median(host):.2f}), "
          f"device busy {busy_ms / args.steps:.2f} ms/call = "
          f"{100 * busy_ms / wall_ms:.1f}% of the window, {len(events) / args.steps:.0f} "
          f"kernels/call")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"profile_lost_{args.dtype}_b{args.batch}")
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
