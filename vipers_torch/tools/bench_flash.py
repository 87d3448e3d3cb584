"""The flash attention forward's rows at their main paths' shapes, timed on
one card, for an A/B of two checkouts: head dim 64 at the ViT-S/16 LOST
shape (B*H = 128*6, T = 896, 769 valid keys on every other image),
head-major and packed, and head dim 80 at vit_h_14's (B*H = 128*16, T =
1024, 1009 valid keys), bf16 and f32. Prints the median ms of CUDA events
over ``--reps`` calls, each row beside the package it ran. Needs a card:

    python -m vipers_torch.tools.bench_flash
    PYTHONPATH=<other checkout> python vipers_torch/tools/bench_flash.py

Run as a file, the ``vipers_torch`` that leads ``PYTHONPATH`` is timed, so
two checkouts compare in one call (parent, change, change, parent). A
checkout without the hd-80 instances times the hd-64 rows only.
"""

from __future__ import annotations

import argparse
import statistics

import torch


def cuda_ms(fn, reps: int) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs a CUDA device")
    from vipers_torch.core.device import card_line
    from vipers_torch.ops import flash_attention as fa

    print(card_line())
    print(f"package {fa.__file__}")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(6, 896, 769, 64)]
    if 80 in getattr(fa, "FWD_HEAD_DIMS", (64,)):
        shapes.append((16, 1024, 1009, 80))
    rows = []
    for h, t, n_valid, hd in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(128, h, t, hd, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            valid = torch.ones(128, t, dtype=torch.bool, device="cuda")
            valid[1::2, n_valid:] = False
            name = f"{str(dtype)[6:]} hd{hd}"
            rows.append((f"flash {name}",
                         cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, valid), args.reps)))
            if hd == 64:
                qkv = torch.randn(128, t, 3 * h * hd, generator=g, device="cuda").to(dtype)
                rows.append((f"packed {name}", cuda_ms(
                    lambda: fa.flash_attention_packed_fwd(qkv, valid, h, hd ** -0.5),
                    args.reps)))
            del q, k, v
    print("; ".join(f"{n} {ms:.4f} ms" for n, ms in rows))


if __name__ == "__main__":
    main()
