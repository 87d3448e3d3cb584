"""A/B of the softmax precision in the port's training attention kernels:
the port of ``tools/bench_softmax_prec.py``.

Variants at the ViT-S/16 bf16 train shape (B=128, H=6, T=256, hd=64), the
forward and backward kernels of ``vipers_torch/csrc/attention_train.cu``
in their template instances:

  f32      the train kernels: f32 exp on the scores, p rounded to bf16 for
           P.V and for dV;
  bf16exp  s - m (backward: s - lse) rounded once to bf16 and exponentiated
           on bf16 pairs; l sums the bf16 p in f32; the backward keeps p in
           bf16 for dV and dS;
  normP    p / l rounded to bf16 before P.V, no division after (its
           backward is f32's).

Inputs from seed 0 as the TPU tool makes them: q, k, v and dO standard
normal in bf16, every key valid. Prints the card's name and power limit,
then ms per variant (fwd+bwd, best of 5 windows of 20 steps, CUDA events),
the max-abs deltas of o, dq, dk and dv of bf16exp and normP against f32,
and bf16exp's speedup over f32. Runs on the card:

    python -m vipers_torch.tools.bench_softmax_prec

``--device cpu`` runs the plain versions (host clock) at the shape asked.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

B, H, T, HD = 128, 6, 256, 64
VARIANTS = ("normP", "f32", "bf16exp")  # the TPU tool's order
TAGS = ("o", "dq", "dk", "dv")


def make_step(variant: str):
    """One forward and backward through the kernels (plain versions on the
    CPU) in ``variant``; normP's backward is f32's, as in the TPU tool."""
    from vipers_torch.ops import attention_train as at

    bwd_variant = "f32" if variant == "normP" else variant

    def step(q, k, v, do, ok, scale):
        o, lse = at.attention_train_fwd(q, k, v, ok, scale, variant=variant)
        dq, dk, dv = at.attention_train_bwd(q, k, v, o, lse, do, ok, scale,
                                            variant=bwd_variant)
        return o, dq, dk, dv

    return step


def best_ms(fn, windows: int, iters: int, device: torch.device) -> float:
    """Best over ``windows`` of the mean ms of ``iters`` calls: CUDA events
    on the card, the host clock on the CPU."""
    best = float("inf")
    for _ in range(windows):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / iters)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--heads", type=int, default=H)
    ap.add_argument("--seq", type=int, default=T)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from vipers_torch.core.device import card_line, resolve_device

    dev = resolve_device(args.device)
    print(card_line() if dev.type == "cuda" else "cpu (plain versions)", flush=True)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.heads, args.seq, HD)

    def mk():
        return torch.from_numpy(rng.normal(size=shape)).to(dev, torch.bfloat16)

    q, k, v, do = mk(), mk(), mk(), mk()
    ok = torch.ones((args.batch, args.seq), dtype=torch.bool, device=dev)
    scale = HD ** -0.5

    ms, outs = {}, {}
    for name in VARIANTS:
        step = make_step(name)
        outs[name] = [z.float().cpu() for z in step(q, k, v, do, ok, scale)]
        ms[name] = best_ms(lambda: step(q, k, v, do, ok, scale), args.windows,
                           args.iters, dev)
        print(f"{name}: {ms[name]:.3f} ms fwd+bwd", flush=True)

    # numeric deltas against the f32-softmax kernels (bf16 I/O in all)
    rel = {}
    for name in ("bf16exp", "normP"):
        print(f"{name} against f32:")
        for i, tag in enumerate(TAGS):
            a, c = outs["f32"][i], outs[name][i]
            denom = a.abs().max().item() or 1.0
            delta = (a - c).abs().max().item()
            rel[name, tag] = delta / denom
            print(f"  {tag}: max-abs-delta {delta:.3e} (rel {delta / denom:.3e})")
    print(f"speedup: {ms['f32'] / ms['bf16exp']:.3f}x")
    return {"ms": ms, "rel_delta": rel}


if __name__ == "__main__":
    main()
