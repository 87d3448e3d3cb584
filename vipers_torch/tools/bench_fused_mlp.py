"""A/B of the port's fused LN->fc1->GELU kernel against the layer_norm ->
linear -> tanh-GELU sequence at the LOST bench shape: the port of
``tools/bench_fused_mlp.py``.

M = 128*896 rows, 384 -> 1536, bf16, seed 0: x standard normal, the
LayerNorm scale 1 + 0.1 N(0, 1) and bias 0.1 N(0, 1), fc1 N(0, 1) / sqrt(D)
with bias 0.1 N(0, 1), and a back-projection (F -> D, N(0, 1) / sqrt(F))
that keeps the chain shape-stable. Each line times ``iters`` chained
applications of ``f(x) @ Wb`` (every output is the next call's input) and
prints ms and TFLOP/s (fc1's product only) an application, best of 3
chains, and ``f`` alone on x (best of 3 rounds of ``iters`` calls):
  * ``seq``: layer_norm with its affine in f32, rounded to bf16, linear
    with bias in bf16, tanh-GELU in f32 (the TPU tool's XLA sequence);
  * ``fused``: the affine folded into W_eff / b_eff, then the kernel
    (``ops/fused_mlp.py``).
``--d`` takes one or more widths D (F = 4D each, the ViT MLP ratio), for
the wider models' kernel instances. Runs on the card:

    python -m vipers_torch.tools.bench_fused_mlp [--iters 12] [--d 384 768 1280]

The tool calls only ``fold_ln_affine`` and
``fused_ln_dense_gelu_core(x, w_eff_t, b_eff, eps)``, so it times another
checkout's kernel when run as a file with that checkout first on
``PYTHONPATH``. ``--device cpu`` runs the plain versions (host clock) at
the ``--m`` asked.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

M, D = 128 * 896, 384


def best_ms(run, x, iters: int) -> float:
    """Milliseconds a call of ``run()``, best of 3 rounds of ``iters`` calls
    (after one untimed round); CUDA events on the card."""
    for _ in range(iters):
        run()
    best = float("inf")
    for _ in range(3):
        if x.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                run()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def chain_ms(f, wb, x, iters: int) -> float:
    """Milliseconds an application of ``f(x) @ wb`` in a chain of ``iters``
    (every output the next input), best of 3 chains."""

    def chain():
        z = x
        for _ in range(iters):
            z = f(z) @ wb
        return z

    return best_ms(chain, x, 1) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--d", type=int, nargs="+", default=[D],
                    help="widths D to run, F = 4D each")
    args = ap.parse_args(argv)

    from vipers_torch.core.device import card_line, resolve_device
    from vipers_torch.ops import fused_mlp as fm

    dev = resolve_device(args.device)
    print(card_line() if dev.type == "cuda" else "cpu (plain versions)", flush=True)
    m, bf16 = args.m, torch.bfloat16
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift)

    ms, alone = {}, {}
    for d in args.d:
        ff = 4 * d
        x = normal(m, d).to(dev, bf16)
        g = normal(d, scale=0.1, shift=1.0).to(dev, bf16)
        b = normal(d, scale=0.1).to(dev, bf16)
        w = normal(d, ff, scale=d ** -0.5).to(dev, bf16)
        bb = normal(ff, scale=0.1).to(dev, bf16)
        wb = normal(ff, d, scale=ff ** -0.5).to(dev, bf16)
        wt = w.t().contiguous()
        flops = 2 * m * d * ff

        def seq(z):
            ln = F.layer_norm(z.float(), (d,), g.float(), b.float(), 1e-6).to(bf16)
            return F.gelu(F.linear(ln, wt, bb).float(), approximate="tanh").to(bf16)

        def fused(z):
            w_eff_t, b_eff = fm.fold_ln_affine(g, b, w, bb, bf16)
            return fm.fused_ln_dense_gelu_core(z, w_eff_t, b_eff, 1e-6)

        with torch.inference_mode():
            for name, f in (("seq", seq), ("fused", fused)):
                key = name if len(args.d) == 1 else f"{name}[D={d}]"
                ms[key] = chain_ms(f, wb, x, args.iters)
                alone[key] = best_ms(lambda: f(x), x, args.iters)
                print(f"{name:6s} D={d:<5d} F={ff:<5d} {ms[key]:8.3f} ms/app  "
                      f"{flops / ms[key] / 1e9:6.1f} TFLOP/s (fc1 matmul only)  "
                      f"alone {alone[key]:8.3f} ms", flush=True)
    return {"ms": ms, "alone_ms": alone}


if __name__ == "__main__":
    main()
