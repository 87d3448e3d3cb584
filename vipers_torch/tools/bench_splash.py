"""A/B of the port's splash attention instances against its flash kernel at
the LOST attention shape: the port of ``tools/bench_splash.py``.

B=32, H=6, T=896 (769 real tokens before the seq-pad), hd=64, bf16, q, k
and v standard normal from seed 0. Prints the card's name and power limit,
then, each as ms and TFLOP/s per call under dependency-chained timing (every
output is the next call's q, so no two calls overlap):
  * the flash kernel (``ops/flash_attention.py``) with the 769-of-896 valid
    mask and without a mask;
  * every splash instance (``ops/splash_attention.py``): block_q x block_kv
    in {64, 128}^2 with K head-dim-minor, then the layout lines with K
    seq-minor (the transposed copy is made outside the timed loop);
  * each instance's max abs error against an f32 einsum reference on the
    valid query rows, held to 2e-2 of the reference's scale.
Runs on the card:

    python -m vipers_torch.tools.bench_splash

``--device cpu`` runs the plain versions (host clock) at the shape asked.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

B, H, T, HD = 32, 6, 896, 64
VALID_T = 769  # real token count before seq_pad_multiple


def time_chained(fn, q, k, v, *extra, iters: int = 20) -> float:
    """Seconds per call of ``fn`` with each call's q the previous call's
    output (after one untimed chain); CUDA events on the card."""

    def chained():
        qc = q
        for _ in range(iters):
            qc = fn(qc, k, v, *extra).to(q.dtype)
        return qc

    chained()
    if q.device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        chained()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / iters
    t0 = time.perf_counter()
    chained()
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--heads", type=int, default=H)
    ap.add_argument("--seq", type=int, default=T)
    ap.add_argument("--valid", type=int, default=VALID_T)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    from vipers_torch.core.device import card_line, resolve_device
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import splash_attention as sa

    dev = resolve_device(args.device)
    print(card_line() if dev.type == "cuda" else "cpu (plain versions)", flush=True)
    b, h, t = args.batch, args.heads, args.seq
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, HD))).to(dev, torch.bfloat16)
               for _ in range(3))
    valid = (torch.arange(t, device=dev) < args.valid)[None, :].expand(b, t).contiguous()
    scale = HD ** -0.5
    flops = 2 * b * h * t * t * HD * 2  # q k^T + p v

    def line(label, sec):
        print(f"{label}: {sec * 1e3:8.3f} ms  {flops / sec / 1e12:6.1f} TFLOP/s", flush=True)

    ms = {}
    sec = time_chained(lambda q_, k_, v_, m_: fa.flash_attention_fwd(q_, k_, v_, m_, scale)[0],
                       q, k, v, valid, iters=args.iters)
    ms["flash+mask"] = sec * 1e3
    line("flash kernel + valid mask  ", sec)
    sec = time_chained(lambda q_, k_, v_: fa.flash_attention_fwd(q_, k_, v_, None, scale)[0],
                       q, k, v, iters=args.iters)
    ms["flash"] = sec * 1e3
    line("flash kernel no mask       ", sec)

    def make_splash(bq, bkv, layout):
        def run(q_, k_, v_):
            return sa.splash_attention((q_ * scale).to(q_.dtype), k_, v_, bq, bkv, layout)
        return run

    k_of = {"head_dim_minor": k, "seq_minor": k.transpose(-1, -2).contiguous()}
    for bq, bkv, layout in sa.INSTANCES:
        sec = time_chained(make_splash(bq, bkv, layout), q, k_of[layout], v, iters=args.iters)
        ms[sa.instance_name(bq, bkv, layout)] = sec * 1e3
        if layout == "head_dim_minor":
            line(f"splash bq={bq:4d} bkv={bkv:4d}     ", sec)
        else:
            line(f"splash {bq:3d}/{bkv:3d} k-seq-minor ", sec)

    # correctness against an f32 einsum on the valid query rows
    ref_p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    ref = torch.matmul(ref_p, v.float())[:, :, :args.valid]
    ref_scale = ref.abs().max().item()
    errs = {}
    for bq, bkv, layout in sa.INSTANCES:
        out = make_splash(bq, bkv, layout)(q, k_of[layout], v)
        name = sa.instance_name(bq, bkv, layout)
        errs[name] = (out.float()[:, :, :args.valid] - ref).abs().max().item()
        print(f"splash {name} max abs err vs f32 einsum (valid rows, unmasked): "
              f"{errs[name]:.4f} (tol {2e-2 * ref_scale:.4f})")
        if errs[name] > 2e-2 * ref_scale:
            raise AssertionError(f"splash {name}: error {errs[name]} above 2e-2 of "
                                 f"the reference scale {ref_scale}")
    return {"ms": ms, "err": errs}


if __name__ == "__main__":
    main()
