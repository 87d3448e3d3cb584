"""Quickest proof that the PyTorch/CUDA port (``vipers_torch``) runs on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions,
     both TF32 switches (cuBLAS matmuls, cuDNN convolutions);
  2. build: the six CUDA sources of ``vipers_torch/csrc``, one nvcc each,
     in parallel;
  3. kernels against their plain PyTorch versions at their main path's
     shapes (flash attention f32 and bf16, the flash backward f32 and bf16
     at the 384x384 train shape, packed token-major attention f32
     and bf16, fused LN->fc1->GELU bf16, the training attention forward and
     backward bf16 and their softmax-precision variants, every splash
     instance): max error against the stated tolerance (each variant also
     clearly nearer its own plain version than f32's), kernel / plain /
     library times (CUDA events, median), and the bound from the work's
     FLOPs and bytes; for the flash, flash backward, packed, fused-MLP and
     splash kernels also TFLOP/s and the share of the bound, and for flash
     and packed the attention tile's shape (bf16: query rows, key tile,
     stages; f32: query rows, key stage, raw and split stages, TF32
     products a product) and in f32 the shares of both the 3xTF32 and the
     FMA bounds (the kernels JSON's f32 bound is the 3xTF32 one); for the
     flash backward also the share of the bound of the seven products its
     split does and its design (tiles, stages, kernels), and in f32 the
     shares of both bounds and the error of the plain version under cuBLAS
     TF32, which the kernel must beat tenfold; for the fused MLP its design
     (rows a CTA, column tile, stages); for the training kernels the share
     of the bound and their design (tiles, chunk, stages); more checks the
     main path does not run: the training kernels at T = 640 (the two-pass
     forward and the backward's key rounds) and the fused MLP at vit_b's
     and vit_h's widths (D = 768 and 1280, F = 4D; timed, beside the
     library's sequence); then the ViT family's rows: the flash forward's
     hd-80 instances (f32 and bf16) at vit_h_14's LOST shape (B*H =
     128*16, T = 1024 with 1009 valid keys, bucket-pad keys on every other
     image, one image all invalid; SDPA with the bool mask as the library
     call) and the fused MLP at D = 768 and 1024 (M = 128*896) and 1280 (M
     = 128*1024); then vit_h_14's train rows at hd 80: the training
     forward and backward at its 224x224 shape (B*H = 32*16, T = 384 with
     257 valid keys) and the flash backward f32 and bf16 at its 392x392
     shape (B*H = 16*16, T = 896 with 785 valid keys, the last image
     attending no key);
  4. LOST path: full-width ViT-S/16 (12 layers, D=384, 6 heads, mlp 1536)
     from a seeded generator, 50% global magnitude mask, 512x384 uint8
     images, ``make_batched_pipeline`` in f32 and bf16 at B=128 on an
     exact-fit and a mixed-size bucket; the launch counters must show every
     block went through the kernels; B=4 against the same extractor on the
     CPU (plain versions); img/s at B=128 and p50 latency at B=1;
  5. packed LOST path: the same pipeline on the mixed-size bucket with
     ``VIPERS_PACKED_ATTENTION=1``: 12 packed and 0 flash launches per
     forward (and 12 fused MLP in bf16), f32 features within 2e-4 of the
     default route's scale with equal boxes; bf16 img/s and p50 of both
     routes on both buckets;
  6. JPEG -> boxes -> CorLoc: ``vipers_torch.cli.main lost`` in this
     process on a VOC07-layout tree of symlinks to the committed fixture
     (``tests/data/torch_voc``), with a full-width ViT-S/16 (seed 0, 50%
     global magnitude mask) written as a reference .pth in the
     weight_orig/weight_mask form, B=128, 8 decode threads: bf16 on 1024
     images, f32 on 256, bf16 on 256 under ``VIPERS_PACKED_ATTENTION=1``;
     preds.pkl one entry per image not reported as a seed-in-background
     failure, the results txt equal to ``corloc`` re-scoring, 12 attention
     and (bf16) 12 fused-MLP launches per batch, tail batches included, the
     first batch's boxes equal to ``make_batched_pipeline`` on the same
     decoded uint8 batch; e2e img/s (first decode to preds.pkl), the
     decode-only rate on 8 threads and on 1, the CPU count and the decoder
     (libjpeg or PIL). With
     neither libjpeg nor PIL on the host the phase says so and is skipped;
  7. train path: the masked bf16 train step of full-width ViT-S/16 at
     224x224 (T=197 seq-padded to 256), 1000 classes, SGD momentum with a
     cosine LR, uint8 images normalized on the card: 12 forward and 12
     backward launches of the training attention kernels per step, finite
     losses, pruned slots unchanged, img/s at B=128, card vs CPU at B=4,
     one LRR round;
  8. flash train path: the same step at 384x384 (T=577 seq-padded to 640,
     at least ``flash_min_t()``): 12 flash forward and 12 flash backward
     launches per step and none of the training kernels, finite losses,
     pruned slots unchanged, img/s at B=128, card vs CPU at B=2 (f32 params
     after 2 steps through the f32 flash kernels, counted; bf16 loss and
     gradients);
  9. the A/B tools at their shapes: ``vipers_torch.tools.bench_softmax_prec``
     (the softmax-precision variants), ``vipers_torch.tools.bench_splash``
     (the splash instances against the flash kernel) and
     ``vipers_torch.tools.bench_fused_mlp`` (the fused MLP against the
     layer_norm -> linear -> GELU sequence), their lines printed;
 10. ViT family LOST, full width, random weights from seed 0, pos tables
     at 224x224 interpolated to each bucket as ``vipers_torch lost`` does:
     ViT-B/16 (12 layers, D 768, 12 heads, mlp 3072; 50% global magnitude
     mask) at 512x384 in f32 and bf16 on an exact-fit and a mixed bucket
     (12 flash and 12 fused-MLP launches at D = 768 a bf16 batch), card vs
     CPU at B=4, img/s and p50; ``vipers_torch.cli.main lost --model
     vit_b_16 --patch-size 16 --dtype bf16`` from a pruned .pth on phase
     6's 1024 JPEGs (launches, first batch against the pipeline, the
     results txt against ``corloc``, e2e img/s); vit_b_32 bf16 at patch 32
     (T = 193: 0 flash, 12 fused-MLP launches a batch); vit_l_16 bf16 (24
     flash, 24 fused MLP at D = 1024); vit_h_14 (32 layers, D 1280, 16
     heads of 80) at 504x392 (T = 1009 -> 1024) in f32 and bf16 (32 hd-80
     flash launches a batch, 32 fused MLP at D = 1280 in bf16), bf16 img/s
     and p50, one f32 call's time, card vs CPU on its first 8 blocks at
     B=2 (the cut printed);
 11. vit_h_14 pruned and trained, full width and depth (32 blocks, D
     1280, 16 heads of 80, mlp 5120, 1000 classes, seed-0 weights, 50%
     global magnitude masks ranked on the card): phase 7's masked bf16
     step at 224x224 B=32 (T = 257 -> 384: 32 hd-80 training forward and
     backward launches a step, no flash, no fused MLP; img/s, peak device
     memory; one LRR round, 50% -> 60%) and phase 8's at 392x392 B=16 (T =
     785 -> 896: 32 hd-80 flash forward and backward a step), each card vs
     CPU on its first 8 blocks at B=2 (f32 params after 2 steps within
     1e-4, at 392 through the f32 hd-80 flash kernels, counted; bf16 loss
     and gradients); SNIP at 392 in f32: card vs CPU on the 8-block cut
     (masks at the target sparsity, equal up to threshold ties), then at
     full depth, B=8, on the card (32 f32 hd-80 flash forward and backward
     launches), then 2 bf16 steps from its masks.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last is a JSON object listing the kernels (the rows
phase 6 drove also carry its launches as ``cli_launches``); the last is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H, W, PATCH = 512, 384, 16
BATCH = 128
SPARSITY = 0.5
K_PATCHES = 100
N_CPU = 4
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 outside them, HBM3
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
PEAK_TF32 = 494.7e12  # TF32 tensor cores, dense: the f32 flash kernels' 3xTF32 products
TRAIN_HW, TRAIN_BATCH = 224, 128
TRAIN_HW_FLASH = 384  # the ViT/DeiT fine-tuning resolution: T = 577 takes flash
N_JPEG, N_JPEG_SHORT = 1024, 256  # JPEG -> CorLoc runs: bf16, then f32 and packed bf16
REPO = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
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


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_tile(fa, dtype, head_dim=64):
    """The attention forward tile's shape for ``dtype`` at ``head_dim`` as
    compiled, for the flash and packed lines."""
    d = fa.tile_shape(dtype, head_dim)
    if dtype == torch.bfloat16:
        return "; tile {block_q} x {block_k}, {stages} stages".format(**d)
    return ("; tile {block_q} queries x {block_k}-key stages, {stages} raw stages, "
            "{split_stages} split stages, every product {tf32_products} TF32 products "
            "(3xTF32)".format(**d))


def forward_bound(flops, nbytes, dtype, ms):
    """The bound of an attention forward of ``flops`` and ``nbytes`` and the
    kernel's share of it: bf16 on the bf16 tensor cores; f32 as 3xTF32
    (three times the FLOPs on the TF32 tensor cores), with the share of
    the FMA bound beside it. Returns (bound ms, bounded by, text)."""
    if dtype == torch.bfloat16:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        return bms, by, f"{bms / ms:.1%} of the bound"
    bms, by = bound(3 * flops, nbytes, PEAK_TF32)
    fma_ms = bound(flops, nbytes, PEAK_F32)[0]
    return bms, by, (f"{bms / ms:.1%} of its 3xTF32 bound {bms:.3f} ms, {fma_ms / ms:.1%} of "
                     f"its FMA bound {fma_ms:.3f} ms")


def bwd_design(fa, dtype, hd=64):
    """The flash backward's design for ``dtype`` at ``hd`` as compiled, for
    its line."""
    d = fa.bwd_design(dtype, hd)
    arith = (f"; every product {d['tf32_products']} TF32 products (3xTF32)"
             if d["tf32_products"] else "")
    return (f"; {d['kernels']} kernels after a row pass (D, lse in log2 units): dk/dv on "
            f"{d['dkv_keys']}-key tiles over {d['dkv_queries']}-query stages, "
            f"{d['dkv_stages']} stages; dq on {d['dq_queries']}-query tiles over "
            f"{d['dq_keys']}-key stages, {d['dq_stages']} stages{arith}")


def check_flash(fa, dtype, gen):
    """Flash kernel vs plain at (B*H = 128*6, T = 896, hd = 64) with a
    ragged key mask: 769 real tokens padded to 896, and a bucket-pad
    pattern on every other image."""
    b, h, t, hd = BATCH, 6, 896, 64
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :769] = True
    grid = valid[1::2, 1:769].view(-1, 32, 24)
    grid[:, 29:, :] = False
    grid[:, :, 22:] = False
    out, lse = fa.flash_attention_fwd(q, k, v, valid)
    want, want_lse = fa.flash_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        tol = f"atol 1e-5 rtol 1e-4; lse {lse_err:.2e} (atol 1e-4 rtol 1e-4)"
    else:
        scale = want.float().abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        tol = f"2e-2 of output scale {scale:.3g}; lse {lse_err:.2e} (atol 1e-3)"
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, valid))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, valid), reps=5)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    elt = q.element_size()
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * elt + lse.numel() * 4 + valid.numel()
    bms, by, shares = forward_bound(flops, nbytes, dtype, ms)
    name = "f32" if dtype == torch.float32 else "bf16"
    print(f"flash_attention_fwd[{name}] max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.0f} TFLOP/s, {shares}{attention_tile(fa, dtype)}) "
          f"plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
    return {"name": f"flash_attention_fwd[{name}]", "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_fwd.cu",
            "replaces": "vipers/ops/flash_attention.py:91",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def check_flash_hd80(fa, dtype, gen):
    """The flash kernel's hd-80 instance vs plain at vit_h_14's LOST shape:
    B*H = 128*16, T = 1024 (the 504x392 VOC bucket at patch 14: 1009 tokens,
    seq-padded), hd = 80, with bucket-pad keys on every other image and one
    image whose keys are all invalid. Tolerances as at hd 64; the library
    call is SDPA with the bool mask."""
    b, h, t, hd = BATCH, 16, 1024, 80
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :1009] = True
    grid = valid[1::2, 1:1009].view(-1, 28, 36)
    grid[:, 25:, :] = False
    grid[:, :, 33:] = False
    valid[-1] = False
    key = fa.launch_key(dtype, hd)
    n0 = fa.LAUNCHES[key]
    out, lse = fa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert fa.LAUNCHES[key] == n0 + 1, fa.LAUNCHES
    want, want_lse = fa.flash_attention_plain(q, k, v, valid)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        tol = f"atol 1e-5 rtol 1e-4; lse {lse_err:.2e} (atol 1e-4 rtol 1e-4)"
    else:
        scale = want.float().abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        tol = f"2e-2 of output scale {scale:.3g}; lse {lse_err:.2e} (atol 1e-3)"
    del want, want_lse
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, valid))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, valid), reps=3, warmup=1)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4 + valid.numel()
    bms, by, shares = forward_bound(flops, nbytes, dtype, ms)
    name = f"flash_attention_fwd[{'f32' if dtype == torch.float32 else 'bf16'}, hd80]"
    print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.0f} TFLOP/s, {shares}{attention_tile(fa, dtype, hd)}) "
          f"plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB) at B*H = {b}*{h}, T = {t} "
          f"(1009 valid keys), hd {hd}")
    return {"name": name, "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_fwd.cu",
            "replaces": "vipers/ops/flash_attention.py:91",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def check_flash_bwd(fa, dtype, gen, shape=(TRAIN_BATCH, 6, 640, 64), n_valid=577, ragged=300):
    """Flash backward kernel vs plain at the 384x384 train shape: B*H =
    128*6, T = 640 (577 tokens seq-padded; a ragged run of pad keys inside
    the 577, from key 300, on every other image; the last image attends no
    key), hd = 64 (or ``shape``, ``n_valid`` tokens, pad keys from
    ``ragged``: vit_h_14's 392x392 train shape at hd 80), residuals from the
    forward kernel, cotangents on every row (so the kernel is held to the
    plain version on every row): each of dq, dk, dv within 1e-4 (f32) or
    2e-2 (bf16) of its scale, and two calls bit-equal. f32: the plain
    version in exact f32 (cuBLAS TF32 off), and the kernel at least 10x
    nearer it than the same plain version in cuBLAS TF32 (one TF32 product
    a product, the yardstick). Library: ``torch.autograd.grad`` of SDPA with
    the bool mask."""
    b, h, t, hd = shape
    f32 = dtype == torch.float32
    q, k, v, cot = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(dtype)
                    for _ in range(4))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n_valid] = True
    valid[1::2, ragged:n_valid:3] = False
    valid[-1] = False
    scale = hd ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, valid, scale)
    args = (q, k, v, valid, out, lse, cot, scale)
    key = fa.launch_key(dtype, hd)
    n0 = fa.BWD_LAUNCHES[key]
    got = fa.flash_attention_bwd(*args)
    again = fa.flash_attention_bwd(*args)
    assert fa.BWD_LAUNCHES[key] == n0 + 2, fa.BWD_LAUNCHES
    assert not torch.backends.cuda.matmul.allow_tf32, "the plain reference must be exact f32"
    want = fa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again)), "backward not deterministic"
    frac = 1e-4 if f32 else 2e-2
    errs = [scaled_err(a, c, frac) for a, c in zip(got, want)]
    yard = ""
    if f32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = fa.flash_attention_bwd_plain(*args)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        y_errs = [(y.float() - c.float()).abs().max().item() for y, c in zip(tf32, want)]
        near = min(ye / e if e else float("inf") for ye, (e, _) in zip(y_errs, errs))
        assert near >= 10, (near, y_errs, errs)
        yard = (f"; cuBLAS-TF32 yardstick {max(y_errs):.3e}, worst "
                f"{max(ye / sc for ye, (_, sc) in zip(y_errs, errs)):.2e} of a scale, the "
                f"kernel {near:.0f}x nearer f32")
    ms = cuda_ms(lambda: fa.flash_attention_bwd(*args))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), reps=5)
    lib_ms = sdpa_bwd_ms(q, k, v, cot, valid[:, None, None, :])
    n = q.numel()
    flops = 10 * b * h * t * t * hd  # the function: five T x T x hd products
    nbytes = 8 * n * q.element_size() + lse.numel() * 4 + valid.numel()
    # both instances split dk/dv from dq as the library does: S and dP twice
    design_flops = 14 * b * h * t * t * hd
    name = f"flash_attention_bwd[{'f32' if f32 else 'bf16'}{'' if hd == 64 else f', hd{hd}'}]"
    if f32:
        # every f32 product is three TF32 products on the tensor cores
        bms, by = bound(3 * flops, nbytes, PEAK_TF32)
        design_ms = bound(3 * design_flops, nbytes, PEAK_TF32)[0]
        fma_ms, fma_design_ms = (bound(f, nbytes, PEAK_F32)[0] for f in (flops, design_flops))
        shares = (f"{bms / ms:.1%} of its 3xTF32 bound {bms:.3f} ms, {fma_ms / ms:.1%} of its FMA "
                  f"bound {fma_ms:.3f} ms; {design_flops / ms / 1e9:.0f} TFLOP/s done, "
                  f"{design_ms / ms:.1%} of the 3xTF32 bound {design_ms:.3f} ms and "
                  f"{fma_design_ms / ms:.1%} of the FMA bound {fma_design_ms:.3f} ms of the "
                  f"{design_flops / 1e9:.1f} GFLOP the split does")
    else:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        design_ms = bound(design_flops, nbytes, PEAK_BF16)[0]
        shares = (f"{bms / ms:.1%} of its bound; {design_flops / ms / 1e9:.0f} TFLOP/s done, "
                  f"{design_ms / ms:.1%} of the bound of the {design_flops / 1e9:.1f} GFLOP the "
                  f"split does, {design_ms:.3f} ms")
    print(f"{name} max_abs_err {max(e for e, _ in errs):.3e} ({frac:g} of each of dq, dk, dv's "
          f"scale ({', '.join(f'{sc:.3g}' for _, sc in errs)}); worst "
          f"{max(e / sc for e, sc in errs):.2e} of it; two calls bit-equal{yard}) kernel "
          f"{ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s of the function's work, {shares}"
          f"{bwd_design(fa, dtype, hd)}) plain {plain_ms:.3f} ms sdpa-backward {lib_ms:.3f} ms "
          f"bound {bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB) at B*H = "
          f"{b}*{h}, T = {t} ({n_valid} valid keys), hd {hd}")
    return {"name": name, "route": "cuda", "source": "vipers_torch/csrc/flash_attention_bwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                        "(_flash_attention_bwd_dkv) and :1287 (_flash_attention_bwd_dq)",
            "max_abs_err": max(e for e, _ in errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def fused_mlp_inputs(fm, m, d, f, gen):
    """x (m, d) bf16 and the folded (W_eff^T, b_eff) of a LayerNorm and fc1,
    plus the unfolded bf16 weights for the library's sequence."""
    x = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.3 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    kernel = torch.randn(d, f, generator=gen, device="cuda") / d ** 0.5
    bias = 0.1 * torch.randn(f, generator=gen, device="cuda")
    w_eff_t, b_eff = fm.fold_ln_affine(gamma, beta, kernel, bias, torch.bfloat16)
    lib_w = (gamma.bfloat16(), beta.bfloat16(), kernel.t().contiguous().bfloat16(),
             bias.bfloat16())
    return x, w_eff_t, b_eff, lib_w


def fused_mlp_design(fm, d):
    ds = fm.design(d)
    return (f"{ds['rows']} rows a CTA, {ds['block_n']}-column tiles, {ds['stages']} W_eff stages "
            f"of 64 k, "
            f"{'an epilogue warpgroup a consumer' if ds['staged'] else 'epilogue in the consumer'}")


def fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w):
    """Kernel and layer_norm+linear+gelu milliseconds, and the bound."""
    (m, d), f = x.shape, w_eff_t.shape[0]
    g16, b16, wt16, bb16 = lib_w
    ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff))
    lib_ms = cuda_ms(lambda: F.gelu(F.linear(F.layer_norm(x, (d,), g16, b16, 1e-6),
                                             wt16, bb16), approximate="tanh"))
    flops = 2 * m * d * f
    nbytes = (x.numel() + w_eff_t.numel() + m * f) * 2 + b_eff.numel() * 4
    bms, by = bound(flops, nbytes, PEAK_BF16)
    line = (f"kernel {ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s, {bms / ms:.1%} of the bound; "
            f"{fused_mlp_design(fm, d)}) layer_norm+linear+gelu {lib_ms:.3f} ms bound "
            f"{bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
    return ms, lib_ms, bms, by, line


def check_fused_mlp(fm, gen):
    """Fused LN->fc1->GELU kernel vs plain at (128*896, 384) x (384, 1536):
    2e-2 of the output scale (the kernel's tanh is tanh.approx.f32, the
    plain version's torch.tanh)."""
    m, d, f = BATCH * 896, 384, 1536
    x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
    out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
    want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
    torch.cuda.synchronize()
    err, scale = scaled_err(out, want)
    ms, lib_ms, bms, by, line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)
    plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6), reps=5)
    print(f"fused_ln_fc1_gelu[bf16] max_abs_err {err:.3e} (2e-2 of output scale {scale:.3g}) "
          f"{line} plain {plain_ms:.3f} ms")
    return {"name": "fused_ln_fc1_gelu[bf16]", "route": "cuda",
            "source": "vipers_torch/csrc/fused_mlp.cu",
            "replaces": "vipers/ops/fused_mlp.py:123",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "tflops": 2 * m * d * f / ms / 1e9, "share_of_bound": bms / ms,
            "design": fm.design(d)}


def check_fused_mlp_wide(fm, gen):
    """The fused MLP at vit_b's and vit_h's widths, (16*896, D) x (D, 4D)
    for D = 768 and 1280 (the one-consumer instance): the kernel against
    its plain version (2e-2 of the output scale), and its time beside the
    layer_norm+linear+gelu sequence's, with no gate on the times."""
    m = 16 * 896
    for d in (768, 1280):
        f = 4 * d
        x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
        out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
        want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)[-1]
        print(f"fused_ln_fc1_gelu[bf16, D={d}, F={f}, M={m}] max_abs_err {err:.3e} (2e-2 of "
              f"output scale {sc:.3g}) {line}")


def check_fused_mlp_family(fm, gen):
    """The fused MLP at the ViT family's LOST shapes, F = 4D: D = 768
    (vit_b_16, M = 128*896), 1024 (vit_l_16, M = 128*896) and 1280 (vit_h_14,
    M = 128*1024), each against its plain version (2e-2 of the output
    scale) with the kernel's, the plain version's and the library
    sequence's times and the bound."""
    rows = []
    for d, m in ((768, BATCH * 896), (1024, BATCH * 896), (1280, BATCH * 1024)):
        f = 4 * d
        x, w_eff_t, b_eff, lib_w = fused_mlp_inputs(fm, m, d, f, gen)
        out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
        want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        del out, want
        ms, lib_ms, bms, by, line = fused_mlp_times(fm, x, w_eff_t, b_eff, lib_w)
        plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6),
                           reps=3, warmup=1)
        name = f"fused_ln_fc1_gelu[bf16, D={d}]"
        print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {sc:.3g}) {line} plain "
              f"{plain_ms:.3f} ms at M = {m}, F = {f}")
        rows.append({"name": name, "route": "cuda", "source": "vipers_torch/csrc/fused_mlp.cu",
                     "replaces": "vipers/ops/fused_mlp.py:123", "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "design": fm.design(d)})
    return rows


def check_flash_packed(fa, dtype, gen):
    """Packed token-major kernel vs plain at the LOST shape: B = 128, T =
    896, D = 384 in 6 heads, the (B, T, 3D) qkv in head-pair stripes, 769
    valid keys on every other image. SDPA runs on the unpacked strided
    views with the bool mask."""
    b, t, heads, hd = BATCH, 896, 6, 64
    d = heads * hd
    qkv = torch.randn(b, t, 3 * d, generator=gen, device="cuda").to(dtype)
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    valid[1::2, 769:] = False
    scale = hd ** -0.5
    out = fa.flash_attention_packed_fwd(qkv, valid, heads, scale)
    want = fa.flash_attention_packed_plain(qkv, valid, heads, scale)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        tol = "atol 1e-5 rtol 1e-4"
    else:
        sc = want.float().abs().max().item()
        assert err <= 2e-2 * sc, (err, sc)
        tol = f"2e-2 of output scale {sc:.3g}"
    ms = cuda_ms(lambda: fa.flash_attention_packed_fwd(qkv, valid, heads, scale))
    plain_ms = cuda_ms(lambda: fa.flash_attention_packed_plain(qkv, valid, heads, scale),
                       reps=5)
    q, k, v = fa._unpack_bhtd(qkv, heads)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    flops = 4 * b * heads * t * t * hd
    nbytes = (qkv.numel() + out.numel()) * qkv.element_size() + valid.numel()
    bms, by, shares = forward_bound(flops, nbytes, dtype, ms)
    name = f"flash_attention_packed[{'f32' if dtype == torch.float32 else 'bf16'}]"
    print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms ({flops / ms / 1e9:.0f} "
          f"TFLOP/s, {shares}{attention_tile(fa, dtype)}) plain {plain_ms:.3f} ms "
          f"sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.0f} MB)")
    return {"name": name, "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_packed.cu",
            "replaces": "vipers/ops/flash_attention.py:358",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def scaled_err(got, ref, frac=2e-2):
    """Max abs error of ``got`` against ``ref``, asserted within ``frac`` of
    ``ref``'s scale (its max abs); returns (error, scale)."""
    sc = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * sc, (err, sc)
    return err, sc


def own_variant(got, want, want_f32):
    """A softmax variant differs from f32 by less than 2e-2 of the output's
    scale, so the tolerance alone would pass an instance that computed f32.
    This asserts that ``got`` is clearly its own variant: its mean distance
    from the variant's plain version ``want`` is at most half the distance
    from ``want`` to f32's plain version ``want_f32`` (so it also lies
    farther from ``want_f32`` than from ``want``). Returns that ratio."""
    gap = (want.float() - want_f32.float()).abs().mean().item()
    ratio = (got.float() - want.float()).abs().mean().item() / gap if gap else float("inf")
    assert ratio <= 0.5, (ratio, gap)
    return ratio


def train_design(at, hd=64):
    """The training attention kernels' compiled design at ``hd``, for their
    lines."""
    d = at.design(hd)
    return (f"; forward {d['fwd_block_q']}-query tiles, {d['chunk']}-key chunks, "
            f"{d['fwd_stages']} K/V stages, K/V loaded by every tile (the other query tile of "
            f"a head reads it from L2); backward {d['bwd_block_q']}-query blocks, "
            f"{d['bwd_stages']} stages, {d['bwd_chunk']} keys a round")


def attention_rows(checks, design=""):
    """Print one line and make one row of the kernels JSON for each
    (name, ms, plain ms, library ms, flops, bytes, error, tolerance text,
    replaces) of a bf16 attention kernel check; ``design`` ends each line."""
    rows = []
    for name, ms, plain, lib, flops, nbytes, err, tol, rep in checks:
        bms, by = bound(flops, nbytes, PEAK_BF16)
        lib_name = "sdpa" if "fwd" in name else "sdpa-backward"
        print(f"{name} max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms ({bms / ms:.1%} of the "
              f"bound{design}) plain {plain:.3f} ms {lib_name} {lib:.3f} ms bound {bms:.3f} ms "
              f"({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vipers_torch/csrc/attention_train.cu", "replaces": rep,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib})
    return rows


def sdpa_bwd_ms(q, k, v, cot, amask):
    """Median ms of ``torch.autograd.grad`` of SDPA alone (retained graph)."""
    lq, lk, lv = (z.detach().clone().requires_grad_(True) for z in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
    return cuda_ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), cot, retain_graph=True))


def attention_work(b, h, t, hd, valid):
    """(flops, bytes) of the training attention forward and backward."""
    n, lse_bytes = b * h * t * hd, b * h * t * 4
    return ((4 * b * h * t * t * hd, 4 * n * 2 + lse_bytes + valid.numel()),
            (10 * b * h * t * t * hd, 8 * n * 2 + lse_bytes + valid.numel()))


def check_attention_train(at, gen, shape=(TRAIN_BATCH, 6, 256, 64), n_valid=197, ragged=120):
    """Training attention kernels vs plain at the train shape: B*H = 128*6,
    T = 256 (197 tokens seq-padded; on every other image a ragged run of pad
    keys inside the 197, from key 120), hd = 64 (or ``shape``, ``n_valid``
    tokens, pad keys from ``ragged``: vit_h_14's 224x224 train shape at hd
    80), bf16, packed (3, B, H, T, hd) q|k|v with the backward writing one
    packed dqkv; one launch of the head dim's instance each way."""
    b, h, t, hd = shape
    qkv = torch.randn(3, b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n_valid] = True
    valid[1::2, ragged:n_valid:3] = False
    q, k, v = qkv.unbind(0)
    scale = hd ** -0.5
    n0 = dict(at.LAUNCHES)
    out, lse = at.attention_train_fwd(q, k, v, valid, scale)
    dqkv = torch.empty_like(qkv)
    at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, out=dqkv.unbind(0))
    fk, bk = (at._launch_key(kind, "f32", hd) for kind in ("fwd", "bwd"))
    assert at.LAUNCHES == {**n0, fk: n0[fk] + 1, bk: n0[bk] + 1}, at.LAUNCHES
    want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale)
    want_g = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()

    fwd_err, fwd_scale = scaled_err(out, want)
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= 1e-3, lse_err
    bwd = [scaled_err(dqkv[i], want_g[i]) for i in range(3)]
    bwd_err = max(e / sc for e, sc in bwd)

    dbuf = dqkv.unbind(0)
    fwd_ms = cuda_ms(lambda: at.attention_train_fwd(q, k, v, valid, scale))
    fwd_plain = cuda_ms(lambda: at.attention_train_fwd_plain(q, k, v, valid, scale), reps=5)
    amask = valid[:, None, None, :]
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    bwd_ms = cuda_ms(lambda: at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale,
                                                    out=dbuf))
    bwd_plain = cuda_ms(lambda: at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid,
                                                             scale), reps=5)
    bwd_lib = sdpa_bwd_ms(q, k, v, cot, amask)

    (fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes) = attention_work(b, h, t, hd, valid)
    sfx = "" if hd == 64 else f", hd{hd}"
    at_shape = f" at B*H = {b}*{h}, T = {t} ({n_valid} valid keys), hd {hd}"
    return attention_rows((
        (f"attention_train_fwd[bf16{sfx}]", fwd_ms, fwd_plain, fwd_lib, fwd_flops, fwd_bytes,
         fwd_err, f"2e-2 of output scale {fwd_scale:.3g}; lse {lse_err:.2e} (atol 1e-3)",
         "vipers/ops/attention_train.py:276"),
        (f"attention_train_bwd[bf16{sfx}]", bwd_ms, bwd_plain, bwd_lib, bwd_flops, bwd_bytes,
         max(e for e, _ in bwd), "2e-2 of each of dq, dk, dv's scale "
         f"({', '.join(f'{sc:.3g}' for _, sc in bwd)}); worst {bwd_err:.2e} of it",
         "vipers/ops/attention_train.py:294")), train_design(at, hd) + at_shape)


def check_attention_train_rounds(at, gen):
    """The training kernels beyond one 256-key chunk, which the main path
    does not run: B*H = 8*6, T = 640 (577 tokens seq-padded, a ragged run of
    pad keys on every other image), packed q|k|v: the two-pass forward and
    the backward's key rounds with dQ summed in the f32 scratch, against the
    plain versions (2e-2 of each output's scale, lse atol 1e-3)."""
    b, h, t, hd = 8, 6, 640, 64
    qkv = torch.randn(3, b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :577] = True
    valid[1::2, 300:577:3] = False
    q, k, v = qkv.unbind(0)
    scale = hd ** -0.5
    out, lse = at.attention_train_fwd(q, k, v, valid, scale)
    dqkv = torch.empty_like(qkv)
    at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, out=dqkv.unbind(0))
    want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale)
    want_g = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()
    fwd_err, fwd_scale = scaled_err(out, want)
    lse_err = (lse - want_lse).abs().max().item()
    assert lse_err <= 1e-3, lse_err
    bwd = [scaled_err(dqkv[i], want_g[i]) for i in range(3)]
    print(f"attention_train[bf16, T={t}, key rounds] forward max_abs_err {fwd_err:.3e} (2e-2 of "
          f"output scale {fwd_scale:.3g}), lse {lse_err:.2e} (atol 1e-3); backward "
          f"{', '.join(f'{e:.3e}' for e, _ in bwd)} (2e-2 of dq, dk, dv's scale "
          f"{', '.join(f'{sc:.3g}' for _, sc in bwd)})")


def check_softmax_variants(at, gen):
    """The softmax-precision instances of the training kernels (the A/B
    tool's bf16exp and normP forward, bf16exp backward; normP's backward is
    f32's) vs their plain versions at the tool's shape: (128, 6, 256, 64)
    bf16, all keys valid. Each is within 2e-2 of its output's scale and
    clearly its own variant, not f32 (``own_variant``); the backward runs on
    the bf16exp forward's residuals."""
    b, h, t, hd = TRAIN_BATCH, 6, 256, 64
    q, k, v, cot = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(4))
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    scale = hd ** -0.5
    amask = valid[:, None, None, :]
    (fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes) = attention_work(b, h, t, hd, valid)
    fwd_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    want_f32, _ = at.attention_train_fwd_plain(q, k, v, valid, scale)
    checks = []
    for variant in ("bf16exp", "normP"):
        out, lse = at.attention_train_fwd(q, k, v, valid, scale, variant=variant)
        want, want_lse = at.attention_train_fwd_plain(q, k, v, valid, scale, variant)
        torch.cuda.synchronize()
        err, sc = scaled_err(out, want)
        lse_err = (lse - want_lse).abs().max().item()
        assert lse_err <= 1e-3, lse_err
        ratio = own_variant(out, want, want_f32)
        ms = cuda_ms(lambda: at.attention_train_fwd(q, k, v, valid, scale, variant=variant))
        plain = cuda_ms(lambda: at.attention_train_fwd_plain(q, k, v, valid, scale, variant),
                        reps=5)
        checks.append((f"attention_train_fwd[{variant}]", ms, plain, fwd_lib, fwd_flops,
                       fwd_bytes, err, f"2e-2 of output scale {sc:.3g}; lse {lse_err:.2e} (atol "
                       f"1e-3); "
                       f"own variant: {ratio:.3f} of its gap to f32",
                       "tools/bench_softmax_prec.py:124"))

    out, lse = at.attention_train_fwd(q, k, v, valid, scale, variant="bf16exp")
    grads = at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale, variant="bf16exp")
    want = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale, "bf16exp")
    want_f32 = at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale)
    torch.cuda.synchronize()
    bwd = [scaled_err(g, w) for g, w in zip(grads, want)]
    ratios = [own_variant(g, w, w32) for g, w, w32 in zip(grads, want, want_f32)]
    ms = cuda_ms(lambda: at.attention_train_bwd(q, k, v, out, lse, cot, valid, scale,
                                                variant="bf16exp"))
    plain = cuda_ms(lambda: at.attention_train_bwd_plain(q, k, v, out, lse, cot, valid, scale,
                                                         "bf16exp"), reps=5)
    checks.append(("attention_train_bwd[bf16exp]", ms, plain, sdpa_bwd_ms(q, k, v, cot, amask),
                   bwd_flops, bwd_bytes, max(e for e, _ in bwd),
                   "2e-2 of each of dq, dk, dv's scale "
                   f"({', '.join(f'{sc:.3g}' for _, sc in bwd)}); own variant: "
                   f"{', '.join(f'{r:.3f}' for r in ratios)} of their gaps to f32",
                   "tools/bench_softmax_prec.py:137"))
    return attention_rows(checks, train_design(at))


def check_splash(sa, gen):
    """Every splash instance vs plain at the A/B's shape: (32, 6, 896, 64)
    bf16, q pre-scaled, K head-dim-minor or seq-minor (a transposed copy).
    SDPA runs without a mask on the same q, k, v with scale 1."""
    b, h, t, hd = 32, 6, 896, 64
    q, k, v = (torch.randn(b, h, t, hd, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    q = (q * hd ** -0.5).to(torch.bfloat16)
    k_of = {"head_dim_minor": k, "seq_minor": k.transpose(-1, -2).contiguous()}
    want = sa.splash_attention_plain(q, k, v)
    sc = want.float().abs().max().item()
    plain_ms = cuda_ms(lambda: sa.splash_attention_plain(q, k, v), reps=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * q.element_size()
    bms, by = bound(flops, nbytes, PEAK_BF16)
    rows = []
    for bq, bkv, layout in sa.INSTANCES:
        kk = k_of[layout]
        out = sa.splash_attention(q, kk, v, bq, bkv, layout)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * sc, (bq, bkv, layout, err, sc)
        ms = cuda_ms(lambda: sa.splash_attention(q, kk, v, bq, bkv, layout))
        name = f"splash_attention[{sa.instance_name(bq, bkv, layout)}]"
        print(f"{name} max_abs_err {err:.3e} (2e-2 of output scale {sc:.3g}) kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.0f} TFLOP/s, {bms / ms:.1%} of the bound) plain "
              f"{plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vipers_torch/csrc/splash_attention.cu",
                     "replaces": "tools/bench_splash.py:79",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib_ms})
    return rows


def make_images(rng, exact_hw, patch=PATCH):
    """Tier-1-padded uint8 images (to ``patch`` multiples), zero beyond the
    exact pixel extent, each with a bright block on textured noise."""
    imgs = []
    for h, w in exact_hw:
        im = np.zeros((-(-h // patch) * patch, -(-w // patch) * patch, 3), np.uint8)
        im[:h, :w] = rng.integers(0, 110, (h, w, 3), dtype=np.uint8)
        r, c = rng.integers(0, h // 2), rng.integers(0, w // 2)
        im[r:r + h // 3, c:c + w // 3] = rng.integers(170, 256, 3, dtype=np.uint8)
        imgs.append(im)
    return imgs


def compare_with_cpu(tag, spec, params, masks, dtype, ex, imgs, exact_hw, lost_core,
                     n_cpu=N_CPU):
    """B=n_cpu images through the same extractor on the CPU (plain kernel
    versions). f32: features within 1e-3 of their scale and equal boxes
    (a seed may differ only inside a tie at the top score); bf16: print.
    The model's patch size and the images' bucket set the grid."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    patch = spec.patch_size
    cpu = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype, device="cpu")
    sub, hw = imgs[:n_cpu], exact_hw[:n_cpu]
    gin, cin = ex.prepare_batch(sub, patch, exact_hw=hw), cpu.prepare_batch(sub, patch, exact_hw=hw)
    gf = ex.batched_features(*gin).float().cpu()
    cf = cpu.batched_features(*cin).float()
    gbox, gseed, gbg = (z.cpu() for z in ex.make_batched_pipeline(K_PATCHES)(*gin))
    cbox, cseed, cbg = cpu.make_batched_pipeline(K_PATCHES)(*cin)
    scale = cf.abs().max().item()
    ferr = (gf - cf).abs().max().item()
    same_seed = (gseed == cseed)
    same_box = (gbox == cbox).all(dim=1)
    print(f"cpu-vs-card [{tag}] features max_abs_err {ferr:.3e} (scale {scale:.3g}); "
          f"seeds equal {int(same_seed.sum())}/{n_cpu}, boxes equal "
          f"{int(same_box.sum())}/{n_cpu}, bg flags equal {int((gbg == cbg).sum())}/{n_cpu}")
    if dtype == torch.float32:
        assert ferr <= 1e-3 * scale, (ferr, scale)
        grid = (cin[0].shape[1] // patch, cin[0].shape[2] // patch)
        scores = lost_core(cf, cin[3], grid, K_PATCHES)["scores"]
        for i in range(n_cpu):
            if same_seed[i]:
                assert same_box[i] and gbg[i] == cbg[i], (i, gbox[i], cbox[i])
            else:
                s = scores[i]
                assert s[gseed[i]] == s[cseed[i]] == s.max(), (i, gseed[i], cseed[i])


def reset_counts(*counters):
    for counts in counters:
        for key in counts:
            counts[key] = 0


def throughput(pipe, inp, one):
    """img/s of ``pipe`` on the batch ``inp`` (3 calls after one warm-up,
    host clock to the boxes on the host) and its p50 ms on the one-image
    batch ``one`` (20 calls after 3)."""
    pipe(*inp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = pipe(*inp)
    out[0].cpu()
    ips = 3 * inp[0].shape[0] / (time.perf_counter() - t0)
    lats = []
    for _ in range(23):
        t0 = time.perf_counter()
        pipe(*one)[0].cpu()
        lats.append(1e3 * (time.perf_counter() - t0))
    return ips, statistics.median(lats[3:])


def packed_lost_phase(card, spec, extractors, buckets, default_outs, lost_core):
    """The LOST pipeline on the mixed-size bucket with
    VIPERS_PACKED_ATTENTION=1: launches per forward (12 packed, 0 flash, 12
    fused MLP in bf16), f32 features and boxes against the default route's;
    then bf16 img/s and p50 of both routes on both buckets, measured here
    in turns. Returns the packed launches of the counted forwards."""
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    imgs, hw = buckets["mixed"]
    layers = spec.cfg.num_layers
    inputs = {e: ex.prepare_batch(imgs, PATCH, exact_hw=hw) for e, ex in extractors.items()}
    default_feats = extractors["f32"].batched_features(*inputs["f32"]).float()
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    os.environ["VIPERS_PACKED_ATTENTION"] = "1"
    try:
        torch.cuda.synchronize()
        reset_counts(fa.LAUNCHES, fa.PACKED_LAUNCHES, fm.LAUNCHES)
        outs = {e: pipes[e](*inputs[e]) for e in extractors}
        torch.cuda.synchronize()
        launches = {"flash_attention_packed[f32]": fa.PACKED_LAUNCHES["float32"],
                    "flash_attention_packed[bf16]": fa.PACKED_LAUNCHES["bfloat16"],
                    "flash": sum(fa.LAUNCHES.values()), "fused_mlp": fm.LAUNCHES["bfloat16"]}
        print(f"packed LOST path launches (f32 and bf16 forward, {layers} blocks each): "
              f"{launches}")
        assert launches == {"flash_attention_packed[f32]": layers,
                            "flash_attention_packed[bf16]": layers,
                            "flash": 0, "fused_mlp": layers}, launches
        feats = extractors["f32"].batched_features(*inputs["f32"]).float()
    finally:
        del os.environ["VIPERS_PACKED_ATTENTION"]

    sc = default_feats.abs().max().item()
    ferr = (feats - default_feats).abs().max().item()
    box, seed, bg = (z.cpu() for z in outs["f32"])
    dbox, dseed, dbg = (z.cpu() for z in default_outs)
    same_seed = seed == dseed
    scores = lost_core(default_feats, inputs["f32"][3], (H // PATCH, W // PATCH),
                       K_PATCHES)["scores"].cpu()
    for i in range(BATCH):
        if same_seed[i]:
            assert bool((box[i] == dbox[i]).all()) and bg[i] == dbg[i], (i, box[i], dbox[i])
        else:  # a tie at the top score, broken the same way only by chance
            assert scores[i, seed[i]] == scores[i, dseed[i]] == scores[i].max(), i
    print(f"packed vs default route [f32, mixed] features max_abs_err {ferr:.3e} "
          f"(tol 2e-4 of scale {sc:.3g}); seeds equal {int(same_seed.sum())}/{BATCH}, boxes "
          f"equal {int((box == dbox).all(dim=1).sum())}/{BATCH}")
    assert ferr <= 2e-4 * sc, (ferr, sc)
    ex = extractors["bf16"]
    for b, (b_imgs, b_hw) in buckets.items():
        batch = ex.prepare_batch(b_imgs, PATCH, exact_hw=b_hw)
        one = ex.prepare_batch(b_imgs[:1], PATCH, exact_hw=b_hw[:1])
        os.environ["VIPERS_PACKED_ATTENTION"] = "1"
        try:
            packed_ips, packed_p50 = throughput(pipes["bf16"], batch, one)
        finally:
            del os.environ["VIPERS_PACKED_ATTENTION"]
        default_ips, default_p50 = throughput(pipes["bf16"], batch, one)
        print(f"throughput [bf16, {b}] packed route {packed_ips:.1f} img/s, p50 "
              f"{packed_p50:.2f} ms; default route {default_ips:.1f} img/s, p50 "
              f"{default_p50:.2f} ms at B={BATCH} / B=1 ({card})")
    return launches


# The ViT family phase: each model's bucket (a VOC 500x375 image at its
# patch size: 512x384 at 16 and 32, 504x392 at 14, T = 1009 seq-padded to
# 1024 for vit_h_14) and the cut of vit_h_14's CPU comparison.
FAMILY_HW = {16: (H, W), 32: (H, W), 14: (504, 392)}
VIT_H_CPU_LAYERS, VIT_H_CPU_BATCH = 8, 2


def to_device(tree, dev, dtype=None):
    """A nested dict of tensors on ``dev`` (and in ``dtype``, where given)."""
    return {k: to_device(v, dev, dtype) if isinstance(v, dict) else v.to(dev, dtype)
            for k, v in tree.items()}


@contextlib.contextmanager
def cublas_tf32(on=True):
    """While on, cuBLAS runs f32 matmuls in TF32 (the yardstick the f32
    kernels are held 10x nearer exact f32 than)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@contextlib.contextmanager
def attention_by_einsum(on=True):
    """While on, the models route no attention to a kernel (nor its plain
    version): ``VIPERS_FLASH_MIN_T`` past any T, and T too long for the
    training kernels."""
    old = os.environ.get("VIPERS_FLASH_MIN_T")
    if on:
        os.environ["VIPERS_FLASH_MIN_T"] = str(1 << 30)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VIPERS_FLASH_MIN_T", None)
        else:
            os.environ["VIPERS_FLASH_MIN_T"] = old


def family_model(name, sparsity):
    """A full-width model of the registry as a reference checkpoint has it
    (1000 classes, the pos table at 224x224, interpolated to the bucket by
    the extractor, as ``vipers_torch lost`` runs it), random weights from
    seed 0 moved to the card, and with ``sparsity`` a global magnitude mask
    ranked there. Returns (spec, params, masks or None, its bucket)."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    t0 = time.time()
    spec = build_model(name)
    hw = FAMILY_HW[spec.patch_size]
    params = to_device(spec.init(torch.Generator().manual_seed(0)), "cuda")
    masks = None
    what = "no mask"
    if sparsity:
        masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                                amount=sparsity)
        kept = sum(int(m.sum()) for m in masks.values())
        total = sum(m.numel() for m in masks.values())
        what = f"{total} prunable weights, sparsity {100 * (1 - kept / total):.2f}%"
    c = spec.cfg
    print(f"{name} {hw[0]}x{hw[1]} ({c.num_layers} layers, D {c.hidden_dim}, {c.num_heads} "
          f"heads of {c.hidden_dim // c.num_heads}, mlp {c.mlp_dim}, patch {c.patch_size}): "
          f"random weights from seed 0, {what} (set-up {time.time() - t0:.1f} s)")
    return spec, params, masks, hw


def family_buckets(hw, patch, seed):
    """An exact-fit and a mixed-size batch of BATCH uint8 images in the
    bucket ``hw`` at ``patch`` (the mixed images 449-512 rows by 321-384
    columns at patch 16 and 32, 449-504 by 337-392 at 14)."""
    rng = np.random.default_rng(seed)
    exact = [hw] * BATCH
    mixed = [hw] * 8 + [(int(rng.integers(449, hw[0] + 1)),
                         int(rng.integers(hw[1] - 55, hw[1] + 1))) for _ in range(BATCH - 8)]
    return {"exact": (make_images(rng, exact, patch), exact),
            "mixed": (make_images(rng, mixed, patch), mixed)}


def check_outs(tag, outs, grid):
    """Boxes inside the grid, seeds on it; prints the background share and
    the mean box area."""
    for key, (box, seed, bg) in outs.items():
        box, seed, bg = box.cpu(), seed.cpu(), bg.cpu()
        gh, gw = grid
        assert box.shape == (BATCH, 4) and seed.shape == (BATCH,) and bg.shape == (BATCH,)
        assert bool(((box[:, 0] <= box[:, 1]) & (box[:, 1] <= gh)
                     & (box[:, 2] <= box[:, 3]) & (box[:, 3] <= gw)).all())
        assert bool(((seed >= 0) & (seed < gh * gw)).all())
        area = float(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).float().mean())
        print(f"{tag} pipeline {list(key)} boxes ok, seed in background {int(bg.sum())}/{BATCH}, "
              f"mean box area {area:.1f} patches")


def family_launches(fa, fm, at):
    """The launch counts a family forward can show."""
    got = {f"flash[{k}]": n for k, n in fa.LAUNCHES.items()}
    got.update({f"fused_mlp[D={d}]": n for d, n in fm.WIDTH_LAUNCHES.items()})
    got["other"] = (sum(fa.PACKED_LAUNCHES.values()) + sum(fa.BWD_LAUNCHES.values())
                    + sum(at.LAUNCHES.values()))
    return got


def family_pipelines(tag, spec, params, masks, hw, dtypes, counters, want, seed):
    """The batched pipeline of one family model on its exact-fit and mixed
    buckets in each of ``dtypes``: launches of the counted forwards against
    ``want`` (every other count 0), sane boxes. Returns (extractors,
    buckets, inputs, pipes, outs, launches)."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    patch = spec.patch_size
    buckets = family_buckets(hw, patch, seed)
    extractors = {e: LostFeatureExtractor(spec, params, masks, compute_dtype=dt)
                  for e, dt in (("f32", None), ("bf16", torch.bfloat16)) if e in dtypes}
    inputs = {(e, b): extractors[e].prepare_batch(imgs, patch, exact_hw=bhw)
              for e in extractors for b, (imgs, bhw) in buckets.items()}
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    torch.cuda.synchronize()
    reset_counts(*counters)
    outs = {key: pipes[key[0]](*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    got = family_launches(fa, fm, at)
    print(f"{tag} LOST path launches ({len(outs)} forwards of {spec.cfg.num_layers} blocks, "
          f"T = {(hw[0] // patch) * (hw[1] // patch) + 1}): "
          f"{ {k: n for k, n in got.items() if n} }")
    assert got == {k: want.get(k, 0) for k in got}, (got, want)
    check_outs(tag, outs, (hw[0] // patch, hw[1] // patch))
    return extractors, buckets, inputs, pipes, outs, got


def family_cli(card, counters, spec, params, masks):
    """``vipers_torch.cli.main lost --model vit_b_16 --patch-size 16 --dtype
    bf16`` on N_JPEG fixture JPEGs (phase 6's tree) from the pruned ViT-B/16
    written as a reference .pth (weight_orig / weight_mask): 12 flash and 12
    fused-MLP launches (D = 768) a batch, the first batch's boxes equal to
    the pipeline's, preds.pkl one entry an image not reported in the
    background, the results txt equal to ``corloc`` re-scoring; e2e img/s."""
    import shutil
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.data import native
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    if not native.available() and not native.pil_available():
        print("vit_b_16 JPEG LOST: neither libjpeg nor PIL on the host: skipped")
        return None
    root = tempfile.mkdtemp(prefix="vipers_torch_vit_b_16_")
    try:
        data = os.path.join(root, "VOC2007")
        items = voc_tree(data, N_JPEG, seed=3)
        pth = os.path.join(root, "vit_b_16_pruned.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), pth)
        batches = cli_batches(items)
        out = os.path.join(root, "out")
        torch.cuda.synchronize()
        reset_counts(*counters)
        cli(["lost", "--model", "vit_b_16", "--arch", "vit", "--patch-size", "16",
             "--dataset", "VOC07", "--set", "trainval", "--data-path", data,
             "--checkpoint", pth, "--dtype", "bf16", "--batch-size", str(BATCH),
             "--workers", "8", "--output-dir", out])
        torch.cuda.synchronize()
        run = dict(drv.LAST_RUN)
        got = family_launches(fa, fm, at)
        layers = spec.cfg.num_layers
        want = {"flash[bfloat16]": layers * batches, "fused_mlp[D=768]": layers * batches}
        print(f"vit_b_16 JPEG LOST [bf16] {N_JPEG} images, {batches} batches of {BATCH}: "
              f"launches { {k: n for k, n in got.items() if n} }")
        assert got == {k: want.get(k, 0) for k in got}, (got, want)
        assert run["images"] == N_JPEG and run["batches"] == batches, run
        check_first_batch("vit_b_16 bf16", pth, data, items, out, run["failed"], "bf16",
                          model="vit_b_16")
        rescored, txt = check_cli_outputs("vit_b_16", out, data, "trainval", items,
                                          run["failed"])
        ips = N_JPEG / run["decode_to_preds_seconds"]
        print(f"vit_b_16 JPEG LOST [bf16] e2e {ips:.1f} img/s ({N_JPEG} images, first decode "
              f"to preds.pkl {run['decode_to_preds_seconds']:.3f} s; {run['seconds']:.3f} s "
              f"with the model load); seed in background {len(run['failed'])}; re-scored "
              f"{rescored}, results txt {txt.strip()}; decoder {run['decoder']} ({card})")
        return {**got, "batches": batches, "e2e_img_per_s": ips}
    finally:
        shutil.rmtree(root)


def family_phase(card, counters, lost_core):
    """The ViT family on the LOST path, full width, random weights from seed
    0, each model's counts set to 0 just before its counted forwards:
    ViT-B/16 (full depth, 50% global magnitude mask) f32 and bf16 on both
    buckets (12 flash and 12 fused-MLP launches at D = 768 a bf16 batch),
    card vs CPU, img/s and p50, then the CLI from JPEGs; vit_b_32 bf16 at
    patch 32 (T = 193: the key-masked einsum, 0 flash and 12 fused-MLP
    launches a batch); vit_l_16 bf16 (24 flash, 24 fused MLP at D = 1024);
    vit_h_14 at 504x392 f32 and bf16 (32 hd-80 flash launches a batch, 32
    fused MLP at D = 1280 in bf16), img/s and the f32 call time, card vs
    CPU at a cut depth. Returns the launches of the family's kernel rows."""
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    rows = {}
    # ViT-B/16, the paper's pruned ViT
    spec, params, masks, hw = family_model("vit_b_16", SPARSITY)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, outs, got = family_pipelines(
        "vit_b_16", spec, params, masks, hw, ("f32", "bf16"), counters,
        {"flash[float32]": 2 * n, "flash[bfloat16]": 2 * n, "fused_mlp[D=768]": 2 * n}, seed=5)
    print(f"vit_b_16 a bf16 batch: {got['flash[bfloat16]'] // 2} flash and "
          f"{got['fused_mlp[D=768]'] // 2} fused-MLP launches at D = 768 (instance "
          f"{fused_mlp_design(fm, 768)})")
    rows["fused_ln_fc1_gelu[bf16, D=768]"] = got["fused_mlp[D=768]"]
    agree = {b: float((outs["f32", b][0] == outs["bf16", b][0]).all(dim=1).float().mean())
             for b in buckets}
    print(f"vit_b_16 bf16 vs f32 on the card: boxes equal on {agree}")
    for e, b in (("f32", "exact"), ("f32", "mixed"), ("bf16", "exact")):
        ex = extractors[e]
        compare_with_cpu(f"vit_b_16 {e}, {b}", spec, params, masks, ex.compute_dtype, ex,
                         *buckets[b], lost_core)
    for e, ex in extractors.items():
        imgs, bhw = buckets["exact"]
        ips, p50 = throughput(pipes[e], inputs[e, "exact"],
                              ex.prepare_batch(imgs[:1], PATCH, exact_hw=bhw[:1]))
        print(f"vit_b_16 throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{p50:.2f} ms at B=1 ({card})")
    del extractors, inputs, pipes, outs
    torch.cuda.empty_cache()
    cli_run = family_cli(card, counters, spec, params, masks)
    del params, masks
    torch.cuda.empty_cache()

    # vit_b_32: T = 193 stays below the flash threshold
    spec, params, _, hw = family_model("vit_b_32", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_b_32", spec, params, None, hw, ("bf16",), counters,
        {"fused_mlp[D=768]": 2 * n}, seed=6)
    assert (hw[0] // 32) * (hw[1] // 32) + 1 < fa.flash_min_t()
    print(f"vit_b_32 a bf16 batch: {got['flash[bfloat16]'] // 2} flash and "
          f"{got['fused_mlp[D=768]'] // 2} fused-MLP launches at D = 768")
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], 32, exact_hw=bhw[:1]))
    print(f"vit_b_32 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    del extractors, inputs, pipes, params
    torch.cuda.empty_cache()

    # vit_l_16: the fused MLP's D = 1024
    spec, params, _, hw = family_model("vit_l_16", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_l_16", spec, params, None, hw, ("bf16",), counters,
        {"flash[bfloat16]": 2 * n, "fused_mlp[D=1024]": 2 * n}, seed=7)
    rows["fused_ln_fc1_gelu[bf16, D=1024]"] = got["fused_mlp[D=1024]"]
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], PATCH, exact_hw=bhw[:1]))
    print(f"vit_l_16 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    del extractors, inputs, pipes, params
    torch.cuda.empty_cache()

    # vit_h_14: 16 heads of 80 at 504x392 (T = 1009 -> 1024)
    spec, params, _, hw = family_model("vit_h_14", 0)
    n = spec.cfg.num_layers
    extractors, buckets, inputs, pipes, _, got = family_pipelines(
        "vit_h_14", spec, params, None, hw, ("f32", "bf16"), counters,
        {"flash[float32[hd80]]": 2 * n, "flash[bfloat16[hd80]]": 2 * n,
         "fused_mlp[D=1280]": 2 * n}, seed=8)
    print(f"vit_h_14 a batch: {got['flash[bfloat16[hd80]]'] // 2} hd-80 flash launches (bf16; "
          f"{got['flash[float32[hd80]]'] // 2} in f32) and {got['fused_mlp[D=1280]'] // 2} "
          f"fused-MLP launches at D = 1280 (bf16; instance {fused_mlp_design(fm, 1280)})")
    rows["flash_attention_fwd[bf16, hd80]"] = got["flash[bfloat16[hd80]]"]
    rows["flash_attention_fwd[f32, hd80]"] = got["flash[float32[hd80]]"]
    rows["fused_ln_fc1_gelu[bf16, D=1280]"] = got["fused_mlp[D=1280]"]
    imgs, bhw = buckets["exact"]
    ips, p50 = throughput(pipes["bf16"], inputs["bf16", "exact"],
                          extractors["bf16"].prepare_batch(imgs[:1], 14, exact_hw=bhw[:1]))
    print(f"vit_h_14 throughput [bf16] {ips:.1f} img/s at B={BATCH}; p50 latency {p50:.2f} ms "
          f"at B=1 ({card})")
    pipes["f32"](*inputs["f32", "exact"])[0].cpu()
    t0 = time.perf_counter()
    pipes["f32"](*inputs["f32", "exact"])[0].cpu()
    f32_s = time.perf_counter() - t0
    print(f"vit_h_14 [f32] one call at B={BATCH}: {1e3 * f32_s:.1f} ms "
          f"({BATCH / f32_s:.1f} img/s) ({card})")
    del extractors, inputs, pipes
    torch.cuda.empty_cache()
    # card vs CPU on the first VIT_H_CPU_LAYERS blocks of the same weights
    from vipers_torch.discovery.driver import LostFeatureExtractor

    cut, cut_params, _ = cut_model(spec, params, {}, VIT_H_CPU_LAYERS)
    print(f"vit_h_14 card vs CPU: cut to its first {VIT_H_CPU_LAYERS} of {n} blocks and "
          f"B={VIT_H_CPU_BATCH} (the CPU's time), f32")
    ex = LostFeatureExtractor(cut, cut_params, None)
    for b in ("exact", "mixed"):
        imgs, bhw = buckets[b]
        sub = (imgs[8:8 + VIT_H_CPU_BATCH], bhw[8:8 + VIT_H_CPU_BATCH]) if b == "mixed" else \
            (imgs[:VIT_H_CPU_BATCH], bhw[:VIT_H_CPU_BATCH])
        compare_with_cpu(f"vit_h_14 f32, {b}", cut, cut_params, None, torch.float32, ex, *sub,
                         lost_core, n_cpu=VIT_H_CPU_BATCH)
    del ex, params, cut_params
    torch.cuda.empty_cache()
    return rows, cli_run


def voc_tree(root, n, seed):
    """A VOC07-layout tree of ``n`` images under ``root`` from the committed
    fixture: ``JPEGImages/`` as symlinks to fixture JPEGs drawn from
    ``seed``, ``Annotations/`` and ``ImageSets/Main/trainval.txt`` written as
    text (no PIL needed). Returns [(name, (w, h))] in dataset order."""
    import xml.etree.ElementTree as ET

    fixture = os.path.join(REPO, "tests", "data", "torch_voc")
    stems = sorted(f[:-4] for f in os.listdir(os.path.join(fixture, "JPEGImages")))
    xml = {s_: open(os.path.join(fixture, "Annotations", f"{s_}.xml")).read() for s_ in stems}
    dims = {s_: (int(ET.fromstring(x).find("size/width").text),
                 int(ET.fromstring(x).find("size/height").text)) for s_, x in xml.items()}
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    picks = np.random.default_rng(seed).integers(0, len(stems), n)
    items = []
    for i, k in enumerate(picks):
        name, stem = f"{i:06d}", stems[k]
        os.symlink(os.path.join(fixture, "JPEGImages", f"{stem}.jpg"),
                   os.path.join(root, "JPEGImages", f"{name}.jpg"))
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(xml[stem].replace(f"{stem}.jpg", f"{name}.jpg"))
        items.append((name, dims[stem]))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name, _ in items))
    return items


def bucket_of(w, h):
    """The driver's bucket for a w x h image (tier-1 pad, then 4 patches)."""
    from vipers_torch.data.preprocess import bucket_hw

    return bucket_hw(-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, PATCH, 4)


def first_batch(items, batch):
    """The images of the driver's first batch: the first bucket to fill up
    in dataset order, else the smallest bucket key at the end."""
    buffers = {}
    for name, (w, h) in items:
        key = bucket_of(w, h)
        buffers.setdefault(key, []).append(name)
        if len(buffers[key]) == batch:
            return buffers[key]
    return buffers[sorted(buffers)[0]]


def cli_batches(items):
    """The driver's batch count for ``items``: BATCH images a batch in each
    bucket, tail batches included."""
    counts = {}
    for _, (w, h) in items:
        counts[bucket_of(w, h)] = counts.get(bucket_of(w, h), 0) + 1
    return sum(-(-c // BATCH) for c in counts.values())


def check_cli_outputs(tag, out, data, set_name, items, failed):
    """A ``vipers_torch lost`` run's files: preds.pkl one finite box an
    image not reported in the background, the results txt equal to
    ``vipers_torch corloc`` re-scoring. Returns (re-scored line, txt)."""
    import contextlib
    import io
    import pickle

    from vipers_torch.cli.main import main as cli

    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    assert sorted(preds) == sorted({f"{nm}.jpg" for nm, _ in items} - set(failed)), tag
    assert all(len(b) == 4 and all(np.isfinite(b)) for b in preds.values())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["corloc", "--preds", os.path.join(out, "preds.pkl"), "--dataset", "VOC07",
             "--set", set_name, "--data-path", data])
    rescored = [ln for ln in buf.getvalue().splitlines() if ln.startswith("corloc:")]
    with open(os.path.join(out, "results_iteration_00.txt")) as f:
        txt = f.read()
    assert len(rescored) == 1 and txt == f"corloc,{float(rescored[0].split()[1]):.1f},,\n", \
        (txt, rescored)
    return rescored[0], txt


def jpeg_lost_phase(card, counters):
    """``vipers_torch lost`` from JPEGs to CorLoc, in this process: a
    full-width ViT-S/16 (seed 0, 224x224 pos table, 50% global magnitude
    mask) written as a reference .pth, pruned layers as weight_orig /
    weight_mask; runs at B=128, 8 decode threads: bf16 on 1024 images, f32
    on 256, bf16 on 256 under VIPERS_PACKED_ATTENTION=1. Checks preds.pkl
    (one entry per image not reported as a seed-in-background failure), the
    results txt against ``vipers_torch corloc``, 12 attention and (bf16) 12
    fused-MLP launches per batch, and the first batch's boxes against
    ``make_batched_pipeline`` on the same decoded uint8 batch. Prints e2e
    img/s (first decode to preds.pkl), the decode-only rate of the thread
    pool (and of one thread), the CPU count and the decoder. Returns each
    run's launches."""
    import shutil
    import tempfile

    from vipers_torch.cli.main import main as cli
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.data.detection import DiscoveryDataset
    from vipers_torch.discovery import driver as drv
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune

    if not native.available():
        # only a missing libjpeg lets the phase go on (with PIL) or skip
        err = native.build_error() or ""
        why = [ln for ln in err.splitlines()
               if any(k in ln for k in ("jpeglib.h", "-ljpeg", "libjpeg.so"))]
        if not why:
            raise RuntimeError(f"the JPEG decoder did not build: {err}")
        why = why[0]
        if not native.pil_available():
            print(f"JPEG -> boxes -> CorLoc: no libjpeg ({why}) and no PIL: phase skipped")
            return None
        print(f"JPEG -> boxes -> CorLoc: no libjpeg ({why}); decoding with PIL")
    root = tempfile.mkdtemp(prefix="vipers_torch_voc_")
    try:
        items = voc_tree(os.path.join(root, "VOC2007"), N_JPEG, seed=3)
        data = os.path.join(root, "VOC2007")
        with open(os.path.join(data, "ImageSets", "Main", "first256.txt"), "w") as f:
            f.write("".join(f"{name}\n" for name, _ in items[:N_JPEG_SHORT]))
        spec = build_model("vit_s_16")
        params = spec.init(torch.Generator().manual_seed(0))
        masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                                amount=SPARSITY)
        pth = os.path.join(root, "vit_s_16_pruned.pth")
        save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), pth)

        ds = DiscoveryDataset("VOC07", "trainval", data)
        for workers in (1, 8):  # 8: the runs' pool; 1: what a thread does alone
            t0 = time.perf_counter()
            n_dec = sum(1 for _ in drv._prefetch_decoded(ds, PATCH, False, workers=workers,
                                                          as_uint8=True))
            dec_ips = n_dec / (time.perf_counter() - t0)
            print(f"decode only: {n_dec} JPEGs with their GT in {n_dec / dec_ips:.3f} s, "
                  f"{dec_ips:.1f} img/s on {workers} thread(s); os.cpu_count() "
                  f"{os.cpu_count()}; decoder {native.backend()}")

        runs = {}
        layers = spec.cfg.num_layers
        for tag, dtype, set_name, n, packed in (("bf16", "bf16", "trainval", N_JPEG, False),
                                                ("f32", "f32", "first256", N_JPEG_SHORT, False),
                                                ("bf16 packed", "bf16", "first256",
                                                 N_JPEG_SHORT, True)):
            out = os.path.join(root, tag.replace(" ", "_"))
            run_items = items[:n]
            batches = cli_batches(run_items)
            if packed:
                os.environ["VIPERS_PACKED_ATTENTION"] = "1"
            try:
                torch.cuda.synchronize()
                reset_counts(*counters)
                cli(["lost", "--model", "vit_s_16", "--arch", "vit", "--dataset", "VOC07",
                     "--set", set_name, "--data-path", data, "--checkpoint", pth,
                     "--dtype", dtype, "--batch-size", str(BATCH), "--workers", "8",
                     "--output-dir", out, "--device", "cuda"])
                torch.cuda.synchronize()
                run = dict(drv.LAST_RUN)
                got = {"flash": fa.LAUNCHES["float32" if dtype == "f32" else "bfloat16"],
                       "packed": fa.PACKED_LAUNCHES["bfloat16"],
                       "fused_mlp": fm.LAUNCHES["bfloat16"],
                       "other": (sum(at.LAUNCHES.values()) + sum(fa.BWD_LAUNCHES.values())
                                 + fa.LAUNCHES["bfloat16" if dtype == "f32" else "float32"]
                                 + fa.PACKED_LAUNCHES["float32"])}
                want = {"flash": 0 if packed else layers * batches,
                        "packed": layers * batches if packed else 0,
                        "fused_mlp": layers * batches if dtype == "bf16" else 0, "other": 0}
                print(f"JPEG LOST [{tag}] {n} images, {batches} batches of {BATCH}: launches "
                      f"{got}")
                assert got == want, (got, want)
                assert run["images"] == n and run["batches"] == batches, (run, n, batches)
                check_first_batch(tag, pth, data, run_items, out, run["failed"], dtype)
            finally:
                if packed:
                    del os.environ["VIPERS_PACKED_ATTENTION"]
            rescored, txt = check_cli_outputs(tag, out, data, set_name, run_items,
                                              run["failed"])
            ips = n / run["decode_to_preds_seconds"]
            print(f"JPEG LOST [{tag}] e2e {ips:.1f} img/s ({n} images, first decode to "
                  f"preds.pkl {run['decode_to_preds_seconds']:.3f} s; {run['seconds']:.3f} s "
                  f"with the model load); seed in background {len(run['failed'])}; re-scored "
                  f"{rescored}, results txt {txt.strip()}; decode only {dec_ips:.1f} img/s; "
                  f"{os.cpu_count()} CPUs; decoder {run['decoder']} ({card})")
            runs[tag] = {**got, "batches": batches, "e2e_img_per_s": ips}
        return runs
    finally:
        shutil.rmtree(root)


def check_first_batch(tag, pth, data, items, out, failed, dtype, model="vit_s_16"):
    """The boxes of the run's first batch against ``make_batched_pipeline``
    on the same decoded uint8 batch, with the model loaded as the CLI loads
    it: equal wherever the seed is not in the background."""
    import pickle

    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import box_feat_to_image

    names = first_batch(items, BATCH)
    spec = build_model(model)  # 1000 classes at 224x224, as the checkpoint
    params, masks = load_lost_checkpoint(pth, spec)
    ex = LostFeatureExtractor(spec, params, masks, device="cuda",
                              compute_dtype=torch.bfloat16 if dtype == "bf16" else None)
    dec = [native.decode_pad(os.path.join(data, "JPEGImages", f"{n}.jpg"), PATCH) for n in names]
    imgs = [d[0] for d in dec] + [dec[-1][0]] * (BATCH - len(dec))
    hw = [d[1] for d in dec] + [dec[-1][1]] * (BATCH - len(dec))
    box, _seed, bg = (z.cpu().numpy() for z in
                      ex.make_batched_pipeline(K_PATCHES)(*ex.prepare_batch(imgs, PATCH,
                                                                            exact_hw=hw)))
    with open(os.path.join(out, "preds.pkl"), "rb") as f:
        preds = pickle.load(f)
    same = 0
    for i, n in enumerate(names):
        im = f"{n}.jpg"
        assert bool(bg[i]) == (im in failed), (tag, im)
        if not bg[i]:
            want = box_feat_to_image(box[i], [PATCH, PATCH], (3, *hw[i])).tolist()
            assert preds[im] == want, (tag, im, preds[im], want)
            same += 1
    print(f"JPEG LOST [{tag}] first batch ({len(names)} images): {same} boxes equal to "
          f"make_batched_pipeline's on the same uint8 batch, {len(names) - same} seeds in "
          f"the background")


def tools_phase(counters):
    """The A/B tools' ``main()`` at their shapes, each with the launch
    counts set to 0 just before it and read just after."""
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.ops import splash_attention as sa
    from vipers_torch.tools import bench_fused_mlp, bench_softmax_prec, bench_splash

    reset_counts(*counters)
    bench_softmax_prec.main([])
    torch.cuda.synchronize()
    launches = {f"attention_train_{k[:3]}[{k[4:-1]}]": n for k, n in at.LAUNCHES.items()
                if "[" in k and "[hd" not in k}  # the softmax variants
    reset_counts(*counters)
    bench_splash.main([])
    torch.cuda.synchronize()
    launches.update({f"splash_attention[{k}]": n for k, n in sa.LAUNCHES.items()})
    reset_counts(*counters)
    bench_fused_mlp.main([])
    torch.cuda.synchronize()
    launches["bench_fused_mlp: fused_ln_fc1_gelu[bf16]"] = fm.LAUNCHES["bfloat16"]
    print(f"A/B tools' launches: {launches}")
    assert all(launches.values()), launches
    return launches


def train_launches(at, fa, fm):
    """The launch counts a train step can show, by kernel row (each head
    dim's instances their own rows)."""
    got = {"fused_ln_fc1_gelu[bf16]": fm.LAUNCHES["bfloat16"]}
    for sfx, hd in (("", 64), (", hd80", 80)):
        got[f"attention_train_fwd[bf16{sfx}]"] = at.LAUNCHES[at._launch_key("fwd", "f32", hd)]
        got[f"attention_train_bwd[bf16{sfx}]"] = at.LAUNCHES[at._launch_key("bwd", "f32", hd)]
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            key = fa.launch_key(dt, hd)
            got[f"flash_attention_fwd[{name}{sfx}]"] = fa.LAUNCHES[key]
            got[f"flash_attention_bwd[{name}{sfx}]"] = fa.BWD_LAUNCHES[key]
    return got


def cut_model(spec, params, masks, layers):
    """``spec`` cut to its first ``layers`` blocks at full width, with the
    same weights and masks (as phase 10 cuts vit_h_14 for the CPU)."""
    import dataclasses

    from vipers_torch.models.vit import _build

    def keep(k):
        return not k.startswith("encoder_layer_") or int(k.rsplit("_", 1)[1]) < layers

    cut = _build(spec.name, dataclasses.replace(spec.cfg, num_layers=layers), spec.input_size)
    return (cut, {k: v for k, v in params.items() if keep(k)},
            {p: m for p, m in masks.items() if keep(p[0])})


def train_phase(card, counters, hw, n_cpu, lrr, model="vit_s_16", patch=PATCH,
                batch=TRAIN_BATCH, cpu_layers=None):
    """The masked train step of full-width ViT-S/16 at hw x hw (12 layers,
    D=384, 6 heads, mlp 1536, 1000 classes; or ``model`` at ``patch``, B =
    ``batch``) with 50% global magnitude masks (ranked on the card) on
    unbaked f32 masters, SGD momentum 0.9, wd 1e-4, lr 0.1 cosine, uint8
    images normalized on the card. At 224 (T = 197 seq-padded to 256) every
    block's attention goes through the training kernels; at 384 (T = 577,
    at least ``flash_min_t()``, seq-padded to 640) through the flash forward
    and backward kernels (vit_h_14: T = 257 -> 384 at 224, 785 -> 896 at
    392, the hd-80 instances). Checks: launches per bf16 step (one of the
    route's forward and one of its backward a block, none of the other
    route's, no fused MLP), finite losses, pruned slots unchanged; img/s at
    B=128 (best of 3 windows of 6 steps) and the peak device memory; card
    vs CPU at B=n_cpu (on the first ``cpu_layers`` blocks, where given):
    f32 params after 2 steps within 1e-4 (counted too: the f32 kernels'
    launches), bf16 loss within 2e-2 and gradients within 3e-2; with
    ``lrr``, one LRR round. Returns the launch counts of the counted bf16
    steps, with the f32 flash backward's from the f32 card steps."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train.loop import magnitude_pruning_round, reset_for_round
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import (create_train_state, loss_and_grads,
                                          make_eval_step, make_train_step)

    t0 = time.time()
    b = batch
    spec = build_model(model, num_classes=1000, image_size=(hw, hw))
    params = to_device(spec.init(torch.Generator().manual_seed(0)), "cuda")
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), SPARSITY)
    ocfg = OptimConfig(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4, epochs=10,
                       lr_scheduler="cosineannealinglr")
    state = create_train_state(spec, params, masks, ocfg, steps_per_epoch=100)
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (b,))).cuda()
    normalize = make_device_normalize()
    x = normalize(u8)
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    pruned = {k: state.params[k].detach()[~m].clone() for k, m in state.masks.items()}
    tokens = (hw // patch) ** 2 + 1
    flash = tokens >= fa.flash_min_t()
    hd = spec.cfg.hidden_dim // spec.cfg.num_heads
    sfx = "" if hd == 64 else f", hd{hd}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"train {model} {hw}x{hw} bf16 B={b} (T={tokens}, hd {hd}, "
          f"{'flash' if flash else 'training'} attention kernels): set-up "
          f"{time.time() - t0:.1f} s")

    # the counted steps
    n_steps = 3
    reset_counts(*counters)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, (x, labels))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launches = train_launches(at, fa, fm)
    losses = [float(v) for v in losses]
    n = spec.cfg.num_layers * n_steps
    print(f"train steps {hw}x{hw}: losses {losses}; launches in {n_steps} steps {launches}")
    route = ((f"flash_attention_fwd[bf16{sfx}]", f"flash_attention_bwd[bf16{sfx}]") if flash
             else (f"attention_train_fwd[bf16{sfx}]", f"attention_train_bwd[bf16{sfx}]"))
    assert launches == {k: n if k in route else 0 for k in launches}, launches
    assert all(np.isfinite(losses)), losses
    for k, m in state.masks.items():
        assert torch.equal(state.params[k].detach()[~m], pruned[k]), k

    # img/s, bench.py's scheme: best of 3 windows of 6 steps
    best = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(6):
            state, m = step(state, (x, labels))
        torch.cuda.synchronize()
        best = max(best, b * 6 / (time.perf_counter() - t1))
    print(f"train throughput {model} {hw}x{hw} bf16 {best:.1f} img/s at B={b} ({card}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # card vs CPU at B=n_cpu (on a cut depth); the f32 card steps counted
    t_cpu = time.time()
    xs, ys = u8[:n_cpu], labels[:n_cpu]
    cspec, cparams, cmasks = spec, params, masks
    if cpu_layers:
        cspec, cparams, cmasks = cut_model(spec, params, masks, cpu_layers)
        print(f"{model} card vs CPU {hw}x{hw}: cut to its first {cpu_layers} of "
              f"{spec.cfg.num_layers} blocks and B={n_cpu} (the CPU's time)")
    f32 = {}
    for dev in ("cuda", "cpu"):
        st = create_train_state(cspec, cparams, cmasks, ocfg, 100, device=dev)
        st_step = make_train_step(1000)
        batch = (normalize(xs.to(dev)), ys.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts(*counters)
        t2 = time.time()
        for _ in range(2):
            st, _ = st_step(st, batch)
        cpu_s = {"f32": time.time() - t2}
        f32[dev] = {k: p.detach().cpu() for k, p in st.params.items()}
        if dev == "cuda":
            f32_launches = train_launches(at, fa, fm)
            bf = loss_and_grads(st.model, st.masks, batch, 1000, compute_dtype=torch.bfloat16)
            bf_masks, bf_state = st.masks, {k: p.detach().cpu() for k, p in st.params.items()}
    print(f"train f32 {hw}x{hw} B={n_cpu} on the card: launches in 2 steps {f32_launches}")
    if flash:
        n2 = 2 * cspec.cfg.num_layers
        assert f32_launches[f"flash_attention_fwd[f32{sfx}]"] == n2, f32_launches
        assert f32_launches[f"flash_attention_bwd[f32{sfx}]"] == n2, f32_launches
        launches[f"flash_attention_bwd[f32{sfx}]"] = f32_launches[f"flash_attention_bwd[f32{sfx}]"]
    f32_err = max((f32["cuda"][k] - f32["cpu"][k]).abs().max().item() for k in f32["cpu"])
    print(f"cpu-vs-card train {hw}x{hw} f32: params after 2 steps max_abs_err {f32_err:.3e} "
          f"(atol 1e-4)")
    assert f32_err <= 1e-4, f32_err
    cpu_model = cspec.module()
    cpu_model.load_state_dict(bf_state)
    t2 = time.time()
    cpu_bf = loss_and_grads(cpu_model, {k: m.cpu() for k, m in bf_masks.items()},
                            (normalize(xs.cpu()), ys.cpu()), 1000,
                            compute_dtype=torch.bfloat16)
    cpu_s["bf16"] = time.time() - t2
    loss_gap = abs(float(bf[0]) - float(cpu_bf[0]))
    gg = torch.cat([g.flatten().cpu() for g in bf[2].values()])
    gc = torch.cat([cpu_bf[2][k].flatten() for k in bf[2]])
    g_rel = ((gg - gc).norm() / gc.norm()).item()
    print(f"cpu-vs-card train {hw}x{hw} bf16: loss {float(bf[0]):.5f} vs {float(cpu_bf[0]):.5f} "
          f"(gap {loss_gap:.2e}, tol 2e-2 relative); gradients relative L2 error "
          f"{g_rel:.3e} (tol 3e-2); card vs CPU {time.time() - t_cpu:.1f} s (the CPU's 2 f32 steps "
          f"{cpu_s['f32']:.1f} s, its bf16 gradients {cpu_s['bf16']:.1f} s)")
    assert loss_gap <= 2e-2 * abs(float(cpu_bf[0])), loss_gap
    assert g_rel <= 3e-2, g_rel
    if not lrr:
        return launches

    # one LRR round: reset -> train -> prune 20% more -> bake; then train on
    t1 = time.time()
    eval_step = make_eval_step(1000, compute_dtype=torch.bfloat16)
    loader = [(x, labels)] * 2
    state, acc1, sparsity = magnitude_pruning_round(
        step, eval_step, state, lambda e: loader, lambda: loader[:1], epochs=1,
        pruning_rate=0.2, print_freq=0)
    kept = sum(int(m.sum()) for m in state.masks.values())
    total = sum(m.numel() for m in state.masks.values())
    assert abs(sparsity - 60.0) < 0.01 and abs(100.0 * (1 - kept / total) - 60.0) < 0.01, sparsity
    reset_for_round(state)
    for _ in range(2):
        state, m = step(state, (x, labels))
    torch.cuda.synchronize()
    for k, msk in state.masks.items():
        assert bool((state.params[k].detach()[~msk] == 0).all()), k
    print(f"LRR round: sparsity 50% -> {sparsity:.4f}%, pruned slots exact zeros after 2 "
          f"more steps (loss {float(m['loss']):.4f}), {time.time() - t1:.1f} s")
    return launches


# Phase 11: vit_h_14 pruned and trained at 224x224 (T = 257 -> 384: the
# training kernels) and 392x392 (T = 785 -> 896: the flash kernels), both
# hd 80; SNIP at 392 in f32. B: the largest of 32 and 16 that fits the 224
# step, 16 at 392, 8 for SNIP's f32 forward and backward.
VIT_H_TRAIN = ((224, 32), (392, 16))
VIT_H_SNIP_BATCH = 8


def snip_phase(card, counters, hw=392, batch=VIT_H_SNIP_BATCH, target=SPARSITY):
    """SNIP on vit_h_14 at 392x392 in f32 (random weights from seed 0, 1000
    classes, uint8 images from seed 9 normalized on the card): first on its
    first VIT_H_CPU_LAYERS blocks at B=VIT_H_CPU_BATCH, card (the f32 flash
    kernels) against the CPU in f32 (the kernels' plain versions) and in
    f64 (the einsum: the truth, to f32's resolution): saliencies within
    1e-5 of their scale of the CPU's f32; masks at the target sparsity
    (exactly, but for saliencies tied at the threshold); where the card's
    and the CPU's f32 masks differ, both saliencies within twice the
    largest saliency difference of their thresholds (derived: no weight
    farther off can flip, so this cannot fail once the saliencies pass);
    and, binding at the threshold, the yardstick the f32 flash kernels
    are held to (10x nearer exact f32 than cuBLAS TF32): on the weights
    whose f64 saliency lies within 1% of the f64 threshold, the RMS of the
    card's saliency error against f64 at most 0.1 of a TF32 run's (the
    card with attention by the einsum and cuBLAS in TF32), and the card's
    masks wrong against the f64 masks on at most 0.1 as many weights as
    that run's (printed beside: the CPU's f32 and the card's einsum in
    f32, which show what the 3xTF32 kernels add). Then at full depth and B=``batch`` on
    the card, counted: 32 f32 hd-80 flash forward and 32 backward
    launches, no other kernel; the masks at the target sparsity; then 2
    bf16 train steps (the flash route) from those masks: finite losses,
    pruned slots unchanged. Returns the full-depth SNIP's launch counts."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.preprocess import make_device_normalize
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, snip_saliency, snip_threshold
    from vipers_torch.pruning.snip import vit_snip_loss
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    def masks_of(sal):
        thr = snip_threshold(sal, target)
        masks = {p: v > thr for p, v in sal.items()}
        n = sum(v.numel() for v in sal.values())
        pruned = n - sum(int(m.sum()) for m in masks.values())
        ties = sum(int((v == thr).sum()) for v in sal.values())
        k = int(n * target)
        assert k <= pruned <= k + ties - 1, (k, pruned, ties)
        return masks, float(thr), n, pruned, k, ties

    t0 = time.time()
    spec = build_model("vit_h_14", num_classes=1000, image_size=(hw, hw))
    params = to_device(spec.init(torch.Generator().manual_seed(0)), "cuda")
    rng = np.random.default_rng(9)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, hw, hw, 3), dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 1000, (batch,))).cuda()
    x = make_device_normalize()(u8)

    cut, cparams, _ = cut_model(spec, params, {}, VIT_H_CPU_LAYERS)
    sal = {}
    # name: device, dtype, attention by the einsum, cuBLAS in TF32
    runs = {"cuda": ("cuda", torch.float32, False, False),
            "cpu": ("cpu", torch.float32, False, False),
            "f64": ("cpu", torch.float64, True, False),  # the plain versions take no f64
            "einsum": ("cuda", torch.float32, True, False),
            "tf32": ("cuda", torch.float32, True, True)}
    for name, (dev, dtype, einsum, tf32) in runs.items():
        p = to_device(cparams, dev, dtype)
        xb = (x[:VIT_H_CPU_BATCH].to(dev, dtype), labels[:VIT_H_CPU_BATCH].to(dev))
        with attention_by_einsum(einsum), cublas_tf32(tf32):
            s = snip_saliency(vit_snip_loss(cut, 1000), p, xb,
                              init_masks(p, exclude=cut.prune_exclude))
        sal[name] = {k: v.cpu() for k, v in s.items()}
    got, thr, n, pruned, k, ties = masks_of(sal["cuda"])
    want, cthr, *_ = masks_of(sal["cpu"])
    scale = max(float(v.max()) for v in sal["cpu"].values())
    sal_err = max(float((sal["cuda"][p] - sal["cpu"][p]).abs().max()) for p in sal["cpu"])
    assert sal_err <= 1e-5 * scale, (sal_err, scale)
    # derived: a weight's masks can differ only where both saliencies lie
    # within twice the largest saliency difference of their thresholds (the
    # k-th smallest moves by at most that difference)
    band = 2 * sal_err
    flips, far = 0, 0.0
    for p in want:
        diff = got[p] != want[p]
        if not bool(diff.any()):
            continue
        flips += int(diff.sum())
        dist = torch.maximum((sal["cuda"][p][diff] - thr).abs(), (sal["cpu"][p][diff] - cthr).abs())
        far = max(far, float(dist.max()))
        assert far <= band, (p, far, band)
    # binding: against the f64 truth, on the weights that decide the mask
    truth, t64, *_ = masks_of(sal["f64"])
    others = [r for r in runs if r != "f64"]
    masks = {"cuda": got, "cpu": want,
             **{r: masks_of(sal[r])[0] for r in others if r not in ("cuda", "cpu")}}
    sq, wrong, near_n = dict.fromkeys(others, 0.0), dict.fromkeys(others, 0), 0
    for p, s64 in sal["f64"].items():
        near = (s64 - t64).abs() <= 1e-2 * t64
        near_n += int(near.sum())
        for r in others:
            sq[r] += float(((sal[r][p].double() - s64)[near] ** 2).sum())
            wrong[r] += int((masks[r][p] != truth[p]).sum())
    rms = {r: (v / max(near_n, 1)) ** 0.5 / t64 for r, v in sq.items()}
    print(f"SNIP vit_h_14 {hw}x{hw} f32, card vs CPU on its first {VIT_H_CPU_LAYERS} of "
          f"{spec.cfg.num_layers} blocks at B={VIT_H_CPU_BATCH}: {n} prunable weights, pruned "
          f"{pruned} (k = {k}, {ties} at the threshold {thr:.6e}; the CPU's {cthr:.6e}, f64 "
          f"{t64:.6e}); saliencies max_abs_err {sal_err:.3e}, {sal_err / scale:.2e} of their "
          f"scale {scale:.3e} (tol 1e-5); masks equal but for {flips} weights at the threshold "
          f"(the farthest {far:.2e} from it, {far / thr:.2e} relative; derived bound: twice "
          f"the saliency error, {band:.2e}); against f64, on the {near_n} weights within 1% "
          f"of its threshold, saliency RMS error (of the threshold) and masks wrong: "
          + ", ".join(f"{r} {rms[r]:.3e} {wrong[r]}" for r in others)
          + " (the card = cuda; einsum, tf32: the card with attention by the einsum, cuBLAS "
          f"in f32 and TF32; tol: the card 10x nearer f64 than tf32 on both); "
          f"{time.time() - t0:.1f} s")
    assert rms["cuda"] <= 0.1 * rms["tf32"], rms
    assert wrong["cuda"] <= 0.1 * wrong["tf32"], wrong
    del sal, got, want, truth

    reset_counts(*counters)
    loss_fn = vit_snip_loss(spec, 1000)
    base = init_masks(params, exclude=spec.prune_exclude)
    t1 = time.perf_counter()
    sal = snip_saliency(loss_fn, params, (x, labels), base)
    torch.cuda.synchronize()
    snip_s = time.perf_counter() - t1
    counted = train_launches(at, fa, fm)
    layers = spec.cfg.num_layers
    route = {"flash_attention_fwd[f32, hd80]": layers, "flash_attention_bwd[f32, hd80]": layers}
    assert counted == {k: route.get(k, 0) for k in counted}, counted
    masks, thr, n, pruned, k, ties = masks_of(sal)
    del sal
    print(f"SNIP vit_h_14 {hw}x{hw} f32 B={batch}, full depth on the card: {snip_s:.2f} s for "
          f"the saliencies; launches {counted}; {n} prunable weights, pruned {pruned} "
          f"({100 * pruned / n:.4f}%; k = {k}, {ties} at the threshold) ({card})")

    ocfg = OptimConfig(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4, epochs=10,
                       lr_scheduler="cosineannealinglr")
    state = create_train_state(spec, params, masks, ocfg, steps_per_epoch=100)
    pruned_w = {key: state.params[key].detach()[~m].clone() for key, m in state.masks.items()}
    step = make_train_step(1000, compute_dtype=torch.bfloat16)
    losses = []
    for _ in range(2):
        state, m = step(state, (x, labels))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    for key, m in state.masks.items():
        assert torch.equal(state.params[key].detach()[~m], pruned_w[key]), key
    print(f"vit_h_14 from the SNIP masks: 2 bf16 steps at {hw}x{hw} B={batch}, losses {losses}, "
          f"pruned slots unchanged ({time.time() - t0:.1f} s for the SNIP phase)")
    return counted


def vit_h_phase(card, counters):
    """Phase 11: vit_h_14 (32 blocks, D 1280, 16 heads of 80, mlp 5120,
    1000 classes) pruned and trained on the card at full width and depth:
    the bf16 masked train step at 224x224 (T = 257 -> 384: 32 hd-80
    training forward and backward launches a step, one LRR round) and
    392x392 (T = 785 -> 896: 32 hd-80 flash forward and backward a step),
    each card vs CPU on its first VIT_H_CPU_LAYERS blocks at
    B=VIT_H_CPU_BATCH; then SNIP (``snip_phase``). Returns the launches of
    the hd-80 training and backward rows."""
    rows = {}
    for hw, batch in VIT_H_TRAIN:
        tl = train_phase(card, counters, hw, VIT_H_CPU_BATCH, lrr=hw == 224, model="vit_h_14",
                         patch=14, batch=batch, cpu_layers=VIT_H_CPU_LAYERS)
        keys = (("attention_train_fwd[bf16, hd80]", "attention_train_bwd[bf16, hd80]")
                if hw == 224 else ("flash_attention_bwd[bf16, hd80]",))
        rows.update({k: tl[k] for k in keys})
        torch.cuda.empty_cache()
    rows["flash_attention_bwd[f32, hd80]"] = snip_phase(
        card, counters)["flash_attention_bwd[f32, hd80]"]
    torch.cuda.empty_cache()
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vipers_torch.core.device import card_line
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.discovery.lost import lost_core
    from vipers_torch.ops import _build
    from vipers_torch.ops import attention_train as at
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.ops import splash_attention as sa
    from vipers_torch.pruning import init_masks, magnitude_prune

    t_start = time.time()
    laps = [t_start]

    def lap(phase):
        """Prints the seconds since the last phase ended."""
        laps.append(time.time())
        print(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s")

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")
    # cuBLAS TF32 off keeps the f32 plain versions exact; cuDNN's is on by
    # default, so the f32 patch conv runs in TF32
    print(f"TF32: torch.backends.cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.time()
    logs = _build.build(["flash_attention_fwd", "flash_attention_bwd", "flash_attention_packed",
                         "fused_mlp", "attention_train", "splash_attention"],
                        ptxas_verbose=True)
    print(f"build {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line:  # which instance the next lines are
                print(f"  {name}: {line.strip()[:170]}")
            elif "registers" in line or "spill" in line or "serialized" in line:
                print(f"  {name}: {line.strip()}")

    lap(2)
    # 3. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_flash(fa, torch.float32, gen), check_flash(fa, torch.bfloat16, gen),
               check_flash_bwd(fa, torch.float32, gen), check_flash_bwd(fa, torch.bfloat16, gen),
               check_flash_packed(fa, torch.float32, gen),
               check_flash_packed(fa, torch.bfloat16, gen),
               check_fused_mlp(fm, gen), *check_attention_train(at, gen),
               *check_softmax_variants(at, gen), *check_splash(sa, gen)]
    check_attention_train_rounds(at, gen)
    check_fused_mlp_wide(fm, gen)
    # the ViT family's rows: row 1 at hd 80, row 4 at D = 768, 1024, 1280
    for dtype in (torch.float32, torch.bfloat16):
        kernels.append(check_flash_hd80(fa, dtype, gen))
        torch.cuda.empty_cache()
    kernels += check_fused_mlp_family(fm, gen)
    torch.cuda.empty_cache()
    # vit_h_14's train rows: the training kernels (rows 5-8) at its 224x224
    # shape and the flash backward (rows 12-13) at its 392x392 shape, hd 80
    kernels += check_attention_train(at, gen, shape=(32, 16, 384, 80), n_valid=257, ragged=150)
    for dtype in (torch.float32, torch.bfloat16):
        kernels.append(check_flash_bwd(fa, dtype, gen, shape=(16, 16, 896, 80), n_valid=785,
                                       ragged=400))
        torch.cuda.empty_cache()

    lap(3)
    # 4. main path
    t0 = time.time()
    spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W))
    params = spec.init(torch.Generator().manual_seed(0))
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                            amount=SPARSITY)
    kept = sum(int(m.sum()) for m in masks.values())
    total = sum(m.numel() for m in masks.values())
    print(f"vit_s_16 {H}x{W}: {total} prunable weights, sparsity "
          f"{100 * (1 - kept / total):.2f}% (set-up {time.time() - t0:.1f} s)")
    rng = np.random.default_rng(1)
    exact_hw = [(H, W)] * BATCH
    mixed_hw = [(H, W)] * 8 + [(int(rng.integers(449, H + 1)), int(rng.integers(321, W + 1)))
                               for _ in range(BATCH - 8)]
    buckets = {"exact": (make_images(rng, exact_hw), exact_hw),
               "mixed": (make_images(rng, mixed_hw), mixed_hw)}
    extractors = {name: LostFeatureExtractor(spec, params, masks, compute_dtype=dt)
                  for name, dt in (("f32", None), ("bf16", torch.bfloat16))}
    inputs = {(e, b): extractors[e].prepare_batch(imgs, PATCH, exact_hw=hw)
              for e in extractors for b, (imgs, hw) in buckets.items()}
    assert inputs["f32", "exact"][2] is None and inputs["f32", "exact"][4] is None
    assert inputs["f32", "mixed"][2] is not None and inputs["f32", "mixed"][4] is not None
    pipes = {e: ex.make_batched_pipeline(K_PATCHES) for e, ex in extractors.items()}
    torch.cuda.synchronize()

    counters = (fa.LAUNCHES, fa.PACKED_LAUNCHES, fa.BWD_LAUNCHES, fm.LAUNCHES,
                fm.WIDTH_LAUNCHES, at.LAUNCHES, sa.LAUNCHES)
    reset_counts(*counters)
    outs = {key: pipes[key[0]](*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd[f32]": fa.LAUNCHES["float32"],
                "flash_attention_fwd[bf16]": fa.LAUNCHES["bfloat16"],
                "fused_ln_fc1_gelu[bf16]": fm.LAUNCHES["bfloat16"]}
    print(f"LOST path launches (4 forwards, 12 blocks each): {launches}")
    assert not any(at.LAUNCHES.values()), at.LAUNCHES
    assert not any(fa.PACKED_LAUNCHES.values()), fa.PACKED_LAUNCHES
    assert not any(fa.BWD_LAUNCHES.values()), fa.BWD_LAUNCHES
    layers = spec.cfg.num_layers
    assert launches == {"flash_attention_fwd[f32]": 2 * layers,
                        "flash_attention_fwd[bf16]": 2 * layers,
                        "fused_ln_fc1_gelu[bf16]": 2 * layers}, launches

    gh, gw = H // PATCH, W // PATCH
    for (e, b), (box, seed, bg) in outs.items():
        box, seed, bg = box.cpu(), seed.cpu(), bg.cpu()
        assert box.shape == (BATCH, 4) and seed.shape == (BATCH,) and bg.shape == (BATCH,)
        assert bool(((box[:, 0] <= box[:, 1]) & (box[:, 1] <= gh)
                     & (box[:, 2] <= box[:, 3]) & (box[:, 3] <= gw)).all())
        assert bool(((seed >= 0) & (seed < gh * gw)).all())
        feats = extractors[e].batched_features(*inputs[e, b])
        assert feats.shape == (BATCH, gh * gw, 384) and bool(torch.isfinite(feats).all())
        print(f"pipeline [{e}, {b}] boxes ok, seed in background {int(bg.sum())}/{BATCH}, "
              f"mean box area {float(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2])).float().mean()):.1f} patches")
    agree = {b: float((outs["f32", b][0] == outs["bf16", b][0]).all(dim=1).float().mean())
             for b in buckets}
    print(f"bf16 vs f32 on the card: boxes equal on {agree}")

    for e, ex in extractors.items():
        for b, (imgs, hw) in buckets.items():
            compare_with_cpu(f"{e}, {b}", spec, params, masks, ex.compute_dtype, ex,
                             imgs, hw, lost_core)

    # throughput at B=128 (exact bucket) and p50 latency at B=1, bf16 and f32
    for e, ex in extractors.items():
        one = ex.prepare_batch(buckets["exact"][0][:1], PATCH, exact_hw=exact_hw[:1])
        ips, p50 = throughput(pipes[e], inputs[e, "exact"], one)
        print(f"throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{p50:.2f} ms at B=1 ({card})")

    lap(4)
    # 5. packed LOST path
    launches.update(packed_lost_phase(card, spec, extractors, buckets, outs["f32", "mixed"],
                                      lost_core))

    lap(5)
    # 6. JPEG -> boxes -> CorLoc through the CLI
    jpeg = jpeg_lost_phase(card, counters)

    lap(6)
    # 7. train path at 224x224: the training attention kernels
    tl = train_phase(card, counters, TRAIN_HW, N_CPU, lrr=True)
    launches.update({k: tl[k] for k in ("attention_train_fwd[bf16]", "attention_train_bwd[bf16]")})

    lap(7)
    # 8. train path at 384x384: the flash forward and backward kernels
    tl = train_phase(card, counters, TRAIN_HW_FLASH, 2, lrr=False)
    launches.update({k: tl[k] for k in ("flash_attention_bwd[f32]", "flash_attention_bwd[bf16]")})

    lap(8)
    # 9. the A/B tools
    launches.update(tools_phase(counters))

    lap(9)
    # 10. the ViT family on the LOST path
    family_rows, family_cli_run = family_phase(card, counters, lost_core)
    launches.update(family_rows)

    lap(10)
    # 11. vit_h_14 pruned and trained: the hd-80 training kernels and flash
    # backward, SNIP
    launches.update(vit_h_phase(card, counters))
    lap(11)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if jpeg:  # the CLI runs' launches beside the pipeline's, on the rows they drove
        for k in kernels:
            cli = {"flash_attention_fwd[bf16]": ("bf16", "flash"),
                   "flash_attention_fwd[f32]": ("f32", "flash"),
                   "flash_attention_packed[bf16]": ("bf16 packed", "packed"),
                   "fused_ln_fc1_gelu[bf16]": ("bf16", "fused_mlp")}.get(k["name"])
            if cli:
                k["cli_launches"] = jpeg[cli[0]][cli[1]]
    if family_cli_run:  # vit_b_16's CLI run, on the D = 768 row it drove
        for k in kernels:
            if k["name"] == "fused_ln_fc1_gelu[bf16, D=768]":
                k["cli_launches"] = family_cli_run["fused_mlp[D=768]"]

    print(f"chip_smoke total {time.time() - t_start:.1f} s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the contract's keys first, then a row's own (the fused MLP's rate and design)
    print(json.dumps({"kernels": [{**{k: kd[k] for k in keys}, **kd} for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
