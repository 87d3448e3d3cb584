"""Quickest proof that the PyTorch/CUDA port (``vipers_torch``) runs on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: both CUDA kernels from ``vipers_torch/csrc``, one nvcc each, in
     parallel;
  3. kernels against their plain PyTorch versions at the main path's shapes
     (flash attention f32 and bf16, fused LN->fc1->GELU bf16): max error
     against the stated tolerance, kernel / plain / library times (CUDA
     events, median), and the bound from the work's FLOPs and bytes;
  4. main path: full-width ViT-S/16 (12 layers, D=384, 6 heads, mlp 1536)
     from a seeded generator, 50% global magnitude mask, 512x384 uint8
     images, ``make_batched_pipeline`` in f32 and bf16 at B=128 on an
     exact-fit and a mixed-size bucket; the launch counters must show every
     block went through the kernels; B=4 against the same extractor on the
     CPU (plain versions); img/s at B=128 and p50 latency at B=1.
The line before the last is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
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
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        tol = "atol 1e-5 rtol 1e-4"
    else:
        scale = want.float().abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)
        tol = f"2e-2 of output scale {scale:.3g}"
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, valid))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, valid), reps=5)
    amask = valid[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=amask))
    elt = q.element_size()
    flops = 4 * b * h * t * t * hd
    nbytes = 4 * q.numel() * elt + lse.numel() * 4 + valid.numel()
    bms, by = bound(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    name = "f32" if dtype == torch.float32 else "bf16"
    print(f"flash_attention_fwd[{name}] max_abs_err {err:.3e} ({tol}) kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
    return {"name": f"flash_attention_fwd[{name}]", "route": "cuda",
            "source": "vipers_torch/csrc/flash_attention_fwd.cu",
            "replaces": "vipers/ops/flash_attention.py:91",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def check_fused_mlp(fm, gen):
    """Fused LN->fc1->GELU kernel vs plain at (128*896, 384) x (384, 1536)."""
    m, d, f = BATCH * 896, 384, 1536
    x = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.3 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    kernel = torch.randn(d, f, generator=gen, device="cuda") / d ** 0.5
    bias = 0.1 * torch.randn(f, generator=gen, device="cuda")
    w_eff_t, b_eff = fm.fold_ln_affine(gamma, beta, kernel, bias, torch.bfloat16)
    out = fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
    want = fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= 2e-2 * scale, (err, scale)
    ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff))
    plain_ms = cuda_ms(lambda: fm.fused_ln_dense_gelu_plain(x, w_eff_t, b_eff, 1e-6), reps=5)
    g16, b16 = gamma.bfloat16(), beta.bfloat16()
    wt16, bb16 = kernel.t().contiguous().bfloat16(), bias.bfloat16()
    lib_ms = cuda_ms(lambda: F.gelu(F.linear(F.layer_norm(x, (d,), g16, b16, 1e-6),
                                             wt16, bb16), approximate="tanh"))
    flops = 2 * m * d * f
    nbytes = (x.numel() + w_eff_t.numel() + out.numel()) * 2 + b_eff.numel() * 4
    bms, by = bound(flops, nbytes, PEAK_BF16)
    print(f"fused_ln_fc1_gelu[bf16] max_abs_err {err:.3e} (2e-2 of output scale "
          f"{scale:.3g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
          f"layer_norm+linear+gelu {lib_ms:.3f} ms bound {bms:.3f} ms ({by}; "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB)")
    return {"name": "fused_ln_fc1_gelu[bf16]", "route": "cuda",
            "source": "vipers_torch/csrc/fused_mlp.cu",
            "replaces": "vipers/ops/fused_mlp.py:123",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def make_images(rng, exact_hw):
    """Tier-1-padded uint8 images, zero beyond the exact pixel extent, each
    with a bright block on textured noise."""
    imgs = []
    for h, w in exact_hw:
        im = np.zeros((-(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH, 3), np.uint8)
        im[:h, :w] = rng.integers(0, 110, (h, w, 3), dtype=np.uint8)
        r, c = rng.integers(0, h // 2), rng.integers(0, w // 2)
        im[r:r + h // 3, c:c + w // 3] = rng.integers(170, 256, 3, dtype=np.uint8)
        imgs.append(im)
    return imgs


def compare_with_cpu(tag, spec, params, masks, dtype, ex, imgs, exact_hw, lost_core):
    """B=N_CPU images through the same extractor on the CPU (plain kernel
    versions). f32: features within 1e-3 of their scale and equal boxes
    (a seed may differ only inside a tie at the top score); bf16: print."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    cpu = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype, device="cpu")
    sub, hw = imgs[:N_CPU], exact_hw[:N_CPU]
    gin, cin = ex.prepare_batch(sub, PATCH, exact_hw=hw), cpu.prepare_batch(sub, PATCH, exact_hw=hw)
    gf = ex.batched_features(*gin).float().cpu()
    cf = cpu.batched_features(*cin).float()
    gbox, gseed, gbg = (z.cpu() for z in ex.make_batched_pipeline(K_PATCHES)(*gin))
    cbox, cseed, cbg = cpu.make_batched_pipeline(K_PATCHES)(*cin)
    scale = cf.abs().max().item()
    ferr = (gf - cf).abs().max().item()
    same_seed = (gseed == cseed)
    same_box = (gbox == cbox).all(dim=1)
    print(f"cpu-vs-card [{tag}] features max_abs_err {ferr:.3e} (scale {scale:.3g}); "
          f"seeds equal {int(same_seed.sum())}/{N_CPU}, boxes equal "
          f"{int(same_box.sum())}/{N_CPU}, bg flags equal {int((gbg == cbg).sum())}/{N_CPU}")
    if dtype == torch.float32:
        assert ferr <= 1e-3 * scale, (ferr, scale)
        scores = lost_core(cf, cin[3], (H // PATCH, W // PATCH), K_PATCHES)["scores"]
        for i in range(N_CPU):
            if same_seed[i]:
                assert same_box[i] and gbg[i] == cbg[i], (i, gbox[i], cbox[i])
            else:
                s = scores[i]
                assert s[gseed[i]] == s[cseed[i]] == s.max(), (i, gseed[i], cseed[i])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.discovery.lost import lost_core
    from vipers_torch.ops import _build
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm
    from vipers_torch.pruning import init_masks, magnitude_prune

    t_start = time.time()
    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.time()
    logs = _build.build(["flash_attention_fwd", "fused_mlp"], ptxas_verbose=True)
    print(f"build {time.time() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_flash(fa, torch.float32, gen), check_flash(fa, torch.bfloat16, gen),
               check_fused_mlp(fm, gen)]

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

    for counts in (fa.LAUNCHES, fm.LAUNCHES):
        for key in counts:
            counts[key] = 0
    outs = {key: pipes[key[0]](*inp) for key, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd[f32]": fa.LAUNCHES["float32"],
                "flash_attention_fwd[bf16]": fa.LAUNCHES["bfloat16"],
                "fused_ln_fc1_gelu[bf16]": fm.LAUNCHES["bfloat16"]}
    print(f"main path launches (4 forwards, 12 blocks each): {launches}")
    layers = spec.cfg.num_layers
    assert launches == {"flash_attention_fwd[f32]": 2 * layers,
                        "flash_attention_fwd[bf16]": 2 * layers,
                        "fused_ln_fc1_gelu[bf16]": 2 * layers}, launches
    for k in kernels:
        k["launches"] = launches[k["name"]]

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
        inp = inputs[e, "exact"]
        pipes[e](*inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            out = pipes[e](*inp)
        out[0].cpu()
        ips = 3 * BATCH / (time.perf_counter() - t0)
        one = ex.prepare_batch(buckets["exact"][0][:1], PATCH, exact_hw=exact_hw[:1])
        lats = []
        for _ in range(23):
            t0 = time.perf_counter()
            pipes[e](*one)[0].cpu()
            lats.append(1e3 * (time.perf_counter() - t0))
        print(f"throughput [{e}] {ips:.1f} img/s at B={BATCH}; p50 latency "
              f"{statistics.median(lats[3:]):.2f} ms at B=1 ({card})")

    print(f"chip_smoke total {time.time() - t_start:.1f} s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
