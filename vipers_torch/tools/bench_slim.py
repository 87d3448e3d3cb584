"""A/B of the structured-slimming payoff on the port's batched LOST
pipeline: the port of ``tools/bench_slim.py``.

ViT-S/16 at 512x384, B=128 (T = 769 tokens, padded to 896 on the flash
route), random weights from seed 0 with a 50% global magnitude mask, is
timed twice through ``LostFeatureExtractor.make_batched_pipeline``, in
bf16 and f32: the masked dense model, then ``slim_vit(mlp_keep=0.5,
heads_keep=0.5, round_to=128)`` of the same tree (mlp 1536 -> 768, heads
6 -> 4), the widths ``vipers_torch slim --mlp-keep 0.5 --heads-keep 0.5``
writes. Unstructured masks never speed up a dense product; this prints
what physically smaller products buy. Each figure is img/s, best of 3
rounds of ``--n-batches`` batches, host clock to the boxes on the host,
after one untimed batch; the images are seeded normal noise (already
normalized, as the JAX tool feeds them). Runs on the card:

    python -m vipers_torch.tools.bench_slim [--layers 12] [--batch 128]

``--device cpu`` runs the kernels' plain versions (host clock); with
``--layers`` the model is cut to its first blocks.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

H, W, PATCH = 512, 384, 16
BATCH, N_BATCHES, SPARSITY, K_PATCHES = 128, 4, 0.5, 100


def pipeline_img_s(spec, params, masks, imgs, dtype, device, n_batches: int) -> float:
    """Best-of-3 img/s of the batched LOST pipeline on ``imgs``."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    ex = LostFeatureExtractor(spec, params, masks, compute_dtype=dtype, device=device)
    pipe = ex.make_batched_pipeline(K_PATCHES)
    inputs = ex.prepare_batch(list(imgs), PATCH)
    pipe(*inputs)[0].cpu()
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            out = pipe(*inputs)
        out[0].cpu()
        best = max(best, len(imgs) * n_batches / (time.perf_counter() - t0))
    return best


def run(layers: int = 12, batch: int = BATCH, n_batches: int = N_BATCHES,
        device: str = "cuda") -> dict:
    """The dense and slim img/s in bf16 and f32, the overrides and the
    parameter reduction, as the JAX tool's JSON line."""
    from vipers_torch.core.device import resolve_device
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.pruning.structured import slim_vit

    dev = resolve_device(device)
    cut = {"num_layers": layers} if layers != 12 else {}
    spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W),
                       **({"arch_overrides": cut} if cut else {}))
    params = spec.init(torch.Generator().manual_seed(0))
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                            amount=SPARSITY)
    slim_vars, slim_masks, overrides, report = slim_vit(
        {"params": params}, masks, spec.cfg, mlp_keep=0.5, heads_keep=0.5, round_to=128)
    slim_spec = build_model("vit_s_16", num_classes=1000, image_size=(H, W),
                            arch_overrides={**cut, **overrides})
    imgs = np.random.default_rng(1).normal(size=(batch, H, W, 3)).astype(np.float32)
    out = {"overrides": overrides,
           "param_reduction_pct": round(100 * report.param_reduction, 1)}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        dense = pipeline_img_s(spec, params, masks, imgs, dtype, dev, n_batches)
        slim = pipeline_img_s(slim_spec, slim_vars["params"], slim_masks, imgs, dtype, dev,
                              n_batches)
        out[tag] = {"dense_masked": round(dense, 1), "slim": round(slim, 1),
                    "speedup": round(slim / dense, 3)}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--n-batches", type=int, default=N_BATCHES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    out = run(a.layers, a.batch, a.n_batches, a.device)
    if a.device == "cuda":
        from vipers_torch.core.device import card_line

        out["device"] = card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
