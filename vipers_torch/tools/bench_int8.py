"""int8 against bf16 on the port's batched LOST pipeline, across model
scale: the port of ``tools/bench_int8.py``.

ViT-S/16 and ViT-B/16 at 512x384 (T = 769 tokens, padded to 896 on the
flash route), random weights from seed 0 with a 50% global magnitude
mask, through ``LostFeatureExtractor.make_batched_pipeline``: bf16, then
``compute_dtype="int8"`` (int8 kernels baked from the masked weights,
every Dense and the patch embedding executed in real int8 with dynamic
per-tensor input qparams, the attention projections and the rest in bf16,
the fused MLP off). Each figure is img/s, best of 3 rounds of
``--n-batches`` batches, host clock to the boxes on the host, after one
untimed batch; the images are seeded normal noise (already normalized,
as the JAX tool feeds them). Runs on the card:

    python -m vipers_torch.tools.bench_int8 [--models vit_s_16 vit_b_16] [--batch 128]

``--device cpu`` runs the plain versions (host clock); with ``--layers``
each model is cut to its first blocks. The last line is a JSON object:
{model: {"bf16": img/s, "int8": img/s, "int8_over_bf16": ratio}}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from vipers_torch.tools.bench_slim import H, PATCH, W, pipeline_img_s

BATCH, N_BATCHES, SPARSITY = 128, 4, 0.5


def run(models=("vit_s_16", "vit_b_16"), layers: int = 12, batch: int = BATCH,
        n_batches: int = N_BATCHES, device: str = "cuda") -> dict:
    from vipers_torch.core.device import resolve_device
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    dev = resolve_device(device)
    imgs = np.random.default_rng(1).normal(size=(batch, H, W, 3)).astype(np.float32)
    out = {}
    for model in models:
        cut = {"arch_overrides": {"num_layers": layers}} if layers != 12 else {}
        spec = build_model(model, num_classes=1000, image_size=(H, W), **cut)
        params = spec.init(torch.Generator().manual_seed(0))
        masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                                amount=SPARSITY)
        row = {tag: round(pipeline_img_s(spec, params, masks, imgs, dtype, dev, n_batches), 1)
               for tag, dtype in (("bf16", torch.bfloat16), ("int8", "int8"))}
        row["int8_over_bf16"] = round(row["int8"] / row["bf16"], 3)
        out[model] = row
        print(f"{model:10s} B={batch}: bf16 {row['bf16']:7.1f} img/s, int8 "
              f"{row['int8']:7.1f} img/s", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+", default=["vit_s_16", "vit_b_16"])
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--n-batches", type=int, default=N_BATCHES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    out = run(a.models, a.layers, a.batch, a.n_batches, a.device)
    if a.device == "cuda":
        from vipers_torch.core.device import card_line

        out["device"] = card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
