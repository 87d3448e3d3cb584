"""Exported ``torch.export`` artifact replay against the eager program,
img/s: the port of ``tools/bench_export.py``.

The serving claim behind ``vipers_torch export`` (``core/export.py``) is
that the artifact is the program: the same kernels and ATen ops, replayed
by the generated code of the loaded program instead of the Python model.
Three surfaces, random weights from seed 0 with a 50% global magnitude
mask, bf16, seeded normal images (already normalized, as the artifact's
contract feeds them):

  * classify: pruned ViT-S/16 forward at 224x224 (the ``evaluate`` path);
  * lost: the batched LOST program at the VOC bucket 512x384 (769 tokens);
  * lost_cnn: the batched CNN LOST program on ResNet-50 at its canonical
    bucket input of 512x384 (its own: 512 and 384 are stride multiples).

Each figure is img/s, best of 3 rounds of ``--reps`` calls with the
outputs on the host, after one untimed call; the artifact is saved,
loaded back (``load_artifact``) and timed beside the eager module that
was exported. Runs on the card:

    python -m vipers_torch.tools.bench_export [--batch 128] [--pipelines classify lost lost_cnn]

On the card it also measures what the custom ops and the ``while_loop``
flood fill cost the host (``op_host_cost``: each wrapper through its op
against the bare launch, the fill against a Python loop, microseconds a
call at shapes where the kernels take microseconds).
``--device cpu --layers 1 --batch 1 --reps 1`` rehearses it on the CPU
(ViT-S/16 cut to its first block; ResNet-50 stays whole). The last line
is a JSON object: {pipeline: {"eager": img/s, "artifact": img/s,
"artifact_over_eager": ratio, "mb": artifact size}, "host_us": {...}}.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

PIPELINES = ("classify", "lost", "lost_cnn")


def img_s(fn, x, reps: int) -> float:
    """img/s of ``fn(x)``, outputs copied to the host: best of 3 rounds."""
    def call():
        out = fn(x)
        return [o.cpu() for o in (out if isinstance(out, tuple) else (out,))]

    call()
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        best = max(best, x.shape[0] * reps / (time.perf_counter() - t0))
    return best


def host_us_per_call(fn, n: int = 2000) -> float:
    """Mean microseconds a call of ``fn`` holds the host, the device synced
    once before and once after ``n`` calls."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / n


def op_host_cost() -> dict:
    """What the custom ops and the ``while_loop`` fill cost the host on the
    card: each kernel's wrapper through its op against the op's CUDA
    implementation called as a plain function (the ctypes launch alone) at
    shapes where the kernels take microseconds (row 1 bf16 at B*H = 1, T =
    128; row 4 at M = 128, D = 384, F = 1536), and the fill of 128 seeded
    24 x 32 grids against the same dilations in a Python loop that syncs on
    ``torch.equal`` every ``CHECK_EVERY`` steps. Microseconds a call."""
    from vipers_torch.discovery import components as C
    from vipers_torch.ops import flash_attention as fa
    from vipers_torch.ops import fused_mlp as fm

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 1, 128, 64, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    x = torch.randn(128, 384, generator=g, device="cuda").bfloat16()
    w = torch.randn(1536, 384, generator=g, device="cuda").bfloat16()
    b = torch.randn(1536, generator=g, device="cuda")
    cpu = torch.Generator().manual_seed(0)
    mask = (torch.rand(128, 24, 32, generator=cpu) > 0.4).cuda()
    seed = torch.stack([torch.randint(0, 24, (128,), generator=cpu),
                        torch.randint(0, 32, (128,), generator=cpu)], 1).cuda()

    def loop_fill():
        cur = torch.zeros_like(mask)
        cur[torch.arange(128, device="cuda"), seed[:, 0], seed[:, 1]] = True
        cur &= mask
        while True:
            for _ in range(C.CHECK_EVERY):
                prev, cur = cur, C._dilate4(cur) & mask
            if torch.equal(cur, prev):
                return cur

    with torch.inference_mode():
        assert torch.equal(loop_fill(), C.flood_fill_from_seed(mask, seed))
        return {
            "flash_op": host_us_per_call(lambda: fa.flash_attention_fwd(q, k, v, None, 0.125)),
            "flash_launch": host_us_per_call(lambda: fa._flash_fwd_cuda(q, k, v, None, 0.125)),
            "fused_op": host_us_per_call(lambda: fm.fused_ln_dense_gelu_core(x, w, b)),
            "fused_launch": host_us_per_call(lambda: fm._fused_cuda(x, w, b, 1e-6)),
            "fill_while_loop": host_us_per_call(lambda: C.flood_fill_from_seed(mask, seed), 50),
            "fill_python_loop": host_us_per_call(loop_fill, 50)}


def run(pipelines=PIPELINES, batch: int = 128, reps: int = 4, layers: int = 12,
        device: str = "cuda") -> dict:
    from vipers_torch.core import export as E
    from vipers_torch.core.device import resolve_device
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    dev = resolve_device(device)
    out = {}
    for pipeline in pipelines:
        hw = (224, 224) if pipeline == "classify" else (512, 384)
        if pipeline == "lost_cnn":
            spec = build_model("resnet50", num_classes=1000)
        else:
            cut = {"arch_overrides": {"num_layers": layers}} if layers != 12 else {}
            spec = build_model("vit_s_16", num_classes=1000, image_size=hw, **cut)
        params = spec.init(torch.Generator().manual_seed(0))
        masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude),
                                amount=0.5)
        kw = dict(masks=masks, dtype=torch.bfloat16, device=dev)
        if pipeline == "classify":
            eager = E.make_serving_forward(spec, params, **kw)
            program, meta = E.export_serving(spec, params, batch_size=batch, **kw)
        else:
            make = E.make_cnn_lost_serving_forward if pipeline == "lost_cnn" \
                else E.make_lost_serving_forward
            eager = make(spec, params, batch_size=batch, image_size=hw, **kw)
            program, meta = E.export_lost_pipeline(spec, params, batch_size=batch,
                                                   image_size=hw, **kw)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(batch, *hw, 3)).astype(np.float32)).to(dev)
        with tempfile.TemporaryDirectory() as td:
            nbytes = E.save_artifact(td, program, meta)
            del program
            replay, _ = E.load_artifact(td)
            with torch.no_grad():
                d = img_s(eager, x, reps)
            r = img_s(replay, x, reps)
        out[pipeline] = {"eager": round(d, 1), "artifact": round(r, 1),
                         "artifact_over_eager": round(r / d, 3), "mb": round(nbytes / 1e6, 1)}
        print(f"{pipeline}: eager {d:7.1f} img/s | artifact replay {r:7.1f} img/s "
              f"({100 * r / d:5.1f}%) | {nbytes / 1e6:.1f} MB artifact", flush=True)
        del eager, replay
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pipelines", nargs="+", default=list(PIPELINES), choices=PIPELINES)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    out = run(a.pipelines, a.batch, a.reps, a.layers, a.device)
    if a.device == "cuda":
        from vipers_torch.core.device import card_line

        out["host_us"] = {k: round(v, 2) for k, v in op_host_cost().items()}
        print(f"host us a call: {out['host_us']}")
        out["device"] = card_line()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
