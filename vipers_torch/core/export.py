"""Serving export: the model forward or the batched LOST program as a
``torch.export`` artifact (port of ``vipers/core/export.py``).

``vipers_torch export`` traces the serving forward (dense, pruned with the
masks baked in, structurally slimmed through the ``.slim.json`` sidecar, or
real int8 with the checkpoint's calibrated qparams) with non-strict
``torch.export.export`` at a static batch and writes::

    <out>/model.pt2    torch.export.save of the program, weights inside
    <out>/meta.json    model name, shapes, dtype, sparsity, platform

The JAX artifact embeds its Pallas kernels in StableHLO; a torch artifact
names the port's kernels as custom ops (``vipers_torch::flash_attention_fwd``,
``vipers_torch::fused_ln_dense_gelu``, ...), which must be registered when
it loads. So replaying needs ``torch`` and ``vipers_torch.ops`` (whose
import registers them, and builds a kernel on its first launch), and no
model, driver or checkpoint code::

    fn, meta = load_artifact(out_dir)
    logits = fn(images)          # (B, H, W, 3) float32 -> (B, classes) f32

On the card the exported LOST program launches the same kernels, as many
times a batch, as the eager pipeline.

Serving contract, as in JAX: the input is float32 NHWC, already normalized
(what ``data/preprocess.py`` produces); compute runs in the dtype chosen at
export; logits come back float32, and the LOST program returns (boxes xyxy
f32 in image coordinates, seed i32, seed_in_background bool). A
``torch.export`` program is one device's program: the artifact records the
device it was exported on (``cuda`` by default, ``cpu`` under ``--device
cpu``) and refuses to run anywhere else.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

import torch

_ARTIFACT = "model.pt2"
_META = "meta.json"

_TOKEN_FAMILIES = ("vit", "dino_vit")
LOAD_REQUIRES = ("torch and vipers_torch.ops: importing vipers_torch.ops registers the "
                 "vipers_torch:: custom ops the program calls")


def _compute_dtype_name(dtype, int8: bool) -> str:
    if int8:
        return "int8+bf16"
    return str(dtype or torch.float32).replace("torch.", "")


def _extractor(spec, params, masks, dtype, int8, observers, batch_stats, device, **kw):
    from vipers_torch.discovery.driver import LostFeatureExtractor

    return LostFeatureExtractor(spec, params, masks, compute_dtype="int8" if int8 else dtype,
                                device=device, batch_stats=batch_stats, observers=observers,
                                **kw)


class _Serving(torch.nn.Module):
    """A serving forward over an extractor's model: its parameters and
    buffers, and the int8 kernels, scales and static qparams as buffers, so
    ``torch.export`` lifts all of them into the artifact."""

    def __init__(self, ex):
        super().__init__()
        self.model, self.ex = ex.model, ex
        if ex.int8:
            for i, t in enumerate([*ex._q.values(), *ex._scales.values(),
                                   *(z for qp in (ex._static_qparams or {}).values()
                                     for z in qp)]):
                self.register_buffer(f"int8_{i}", t, persistent=False)


class _Classify(_Serving):
    def forward(self, images):
        from vipers_torch.models.cnn import exact_f32_convs

        ex = self.ex
        kwargs = {"need_attn": False} if ex.spec.family in _TOKEN_FAMILIES else {}
        with exact_f32_convs(ex.compute_dtype), ex._int8_scope():
            logits, _aux = self.model(images.to(ex.compute_dtype), **kwargs)
        return logits.float()


class _Lost(_Serving):
    def __init__(self, ex, k_patches: int, valid_hw, grid, scales, hw, pos=None):
        super().__init__(ex)
        self.k_patches, self.grid, self.scales, self.hw = k_patches, grid, scales, hw
        self.register_buffer("valid_hw", valid_hw)
        self.register_buffer("pos", pos)

    def forward(self, images):
        from vipers_torch.discovery.lost import lost_core

        ex = self.ex
        if self.pos is None:
            feats = ex.traceable_cnn_features(images, self.valid_hw)
        else:
            b = images.shape[0]
            feats = ex.traceable_features(images, self.pos.expand(b, -1, -1), None,
                                          self.valid_hw)
        out = lost_core(feats, self.valid_hw, self.grid, k_patches=self.k_patches, lean=True)
        ymin, ymax, xmin, xmax = (out["box_feat"][:, i].float() for i in range(4))
        (sy, sx), (h, w) = self.scales, self.hw
        boxes = torch.stack([sx * xmin, sy * ymin, torch.clamp(sx * xmax, max=float(w)),
                             torch.clamp(sy * ymax, max=float(h))], dim=-1)
        return boxes, out["seed"].to(torch.int32), out["seed_in_background"]


def make_serving_forward(spec, params, masks=None, dtype=None, int8: bool = False,
                         observers=None, batch_stats=None, device=None):
    """``fn(images) -> logits``, a module ready to call or export.

    The serving setup is the LOST extractor's (``discovery.driver``,
    ``LostFeatureExtractor``): masks baked into the weights once, float
    parameters cast to the compute dtype (a ResNet's running statistics
    stay f32), and in int8 mode every quantizable Dense/Conv executed as a
    real integer product with dynamic, or observer-calibrated static,
    activation qparams (bf16 elsewhere)."""
    return _Classify(_extractor(spec, params, masks, dtype, int8, observers, batch_stats,
                                device))


def _program(module, batch_size: int, image_size, device):
    h, w = image_size
    x = torch.zeros((batch_size, h, w, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (x,), strict=False)
    program.example_inputs = None  # else torch.export.save writes the zero batch too
    return program


def _ops_in(program) -> list:
    """The vipers_torch custom ops the program calls, by name."""
    return sorted({node.target._schema.name
                   for gm in program.graph_module.modules()
                   if isinstance(gm, torch.fx.GraphModule)
                   for node in gm.graph.nodes
                   if isinstance(node.target, torch._ops.OpOverload)
                   and node.target.namespace == "vipers_torch"})


@contextlib.contextmanager
def _no_cudnn_tf32():
    """``models.cnn.exact_f32_convs`` for f32, here so that loading an
    artifact imports no model code."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _base_meta(spec, device, batch_size, image_size, dtype, int8, program) -> dict:
    from vipers_torch.core.device import resolve_device

    dev = resolve_device(device)
    h, w = image_size
    return {
        "model": spec.name,
        "family": spec.family,
        "input_shape": [batch_size, h, w, 3],
        "input_dtype": "float32",
        "compute_dtype": _compute_dtype_name(dtype, int8),
        "platforms": [dev.type],
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "torch_version": torch.__version__,
        "custom_ops": _ops_in(program),
        "load_requires": LOAD_REQUIRES,
        # f32 convolutions are exact f32, as in the eager forward
        # (models.cnn.exact_f32_convs): load_artifact turns cuDNN TF32 off
        "exact_f32_convs": dtype is None and not int8,
    }


def export_serving(spec, params, *, batch_size: int, image_size: Optional[tuple] = None,
                   masks=None, dtype=None, int8: bool = False, observers=None,
                   batch_stats=None, device=None):
    """Export the serving forward for a fixed batch shape; returns
    ``(program, meta)``. Weights are in the program; the batch is static,
    one artifact per serving batch size."""
    image_size = tuple(image_size or spec.input_size)
    module = make_serving_forward(spec, params, masks=masks, dtype=dtype, int8=int8,
                                  observers=observers, batch_stats=batch_stats, device=device)
    program = _program(module, batch_size, image_size, module.ex.device)
    out_shape = [int(d) for d in program.graph_module.graph.find_nodes(op="output")[0]
                 .args[0][0].meta["val"].shape]
    sparsity = None
    if masks:
        from vipers_torch.pruning.masks import compute_sparsity_global

        sparsity = float(compute_sparsity_global(params, masks))
    meta = _base_meta(spec, module.ex.device, batch_size, image_size, dtype, int8, program)
    meta.update({
        "output_shape": out_shape,
        "output_dtype": "float32",
        "num_classes": out_shape[-1] if len(out_shape) == 2 else None,
        "sparsity_pct": sparsity,
        "calibrated_sites": len(observers) if (int8 and observers) else 0,
    })
    return program, meta


def make_lost_serving_forward(spec, params, *, batch_size: int, image_size: tuple,
                              masks=None, dtype=None, int8: bool = False, observers=None,
                              k_patches: int = 100, which_features: str = "k",
                              batch_stats=None, device=None):
    """``fn(images (B, H, W, 3) f32) -> (boxes xyxy f32, seed i32,
    seed_in_background bool)`` over the batched LOST program of a ViT or
    DINO ViT (``make_batched_pipeline``'s work), with the weights, the
    interpolated pos-embeddings and the box scaling inside: what
    :func:`export_lost_pipeline` exports and ``--verify`` replays. The
    extractor runs at ``bucket=1``: the serving shape fits exactly, so no
    token mask (the seq pad to a 128 multiple stays inside the model)."""
    import numpy as np

    h, w = image_size
    p = spec.patch_size
    ex = _extractor(spec, params, masks, dtype, int8, observers, batch_stats, device,
                    which_features=which_features, bucket=1)
    dummy = [np.zeros((h, w, 3), np.float32)] * batch_size
    _imgs, pos, tmask, vhw = ex.prepare_batch(dummy, p)
    if tmask is not None:
        raise ValueError(f"serving shape {h}x{w} does not fit its bucket exactly")
    return _Lost(ex, k_patches, vhw, (h // p, w // p), (p, p), (h, w), pos=pos[:1].contiguous())


def make_cnn_lost_serving_forward(spec, params, *, batch_size: int, image_size: tuple,
                                  masks=None, dtype=None, int8: bool = False, observers=None,
                                  k_patches: int = 100, batch_stats=None, device=None):
    """The CNN counterpart of :func:`make_lost_serving_forward`: the batched
    CNN LOST program (``make_batched_cnn_pipeline``: batched conv features,
    masked slab LayerNorm, LOST core) at ONE canonical bucket input shape,
    weights and the feature -> image box scaling inside. A shape that is
    not a canonical bucket input raises, naming the nearest one."""
    h, w = image_size
    ex = _extractor(spec, params, masks, dtype, int8, observers, batch_stats, device,
                    which_features="k")
    canon = ex.cnn_bucket_key(h, w)
    if canon != (h, w):
        raise ValueError(
            f"serving shape {h}x{w} is not a canonical CNN bucket input for {spec.name}; "
            f"the nearest canonical shape is {canon[0]}x{canon[1]}: export at that size "
            "and feed zero-padded images")
    fh, fw = ex._cnn_fdim(h), ex._cnn_fdim(w)
    vhw = torch.tensor([[fh, fw]] * batch_size, dtype=torch.int32, device=ex.device)
    return _Lost(ex, k_patches, vhw, (fh, fw), tuple(ex.cnn_scales(h, w)), (h, w))


def export_lost_pipeline(spec, params, *, batch_size: int, image_size: tuple, masks=None,
                         dtype=None, int8: bool = False, observers=None, k_patches: int = 100,
                         which_features: str = "k", batch_stats=None, device=None):
    """The batched LOST program, ``vipers_torch lost``'s product path, as a
    serving artifact for a FIXED image shape (a patch multiple for the
    transformers, a canonical bucket input for the CNNs): ``fn(images (B,
    H, W, 3) float32) -> (boxes (B, 4) xyxy f32 in image coordinates, seed
    (B,) i32, seed_in_background (B,) bool)``. Returns ``(program,
    meta)``."""
    h, w = image_size
    kw = dict(batch_size=batch_size, image_size=image_size, masks=masks, dtype=dtype,
              int8=int8, observers=observers, k_patches=k_patches, batch_stats=batch_stats,
              device=device)
    if spec.family in _TOKEN_FAMILIES:
        p = spec.patch_size
        if h % p or w % p:
            raise ValueError(f"serving shape {h}x{w} not a multiple of patch {p}")
        module = make_lost_serving_forward(spec, params, which_features=which_features, **kw)
    else:
        module = make_cnn_lost_serving_forward(spec, params, **kw)
    program = _program(module, batch_size, image_size, module.ex.device)
    meta = _base_meta(spec, module.ex.device, batch_size, image_size, dtype, int8, program)
    meta.update({
        "pipeline": "lost",
        "which_features": which_features,
        "k_patches": k_patches,
        "outputs": ["boxes_xyxy (B, 4) f32", "seed (B,) i32", "seed_in_background (B,) bool"],
    })
    return program, meta


def save_artifact(out_dir: str, program, meta: dict) -> int:
    """Write ``model.pt2`` and ``meta.json``; returns the program's bytes."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACT)
    torch.export.save(program, path)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return os.path.getsize(path)


def load_artifact(out_dir: str):
    """Load an exported artifact; returns ``(fn, meta)``. Needs only torch
    and ``vipers_torch.ops`` (the custom ops' registrations): no model,
    driver or checkpoint code. An artifact exported for ``cuda`` raises on
    a host without a card: it never runs on the CPU instead."""
    import vipers_torch.ops  # noqa: F401  (registers the custom ops)

    with open(os.path.join(out_dir, _META)) as f:
        meta = json.load(f)
    dev = torch.device(meta["platforms"][0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{out_dir} was exported for cuda and this host has no usable card; "
                           "a torch.export program runs only on the device it was exported on")
    module = torch.export.load(os.path.join(out_dir, _ARTIFACT)).module()

    def fn(images):
        x = torch.as_tensor(images, dtype=torch.float32).to(dev)
        scope = _no_cudnn_tf32() if meta.get("exact_f32_convs") else contextlib.nullcontext()
        with torch.no_grad(), scope:
            return module(x)

    return fn, meta


def _refuse(msg: str):
    raise SystemExit(f"vipers_torch export: {msg}")


def run_export(args) -> int:
    """``vipers_torch export``: load a (pruned / slimmed / calibrated)
    checkpoint, export the serving forward or the LOST program, write the
    artifact, and with ``--verify`` load it back and compare it with the
    direct forward at the JAX CLI's tolerances."""
    import numpy as np

    from vipers_torch.core.checkpoint import (infer_num_classes, infer_representation_size,
                                              infer_vit_image_size)
    from vipers_torch.core.device import resolve_device
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.pruning.structured import arch_sidecar

    device = resolve_device(getattr(args, "device", None))
    bad = [p for p in (args.platforms or []) if p != device.type]
    if bad:
        _refuse(f"--platforms {' '.join(args.platforms)}: a torch.export program is one "
                f"device's program; this export runs on {device.type} and can only record "
                f"--platforms {device.type} (use --device cpu for a CPU artifact)")
    ckpt = getattr(args, "checkpoint", "") or ""
    if ckpt and (os.path.isdir(ckpt) or not ckpt.endswith((".pth", ".pt"))):
        _refuse(f"{ckpt}: the port reads .pth/.pt checkpoints only; reading the JAX "
                "package's orbax checkpoint directories is ROADMAP A7")
    lost = args.pipeline == "lost"
    model_kw = {}
    if args.num_classes:
        model_kw["num_classes"] = args.num_classes
    if "resnet" in args.model and getattr(args, "resnet_dilate", 1) != 1:
        model_kw["dilate"] = args.resnet_dilate
    overrides = arch_sidecar(ckpt)
    if overrides:
        model_kw["arch_overrides"] = overrides
        print(f"slim architecture: {overrides}")
    try:
        spec = build_model(args.model, **model_kw)
    except ValueError as e:
        _refuse(str(e))
    if lost and spec.family not in (*_TOKEN_FAMILIES, "resnet", "vgg"):
        _refuse("--pipeline lost exports the ViT/DINO transformer and resnet/vgg CNN LOST "
                f"programs; model {args.model!r} (family {spec.family!r}) is not supported: "
                "swin LOST runs via `vipers_torch lost`, whose windowed feature path is not a "
                "single fixed-shape program")
    explicit = tuple(args.image_size) if args.image_size else None
    image_size = explicit or tuple(spec.input_size)
    if spec.family == "vit" and image_size != tuple(spec.input_size):
        model_kw["image_size"] = image_size  # the pos table at the serving size
        spec = build_model(args.model, **model_kw)
    masks = batch_stats = observers = None
    if ckpt:
        params, batch_stats, masks, observers = load_lost_checkpoint(ckpt, spec)
        n_cls = infer_num_classes(params)
        if n_cls is not None and n_cls != spec.num_classes:
            model_kw["num_classes"] = n_cls
        if spec.family == "vit":
            model_kw["representation_size"] = infer_representation_size(params)
            trained = infer_vit_image_size(params, spec.patch_size)
            if trained is not None:
                # the module's pos table is the checkpoint's; the LOST program
                # interpolates it to the serving grid, as `lost` does
                model_kw["image_size"] = trained
                if explicit is None:
                    image_size = trained
                elif not lost and trained != explicit:
                    _refuse(f"{ckpt} was trained at {trained[0]}x{trained[1]}: classify "
                            "serves a ViT at its trained size; drop --image-size")
        spec = build_model(args.model, **model_kw)
    else:
        params = spec.init(torch.Generator().manual_seed(0))

    dtype = {"f32": None, "bf16": torch.bfloat16, "int8": None}[args.dtype]
    int8 = args.dtype == "int8"
    common = dict(masks=masks, dtype=dtype, int8=int8, observers=observers,
                  batch_stats=batch_stats, device=device)
    if lost and spec.family in ("resnet", "vgg") and explicit is None:
        # the CNN LOST serving shape: the model's input size snapped to its
        # canonical bucket input (the shape `lost --cnn-bucket` runs)
        snapped = LostFeatureExtractor(spec, params, masks, device="cpu",
                                       batch_stats=batch_stats).cnn_bucket_key(*image_size)
        if snapped != image_size:
            print(f"serving shape {image_size} -> canonical bucket {snapped}")
            image_size = snapped
    lost_kw = dict(batch_size=args.batch_size, image_size=image_size,
                   k_patches=args.k_patches, **common)
    if spec.family in _TOKEN_FAMILIES:
        lost_kw["which_features"] = args.which_features
    if lost:
        program, meta = export_lost_pipeline(spec, params, **lost_kw)
    else:
        program, meta = export_serving(spec, params, batch_size=args.batch_size,
                                       image_size=image_size, **common)
    nbytes = save_artifact(args.output_dir, program, meta)
    del program
    print(f"exported {meta['model']} {meta.get('pipeline', 'classify')} "
          f"{meta['input_shape']} ({meta['compute_dtype']}, platforms {meta['platforms']}, "
          f"custom ops {meta['custom_ops']}) -> {args.output_dir} ({nbytes / 1e6:.1f} MB)")

    if args.verify:
        fn, _ = load_artifact(args.output_dir)
        x = np.random.default_rng(1).normal(
            size=(args.batch_size, *image_size, 3)).astype(np.float32)
        if lost:
            direct = (make_lost_serving_forward if spec.family in _TOKEN_FAMILIES
                      else make_cnn_lost_serving_forward)(spec, params, **lost_kw)
        else:
            direct = make_serving_forward(spec, params, **common)
        xt = torch.from_numpy(x).to(device)
        with torch.no_grad():
            want = direct(xt)
        got = fn(x)
        if lost:
            err = 0.0
            for g, w_ in zip(got, want):
                g, w_ = g.cpu().double().numpy(), w_.cpu().double().numpy()
                np.testing.assert_allclose(g, w_, atol=1e-3, rtol=1e-4)
                err = max(err, float(np.abs(g - w_).max()))
        else:
            got, want = got.cpu().numpy(), want.cpu().numpy()
            # the same program, replayed: f32 moves by rounding only, bf16 by
            # its mantissa, int8's dynamic ranges by a quantization step
            atol, rtol = {"f32": (5e-5, 5e-5), "bf16": (5e-2, 5e-2),
                          "int8": (0.3, 0.0)}[args.dtype]
            np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
            err = float(np.abs(got - want).max())
        print(f"verify: artifact output matches direct apply (max abs err {err:.2e})")
    return 0
