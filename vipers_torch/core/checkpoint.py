"""Weights carried across from the JAX package (port of the ViT, ResNet,
VGG, Swin-V2 and DINO parts of ``vipers/core/checkpoint.py``, with the exporters
the JAX package lacks).

A flax ViT parameter tree (nested dict of numpy arrays or tensors, conv
kernels HWIO, dense kernels (in, out)) plus optional pruning masks (flat
``{path tuple: bool array}`` in the same layout) becomes a state dict of
``vipers_torch.models.vit.VisionTransformer``: conv OIHW, linear (out, in),
``encoder_layer_i`` -> ``layers.i``, LayerNorm ``scale`` -> ``weight``.
Masks are baked as ``where(mask, w, 0)`` before the layout change, exactly
as the JAX extractor bakes them.

The reference's ``.pth`` files come in through ``load_torch_state_dict``
(``module.`` stripped, ``{"model": ...}`` unwrapped, ``weight_orig *
weight_mask`` resolved with the mask kept as ``<key>.__mask__``) and
``import_vit_torchvision``, which returns the flax-layout tree and masks
that ``vit_state_dict_from_flax`` takes; ``export_vit_torchvision`` writes
the torchvision keys back, masks baked or in the ``weight_orig`` /
``weight_mask`` form of ``torch.nn.utils.prune``.

The train driver's own checkpoint (``save_train_checkpoint`` /
``load_train_checkpoint``) is a ``torch.save`` of ``{"model": <torchvision
keys, pruned layers as weight_orig / weight_mask>, "optimizer", "epoch",
"step", "sparsity"[, "model_ema"]}``: ``load_torch_state_dict`` (and so
``vipers_torch lost`` and ``evaluate``) reads its ``model`` as a reference
``.pth``; resuming reads the unbaked weights and the optimizer back.

The reverse direction serves training and its tests:
``flax_tree_from_vit_state_dict`` turns the module's parameters back into a
flax tree (the layout magnitude pruning ranks in), and
``vit_masks_to_state_dict`` / ``vit_masks_from_state_dict`` move masks
between flax paths and state-dict keys with their layouts.

The CNN families (ResNet, VGG) keep torchvision's names in their modules,
so their state dict is the torchvision ``.pth``; ``import_resnet`` /
``import_vgg16`` read one as the JAX package does (running mean and var
into ``batch_stats``) and ``export_resnet`` / ``export_vgg16`` write it,
``num_batches_tracked`` included. Callers that serve every family go
through ``family(spec)``, one ``Family`` of converters a family: the
module's state dict from flax trees and back, masks both ways, the
``.pth`` both ways. Swin-V2's modules carry the flax names, so its state
dict is the ViT's renaming of leaves; ``import_swin_v2_t`` /
``export_swin_v2_t`` read and write torchvision's ``features.*`` layout.
The DINO ViTs' modules carry the flax names too; ``import_dino_vit`` /
``export_dino_vit`` read and write facebookresearch/dino's keys.
MobileNetV2's modules carry torchvision's ``mobilenet_v2`` names, as the
ResNet's do; ``import_mobilenet_v2`` / ``export_mobilenet_v2`` read and
write that ``.pth``.

``average_checkpoints`` (the element-wise mean of several ``.pth``) and
``store_model_weights`` (the weights alone, under a hash-stamped name)
are the JAX package's helpers on ``.pth`` files; the JAX package's own
orbax checkpoints come across through ``scripts/jax_checkpoint_to_torch.py``,
which writes the ``.pth`` files here.

Every converter takes its widths from the arrays, never from a dense
default, so a structurally slimmed tree (``pruning.structured``: a ViT's
rectangular ``in_proj_weight`` (3*h*hd, D) and ``out_proj.weight`` (D,
h*hd), a ResNet block's inner convolutions with their BatchNorm
statistics, VGG's and Swin's widths) goes through them as a dense one
does; its module comes from ``build_model(..., arch_overrides=...)``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vipers_torch.core.tree import flatten_dict, unflatten_dict


def as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a))


def _to_state_layout(w):
    """A flax kernel in the module's layout: conv HWIO -> OIHW, linear
    (in, out) -> (out, in)."""
    return w.permute(3, 2, 0, 1) if w.dim() == 4 else w.t()


def _to_flax_layout(w):
    """A module weight back in the flax kernel layout (HWIO, (in, out))."""
    return w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()


def _state_key(path) -> str:
    parts = list(path)
    m = re.fullmatch(r"encoder_layer_(\d+)", parts[0])
    if m:
        parts[0:1] = ["layers", m.group(1)]
    if parts[-1] in ("scale", "kernel"):
        parts[-1] = "weight"
    return ".".join(parts)


def _state_dict_from_flax(state_key, params: dict, batch_stats: Optional[dict] = None,
                          masks: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """A module state dict from flax trees: kernels in the module's layout,
    ``masks`` baked as ``where(mask, w, 0)`` first, the BatchNorm running
    statistics (``batch_stats``, leaves ``mean`` and ``var``) as buffers.
    ``state_key`` maps a flax path to its state-dict key."""
    flat = {p: as_tensor(a) for p, a in flatten_dict(params).items()}
    for path, m in (masks or {}).items():
        w = flat[path]
        flat[path] = torch.where(as_tensor(m).to(torch.bool), w,
                                 torch.zeros((), dtype=w.dtype))
    flat.update({p: as_tensor(a) for p, a in flatten_dict(batch_stats or {}).items()})
    sd = {}
    for path, w in flat.items():
        if path[-1] == "kernel":
            w = _to_state_layout(w)
        sd[state_key(path)] = w.contiguous()
    return sd


def _trees_from_state_dict(flax_path, sd):
    """The inverse of ``_state_dict_from_flax`` (without masks): (params,
    batch_stats or None) flax trees of tensors from a state dict or
    ``named_parameters`` mapping; ``flax_path(key, ndim)`` maps a key back."""
    params, stats = {}, {}
    for key, w in dict(sd).items():
        w = w.detach()
        path = flax_path(key, w.dim())
        if path[-1] == "kernel":
            w = _to_flax_layout(w)
        (stats if path[-1] in ("mean", "var") else params)[path] = w.contiguous()
    return unflatten_dict(params), (unflatten_dict(stats) if stats else None)


def vit_state_dict_from_flax(params: dict, masks: Optional[dict] = None
                             ) -> Dict[str, torch.Tensor]:
    """State dict for ``VisionTransformer.load_state_dict`` from a flax ViT
    parameter tree, with ``masks`` baked in."""
    return _state_dict_from_flax(_state_key, params, None, masks)


def _flax_path(key: str, ndim: int):
    parts = key.split(".")
    if parts[0] == "layers":
        parts[0:2] = [f"encoder_layer_{parts[1]}"]
    if parts[-1] == "weight":
        parts[-1] = "scale" if ndim == 1 else "kernel"
    return tuple(parts)


def flax_tree_from_vit_state_dict(sd) -> dict:
    """The inverse of ``vit_state_dict_from_flax`` (without masks): a flax
    ViT parameter tree of tensors from a state dict or ``named_parameters``
    mapping; one-dimensional ``weight``s are LayerNorm scales."""
    return _trees_from_state_dict(_flax_path, sd)[0]


def vit_masks_to_state_dict(masks: dict) -> Dict[str, torch.Tensor]:
    """Flax-path masks -> {state-dict key: bool mask in the module's layout}."""
    return {_state_key(p): _to_state_layout(as_tensor(m).to(torch.bool)).contiguous()
            for p, m in masks.items()}


def vit_masks_from_state_dict(masks: dict) -> dict:
    """The inverse of ``vit_masks_to_state_dict``."""
    return {_flax_path(k, m.dim()): _to_flax_layout(m).contiguous()
            for k, m in masks.items()}


# ----------------------- the reference's .pth files ------------------------

def reference_sweep_stem(model: str, vit: bool, epoch="*", iteration="*") -> str:
    """The reference sweep's checkpoint file stem: ViTs use the model name,
    CNNs the literal ``model``; both live under ``{dir}/{model}/``."""
    it = f"{iteration:02d}" if isinstance(iteration, int) else iteration
    return f"{model if vit else 'model'}_epoch_{epoch}_pruning_iteration_{it}"


# classification-head kernel paths per family; the last dim is the class count
_HEAD_KEYS = ("fc", "head", "fc3", "classifier")


def infer_num_classes(params) -> Optional[int]:
    """The class count of the checkpoint's own head kernel, or None for a
    headless tree (the LOST driver rebuilds the model at that width)."""
    for key in _HEAD_KEYS:
        node = params.get(key) if isinstance(params, dict) else None
        if isinstance(node, dict) and "kernel" in node:
            return int(node["kernel"].shape[-1])
    return None


def infer_representation_size(params) -> Optional[int]:
    """The width of the checkpoint's ``pre_logits`` Dense, or None when it
    has none (every torchvision ViT); the LOST driver builds the module
    with it, so the ``.pth``'s ``heads.pre_logits`` reach the module."""
    node = params.get("pre_logits") if isinstance(params, dict) else None
    if isinstance(node, dict) and "kernel" in node:
        return int(node["kernel"].shape[-1])
    return None


def infer_vit_image_size(params, patch_size: int):
    """(H, W) the checkpoint's pos-embedding table was trained at, or None
    when there is no table or its grid is not square: 224 x 224 for a
    table of 197 tokens at patch 16, 50 at patch 32, 257 at patch 14."""
    pos = params.get("pos_embedding") if isinstance(params, dict) else None
    if pos is None or getattr(pos, "ndim", 0) != 3:
        return None
    n = int(pos.shape[1]) - 1  # minus the class token
    g = int(round(n ** 0.5))
    if g * g != n:
        return None
    return (g * patch_size, g * patch_size)


def load_pth(path):
    """``torch.load`` of a ``.pth`` on the CPU, memory-mapped where the file
    is in torch's zip format (the tensors are read from the file as they are
    used, not copied into fresh storage first); a legacy-format file is read
    whole."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    except RuntimeError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """``torch.load`` a checkpoint on the CPU (or take what was loaded),
    unwrap ``{"model": ...}``, then ``normalize_torch_state_dict``."""
    obj = load_pth(path) if isinstance(path, (str, os.PathLike)) else path
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return normalize_torch_state_dict(obj)


def normalize_torch_state_dict(sd) -> Dict[str, np.ndarray]:
    """{key: numpy array} with DDP's ``module.`` stripped and each pruned
    ``<key>_orig`` / ``<key>_mask`` pair resolved into ``<key>`` =
    orig * mask and a bool ``<key>.__mask__``."""
    def _np(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    raw = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    out: Dict[str, np.ndarray] = {}
    for k, v in raw.items():
        if k.endswith("_orig"):
            base = k[:-len("_orig")]
            w = _np(v)
            mask = raw.get(base + "_mask")
            if mask is not None:
                mask = _np(mask)
                w = w * mask
                out[base + ".__mask__"] = mask.astype(bool)
            out[base] = w
        elif not k.endswith("_mask"):
            out[k] = _np(v)
    return out


def _conv_w(a):  # OIHW -> HWIO
    return np.transpose(a, (2, 3, 1, 0))


def _conv_w_inv(a):  # HWIO -> OIHW
    return np.transpose(a, (3, 2, 0, 1))


def _vit_torchvision_table(num_layers: int) -> List[Tuple[str, tuple, str, bool]]:
    """(torchvision key, flax path, layout, mask carried) of every ViT
    parameter. Layout ``conv``: OIHW <-> HWIO, ``lin``: (out, in) <->
    (in, out). The JAX importer carries the masks of the patch conv, the
    attention output, the MLP and the head (the in-projection is never
    pruned)."""
    table = [("conv_proj.weight", ("conv_proj", "kernel"), "conv", True),
             ("conv_proj.bias", ("conv_proj", "bias"), "", False),
             ("class_token", ("class_token",), "", False),
             ("encoder.pos_embedding", ("pos_embedding",), "", False)]
    for i in range(num_layers):
        t, o = f"encoder.layers.encoder_layer_{i}", f"encoder_layer_{i}"
        table += [(f"{t}.ln_1.weight", (o, "ln_1", "scale"), "", False),
                  (f"{t}.ln_1.bias", (o, "ln_1", "bias"), "", False),
                  (f"{t}.self_attention.in_proj_weight", (o, "attention", "qkv", "kernel"),
                   "lin", False),
                  (f"{t}.self_attention.in_proj_bias", (o, "attention", "qkv", "bias"), "",
                   False),
                  (f"{t}.self_attention.out_proj.weight", (o, "attention", "out", "kernel"),
                   "lin", True),
                  (f"{t}.self_attention.out_proj.bias", (o, "attention", "out", "bias"), "",
                   False),
                  (f"{t}.ln_2.weight", (o, "ln_2", "scale"), "", False),
                  (f"{t}.ln_2.bias", (o, "ln_2", "bias"), "", False)]
        # torchvision's MLPBlock: Linear, GELU, Dropout, Linear, Dropout
        for tk, ok in ((f"{t}.mlp.0", "fc1"), (f"{t}.mlp.3", "fc2")):
            table += [(f"{tk}.weight", (o, "mlp", ok, "kernel"), "lin", True),
                      (f"{tk}.bias", (o, "mlp", ok, "bias"), "", False)]
    return table + [("encoder.ln.weight", ("ln", "scale"), "", False),
                    ("encoder.ln.bias", ("ln", "bias"), "", False),
                    ("heads.pre_logits.weight", ("pre_logits", "kernel"), "lin", False),
                    ("heads.pre_logits.bias", ("pre_logits", "bias"), "", False),
                    ("heads.head.weight", ("head", "kernel"), "lin", True),
                    ("heads.head.bias", ("head", "bias"), "", False)]


_OPTIONAL = ("heads.pre_logits.", "heads.head.")


def import_vit_torchvision(sd: Dict[str, np.ndarray], num_layers: int):
    """A normalized torchvision ViT state dict -> (flax-layout params tree,
    masks {flax path: bool array}), the inputs of
    ``vit_state_dict_from_flax``. The head and pre-logits are optional;
    pre-logits reach a module built with ``representation_size``
    (``infer_representation_size``) and go back out on export."""
    to_flax = {"conv": _conv_w, "lin": np.transpose, "": lambda a: a}
    p, masks = {}, {}
    for key, path, layout, carries_mask in _vit_torchvision_table(num_layers):
        if key.startswith(_OPTIONAL) and key not in sd:
            continue
        p[path] = to_flax[layout](sd[key])
        if carries_mask and key + ".__mask__" in sd:
            masks[path] = to_flax[layout](sd[key + ".__mask__"])
    return unflatten_dict(p), masks


def export_vit_torchvision(params, masks=None, bake_masks: bool = True
                           ) -> Dict[str, np.ndarray]:
    """The inverse of ``import_vit_torchvision``: a flax-layout ViT tree ->
    a torchvision-keyed state dict of float32 numpy arrays. ``masks``
    ({flax path: bool array}) are baked by multiplication, as the JAX
    exporter does, or with ``bake_masks=False`` written in the reference's
    pruned form: ``<key>_orig`` (the weight as it is) and ``<key>_mask``
    (float32), which ``normalize_torch_state_dict`` resolves."""
    p = {path: np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float32)
         for path, a in flatten_dict(params).items()}
    masks = {tuple(k): np.asarray(m.detach().cpu() if hasattr(m, "detach") else m, np.float32)
             for k, m in (masks or {}).items() if tuple(k) in p}
    if bake_masks:
        for path, m in masks.items():
            p[path] = p[path] * m
    n_layers = len({k[0] for k in p if k[0].startswith("encoder_layer_")})
    to_torch = {"conv": _conv_w_inv, "lin": np.transpose, "": lambda a: a}
    sd: Dict[str, np.ndarray] = {}
    for key, path, layout, _ in _vit_torchvision_table(n_layers):
        if path not in p:
            continue
        w = to_torch[layout](p[path])
        if path in masks and not bake_masks:
            base, leaf = key.rsplit(".", 1)
            sd[f"{base}.{leaf}_orig"] = w
            sd[f"{base}.{leaf}_mask"] = to_torch[layout](masks[path])
        else:
            sd[key] = w
    return sd


def contiguous_tensor(v) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor: a transposed view is
    copied by torch's (threaded) copy, which is several times faster on the
    host than numpy's for a large kernel."""
    a = np.asarray(v)
    if any(st < 0 for st in a.strides):
        a = a.copy()
    return torch.as_tensor(a).contiguous()


def save_torch_state_dict(sd: Dict[str, np.ndarray], path) -> None:
    """``torch.save`` a {key: numpy array} state dict as contiguous tensors."""
    torch.save({k: contiguous_tensor(v) for k, v in sd.items()}, path)


# ---------------------------- the CNN families ------------------------------
#
# The port's ResNet and VGG modules carry torchvision's state-dict names, so
# their state dict is the torchvision .pth (plus ``num_batches_tracked``);
# flax paths differ only in the names of blocks and leaves.

_TO_STATE_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                  "var": "running_var"}
_RESNET_TO_STATE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _leaf_path(parts: list, ndim: int) -> tuple:
    """A state-dict leaf back to flax: a 1-D ``weight`` is a norm's scale."""
    leaf = {"weight": "scale" if ndim == 1 else "kernel", "running_mean": "mean",
            "running_var": "var"}.get(parts[-1], parts[-1])
    return tuple(parts[:-1] + [leaf])


def _resnet_key(path) -> str:
    """``layer1_0/downsample_bn/scale`` -> ``layer1.0.downsample.1.weight``."""
    parts = list(path)
    m = re.fullmatch(r"layer(\d+)_(\d+)", parts[0])
    if m:
        parts[0:1] = [f"layer{m.group(1)}", m.group(2)]
    parts = [_RESNET_TO_STATE.get(p, p) for p in parts[:-1]]
    return ".".join(parts + [_TO_STATE_LEAF.get(path[-1], path[-1])])


def _resnet_path(key: str, ndim: int) -> tuple:
    key = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_\2.", key)
    for flax_name, state in _RESNET_TO_STATE.items():
        key = key.replace(f".{state}.", f".{flax_name}.")
    return _leaf_path(key.split("."), ndim)


# torchvision vgg16: the conv layers' indices in ``features``, the Linear
# layers' in ``classifier``
_VGG_CONV = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_FC = {"fc1": "classifier.0", "fc2": "classifier.3", "fc3": "classifier.6"}


def _vgg_key(path) -> str:
    m = re.fullmatch(r"conv_(\d+)", path[0])
    head = f"features.{_VGG_CONV[int(m.group(1))]}" if m else _VGG_FC[path[0]]
    return f"{head}.{_TO_STATE_LEAF.get(path[-1], path[-1])}"


def _vgg_path(key: str, ndim: int) -> tuple:
    base, leaf = key.rsplit(".", 1)
    if base.startswith("features."):
        head = f"conv_{_VGG_CONV.index(int(base.split('.')[1]))}"
    else:
        head = {v: k for k, v in _VGG_FC.items()}[base]
    return _leaf_path([head, leaf], ndim)


def import_resnet(sd: Dict[str, np.ndarray], stage_sizes, headless: bool = False):
    """torchvision resnet{18,34,50} keys -> (params, batch_stats, masks): the
    flax trees of the JAX package's ``import_resnet`` (running mean and var
    into ``batch_stats``) and its flat {path: bool array} masks. A headless
    model takes no ``fc``."""
    p, bs, masks = {}, {}, {}

    def put_conv(tkey, path):
        p[path + ("kernel",)] = _conv_w(sd[tkey + ".weight"])
        m = sd.get(tkey + ".weight.__mask__")
        if m is not None:
            masks[path + ("kernel",)] = _conv_w(m)

    def put_bn(tkey, path):
        p[path + ("scale",)] = sd[tkey + ".weight"]
        p[path + ("bias",)] = sd[tkey + ".bias"]
        bs[path + ("mean",)] = sd[tkey + ".running_mean"]
        bs[path + ("var",)] = sd[tkey + ".running_var"]

    put_conv("conv1", ("conv1",))
    put_bn("bn1", ("bn1",))
    n_convs = 3 if any(k.startswith("layer1.0.conv3") for k in sd) else 2
    for stage, blocks in enumerate(stage_sizes, start=1):
        for b in range(blocks):
            t, o = f"layer{stage}.{b}", (f"layer{stage}_{b}",)
            for ci in range(1, n_convs + 1):
                put_conv(f"{t}.conv{ci}", o + (f"conv{ci}",))
                put_bn(f"{t}.bn{ci}", o + (f"bn{ci}",))
            if f"{t}.downsample.0.weight" in sd:
                put_conv(f"{t}.downsample.0", o + ("downsample_conv",))
                put_bn(f"{t}.downsample.1", o + ("downsample_bn",))
    if "fc.weight" in sd and not headless:
        p[("fc", "kernel")] = np.transpose(sd["fc.weight"])
        p[("fc", "bias")] = sd["fc.bias"]
        if "fc.weight.__mask__" in sd:
            masks[("fc", "kernel")] = np.transpose(sd["fc.weight.__mask__"])
    return unflatten_dict(p), unflatten_dict(bs), masks


def import_vgg16(sd: Dict[str, np.ndarray], headless: bool = False):
    """torchvision vgg16 (``features.{0,2,...,28}``, ``classifier.{0,3,6}``)
    -> (params, masks), as the JAX package's ``import_vgg16``: the
    convolutions' masks are carried, the classifier's are not."""
    p, masks = {}, {}
    for i, ti in enumerate(_VGG_CONV):
        p[(f"conv_{i}", "kernel")] = _conv_w(sd[f"features.{ti}.weight"])
        p[(f"conv_{i}", "bias")] = sd[f"features.{ti}.bias"]
        if f"features.{ti}.weight.__mask__" in sd:
            masks[(f"conv_{i}", "kernel")] = _conv_w(sd[f"features.{ti}.weight.__mask__"])
    if not headless and "classifier.0.weight" in sd:
        for ok, tk in _VGG_FC.items():
            p[(ok, "kernel")] = np.transpose(sd[f"{tk}.weight"])
            p[(ok, "bias")] = sd[f"{tk}.bias"]
    return unflatten_dict(p), masks


def _export_cnn(state_key, params, batch_stats=None, masks=None, bake_masks: bool = True
                ) -> Dict[str, np.ndarray]:
    """A flax CNN tree -> its torchvision state dict of numpy arrays: f32
    weights, ``masks`` baked by multiplication or written as ``<key>_orig``
    / ``<key>_mask`` (the pruned form ``normalize_torch_state_dict``
    resolves), and for every BatchNorm its running statistics (``batch_stats``,
    else mean 0 and var 1) and ``num_batches_tracked`` (0), so a torchvision
    model loads it strictly."""
    def f32(a):
        return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float32)

    p = {path: f32(a) for path, a in flatten_dict(params).items()}
    masks = {tuple(k): f32(m) for k, m in (masks or {}).items() if tuple(k) in p}
    stats = {path: f32(a) for path, a in flatten_dict(batch_stats or {}).items()}
    sd: Dict[str, np.ndarray] = {}
    for path, w in p.items():
        m = masks.get(path)
        if m is not None and bake_masks:
            w = w * m
        layout = _conv_w_inv if w.ndim == 4 else np.transpose
        key = state_key(path)
        if path[-1] == "kernel":
            w = layout(w)
        if m is not None and not bake_masks:
            sd[f"{key}_orig"], sd[f"{key}_mask"] = w, layout(m)
        else:
            sd[key] = w
        if path[-1] == "scale":  # a BatchNorm
            bn = path[:-1]
            for leaf, init in (("mean", np.zeros_like(w)), ("var", np.ones_like(w))):
                sd[state_key(bn + (leaf,))] = stats.get(bn + (leaf,), init)
            sd[key[:-len("weight")] + "num_batches_tracked"] = np.zeros((), np.int64)
    return sd


def export_resnet(params, batch_stats=None, masks=None, bake_masks: bool = True
                  ) -> Dict[str, np.ndarray]:
    """The inverse of ``import_resnet``: a torchvision ResNet state dict."""
    return _export_cnn(_resnet_key, params, batch_stats, masks, bake_masks)


def export_vgg16(params, masks=None, bake_masks: bool = True) -> Dict[str, np.ndarray]:
    """The inverse of ``import_vgg16``: a torchvision vgg16 state dict."""
    return _export_cnn(_vgg_key, params, None, masks, bake_masks)


# ------------------------------ MobileNetV2 --------------------------------
#
# The port's MobileNetV2 carries torchvision's names: ``features.0`` the stem
# (``.0`` conv, ``.1`` BatchNorm), ``features.{n}`` the n-th inverted
# residual in order, its ``conv.{k}`` the expand (absent in stage 0, whose
# expand ratio is 1), depthwise, project convolution and project BatchNorm,
# ``features.{last}`` the head convolution and ``classifier.1`` the Linear.

def _mobilenet_blocks():
    """[(flax block name, has expand)] of the inverted residuals in order."""
    from vipers_torch.models.mobilenet import V2_CFG

    return [(f"block{bi}_{i}", t != 1) for bi, (t, _c, n, _s) in enumerate(V2_CFG)
            for i in range(n)]


def _mobilenet_key(path) -> str:
    """``block1_0/depthwise/bn/scale`` -> ``features.2.conv.1.1.weight``."""
    blocks = _mobilenet_blocks()
    names = [b for b, _ in blocks]
    head, *mid = path[:-1]
    leaf = _TO_STATE_LEAF.get(path[-1], path[-1])
    sub = {"conv": "0", "bn": "1"}
    if head == "stem":
        base = ["features", "0", sub[mid[0]]]
    elif head == "head_conv":
        base = ["features", str(len(blocks) + 1), sub[mid[0]]]
    elif head == "classifier":
        base = ["classifier", "1"]
    else:
        n = names.index(head)
        first = 0 if blocks[n][1] else -1  # the depthwise's index is 1 or 0
        part, layer = mid
        k = {"expand": 0, "depthwise": first + 1}.get(part)
        base = (["features", str(n + 1), "conv", str(k), sub[layer]] if k is not None
                else ["features", str(n + 1), "conv", str(first + 2 + (layer == "bn"))])
    return ".".join(base + [leaf])


def _mobilenet_path(key: str, ndim: int) -> tuple:
    blocks = _mobilenet_blocks()
    parts = key.split(".")
    layer = {"0": "conv", "1": "bn"}
    if parts[0] == "classifier":
        return _leaf_path(["classifier", parts[-1]], ndim)
    n = int(parts[1])
    if n == 0 or n == len(blocks) + 1:
        return _leaf_path(["stem" if n == 0 else "head_conv", layer[parts[2]], parts[-1]], ndim)
    name, expand = blocks[n - 1]
    k = int(parts[3]) - (0 if expand else -1)  # 0 expand, 1 depthwise, 2-3 project
    if k <= 1:
        mid = ["expand" if k == 0 else "depthwise", layer[parts[4]]]
    else:
        mid = ["project", "conv" if k == 2 else "bn"]
    return _leaf_path([name] + mid + [parts[-1]], ndim)


def import_mobilenet_v2(sd: Dict[str, np.ndarray]):
    """torchvision mobilenet_v2 keys -> (params, batch_stats, masks) in the
    JAX package's flax paths (running mean and var into ``batch_stats``,
    ``num_batches_tracked`` dropped, each ``.__mask__`` carried)."""
    p, bs, masks = {}, {}, {}
    for key, v in sd.items():
        if key.endswith(("num_batches_tracked", ".__mask__")):
            continue
        path = _mobilenet_path(key, np.ndim(v))
        if path[-1] == "kernel":
            layout = _conv_w if np.ndim(v) == 4 else np.transpose
            v = layout(v)
            m = sd.get(key + ".__mask__")
            if m is not None:
                masks[path] = layout(m)
        (bs if path[-1] in ("mean", "var") else p)[path] = v
    return unflatten_dict(p), unflatten_dict(bs), masks


def export_mobilenet_v2(params, batch_stats=None, masks=None, bake_masks: bool = True
                        ) -> Dict[str, np.ndarray]:
    """The inverse of ``import_mobilenet_v2``: a torchvision mobilenet_v2
    state dict (``num_batches_tracked`` 0, masks baked or as
    ``weight_orig`` / ``weight_mask``)."""
    return _export_cnn(_mobilenet_key, params, batch_stats, masks, bake_masks)


# -------------------------------- Swin-V2 ----------------------------------
#
# The port's Swin modules carry the flax names (``stage0_block0.attn.qkv``),
# so the module state dict is the ViT's renaming of leaves; the torchvision
# ``.pth`` numbers stages and merges into ``features`` (features.0 the patch
# embedding, features.{1,3,5,7} the stages, features.{2,4,6} the merges).

SWIN_DEPTHS = (2, 2, 6, 2)


def _swin_torchvision_table(depths) -> List[Tuple[str, tuple, str]]:
    """(torchvision key, flax path, layout) of every Swin-V2 parameter;
    layouts as ``_vit_torchvision_table``'s. Every kernel may carry a mask,
    as the JAX importer reads them."""
    table = [("features.0.0.weight", ("patch_embed", "kernel"), "conv"),
             ("features.0.0.bias", ("patch_embed", "bias"), ""),
             ("features.0.2.weight", ("patch_norm", "scale"), ""),
             ("features.0.2.bias", ("patch_norm", "bias"), "")]

    def lin(tkey, path, bias=True):
        out = [(f"{tkey}.weight", path + ("kernel",), "lin")]
        return out + ([(f"{tkey}.bias", path + ("bias",), "")] if bias else [])

    def ln(tkey, path):
        return [(f"{tkey}.weight", path + ("scale",), ""), (f"{tkey}.bias", path + ("bias",), "")]

    for si, depth in enumerate(depths):
        for bi in range(depth):
            t, o = f"features.{1 + 2 * si}.{bi}", (f"stage{si}_block{bi}",)
            table += (ln(f"{t}.norm1", o + ("norm1",)) + ln(f"{t}.norm2", o + ("norm2",))
                      + lin(f"{t}.attn.qkv", o + ("attn", "qkv"))
                      + lin(f"{t}.attn.proj", o + ("attn", "proj"))
                      + [(f"{t}.attn.logit_scale", o + ("attn", "logit_scale"), "")]
                      + lin(f"{t}.attn.cpb_mlp.0", o + ("attn", "cpb_fc1"))
                      + lin(f"{t}.attn.cpb_mlp.2", o + ("attn", "cpb_fc2"), bias=False)
                      + lin(f"{t}.mlp.0", o + ("fc1",)) + lin(f"{t}.mlp.3", o + ("fc2",)))
        if si < len(depths) - 1:
            m = f"features.{2 + 2 * si}"
            table += (lin(f"{m}.reduction", (f"merge{si}", "reduction"), bias=False)
                      + ln(f"{m}.norm", (f"merge{si}", "norm")))
    return table + ln("norm", ("norm",)) + lin("head", ("head",))


def import_swin_v2_t(sd: Dict[str, np.ndarray], depths=SWIN_DEPTHS):
    """A normalized torchvision ``swin_v2_t`` state dict -> (flax-layout
    params tree, masks {flax path: bool array}), as the JAX package's
    ``import_swin_v2_t``: the head is optional, the ``relative_coords_table``
    and ``relative_position_index`` buffers are recomputed, not read."""
    to_flax = {"conv": _conv_w, "lin": np.transpose, "": lambda a: a}
    p, masks = {}, {}
    for key, path, layout in _swin_torchvision_table(depths):
        if key.startswith("head.") and key not in sd:
            continue
        p[path] = to_flax[layout](sd[key])
        if key + ".__mask__" in sd:
            masks[path] = to_flax[layout](sd[key + ".__mask__"])
    return unflatten_dict(p), masks


def _torchvision_swin_buffers(ws: int):
    """A block's ``relative_coords_table`` (1, 2ws-1, 2ws-1, 2) and
    ``relative_position_index`` (ws^4,) as torchvision computes them (in
    f32)."""
    from vipers_torch.models.swin import relative_position_index_np

    coords = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(coords, coords, indexing="ij")).permute(1, 2, 0)[None]
    table = table / (ws - 1) * 8.0
    table = torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / 3.0
    return table.numpy(), relative_position_index_np(ws).reshape(-1).astype(np.int64)


def export_swin_v2_t(params, masks=None, bake_masks: bool = True, window_size: int = 8
                     ) -> Dict[str, np.ndarray]:
    """The inverse of ``import_swin_v2_t``, which the JAX package lacks: a
    flax-layout Swin-V2 tree -> torchvision's keys, f32, masks baked or as
    ``<key>_orig`` / ``<key>_mask`` (as ``export_vit_torchvision``), with
    every block's ``relative_coords_table`` (1, 2ws-1, 2ws-1, 2) and
    ``relative_position_index`` (ws^4,) buffers, so a torchvision
    ``swin_v2_t`` loads the file strictly."""
    p = {path: np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float32)
         for path, a in flatten_dict(params).items()}
    masks = {tuple(k): np.asarray(m.detach().cpu() if hasattr(m, "detach") else m, np.float32)
             for k, m in (masks or {}).items() if tuple(k) in p}
    stages = sorted({int(m.group(1)) for k in p
                     for m in [re.fullmatch(r"stage(\d+)_block\d+", k[0])] if m})
    depths = [1 + max(int(k[0].split("_block")[1]) for k in p if k[0].startswith(f"stage{s}_"))
              for s in stages]
    to_torch = {"conv": _conv_w_inv, "lin": np.transpose, "": lambda a: a}
    coords, index = _torchvision_swin_buffers(window_size)
    sd: Dict[str, np.ndarray] = {}
    for key, path, layout in _swin_torchvision_table(depths):
        if path not in p:
            continue
        w, m = p[path], masks.get(path)
        if m is not None and bake_masks:
            w = w * m
        if m is not None and not bake_masks:
            base, leaf = key.rsplit(".", 1)
            sd[f"{base}.{leaf}_orig"] = to_torch[layout](w)
            sd[f"{base}.{leaf}_mask"] = to_torch[layout](m)
        else:
            sd[key] = to_torch[layout](w)
        if key.endswith(".attn.logit_scale"):
            base = key[:-len("logit_scale")]
            sd[base + "relative_coords_table"] = coords.copy()
            sd[base + "relative_position_index"] = index.copy()
    return sd


# ------------------------------ the DINO ViTs -------------------------------
#
# facebookresearch/dino's keys (``patch_embed.proj``, ``blocks.i.attn.qkv``,
# ``blocks.i.mlp.fc1``); the port's modules carry the flax names, so their
# state dict is the flax tree renamed, as for Swin.

def _dino_table(depth: int) -> List[Tuple[str, tuple, str]]:
    """(dino key, flax path, layout) of every DINO ViT parameter but the
    head, which the JAX importer does not read."""
    table = [("patch_embed.proj.weight", ("patch_embed", "kernel"), "conv"),
             ("patch_embed.proj.bias", ("patch_embed", "bias"), ""),
             ("cls_token", ("cls_token",), ""), ("pos_embed", ("pos_embed",), "")]
    for i in range(depth):
        t, o = f"blocks.{i}", (f"block_{i}",)
        for tk, path in (("norm1", ("norm1",)), ("attn.qkv", ("attn", "qkv")),
                         ("attn.proj", ("attn", "proj")), ("norm2", ("norm2",)),
                         ("mlp.fc1", ("fc1",)), ("mlp.fc2", ("fc2",))):
            ln = tk.startswith("norm")
            table += [(f"{t}.{tk}.weight", o + path + ("scale" if ln else "kernel",),
                       "" if ln else "lin"),
                      (f"{t}.{tk}.bias", o + path + ("bias",), "")]
    return table + [("norm.weight", ("norm", "scale"), ""), ("norm.bias", ("norm", "bias"), "")]


def import_dino_vit(sd: Dict[str, np.ndarray], depth: int):
    """A facebookresearch/dino state dict -> (flax-layout params tree, {}),
    as the JAX package's ``import_dino_vit``: the qkv bias is optional, the
    head and any mask are not read."""
    to_flax = {"conv": _conv_w, "lin": np.transpose, "": lambda a: a}
    p = {path: to_flax[layout](sd[key]) for key, path, layout in _dino_table(depth)
         if key in sd or not key.endswith("attn.qkv.bias")}
    return unflatten_dict(p), {}


def export_dino_vit(params) -> Dict[str, np.ndarray]:
    """The inverse of ``import_dino_vit``, which the JAX package lacks: a
    flax-layout DINO tree -> facebookresearch/dino's keys, float32 (a head
    is not written)."""
    p = {path: np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float32)
         for path, a in flatten_dict(params).items()}
    depth = len({k[0] for k in p if k[0].startswith("block_")})
    to_torch = {"conv": _conv_w_inv, "lin": np.transpose, "": lambda a: a}
    return {key: to_torch[layout](p[path]) for key, path, layout in _dino_table(depth)
            if path in p}


def dino_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """State dict for ``DinoVisionTransformer.load_state_dict`` from the JAX
    package's DINO parameters (a flax tree of numpy arrays)."""
    return _state_dict_from_flax(_state_key, params)


# ------------------------- one table of converters --------------------------

@dataclasses.dataclass(frozen=True)
class Family:
    """How one family's flax trees meet the module's state dict and the
    torchvision ``.pth``. ``state_key(path)`` maps a flax path to its
    state-dict key and ``flax_path(key, ndim)`` back; ``import_pth(sd,
    spec)`` reads a normalized torchvision state dict into (params,
    batch_stats or None, masks) and ``export_pth(params, batch_stats,
    masks, bake_masks)`` writes one."""

    state_key: Callable
    flax_path: Callable
    import_pth: Callable
    export_pth: Callable

    def state_dict(self, params, batch_stats=None, masks=None) -> Dict[str, torch.Tensor]:
        """The module's state dict (masks baked; buffers from
        ``batch_stats`` where given)."""
        return _state_dict_from_flax(self.state_key, params, batch_stats, masks)

    def trees(self, sd):
        """(params, batch_stats or None) flax trees of a state dict."""
        return _trees_from_state_dict(self.flax_path, sd)

    def masks_to_state_dict(self, masks: dict) -> Dict[str, torch.Tensor]:
        """Flax-path masks -> {state-dict key: bool mask in the module's layout}."""
        return {self.state_key(p): _to_state_layout(as_tensor(m).to(torch.bool)).contiguous()
                for p, m in masks.items()}

    def masks_from_state_dict(self, masks: dict) -> dict:
        return {self.flax_path(k, m.dim()): _to_flax_layout(m).contiguous()
                for k, m in masks.items()}


def _import_vit(sd, spec):
    params, masks = import_vit_torchvision(sd, spec.cfg.num_layers)
    return params, None, masks


def _export_vit(params, batch_stats, masks, bake_masks):
    return export_vit_torchvision(params, masks, bake_masks)


def _import_vgg(sd, spec):
    params, masks = import_vgg16(sd, spec.cfg.headless)
    return params, None, masks


def _export_vgg(params, batch_stats, masks, bake_masks):
    return export_vgg16(params, masks, bake_masks)


def _import_resnet(sd, spec):
    return import_resnet(sd, spec.cfg.stage_sizes, spec.cfg.headless)


def _import_mobilenet(sd, spec):
    return import_mobilenet_v2(sd)


def _import_swin(sd, spec):
    params, masks = import_swin_v2_t(sd, spec.cfg.depths)
    return params, None, masks


def _export_swin(params, batch_stats, masks, bake_masks):
    return export_swin_v2_t(params, masks, bake_masks)


def _import_dino(sd, spec):
    params, masks = import_dino_vit(sd, spec.cfg.depth)
    return params, None, masks


def _export_dino(params, batch_stats, masks, bake_masks):
    return export_dino_vit(params)


FAMILIES = {
    "vit": Family(_state_key, _flax_path, _import_vit, _export_vit),
    "resnet": Family(_resnet_key, _resnet_path, _import_resnet, export_resnet),
    "vgg": Family(_vgg_key, _vgg_path, _import_vgg, _export_vgg),
    "swin": Family(_state_key, _flax_path, _import_swin, _export_swin),
    "dino_vit": Family(_state_key, _flax_path, _import_dino, _export_dino),
    "mobilenet": Family(_mobilenet_key, _mobilenet_path, _import_mobilenet,
                        export_mobilenet_v2),
}


def family(spec) -> Family:
    """The converters of ``spec``'s family."""
    return FAMILIES[spec.family]


# ------------------------ the train driver's .pth --------------------------

def save_train_checkpoint(path, state, epoch: int, sparsity: float) -> None:
    """``torch.save`` a ``train.steps.TrainState`` to ``path`` (written to
    a temporary file, then renamed) through its family's torchvision
    exporter: the weights unbaked, every masked layer as ``weight_orig`` /
    ``weight_mask``, the BatchNorm running statistics, the optimizer, the
    epoch, the step count, the sparsity and the EMA weights and statistics
    if any."""
    fam = state.family

    def torchvision(named, stats, masks=None):
        params, batch_stats = fam.trees({**named, **(stats or {})})
        sd = fam.export_pth(params, batch_stats, masks, False)
        return {k: contiguous_tensor(v) for k, v in sd.items()}

    obj = {"model": torchvision(state.params, state.batch_stats,
                                fam.masks_from_state_dict(state.masks)),
           "optimizer": state.opt.state_dict(), "epoch": int(epoch), "step": int(state.step),
           "sparsity": float(sparsity)}
    if state.ema_params is not None:
        obj["model_ema"] = torchvision(state.ema_params, state.ema_batch_stats)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _unbaked(sd) -> Dict[str, np.ndarray]:
    """A state dict with each ``<key>_orig`` / ``<key>_mask`` pair as the
    raw ``<key>`` (NOT multiplied by its mask) and a bool
    ``<key>.__mask__``."""
    out = {}
    for k, v in sd.items():
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        if k.endswith("_orig"):
            out[k[:-len("_orig")]] = v
        elif k.endswith("_mask"):
            out[k[:-len("_mask")] + ".__mask__"] = v.astype(bool)
        else:
            out[k] = v
    return out


def load_train_checkpoint(path, spec) -> dict:
    """What ``save_train_checkpoint`` wrote, read through ``spec``'s family:
    ``params`` (flax-layout tree, unbaked), ``batch_stats`` (a flax tree or
    None), ``masks`` ({flax path: bool array}), ``optimizer``, ``epoch``,
    ``step``, ``sparsity``, ``ema_params`` and ``ema_batch_stats`` (flax
    trees or None). A reference ``.pth`` (``{"model": ...}`` or a bare
    state dict, DDP's ``module.`` stripped) gives its weights, statistics
    and masks, the rest at their defaults."""
    fam = family(spec)
    obj = load_pth(path)
    if "model" not in obj:  # a bare state dict
        obj = {"model": obj}

    def trees(sd):
        sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
        return fam.import_pth(_unbaked(sd), spec)

    params, batch_stats, masks = trees(obj["model"])
    ema_params = ema_batch_stats = None
    if obj.get("model_ema") is not None:
        ema_params, ema_batch_stats, _ = trees(obj["model_ema"])
    return {"params": params, "batch_stats": batch_stats, "masks": masks,
            "optimizer": obj.get("optimizer"), "epoch": int(obj.get("epoch", -1)),
            "step": int(obj.get("step", 0)), "sparsity": float(obj.get("sparsity", 0.0)),
            "ema_params": ema_params, "ema_batch_stats": ema_batch_stats}


# ------------------------- averaging and release weights -------------------

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked", "_mask",
                    "relative_coords_table", "relative_position_index")


def average_checkpoints(paths) -> dict:
    """The element-wise mean of several ``.pth`` checkpoints' weights
    (fairseq's checkpoint averaging; port of the JAX package's
    ``average_checkpoints``): every float parameter of ``model`` averaged
    in f64 and cast back to its dtype; the BatchNorm statistics, masks and
    every other entry of the first checkpoint kept as they are."""
    objs = [load_pth(p) for p in paths]
    objs = [o if "model" in o else {"model": o} for o in objs]
    out = dict(objs[0])
    sd = dict(objs[0]["model"])
    for k, v in sd.items():
        if v.is_floating_point() and not k.endswith(_BUFFER_SUFFIXES):
            mean = sum(o["model"][k].double() for o in objs) / len(objs)
            sd[k] = mean.to(v.dtype)
    out["model"] = sd
    return out


def store_model_weights(obj: dict, out_dir: str, prefix: str = "weights") -> str:
    """Release weights (port of the JAX package's ``store_model_weights``):
    ``obj``'s ``model`` state dict alone (the weights, masks and running
    statistics; no optimizer, EMA or epoch), written as
    ``{out_dir}/{prefix}-{sha256[:8]}.pth``, the hash over the tensors'
    bytes in key order. Returns the path."""
    import hashlib

    sd = obj["model"] if "model" in obj else obj
    h = hashlib.sha256()
    for k in sd:
        h.update(sd[k].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{prefix}-{h.hexdigest()[:8]}.pth")
    torch.save({"model": {k: contiguous_tensor(v) for k, v in sd.items()}}, path)
    return path
