"""Structured slimming: turn pruning into physically smaller matmuls
(port of ``vipers/pruning/structured.py``).

Unstructured masks never speed up a dense kernel: the effective weight is
``w * mask`` and the product multiplies the zeros at full cost. This
module removes whole units from a (possibly mask-pruned) model: MLP
neurons and attention heads from ViTs (``slim_vit``), conv output
channels and fc units from VGG16 (``slim_vgg``), MLP neurons from Swin-V2
(``slim_swin``) and the residual-free inner channels of ResNet blocks
(``slim_resnet``). Each returns a smaller parameter tree, its masks
sliced alike, and the config overrides (``mlp_dim``/``num_heads``/
``head_dim``, ``conv_widths``/``fc_dims``, ``mlp_dims``,
``inner_widths``) that rebuild a matching module through
``core.registry.build_model(..., arch_overrides=...)``.

Exactness contract (tested): a dropped unit whose DOWNSTREAM projection
is zero contributes exactly nothing to the network output:

* an MLP neuron ``j`` is inert iff ``fc2.kernel[j, :] == 0`` (whatever
  ``gelu(x @ W1[:, j] + b1[j])`` is, it multiplies a zero row);
* a head ``a`` is inert iff its ``out``-projection rows are zero, or its
  v-projection kernel slice AND v bias are zero (then ``attn @ v == 0``).

So when the keep-set covers every unit with a nonzero downstream
projection, the slim model computes the same function as the masked
model (up to f32 reduction regrouping at the smaller width). Below that,
slimming is the standard L2-saliency structured approximation.

Host-side numpy, as in the JAX module: the saliencies, the keep sets and
the slices are computed on the host, never on a device, and trees come in
and go out in the JAX package's flax paths and layouts (conv HWIO, dense
(in, out)). ``np.argpartition``'s choice among equal scores decides which
units survive, and inert units all score exactly 0, so such ties are
common: a ``torch.topk`` would break them differently. So the kept
indices, the overrides and the slim trees equal the JAX package's exactly
on the same inputs.

``run_slim_cli`` is ``vipers_torch slim``: a ``.pth`` in, through
``discovery.driver.load_lost_checkpoint``, and
``{model}_slim_{tag}.pth`` out through the family's torchvision exporter,
masked layers as ``weight_orig`` / ``weight_mask`` (as ``train`` writes
them), with the JAX package's ``.slim.json`` sidecar beside it. A
checkpoint that carries quantize observers (``vipers_torch quantize``)
passes them into the slim one unchanged, as the JAX CLI does: the
activation sites keep their names across a slim.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from vipers_torch.core.tree import flatten_dict, unflatten_dict

Path = Tuple[str, ...]


@dataclasses.dataclass
class SlimReport:
    """What slimming did: per-layer kept unit indices + param counts."""

    mlp_dim: int
    num_heads: int
    head_dim: int
    kept_neurons: Dict[str, np.ndarray]
    kept_heads: Dict[str, np.ndarray]
    params_before: int
    params_after: int

    @property
    def param_reduction(self) -> float:
        return 1.0 - self.params_after / max(self.params_before, 1)


def _eff(flat, masks, path):
    w = np.asarray(flat[path])
    m = masks.get(path)
    return w * np.asarray(m, w.dtype) if m is not None else w


def _layers(flat):
    names = sorted(
        {p[0] for p in flat if p[0].startswith("encoder_layer_")},
        key=lambda s: int(s.rsplit("_", 1)[1]),
    )
    if not names:
        raise ValueError(
            "no encoder_layer_* params: structured slimming targets the "
            "torchvision ViT family (the models the reference actually "
            "prunes); DINO backbones are frozen feature extractors and "
            "are never mask-pruned"
        )
    return names


def mlp_neuron_scores(flat, masks, layer: str) -> np.ndarray:
    """L2 saliency per hidden neuron: ``||fc2_row|| * sqrt(||fc1_col||^2 +
    b1^2)`` on mask-applied weights. Exactly zero iff the neuron is inert
    (zero fc2 row) or feeds nothing in (zero fc1 col+bias — then its
    output is the constant ``gelu(b1)=gelu(0)=0`` only when b1==0, which
    the second factor encodes)."""
    w1 = _eff(flat, masks, (layer, "mlp", "fc1", "kernel"))
    b1 = np.asarray(flat[(layer, "mlp", "fc1", "bias")], np.float32)
    w2 = _eff(flat, masks, (layer, "mlp", "fc2", "kernel"))
    up = np.sqrt((w1.astype(np.float32) ** 2).sum(0) + b1**2)
    down = np.sqrt((w2.astype(np.float32) ** 2).sum(1))
    return down * up


def head_scores(flat, masks, layer: str, h: int, hd: int) -> np.ndarray:
    """L2 saliency per head: ``||out_rows|| * sqrt(||v_kernel||^2 +
    ||v_bias||^2)``. Zero iff the head is provably inert (see module
    docstring) — q/k only shape the softmax, they cannot make a head with
    zero v and zero out rows contribute."""
    qkv = _eff(flat, masks, (layer, "attention", "qkv", "kernel"))
    qkv_b = np.asarray(flat[(layer, "attention", "qkv", "bias")], np.float32)
    out = _eff(flat, masks, (layer, "attention", "out", "kernel"))
    d = qkv.shape[0]
    v = qkv.reshape(d, 3, h, hd)[:, 2].astype(np.float32)  # (d, h, hd)
    vb = qkv_b.reshape(3, h, hd)[2]  # (h, hd)
    o = out.reshape(h, hd, -1).astype(np.float32)
    v_mass = np.sqrt((v**2).sum(axis=(0, 2)) + (vb**2).sum(axis=1))
    out_mass = np.sqrt((o**2).sum(axis=(1, 2)))
    return out_mass * v_mass


def _keep_count(total: int, keep: Optional[float], unit: int,
                round_to: int) -> int:
    """Units to keep: ``ceil(total*keep)`` rounded UP so the resulting
    width (``count*unit``) is a ``round_to`` multiple; never below one
    aligned group, never above ``total``."""
    if keep is None or keep >= 1.0:
        return total
    want = int(np.ceil(total * keep))
    per = max(round_to // unit, 1) if (round_to % unit == 0) else 1
    want = int(np.ceil(want / per) * per)
    return min(max(want, per), total)


def _top_idx(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, in ascending index order (a
    deterministic permutation-free layout for the slim kernels)."""
    idx = np.argpartition(-scores, k - 1)[:k] if k < len(scores) else \
        np.arange(len(scores))
    return np.sort(idx)


def slim_vit(
    variables: dict,
    masks: Dict[Path, "np.ndarray"],
    cfg,
    mlp_keep: Optional[float] = None,
    heads_keep: Optional[float] = None,
    round_to: int = 128,
):
    """Slim a ViT parameter tree (and its masks) by whole units.

    Args:
      variables: ``{"params": ...}`` tree (ViT layout, `models/vit.py`).
      masks: ``{path_tuple: bool array}`` unstructured masks (may be
        empty); saliencies are computed on mask-applied weights and kept
        masks are sliced to the kept units.
      cfg: the model's ``ViTConfig``.
      mlp_keep / heads_keep: fraction of MLP neurons / heads to keep
        (None = keep all). The kept count is uniform across layers (one
        static shape per program); the SELECTION is per-layer.
      round_to: align slimmed widths to this multiple (the JAX package's
        default 128, its TPU lane count, is the fused MLP kernel's column
        tile too; pass 1 to disable).

    Returns ``(variables, masks, overrides, SlimReport)`` where
    ``overrides`` plugs into ``build_model(name, arch_overrides=...)``.
    """
    params = variables["params"]
    flat = dict(flatten_dict(params))
    layers = _layers(flat)
    h = cfg.num_heads
    hd = cfg.head_dim or cfg.hidden_dim // cfg.num_heads
    m_total = cfg.mlp_dim

    keep_m = _keep_count(m_total, mlp_keep, 1, round_to)
    keep_h = _keep_count(h, heads_keep, hd, round_to)

    params_before = sum(int(np.prod(v.shape)) for v in flat.values())
    new_flat = dict(flat)
    new_masks = dict(masks)
    kept_neurons, kept_heads = {}, {}

    def _slice(path, take, axis):
        arr = np.asarray(new_flat[path])
        new_flat[path] = np.take(arr, take, axis=axis)
        if path in new_masks:
            new_masks[path] = np.take(
                np.asarray(new_masks[path]), take, axis=axis
            )

    for layer in layers:
        if keep_m < m_total:
            idx = _top_idx(mlp_neuron_scores(flat, masks, layer), keep_m)
            kept_neurons[layer] = idx
            _slice((layer, "mlp", "fc1", "kernel"), idx, 1)
            _slice((layer, "mlp", "fc1", "bias"), idx, 0)
            _slice((layer, "mlp", "fc2", "kernel"), idx, 0)
        if keep_h < h:
            hidx = _top_idx(head_scores(flat, masks, layer, h, hd), keep_h)
            kept_heads[layer] = hidx
            d = flat[(layer, "attention", "qkv", "kernel")].shape[0]
            # qkv columns are q|k|v contiguous; within each, head-major.
            col = (
                np.arange(3)[:, None, None] * (h * hd)
                + hidx[None, :, None] * hd
                + np.arange(hd)[None, None, :]
            ).reshape(-1)
            _slice((layer, "attention", "qkv", "kernel"), col, 1)
            _slice((layer, "attention", "qkv", "bias"), col, 0)
            row = (hidx[:, None] * hd + np.arange(hd)[None, :]).reshape(-1)
            _slice((layer, "attention", "out", "kernel"), row, 0)

    params_after = sum(int(np.prod(v.shape)) for v in new_flat.values())
    overrides = {}
    if keep_m < m_total:
        overrides["mlp_dim"] = keep_m
    if keep_h < h:
        overrides["num_heads"] = keep_h
        overrides["head_dim"] = hd
    out_vars = dict(variables)
    out_vars["params"] = unflatten_dict(new_flat)
    report = SlimReport(
        mlp_dim=keep_m, num_heads=keep_h, head_dim=hd,
        kept_neurons=kept_neurons, kept_heads=kept_heads,
        params_before=params_before, params_after=params_after,
    )
    return out_vars, new_masks, overrides, report


def conv_channel_scores(flat, masks, i: int, fc1_group: int) -> np.ndarray:
    """L2 saliency per output channel of ``conv_i`` (VGG layout):
    ``||downstream_in_slice|| * sqrt(||kernel_out_slice||^2 + bias^2)``.
    Downstream is ``conv_{i+1}``'s in-channel slice, or — for the last
    conv — the ``fc1`` row group the channel owns under torch's CHW
    flatten (``fc1_group`` consecutive rows per channel). Exactly zero iff
    the channel is inert: whatever ``relu(conv(x) + b)`` emits multiplies
    a zero downstream slice."""
    w = _eff(flat, masks, (f"conv_{i}", "kernel")).astype(np.float32)
    b = np.asarray(flat[(f"conv_{i}", "bias")], np.float32)
    up = np.sqrt((w**2).sum(axis=(0, 1, 2)) + b**2)
    nxt = (f"conv_{i + 1}", "kernel")
    if nxt in flat:
        dw = _eff(flat, masks, nxt).astype(np.float32)
        down = np.sqrt((dw**2).sum(axis=(0, 1, 3)))
    else:
        dw = _eff(flat, masks, ("fc1", "kernel")).astype(np.float32)
        down = np.sqrt(
            (dw.reshape(-1, fc1_group, dw.shape[1]) ** 2).sum(axis=(1, 2))
        )
    return down * up


def slim_vgg(
    variables: dict,
    masks: Dict[Path, "np.ndarray"],
    cfg,
    conv_keep: Optional[float] = None,
    fc_keep: Optional[float] = None,
    round_to: int = 128,
):
    """Slim a VGG16 tree by whole conv channels and fc neurons.

    VGG is a plain sequential stack, so channel removal is exact chaining:
    slicing ``conv_i``'s output channels slices ``conv_{i+1}``'s input
    channels (or the matching ``fc1`` row groups for the last conv — torch
    CHW flatten puts each channel's ``H*W`` rows contiguously). The
    exactness contract is the module docstring's: drop only channels whose
    downstream slice is zero and the logits are unchanged. ``fc_keep``
    slims ``fc1``/``fc2`` hidden units exactly like the ViT MLP.

    Returns ``(variables, masks, overrides, SlimReport)`` with overrides
    ``{"conv_widths": (...), "fc_dims": (...)}`` for
    ``build_model("vgg16", arch_overrides=...)``. Headless trees (no
    ``fc1``) keep the LAST conv intact — its output IS the LOST feature
    map contract.
    """
    params = variables["params"]
    flat = dict(flatten_dict(params))
    n_convs = len(cfg.conv_widths)
    if (f"conv_{n_convs - 1}", "kernel") not in flat:
        raise ValueError("no conv_* params — not a VGG tree?")
    has_fc = ("fc1", "kernel") in flat
    fc1_group = (
        flat[("fc1", "kernel")].shape[0] // cfg.conv_widths[-1]
        if has_fc else 0
    )

    params_before = sum(int(np.prod(v.shape)) for v in flat.values())
    new_flat = dict(flat)
    new_masks = dict(masks)
    kept = {}

    def _slice(path, take, axis):
        arr = np.asarray(new_flat[path])
        new_flat[path] = np.take(arr, take, axis=axis)
        if path in new_masks:
            new_masks[path] = np.take(
                np.asarray(new_masks[path]), take, axis=axis
            )

    conv_widths = list(cfg.conv_widths)
    last = n_convs - 1 if has_fc else n_convs - 2
    for i in range(last + 1):
        total = cfg.conv_widths[i]
        k = _keep_count(total, conv_keep, 1, round_to)
        if k >= total:
            continue
        idx = _top_idx(conv_channel_scores(flat, masks, i, fc1_group), k)
        kept[f"conv_{i}"] = idx
        conv_widths[i] = k
        _slice((f"conv_{i}", "kernel"), idx, 3)
        _slice((f"conv_{i}", "bias"), idx, 0)
        if i < n_convs - 1:
            _slice((f"conv_{i + 1}", "kernel"), idx, 2)
        else:
            rows = (idx[:, None] * fc1_group
                    + np.arange(fc1_group)[None, :]).reshape(-1)
            _slice(("fc1", "kernel"), rows, 0)

    fc_dims = list(cfg.fc_dims)
    if has_fc:
        for j, (name, down) in enumerate((("fc1", "fc2"), ("fc2", "fc3"))):
            total = cfg.fc_dims[j]
            k = _keep_count(total, fc_keep, 1, round_to)
            if k >= total:
                continue
            w1 = _eff(new_flat, new_masks, (name, "kernel")).astype(np.float32)
            b1 = np.asarray(new_flat[(name, "bias")], np.float32)
            w2 = _eff(new_flat, new_masks, (down, "kernel")).astype(np.float32)
            score = (np.sqrt((w2**2).sum(1))
                     * np.sqrt((w1**2).sum(0) + b1**2))
            idx = _top_idx(score, k)
            kept[name] = idx
            fc_dims[j] = k
            _slice((name, "kernel"), idx, 1)
            _slice((name, "bias"), idx, 0)
            _slice((down, "kernel"), idx, 0)

    params_after = sum(int(np.prod(v.shape)) for v in new_flat.values())
    overrides = {}
    if conv_widths != list(cfg.conv_widths):
        overrides["conv_widths"] = tuple(conv_widths)
    if fc_dims != list(cfg.fc_dims):
        overrides["fc_dims"] = tuple(fc_dims)
    out_vars = dict(variables)
    out_vars["params"] = unflatten_dict(new_flat)
    report = SlimReport(
        mlp_dim=0, num_heads=0, head_dim=0,
        kept_neurons=kept, kept_heads={},
        params_before=params_before, params_after=params_after,
    )
    return out_vars, new_masks, overrides, report


def slim_swin(
    variables: dict,
    masks: Dict[Path, "np.ndarray"],
    cfg,
    mlp_keep: Optional[float] = None,
    round_to: int = 128,
):
    """Slim a Swin-V2 tree by whole MLP hidden neurons, per block.

    Same exactness contract as the ViT MLP: a neuron whose ``fc2`` row is
    zero contributes nothing — Swin's res-post-norm (``x + norm2(fc2(
    gelu(fc1(x))))``) does not change this, because the dropped neuron
    leaves fc2's OUTPUT (norm2's input) bit-identical. Attention heads
    are NOT slimmed: each head owns a relative-position-bias table
    produced by the shared cpb MLP, so head removal is not a pure
    parameter slice (documented limitation).

    Returns overrides ``{"mlp_dims": {block: width}}`` for
    ``build_model("swin_v2_t", arch_overrides=...)``.
    """
    params = variables["params"]
    flat = dict(flatten_dict(params))
    blocks = sorted({p[0] for p in flat if p[0].startswith("stage")})
    if not blocks:
        raise ValueError("no stage*_block* params — not a Swin tree?")

    params_before = sum(int(np.prod(v.shape)) for v in flat.values())
    new_flat = dict(flat)
    new_masks = dict(masks)
    kept = {}
    mlp_dims = {}

    def _slice(path, take, axis):
        arr = np.asarray(new_flat[path])
        new_flat[path] = np.take(arr, take, axis=axis)
        if path in new_masks:
            new_masks[path] = np.take(
                np.asarray(new_masks[path]), take, axis=axis
            )

    for block in blocks:
        total = flat[(block, "fc1", "kernel")].shape[1]
        k = _keep_count(total, mlp_keep, 1, round_to)
        if k >= total:
            continue
        w1 = _eff(flat, masks, (block, "fc1", "kernel")).astype(np.float32)
        b1 = np.asarray(flat[(block, "fc1", "bias")], np.float32)
        w2 = _eff(flat, masks, (block, "fc2", "kernel")).astype(np.float32)
        score = (np.sqrt((w2**2).sum(1))
                 * np.sqrt((w1**2).sum(0) + b1**2))
        idx = _top_idx(score, k)
        kept[block] = idx
        mlp_dims[block] = k
        _slice((block, "fc1", "kernel"), idx, 1)
        _slice((block, "fc1", "bias"), idx, 0)
        _slice((block, "fc2", "kernel"), idx, 0)

    params_after = sum(int(np.prod(v.shape)) for v in new_flat.values())
    overrides = {"mlp_dims": mlp_dims} if mlp_dims else {}
    out_vars = dict(variables)
    out_vars["params"] = unflatten_dict(new_flat)
    report = SlimReport(
        mlp_dim=0, num_heads=0, head_dim=0,
        kept_neurons=kept, kept_heads={},
        params_before=params_before, params_after=params_after,
    )
    return out_vars, new_masks, overrides, report


def _resnet_inner_score(flat, masks, block: str, conv: str,
                        down_conv: str) -> np.ndarray:
    """L2 saliency per residual-free inner channel of a ResNet block:
    ``||down_in_slice|| * sqrt(||conv_out_slice||^2 + bn_scale^2 +
    bn_bias^2)``. Exactly zero iff the channel is provably inert: either
    the downstream conv's in-slice is zero (whatever bn+relu emit
    multiplies zeros), or the conv slice AND the bn affine are all zero
    (bn output ``gamma*(0-mu)/sigma + beta == 0``, relu(0)=0)."""
    bn = "bn" + conv[-1]
    w = _eff(flat, masks, (block, conv, "kernel")).astype(np.float32)
    g = np.asarray(flat[(block, bn, "scale")], np.float32)
    b = np.asarray(flat[(block, bn, "bias")], np.float32)
    up = np.sqrt((w**2).sum(axis=(0, 1, 2)) + g**2 + b**2)
    dw = _eff(flat, masks, (block, down_conv, "kernel")).astype(np.float32)
    down = np.sqrt((dw**2).sum(axis=(0, 1, 3)))
    return down * up


def slim_resnet(
    variables: dict,
    masks: Dict[Path, "np.ndarray"],
    inner_keep: Optional[float] = None,
    round_to: int = 128,
):
    """Slim a ResNet tree by the residual-free INNER channels of each
    block — conv1's outputs in a BasicBlock, conv1's and conv2's in a
    Bottleneck. Block input/output widths stay untouched: they are
    coupled through the residual adds (the classic channel-pruning
    constraint), so only the inner widths can shrink without touching
    every block in a stage. bn running stats (``batch_stats``) are
    sliced alongside the bn affine params.

    Returns ``(variables, masks, overrides, SlimReport)`` with overrides
    ``{"inner_widths": {block: int | (int, int)}}`` for
    ``build_model("resnet18|resnet50", arch_overrides=...)``.
    """
    params = variables["params"]
    flat = dict(flatten_dict(params))
    blocks = sorted({p[0] for p in flat
                     if p[0].startswith("layer") and "_" in p[0]})
    if not blocks:
        raise ValueError("no layer*_* params — not a ResNet tree?")
    stats = variables.get("batch_stats")
    flat_stats = dict(flatten_dict(stats)) if stats else {}

    params_before = sum(int(np.prod(v.shape)) for v in flat.values())
    new_flat = dict(flat)
    new_masks = dict(masks)
    kept = {}
    inner_widths = {}

    def _slice(path, take, axis):
        arr = np.asarray(new_flat[path])
        new_flat[path] = np.take(arr, take, axis=axis)
        if path in new_masks:
            new_masks[path] = np.take(
                np.asarray(new_masks[path]), take, axis=axis
            )

    def _slim_one(block, conv, down_conv):
        total = flat[(block, conv, "kernel")].shape[3]
        k = _keep_count(total, inner_keep, 1, round_to)
        if k >= total:
            return total
        idx = _top_idx(
            _resnet_inner_score(flat, masks, block, conv, down_conv), k
        )
        kept[f"{block}/{conv}"] = idx
        bn = "bn" + conv[-1]
        _slice((block, conv, "kernel"), idx, 3)
        for leaf in ("scale", "bias"):
            _slice((block, bn, leaf), idx, 0)
        for leaf in ("mean", "var"):
            p = (block, bn, leaf)
            if p in flat_stats:
                flat_stats[p] = np.take(np.asarray(flat_stats[p]), idx, 0)
        _slice((block, down_conv, "kernel"), idx, 2)
        return k

    for block in blocks:
        if (block, "conv3", "kernel") in flat:  # Bottleneck
            k1 = _slim_one(block, "conv1", "conv2")
            k2 = _slim_one(block, "conv2", "conv3")
            total = flat[(block, "conv1", "kernel")].shape[3]
            if (k1, k2) != (total, total):
                inner_widths[block] = (k1, k2)
        else:  # BasicBlock
            total = flat[(block, "conv1", "kernel")].shape[3]
            k = _slim_one(block, "conv1", "conv2")
            if k != total:
                inner_widths[block] = k

    params_after = sum(int(np.prod(v.shape)) for v in new_flat.values())
    overrides = {"inner_widths": inner_widths} if inner_widths else {}
    out_vars = dict(variables)
    out_vars["params"] = unflatten_dict(new_flat)
    if stats:
        out_vars["batch_stats"] = unflatten_dict(flat_stats)
    report = SlimReport(
        mlp_dim=0, num_heads=0, head_dim=0,
        kept_neurons=kept, kept_heads={},
        params_before=params_before, params_after=params_after,
    )
    return out_vars, new_masks, overrides, report


def write_sidecar(checkpoint_path: str, model: str,
                  arch_overrides: dict) -> None:
    """Write the ``.slim.json`` sidecar next to a checkpoint so every
    driver (``arch_sidecar`` readers) rebuilds the module at the slim
    widths. Called by ``vipers_torch slim`` AND by the train driver
    whenever it checkpoints a session that was itself resumed from a
    slim checkpoint: otherwise the fine-tune outputs would look dense
    and crash every downstream consumer."""
    with open(str(checkpoint_path).rstrip("/") + ".slim.json", "w") as f:
        json.dump({"model": model, "arch_overrides": arch_overrides}, f)


def merge_overrides(base: Optional[dict], new: dict) -> dict:
    """Combine an input checkpoint's existing arch overrides with a new
    slim pass's. Scalar/tuple fields (mlp_dim, conv_widths, ...) are
    absolute widths — the new value wins; dict-valued fields (ResNet
    inner_widths, Swin mlp_dims) merge per block so blocks untouched by
    the new pass keep their earlier widths."""
    out = dict(base or {})
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = {**out[k], **v}
        else:
            out[k] = v
    return out


def arch_sidecar(checkpoint_path: str) -> Optional[dict]:
    """``arch_overrides`` recorded next to a slimmed checkpoint
    (``{path}.slim.json``, written by ``run_slim_cli``, or ``slim.json``
    inside a checkpoint directory), or None. Drivers pass the dict to
    ``build_model(..., arch_overrides=...)`` so the module's parameter
    shapes match the slim tree."""
    if not checkpoint_path:
        return None
    p = str(checkpoint_path).rstrip("/")
    for cand in (p + ".slim.json", os.path.join(p, "slim.json")):
        if os.path.exists(cand):
            with open(cand) as f:
                return json.load(f).get("arch_overrides") or None
    return None


def run_slim_cli(args) -> int:
    """``vipers_torch slim``: trained (masked) ``.pth`` -> physically
    smaller ``.pth`` + ``.slim.json`` sidecar that ``lost``, ``evaluate``,
    ``train --resume`` and ``explain`` pick up. Exit 1 for a family slim
    does not take or keep fractions that leave every unit."""
    import torch

    from vipers_torch.core.checkpoint import family, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.discovery.driver import load_lost_checkpoint

    # an already-slim input (slim -> fine-tune -> slim again): build the
    # module at the INPUT's widths so saliency reshapes match the tree, and
    # fold its overrides into the new sidecar below
    input_arch = arch_sidecar(args.checkpoint)
    spec = build_model(args.model, num_classes=args.num_classes,
                       **({"arch_overrides": input_arch} if input_arch else {}))
    params, batch_stats, masks, observers = load_lost_checkpoint(args.checkpoint, spec)
    variables = {"params": params}
    if batch_stats is not None:
        variables["batch_stats"] = batch_stats
    if spec.family == "vgg":
        out_vars, new_masks, overrides, report = slim_vgg(
            variables, masks, spec.cfg,
            conv_keep=args.conv_keep, fc_keep=args.fc_keep,
            round_to=args.round_to,
        )
        tag = (f"c{int(100 * (args.conv_keep or 1))}"
               f"_f{int(100 * (args.fc_keep or 1))}")
    elif spec.family == "resnet":
        out_vars, new_masks, overrides, report = slim_resnet(
            variables, masks, inner_keep=args.inner_keep,
            round_to=args.round_to,
        )
        tag = f"i{int(100 * (args.inner_keep or 1))}"
    elif spec.family == "swin":
        out_vars, new_masks, overrides, report = slim_swin(
            variables, masks, spec.cfg,
            mlp_keep=args.mlp_keep, round_to=args.round_to,
        )
        tag = f"m{int(100 * (args.mlp_keep or 1))}"
    elif spec.family == "vit":
        out_vars, new_masks, overrides, report = slim_vit(
            variables, masks, spec.cfg,
            mlp_keep=args.mlp_keep, heads_keep=args.heads_keep,
            round_to=args.round_to,
        )
        tag = f"m{report.mlp_dim}_h{report.num_heads}"
    else:
        print(f"slim supports the vit, swin, resnet, and vgg families; "
              f"model {args.model!r} is family {spec.family!r}")
        return 1
    if not overrides:
        print("nothing to slim: keep fractions leave every unit "
              "(pass --mlp-keep/--heads-keep, --conv-keep/--fc-keep, "
              "or --inner-keep < 1)")
        return 1
    overrides = merge_overrides(input_arch, overrides)
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, f"{args.model}_slim_{tag}.pth")
    sd = family(spec).export_pth(out_vars["params"], out_vars.get("batch_stats"),
                                 new_masks, False)
    if observers:
        # quantize calibration ranges: the sites keep their names across a
        # slim, and an exact-keep slim leaves their distributions as they
        # were; carrying them beats falling back to dynamic int8 serving
        torch.save({"model": {k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                    "observers": observers}, path)
    else:
        save_torch_state_dict(sd, path)
    write_sidecar(path, args.model, overrides)
    arch_txt = ", ".join(f"{k} {v}" for k, v in overrides.items())
    print(
        f"slimmed {args.model}: {arch_txt}, "
        f"params {report.params_before} -> {report.params_after} "
        f"(-{100 * report.param_reduction:.1f}%)\nwrote {path}"
    )
    return 0
