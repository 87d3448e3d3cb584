"""Swin Transformer V2 (Tiny) (port of ``vipers/models/swin.py``),
torchvision's ``swin_v2_t``: patch 4, dims 96, depths (2, 2, 6, 2), heads
(3, 6, 12, 24), window 8, res-post-norm blocks, cosine attention with a
learnable per-head logit scale, the continuous relative-position bias (CPB)
MLP, PatchMergingV2, stochastic depth 0.2 scaled linearly over the blocks.

Input is NHWC, like the JAX package. The forward returns ``(logits,
aux)``: ``aux["features"]`` the final (N, H/32, W/32, 8C) map before the
norm, ``aux["attn"]`` the last block's softmax, ``aux["qkv"]`` its qkv
projection (full bias) in window-major token order (N, nW*64, 3C), the
tokens the reference's Swin LOST reads, and ``aux["qkv_grid"]`` the same
undone back to image order (N, H', W', 3C), for ``--swin-all-windows``.

The windows hold 64 tokens and the attention is always materialized, as
XLA computes it for the JAX package: no port kernel is on this path. The
dtype flow is flax's under a bf16 parameter copy: q.k^T takes bf16 inputs
into f32 logits (the einsum's ``preferred_element_type``), the CPB MLP
runs in f32 on bf16-rounded weights (its input table is an f32 constant
and flax promotes), the softmax runs in f32 and its probabilities are cast
back to bf16 for P.V; GELU is tanh in bf16 and erf in f32. Layers with
weights promote like flax (``models.cnn.Conv2d``, ``Linear``). The patch
embedding is a convolution: f32 callers run it inside
``models.cnn.exact_f32_convs``.

Stochastic depth draws from the ``generator`` a train forward is given
(``models.stochastic``). Module names are the flax paths
(``stage0_block0.attn.qkv``, ``merge0.reduction``), so the state dict maps
to the JAX tree by renaming leaves only; ``core.checkpoint`` converts
torchvision's ``features.*`` layout both ways.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.models.cnn import Conv2d, Linear
from vipers_torch.models.stochastic import drop_path
from vipers_torch.models.vit import LayerNorm, _lecun_normal

CPB_HIDDEN = 512


def window_partition(x, ws: int):
    """(N, H, W, C) -> (N*nW, ws*ws, C); H and W divisible by ws."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    n = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(n, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, -1)


def relative_coords_table_np(ws: int) -> np.ndarray:
    """((2ws-1)^2, 2) f32: the log-spaced relative coordinates the CPB MLP
    reads."""
    coords = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    table = table / (ws - 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2).astype(np.float32)


def relative_position_index_np(ws: int) -> np.ndarray:
    """(T, T) int: each token pair's row of the CPB table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


# The cached constants below are made outside inference mode whatever the
# caller's mode: a LOST call (inference mode) may make one first, and a
# training forward must be able to save it for its backward.

@functools.lru_cache(maxsize=None)
def _relative_coords_table(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(relative_coords_table_np(ws)).to(device)


@functools.lru_cache(maxsize=None)
def _relative_position_index(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_index_np(ws).reshape(-1)).long().to(device)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(h: int, w: int, ws: int, sh: int, sw: int,
                    device: torch.device) -> torch.Tensor:
    """(nW, T, T) f32 additive -100 mask between tokens of different
    regions after a cyclic shift: torchvision's region labels over the
    PADDED (h, w) map, the degenerate slices of a zero shift included."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in ((0, -ws), (-ws, -sh), (-sh, None)):
        for wsl in ((0, -ws), (-ws, -sw), (-sw, None)):
            img[hs[0]:hs[1], wsl[0]:wsl[1]] = cnt
            cnt += 1
    with torch.inference_mode(False):
        win = window_partition(torch.from_numpy(img)[None, :, :, None], ws).reshape(-1, ws * ws)
        diff = win[:, :, None] - win[:, None, :]
        return torch.where(diff != 0, -100.0, 0.0).to(device)


def _cosine_normalize(z):
    """``z / max(||z||, 1e-12)`` along the last axis, the norm as
    ``jnp.linalg.norm`` computes it (the squares in z's dtype, their sum in
    f32, rounded back). A zero vector (a pad token's k: its bias is zeroed)
    gets a zero gradient, as torch's norm and so torchvision's
    ``F.normalize`` give it; the JAX package's sqrt gives NaN there, so its
    gradients are NaN whenever a block pads its map (any input side that is
    not a multiple of 256 at window 8)."""
    s = torch.sum(z * z, dim=-1, keepdim=True, dtype=torch.float32).to(z.dtype)
    pos = s > 0
    n = torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))), torch.zeros_like(s))
    return z / torch.clamp(n, min=1e-12)


class WindowAttentionV2(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.qkv = Linear(dim, 3 * dim)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = Linear(2, CPB_HIDDEN)
        self.cpb_fc2 = Linear(CPB_HIDDEN, num_heads, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x, attn_mask=None):
        """x: (B, T, C) windows; ``attn_mask`` (nW, T, T) additive or None.
        Returns (out, softmax (B, h, T, T), qkv with the full bias)."""
        b, t, c = x.shape
        h = self.num_heads
        full = self.qkv(x)
        # torchvision zeroes the k third of the bias at every call; the
        # attention reads that, LOST the full-bias output (a hook's view)
        kb = self.qkv.bias.to(full.dtype)
        k_only = torch.cat([torch.zeros_like(kb[:c]), kb[c:2 * c], torch.zeros_like(kb[:c])])
        qkv = (full - k_only).reshape(b, t, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        q, k = _cosine_normalize(q), _cosine_normalize(k)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        # bf16 inputs, f32 products and sums (the einsum's preferred f32)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale

        cpb = self.cpb_fc2(torch.relu(self.cpb_fc1(_relative_coords_table(self.window_size,
                                                                          x.device))))
        idx = _relative_position_index(self.window_size, x.device)
        bias = 16.0 * torch.sigmoid(cpb[idx].reshape(t, t, h).permute(2, 0, 1))
        attn = attn + bias[None]
        if attn_mask is not None:
            n_w = attn_mask.shape[0]
            attn = (attn.reshape(b // n_w, n_w, h, t, t) + attn_mask[None, :, None]).reshape(
                b, h, t, t)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
        return self.proj(out), attn, full


class SwinBlockV2(nn.Module):
    """torchvision's ``SwinTransformerBlockV2``: the map zero-padded up to
    window multiples (pad tokens attend unmasked), the shift zeroed on an
    axis one window covers, windows, attention, reverse, crop, then
    res-post-norm ``x + drop_path(norm(f(x)))`` for the attention and the
    MLP. ``mlp_dim`` overrides the MLP's hidden width (structured
    slimming, ``pruning.structured.slim_swin``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0, sd_rate: float = 0.0, mlp_dim: Optional[int] = None):
        super().__init__()
        self.window_size, self.shift, self.sd_rate = window_size, shift, sd_rate
        hidden = mlp_dim or int(dim * mlp_ratio)
        self.attn = WindowAttentionV2(dim, num_heads, window_size)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def geometry(self, h: int, w: int):
        """(padded H, padded W, shift rows, shift cols) of an (h, w) map."""
        ws = self.window_size
        hp, wp = h + (ws - h % ws) % ws, w + (ws - w % ws) % ws
        return hp, wp, self.shift if ws < hp else 0, self.shift if ws < wp else 0

    def forward(self, x, generator=None):
        """x: (N, H, W, C). Returns (x, attn, qkv) of this block."""
        _, h, w, _ = x.shape
        ws = self.window_size
        hp, wp, sh, sw = self.geometry(h, w)
        xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h)) if (hp, wp) != (h, w) else x
        if sh or sw:
            xp = torch.roll(xp, (-sh, -sw), (1, 2))
        mask = shift_attn_mask(hp, wp, ws, sh, sw, x.device) if (sh or sw) else None
        y, attn, qkv = self.attn(window_partition(xp, ws), mask)
        y = window_reverse(y, ws, hp, wp)
        if sh or sw:
            y = torch.roll(y, (sh, sw), (1, 2))
        y = y[:, :h, :w, :]
        x = x + drop_path(self.norm1(y), self.sd_rate, self.training, generator)
        z = self.fc1(x)
        z = F.gelu(z, approximate="tanh" if z.dtype == torch.bfloat16 else "none")
        z = self.fc2(z)
        x = x + drop_path(self.norm2(z), self.sd_rate, self.training, generator)
        return x, attn, qkv


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x):
        n, h, w, c = x.shape
        if h % 2 or w % 2:  # torchvision pads odd maps
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        # torchvision's channel order cat([x0, x1, x2, x3]) = [(r0, c0),
        # (r1, c0), (r0, c1), (r1, c1)]: col-offset-major
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.norm(self.reduction(x.reshape(n, h // 2, w // 2, 4 * c)))


@dataclasses.dataclass(frozen=True)
class SwinV2Config:
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 8
    num_classes: int = 1000
    mlp_ratio: float = 4.0
    stochastic_depth_prob: float = 0.2  # torchvision swin_v2_t's
    # block name -> MLP hidden width (structured slimming); missing blocks
    # keep int(dim * mlp_ratio)
    mlp_dims: Optional[Dict[str, int]] = None

    def blocks(self):
        """(stage, block, dim, heads, shift, stochastic-depth rate) of each
        block; the rate rises linearly from 0 to ``stochastic_depth_prob``."""
        total, block_id, dim, out = sum(self.depths), 0, self.embed_dim, []
        for si, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            for bi in range(depth):
                sd = self.stochastic_depth_prob * block_id / max(total - 1, 1)
                out.append((si, bi, dim, heads, 0 if bi % 2 == 0 else self.window_size // 2, sd))
                block_id += 1
            dim *= 2
        return out

    def hidden(self, si: int, bi: int, dim: int) -> int:
        return (self.mlp_dims or {}).get(f"stage{si}_block{bi}") or int(dim * self.mlp_ratio)

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


class SwinTransformerV2(nn.Module):
    def __init__(self, cfg: SwinV2Config):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = Conv2d(3, cfg.embed_dim, p, stride=p)
        self.patch_norm = LayerNorm(cfg.embed_dim, eps=1e-5)
        self.blocks = []
        for si, bi, dim, heads, shift, sd in cfg.blocks():
            blk = SwinBlockV2(dim, heads, cfg.window_size, shift, cfg.mlp_ratio, sd,
                              cfg.hidden(si, bi, dim))
            setattr(self, f"stage{si}_block{bi}", blk)
            self.blocks.append(blk)
            if bi == cfg.depths[si] - 1 and si < len(cfg.depths) - 1:
                setattr(self, f"merge{si}", PatchMergingV2(dim))
                self.blocks.append(getattr(self, f"merge{si}"))
        self.norm = LayerNorm(cfg.num_features, eps=1e-5)
        self.head = Linear(cfg.num_features, cfg.num_classes) if cfg.num_classes else None

    def random_rates(self):
        """The blocks' stochastic-depth rates."""
        return tuple(blk.sd_rate for blk in self.blocks if isinstance(blk, SwinBlockV2))

    def forward(self, x, need_attn: bool = True, generator=None, tap_delta=None):
        """x (N, H, W, 3); ``need_attn`` is accepted for the callers' sake
        (the windows' attention is always materialized); ``generator``
        feeds stochastic depth in train mode; ``tap_delta``, the explain
        tap, is added to the final feature map before the norm."""
        x = self.patch_norm(self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        last = None
        for blk in self.blocks:
            if isinstance(blk, PatchMergingV2):
                x = blk(x)
                continue
            geo = x.shape[1:3]
            x, attn, qkv = blk(x, generator)
            last = (blk, geo, attn, qkv)
        blk, (gh, gw), attn, qkv = last
        # the last block's qkv back in image order: its pad, shift and
        # windows undone
        hp, wp, sh, sw = blk.geometry(gh, gw)
        g = window_reverse(qkv, self.cfg.window_size, hp, wp)
        if sh or sw:
            g = torch.roll(g, (sh, sw), (1, 2))
        if tap_delta is not None:
            x = x + tap_delta
        features = x
        pooled = self.norm(x).mean(dim=(1, 2))
        logits = self.head(pooled) if self.head is not None else pooled
        return logits, {"features": features, "attn": attn,
                        "qkv": qkv.reshape(x.shape[0], -1, qkv.shape[-1]),
                        "qkv_grid": g[:, :gh, :gw, :]}


def init_swin_params(cfg: SwinV2Config, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys and layouts (conv HWIO,
    dense (in, out)) and flax's initializers: lecun_normal kernels, zero
    biases, LayerNorm scale 1 and bias 0, ``logit_scale`` log 10; drawn
    from ``gen``."""
    def dense(fan_in, features, bias=True):
        d = {"kernel": _lecun_normal((fan_in, features), fan_in, gen)}
        if bias:
            d["bias"] = torch.zeros(features)
        return d

    def ln(d):
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    p, e = cfg.patch_size, cfg.embed_dim
    params = {"patch_embed": {"kernel": _lecun_normal((p, p, 3, e), p * p * 3, gen),
                              "bias": torch.zeros(e)},
              "patch_norm": ln(e)}
    for si, bi, dim, heads, _shift, _sd in cfg.blocks():
        hidden = cfg.hidden(si, bi, dim)
        params[f"stage{si}_block{bi}"] = {
            "attn": {"qkv": dense(dim, 3 * dim),
                     "logit_scale": torch.full((heads, 1, 1), math.log(10.0)),
                     "cpb_fc1": dense(2, CPB_HIDDEN), "cpb_fc2": dense(CPB_HIDDEN, heads, False),
                     "proj": dense(dim, dim)},
            "norm1": ln(dim), "fc1": dense(dim, hidden), "fc2": dense(hidden, dim),
            "norm2": ln(dim)}
        if bi == cfg.depths[si] - 1 and si < len(cfg.depths) - 1:
            params[f"merge{si}"] = {"reduction": dense(4 * dim, 2 * dim, False),
                                    "norm": ln(2 * dim)}
    params["norm"] = ln(cfg.num_features)
    if cfg.num_classes:
        params["head"] = dense(cfg.num_features, cfg.num_classes)
    return params


def swin_spec(name: str, cfg: SwinV2Config, input_size=(256, 256)) -> ModelSpec:
    """The ModelSpec of a Swin-V2 configuration (the registry's and the
    tests' narrower ones)."""
    return ModelSpec(
        name=name, cfg=cfg, module=lambda: SwinTransformerV2(cfg),
        init=lambda gen: init_swin_params(cfg, gen), input_size=tuple(input_size),
        prune_exclude=("qkv", "cpb"), patch_size=cfg.patch_size, family="swin",
        num_classes=cfg.num_classes,
        extra={"num_heads": cfg.num_heads[-1], "embed_dim": cfg.embed_dim},
        rebuild=lambda c: swin_spec(name, c, input_size))


@register_model("swin_v2_t")
def swin_v2_t(num_classes=1000, input_size=(256, 256)):
    """torchvision's swin_v2_t, the paper's pruned Swin."""
    return swin_spec("swin_v2_t", SwinV2Config(num_classes=num_classes), input_size)
