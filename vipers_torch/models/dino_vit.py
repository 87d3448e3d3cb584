"""DINO Vision Transformer, ViT-Tiny/Small/Base at patch 8 or 16 (port of
``vipers/models/dino_vit.py``): the frozen backbone of LOST's ``--arch
dino`` and of ``cluster``.

Input is NHWC. The forward returns ``(out, aux)``: ``out`` the CLS feature
after the final LayerNorm (``num_classes`` 0, the DINO convention) or the
head's logits; ``aux`` holds the last block's ``qkv`` projection (N, T,
3D) in the timm layout, its per-head softmax ``attn`` when ``need_attn``,
the final ``tokens`` and the last block's norm1 output ``qkv_input``. Any
input size runs: the stored position table (224 // patch a side) is
resized bicubically with half-pixel centres (``_interp_pos``), unless the
caller passes ``override_pos_embedding``. ``seq_pad_multiple`` pads the
tokens once, masked invalid, as the ViT does.

Kernel routing is the JAX package's: attention at T >= ``flash_min_t()``
without ``need_attn`` goes to the flash kernel (``ops/flash_attention.py``;
only the last block asks for the probabilities), and in bf16 at inference
norm2 -> fc1 -> GELU goes to the fused kernel (``ops/fused_mlp.py``) when
the row count passes the JAX block rule; otherwise the key-masked einsum
and LayerNorm -> Linear -> GELU (tanh in bf16, erf in f32). Under sequence
parallelism (``parallel.sp``) a rank holds its share of the tokens, gathers
k and v in each block and the last block's outputs whole at the end; both
kernels are off there, as in the JAX package. Modules carry
the flax names (``block_i.attn.qkv``), so the state dict is the flax tree
renamed (``core.checkpoint``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.models.interpolate import interpolate_pos_embedding
from vipers_torch.models.vit import LayerNorm, PatchConv, _lecun_normal
from vipers_torch.ops.flash_attention import attention_reference, flash_attention, flash_min_t
from vipers_torch.ops.fused_mlp import fused_ln_dense_gelu, fused_supported
from vipers_torch.ops.tokens import pad_tokens, unpad_tokens
from vipers_torch.parallel import sp


class DinoAttention(nn.Module):
    """timm attention: one qkv projection laid out (3, heads, head dim)
    along its outputs, returned beside the output and the probabilities."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, token_mask=None, need_attn: bool = True):
        n, t, d = x.shape
        h = self.num_heads
        hd = d // h
        scale = hd ** -0.5
        qkv_out = self.qkv(x)
        qkv = qkv_out.reshape(n, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        seq = sp.sequence_axis()
        if seq is not None:
            # this rank's queries against every rank's keys
            q, k, v = qkv.unbind(0)
            k, v = sp.gather_tokens(k, seq, dim=2), sp.gather_tokens(v, seq, dim=2)
            mask = token_mask[:, None, None, :] if token_mask is not None else None
            out, attn = attention_reference(q, k, v, scale=scale, mask=mask)
            if not need_attn:
                attn = None
        elif not need_attn and t >= flash_min_t():
            q, k, v = qkv.contiguous().unbind(0)
            out = flash_attention(q, k, v, valid=token_mask, scale=scale)
            attn = None
        else:
            q, k, v = qkv.unbind(0)
            mask = token_mask[:, None, None, :] if token_mask is not None else None
            out, attn = attention_reference(q, k, v, scale=scale, mask=mask)
            if not need_attn:
                attn = None
        out = out.transpose(1, 2).reshape(n, t, d)
        return self.proj(out), attn, qkv_out


class DinoBlock(nn.Module):
    """Pre-norm block; returns (x, attn, qkv projection, norm1 output)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = DinoAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, token_mask=None, need_attn: bool = True, tap_delta=None):
        n1 = self.norm1(x)
        if tap_delta is not None:
            n1 = n1 + tap_delta  # the explain tap, as the ViT's
        y, attn, qkv_out = self.attn(n1, token_mask=token_mask, need_attn=need_attn)
        x = x + y
        if fused_supported(x, train=self.training) and sp.sequence_axis() is None:
            z = fused_ln_dense_gelu(x, self.norm2.weight, self.norm2.bias,
                                    self.fc1.weight.t(), self.fc1.bias, eps=self.norm2.eps)
        else:
            z = self.fc1(self.norm2(x))
            z = F.gelu(z, approximate="tanh" if z.dtype == torch.bfloat16 else "none")
        return x + self.fc2(z), attn, qkv_out, n1


@dataclasses.dataclass(frozen=True)
class DinoViTConfig:
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    num_classes: int = 0


class DinoVisionTransformer(nn.Module):
    """``base_grid``: the side of the grid the stored pos table holds
    (DINO pretrains at 224, so 224 // patch)."""

    def __init__(self, cfg: DinoViTConfig, base_grid: int = 14):
        super().__init__()
        self.cfg = cfg
        self.base_grid = base_grid
        p, d = cfg.patch_size, cfg.embed_dim
        self.patch_embed = PatchConv(3, d, p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, base_grid * base_grid + 1, d))
        for i in range(cfg.depth):
            setattr(self, f"block_{i}", DinoBlock(d, cfg.num_heads, cfg.mlp_ratio))
        self.norm = LayerNorm(d)
        self.head = nn.Linear(d, cfg.num_classes) if cfg.num_classes else None

    def _interp_pos(self, gh: int, gw: int):
        """DINO's ``interpolate_pos_encoding``: the stored table resized to
        (gh, gw), bicubic with half-pixel centres, in f32, then in the
        table's dtype; the table itself at the base grid."""
        if gh == self.base_grid and gw == self.base_grid:
            return self.pos_embed
        return interpolate_pos_embedding(self.pos_embed, (gh, gw), align_corners=False)

    def forward(self, x, token_mask=None, override_pos_embedding=None,
                need_attn: bool = True, seq_pad_multiple=None, tap_delta=None):
        c = self.cfg
        p = c.patch_size
        n, h, w, _ = x.shape
        gh, gw = h // p, w // p
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(n, -1, -1), x], dim=1)
        pos = (override_pos_embedding if override_pos_embedding is not None
               else self._interp_pos(gh, gw))
        x = x + pos
        seq_len = gh * gw + 1
        if seq_pad_multiple:
            x, token_mask = pad_tokens(x, token_mask, seq_len, seq_pad_multiple)
        x, token_mask = sp.shard_tokens(x, token_mask)
        seq = sp.sequence_axis()
        attn = qkv_out = qkv_input = None
        for i in range(c.depth):
            last = i == c.depth - 1
            x, attn_i, qkv_i, n1_i = getattr(self, f"block_{i}")(
                x, token_mask=token_mask, need_attn=need_attn and last,
                tap_delta=tap_delta if last else None)
            if last:
                attn, qkv_out, qkv_input = attn_i, qkv_i, n1_i
        if seq is not None:
            x, qkv_out, qkv_input = (seq.gather(z, 1, seq_len) for z in (x, qkv_out, qkv_input))
            attn = seq.gather(attn, 2, seq_len)
            attn = None if attn is None else attn[..., :seq_len]
        if seq_pad_multiple:
            x, qkv_out, attn = unpad_tokens(x, qkv_out, attn, seq_len)
            qkv_input = qkv_input[:, :seq_len]
        x = self.norm(x)
        cls_feat = x[:, 0]
        out = self.head(cls_feat) if self.head is not None else cls_feat
        return out, {"attn": attn, "qkv": qkv_out, "tokens": x, "qkv_input": qkv_input}


def split_qkv_dino(qkv_out, num_heads: int):
    """(N, T, 3D) qkv projection -> q, k, v each (N, T, D): the true
    layout, (3, heads, head dim) along the last axis."""
    n, t, d3 = qkv_out.shape
    d = d3 // 3
    qkv = qkv_out.reshape(n, t, 3, num_heads, d // num_heads).permute(2, 0, 3, 1, 4)

    def flat(z):
        return z.permute(0, 2, 1, 3).reshape(n, t, d)

    return flat(qkv[0]), flat(qkv[1]), flat(qkv[2])


def init_dino_params(cfg: DinoViTConfig, base_grid: int, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys and layouts (conv HWIO,
    dense (in, out)) and its initializers, drawn from ``gen``."""
    p, d = cfg.patch_size, cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)

    def dense(fan_in, features):
        return {"kernel": _lecun_normal((fan_in, features), fan_in, gen),
                "bias": torch.zeros(features)}

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    params = {
        "patch_embed": {"kernel": _lecun_normal((p, p, 3, d), p * p * 3, gen),
                        "bias": torch.zeros(d)},
        "cls_token": torch.zeros(1, 1, d),
        "pos_embed": torch.randn(1, base_grid * base_grid + 1, d, generator=gen) * 0.02,
    }
    for i in range(cfg.depth):
        params[f"block_{i}"] = {"norm1": ln(),
                                "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
                                "norm2": ln(), "fc1": dense(d, hidden), "fc2": dense(hidden, d)}
    params["norm"] = ln()
    if cfg.num_classes:
        params["head"] = dense(d, cfg.num_classes)
    return params


def _build(name, cfg: DinoViTConfig):
    base = 224 // cfg.patch_size  # DINO pretrains at 224
    return ModelSpec(
        name=name, cfg=cfg,
        module=lambda: DinoVisionTransformer(cfg, base_grid=base),
        init=lambda gen: init_dino_params(cfg, base, gen),
        input_size=(224, 224),
        # the reference keeps these backbones frozen; qkv is excluded as on the ViTs
        prune_exclude=("qkv",),
        patch_size=cfg.patch_size,
        family="dino_vit",
        num_classes=cfg.num_classes,
        extra={"num_heads": cfg.num_heads, "embed_dim": cfg.embed_dim},
        rebuild=lambda c: _build(name, c),
    )


@register_model("dino_vit_tiny")
def dino_vit_tiny(patch_size=16, num_classes=0):
    return _build("dino_vit_tiny", DinoViTConfig(patch_size, 192, 12, 3, 4.0, num_classes))


@register_model("dino_vit_small")
def dino_vit_small(patch_size=16, num_classes=0):
    return _build("dino_vit_small", DinoViTConfig(patch_size, 384, 12, 6, 4.0, num_classes))


@register_model("dino_vit_base")
def dino_vit_base(patch_size=16, num_classes=0):
    return _build("dino_vit_base", DinoViTConfig(patch_size, 768, 12, 12, 4.0, num_classes))
