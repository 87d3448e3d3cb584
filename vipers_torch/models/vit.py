"""torchvision-style Vision Transformer, forward with aux outputs, for
inference and training (port of ``vipers/models/vit.py``; ``self.training``
is the JAX package's ``train``).

Input is NHWC, like the JAX package. The forward returns
``(logits, {"qkv_input", "attn", "cls"})``: the last block's ln_1 output
(the reference's qkv dump that LOST reads), its per-head softmax when
``need_attn`` and the final CLS feature.

Kernel routing follows the JAX package exactly, switches included
(``VIPERS_FLASH_MIN_T``, ``VIPERS_PACKED_ATTENTION``, ``VIPERS_FUSED_MLP``,
``VIPERS_FUSED_ATTN``, read at call time):
  * attention at T >= ``flash_min_t()`` without ``need_attn`` (and, in
    training, without attention dropout) goes to the flash kernel (``ops/flash_attention.py``), or with
    ``VIPERS_PACKED_ATTENTION=1`` and a packed layout to the token-major
    packed kernel on one projection with head-pair-permuted weight rows;
    below it, in training without attention dropout, in
    bf16 and within the kernel's envelope, to the short-T training kernel
    on the packed (3, N, H, T, hd) projection
    (``ops/attention_train.py``); otherwise the key-masked einsum,
  * training forwards pad the tokens once to a 128 multiple where a kernel
    will engage (``_auto_seq_pad``; never under attention dropout): T = 197
    -> 256 at 224x224,
  * in bf16 at inference, when the row count passes the JAX block rule,
    ln_2 -> fc1 -> GELU goes to the fused kernel (``ops/fused_mlp.py``);
    otherwise LayerNorm -> Dense -> GELU (tanh in bf16, erf in f32).

The patch embedding is a reshape and a matmul, not a convolution, so the
f32 path never takes cuDNN's TF32 convolutions. f32 matmuls follow torch's
global precision setting, which defaults to full f32 on the card.

Dropout is the JAX model's: ``dropout_rate`` after the position embedding,
after the attention block and after the MLP's GELU and fc2,
``attention_dropout_rate`` on the attention probabilities, in train mode
only, the masks drawn from the forward's ``generator``
(``models.stochastic``).

Tensor parallelism (``parallel.tp``): a rank's blocks are the slim
rectangular blocks at H/k heads and F/k MLP columns, with ``tp`` set to
(model group, j, k). The block then wraps attention and the MLP in the two
Megatron collectives (``tp.copy_to_model`` after each LayerNorm,
``tp.reduce_from_model`` before the out and fc2 biases, which are added
once after the reduce), and the dropout on the probabilities and after the
GELU keeps the rank's slice of the full tensor's draw. The kernels stay on
inside the rank.

Sequence parallelism (``parallel.sp``): while ``sp.sequence_axis()`` is
set, the forward holds the rank's share of the tokens; each block's
attention gathers k and v from every rank, and the last block's ln_1
output, its attention and the final tokens are gathered whole. As in the
JAX package, the flash and fused-MLP kernels and the automatic token pad
are off under it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.ops.attention_train import (attention_train_enabled,
                                              attention_train_packed,
                                              fused_attention_supported)
from vipers_torch.ops.flash_attention import (attention_probs,
                                              attention_reference,
                                              flash_attention,
                                              flash_attention_packed,
                                              flash_min_t,
                                              packed_layout_supported,
                                              packed_qkv_permutation)
from vipers_torch.models.stochastic import dropout
from vipers_torch.parallel import sp, tp as tensor_parallel
from vipers_torch.ops.fused_mlp import fused_ln_dense_gelu, fused_supported
from vipers_torch.ops.tokens import pad_tokens, round_up, unpad_tokens


def layer_norm(x, scale, bias, eps: float):
    """flax ``nn.LayerNorm``: statistics in f32 even for bf16 input,
    var = max(E[x^2] - mean^2, 0), output in the input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (x32 - mu) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def patch_matmul(x, conv: nn.Conv2d, p: int):
    """A stride-``p`` patch conv on NHWC ``x`` as reshape + matmul: (N,
    gh*gw, D) tokens in raster order, the patch flattened (kh, kw, c) like
    the flax HWIO kernel."""
    n, h, w, c = x.shape
    gh, gw = h // p, w // p
    patches = (x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
               .reshape(n, gh * gw, p * p * c))
    wmat = conv.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
    return torch.matmul(patches, wmat) + conv.bias


class PatchConv(nn.Conv2d):
    """The patch embedding's stride-``p`` convolution on NHWC input, as
    ``patch_matmul``. Called as a module, so the quantize hooks
    (``train.quantize``) meet it where the JAX package's interceptors meet
    its ``nn.Conv``."""

    def __init__(self, channels: int, dim: int, p: int):
        super().__init__(channels, dim, p, stride=p)

    def forward(self, x):
        return patch_matmul(x, self, self.kernel_size[0])


@functools.lru_cache(maxsize=None)
def _packed_rows(d: int, num_heads: int, device: torch.device):
    """The packed stripe permutation as an index tensor on ``device``."""
    return torch.from_numpy(packed_qkv_permutation(d, num_heads)).to(device)


class MultiHeadAttention(nn.Module):
    """Self-attention with torch ``nn.MultiheadAttention`` semantics: fused
    qkv projection (q, k, v row blocks), per-head softmax returned when
    ``need_attn``; ``dropout_rate`` drops attention probabilities in
    training. ``head_dim`` (None: ``dim // num_heads``) is a structurally
    slimmed model's: whole heads are gone, so ``inner = num_heads *
    head_dim`` < dim and the projections are rectangular, (3*inner, dim)
    and (dim, inner); the packed route then stays off, as in JAX."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 head_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim or dim // num_heads
        self.dropout_rate = dropout_rate
        inner = num_heads * self.head_dim
        self.qkv = nn.Linear(dim, 3 * inner)
        self.out = nn.Linear(inner, dim)
        self.tp = None  # (model group, j, k) on a tensor-parallel rank

    def forward(self, x, token_mask=None, need_attn: bool = True, generator=None):
        n, t, d = x.shape
        h, hd = self.num_heads, self.head_dim
        inner = h * hd
        scale = float(hd) ** -0.5
        drop = self.training and self.dropout_rate > 0  # the kernels keep no probs
        seq = sp.sequence_axis()
        if seq is not None:
            return self._sequence_parallel(x, token_mask, need_attn, seq, scale)
        use_flash = not need_attn and not drop and t >= flash_min_t()
        if (use_flash and inner == d and packed_layout_supported(d, h)
                and os.environ.get("VIPERS_PACKED_ATTENTION") == "1"):
            # one projection with head-pair-permuted weight rows feeds the
            # token-major kernel, which writes (N, T, D) h-major
            rows = _packed_rows(d, h, x.device)
            qkv_p = F.linear(x, self.qkv.weight[rows], self.qkv.bias[rows])
            y = flash_attention_packed(qkv_p, valid=token_mask, num_heads=h, scale=scale)
            return tensor_parallel.row_linear(y, self.out, self.tp), None
        qkv = self.qkv(x).reshape(n, t, 3, h, hd).permute(2, 0, 3, 1, 4)
        if (self.training and not need_attn and not use_flash
                and self.dropout_rate == 0 and fused_attention_supported(t, hd)
                and attention_train_enabled(x.dtype)):
            out = attention_train_packed(qkv, valid=token_mask, scale=scale)
            attn = None
        elif use_flash:
            q, k, v = qkv.contiguous().unbind(0)
            out = flash_attention(q, k, v, valid=token_mask, scale=scale)
            attn = None
        else:
            q, k, v = qkv.unbind(0)
            mask = token_mask[:, None, None, :] if token_mask is not None else None
            if drop:
                attn = attention_probs(q, k, scale=scale, mask=mask)
                out = torch.matmul(dropout(attn, self.dropout_rate, True, generator,
                                           shard=tensor_parallel.shard_of(self.tp, 1)), v)
            else:
                out, attn = attention_reference(q, k, v, scale=scale, mask=mask)
            if not need_attn:
                attn = None
        out = tensor_parallel.row_linear(out.transpose(1, 2).reshape(n, t, inner), self.out,
                                         self.tp)
        return out, attn

    def _sequence_parallel(self, x, token_mask, need_attn, seq, scale):
        """This rank's queries against every rank's keys (``sp.gather_tokens``
        of k and v), the key mask the whole padded sequence's; returns
        (out, the rank's attention rows or None)."""
        n, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).reshape(n, t, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
        k, v = sp.gather_tokens(k, seq, dim=2), sp.gather_tokens(v, seq, dim=2)
        mask = token_mask[:, None, None, :] if token_mask is not None else None
        out, attn = attention_reference(q, k, v, scale=scale, mask=mask)
        return self.out(out.transpose(1, 2).reshape(n, t, h * hd)), attn if need_attn else None


class MLPBlock(nn.Module):
    """Linear -> GELU -> dropout -> Linear -> dropout. GELU is exact erf in
    f32 (reference bit parity) and tanh in bf16, as in the JAX package."""

    def __init__(self, dim: int, mlp_dim: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.tp = None  # (model group, j, k) on a tensor-parallel rank

    def forward(self, x, prefused: bool = False, generator=None):
        if prefused:
            y = x  # already gelu(fc1(ln_2(x))) from the fused kernel
        else:
            y = self.fc1(x)
            y = F.gelu(y, approximate="tanh" if y.dtype == torch.bfloat16 else "none")
        y = dropout(y, self.dropout_rate, self.training, generator,
                    shard=tensor_parallel.shard_of(self.tp, 2))
        return dropout(tensor_parallel.row_linear(y, self.fc2, self.tp), self.dropout_rate,
                       self.training, generator)


class EncoderBlock(nn.Module):
    """Pre-norm transformer block; returns (x, ln_1 output, attn)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 attention_dropout_rate: float = 0.0, head_dim: Optional[int] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln_1 = LayerNorm(dim)
        self.attention = MultiHeadAttention(dim, num_heads, attention_dropout_rate, head_dim)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, dropout_rate)

    def forward(self, x, token_mask=None, need_attn: bool = True, tap_delta=None,
                generator=None):
        tp = self.attention.tp
        ln1 = self.ln_1(x)
        if tap_delta is not None:
            ln1 = ln1 + tap_delta  # the explain tap: GradCAM's ViT target layer
        y, attn = self.attention(tensor_parallel.copy_to_model(ln1, tp), token_mask=token_mask,
                                 need_attn=need_attn, generator=generator)
        x = x + dropout(y, self.dropout_rate, self.training, generator)
        if fused_supported(x, train=self.training) and sp.sequence_axis() is None:
            # inference only (no cotangent for the copy to sum)
            z = fused_ln_dense_gelu(
                x, self.ln_2.weight, self.ln_2.bias,
                self.mlp.fc1.weight.t(), self.mlp.fc1.bias, eps=self.ln_2.eps)
            z = self.mlp(z, prefused=True, generator=generator)
        else:
            z = self.mlp(tensor_parallel.copy_to_model(self.ln_2(x), tp), generator=generator)
        return x + z, ln1, attn


def _auto_seq_pad(seq_len: int, dtype, train: bool, need_attn: bool, cfg):
    """128-multiple token padding, once at the embedding, for training
    forwards where an attention kernel will engage (both kernels pad to a
    128 multiple inside, so padding once is compute-identical). Inference
    stays unpadded. A pad that would push T across ``flash_min_t()`` is not
    made: the gate then decides on the true length. Under attention dropout
    no kernel engages, so nothing is padded."""
    if (not train or need_attn or seq_len % 128 == 0 or cfg.attention_dropout_rate > 0
            or sp.sequence_axis() is not None):
        return None
    pad_t = round_up(seq_len, 128)
    min_t = flash_min_t()
    if seq_len < min_t <= pad_t:
        return None
    if seq_len >= min_t:
        return 128
    hd = cfg.head_dim or cfg.hidden_dim // cfg.num_heads
    if fused_attention_supported(seq_len, hd) and attention_train_enabled(dtype):
        return 128
    return None


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The JAX package's ``ViTConfig``. ``representation_size``: a
    ``pre_logits`` Dense and tanh before the head; ``head_dim``: the
    per-head width, None for ``hidden_dim // num_heads`` (a structurally
    slimmed model keeps its heads' width while ``num_heads`` shrinks)."""

    patch_size: int = 16
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_dim: int = 3072
    num_classes: int = 1000
    dropout_rate: float = 0.0
    attention_dropout_rate: float = 0.0
    representation_size: Optional[int] = None
    head_dim: Optional[int] = None


class VisionTransformer(nn.Module):
    """ViT with rectangular-input support and aux outputs. ``image_size``
    fixes the stored pos-embedding; other resolutions pass an interpolated
    one as ``override_pos_embedding``."""

    def __init__(self, cfg: ViTConfig, image_size: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.cfg = cfg
        self.image_size = tuple(image_size)
        p, d = cfg.patch_size, cfg.hidden_dim
        self.conv_proj = PatchConv(3, d, p)
        self.class_token = nn.Parameter(torch.zeros(1, 1, d))
        seq = (image_size[0] // p) * (image_size[1] // p) + 1
        self.pos_embedding = nn.Parameter(torch.zeros(1, seq, d))
        self.layers = nn.ModuleList(
            EncoderBlock(d, cfg.num_heads, cfg.mlp_dim, cfg.dropout_rate,
                         cfg.attention_dropout_rate, cfg.head_dim)
            for _ in range(cfg.num_layers))
        self.ln = LayerNorm(d)
        rep = cfg.representation_size
        self.pre_logits = nn.Linear(d, rep) if rep is not None else None
        self.head = nn.Linear(rep or d, cfg.num_classes) if cfg.num_classes else None

    def patch_embed(self, x):
        return self.conv_proj(x)

    def random_rates(self):
        """The dropout rates: after embeddings, attention and MLP layers, and
        on the attention probabilities."""
        return (self.cfg.dropout_rate, self.cfg.attention_dropout_rate)

    def forward(self, x, override_pos_embedding=None, token_mask=None,
                need_attn: bool = True, seq_pad_multiple: Optional[int] = None,
                tap_delta=None, generator: Optional[torch.Generator] = None):
        """``seq_pad_multiple``: pad the token axis once (zeros, masked
        invalid) to this multiple before the encoder and slice once after,
        so the flash kernel sees an aligned length. In training it defaults
        to ``_auto_seq_pad``'s choice. ``tap_delta``: the explain tap, (N, T,
        D) added to the last block's ln_1 output, which ``aux["qkv_input"]``
        returns with it. ``generator``: the dropout masks in train mode."""
        x, token_mask, seq_len, seq_pad_multiple = self.embed(
            x, override_pos_embedding, token_mask, need_attn, seq_pad_multiple, generator)
        x, token_mask = sp.shard_tokens(x, token_mask)
        seq = sp.sequence_axis()
        qkv_input = attn = None
        last = len(self.layers) - 1
        for i, block in enumerate(self.layers):
            x, ln1, attn_i = block(x, token_mask=token_mask,
                                   need_attn=need_attn and i == last,
                                   tap_delta=tap_delta if i == last else None,
                                   generator=generator)
            if i == last:
                qkv_input, attn = ln1, attn_i
        if seq is not None:
            # the LOST core and the head read whole sequences
            x, qkv_input = seq.gather(x, 1, seq_len), seq.gather(qkv_input, 1, seq_len)
            attn = seq.gather(attn, 2, seq_len)
            attn = None if attn is None else attn[..., :seq_len]
        if seq_pad_multiple:
            x, qkv_input, attn = unpad_tokens(x, qkv_input, attn, seq_len)
        logits, cls_feat = self.head_logits(x)
        return logits, {"qkv_input": qkv_input, "attn": attn, "cls": cls_feat}

    def embed(self, x, override_pos_embedding=None, token_mask=None, need_attn: bool = True,
              seq_pad_multiple: Optional[int] = None,
              generator: Optional[torch.Generator] = None):
        """The patch embedding, CLS token, position embedding (and its
        dropout) and the once-pad of the tokens: (tokens, token mask, true
        token count, the pad multiple or None)."""
        c = self.cfg
        p = c.patch_size
        n, h, w, _ = x.shape
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        seq_len = (h // p) * (w // p) + 1
        if seq_pad_multiple is None:
            seq_pad_multiple = _auto_seq_pad(seq_len, x.dtype, self.training,
                                             need_attn, c)
        x = self.patch_embed(x)
        x = torch.cat([self.class_token.expand(n, -1, -1), x], dim=1)
        pos = (override_pos_embedding if override_pos_embedding is not None
               else self.pos_embedding)
        if pos.shape[1] != seq_len:
            raise ValueError(
                f"pos embedding has {pos.shape[1]} tokens but input needs "
                f"{seq_len}; pass an interpolated override_pos_embedding")
        x = dropout(x + pos, c.dropout_rate, self.training, generator)
        if seq_pad_multiple:
            x, token_mask = pad_tokens(x, token_mask, seq_len, seq_pad_multiple)
        return x, token_mask, seq_len, seq_pad_multiple

    def head_logits(self, x):
        """The final LayerNorm, (pre-logits and) the head on the CLS token of
        the encoder's output: (logits, the CLS feature)."""
        x = self.ln(x)
        cls_feat = x[:, 0]
        y = cls_feat
        if self.pre_logits is not None:
            y = torch.tanh(self.pre_logits(y))
        return (self.head(y) if self.head is not None else y), cls_feat


def split_qkv_torchvision(qkv_dump, num_heads: int):
    """The reference's reshape of the (3N, T, D) stacked dump to
    (N, T, 3, nh, hd) without a permutation first (a scramble of the three
    identical copies), then (3, N, nh, T, hd) and back to (N, T, D) each."""
    three_n, t, d = qkv_dump.shape
    n = three_n // 3
    qkv = qkv_dump.reshape(n, t, 3, num_heads, -1).permute(2, 0, 3, 1, 4)

    def flat(z):
        return z.transpose(1, 2).reshape(n, t, d)

    return flat(qkv[0]), flat(qkv[1]), flat(qkv[2])


def scrambled_qkv_gather(x_compact, t1, which: str = "k"):
    """Batched closed form of ``split_qkv_torchvision(stacked dump)[which]``:
    the row gather ``out[t] = x[(3*t + c) % t1]``, c = 0/1/2 for q/k/v.

    x_compact: (B, T, D) ln_1 tokens whose rows [0, t1) are the tier-1
    (CLS + valid) tokens in raster order. t1: int or (B,) integer tensor.
    Rows >= t1 of the result are garbage and must be masked downstream."""
    c_sel = {"q": 0, "k": 1, "v": 2}[which]
    b, t, d = x_compact.shape
    ar = torch.arange(t, device=x_compact.device)
    if isinstance(t1, torch.Tensor):
        src = (3 * ar[None, :] + c_sel) % t1.to(ar.device)[:, None]
    else:
        src = ((3 * ar + c_sel) % t1)[None, :].expand(b, t)
    return torch.gather(x_compact, 1, src[:, :, None].expand(b, t, d))


def _lecun_normal(shape, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                 generator=gen)


def init_vit_params(cfg: ViTConfig, image_size, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys and layouts (conv HWIO,
    dense (in, out)) and its initializers, drawn from ``gen``."""
    p, d = cfg.patch_size, cfg.hidden_dim
    inner = cfg.num_heads * (cfg.head_dim or d // cfg.num_heads)
    seq = (image_size[0] // p) * (image_size[1] // p) + 1

    def dense(fan_in, features):
        return {"kernel": _lecun_normal((fan_in, features), fan_in, gen),
                "bias": torch.zeros(features)}

    def ln():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    params = {
        "conv_proj": {"kernel": _lecun_normal((p, p, 3, d), p * p * 3, gen),
                      "bias": torch.zeros(d)},
        "class_token": torch.zeros(1, 1, d),
        "pos_embedding": torch.randn(1, seq, d, generator=gen) * 0.02,
    }
    for i in range(cfg.num_layers):
        params[f"encoder_layer_{i}"] = {
            "ln_1": ln(),
            "attention": {"qkv": dense(d, 3 * inner), "out": dense(inner, d)},
            "ln_2": ln(),
            "mlp": {"fc1": dense(d, cfg.mlp_dim), "fc2": dense(cfg.mlp_dim, d)},
        }
    params["ln"] = ln()
    rep = cfg.representation_size
    if rep is not None:
        params["pre_logits"] = dense(d, rep)
    if cfg.num_classes:
        params["head"] = dense(rep or d, cfg.num_classes)
    return params


def _build(name, cfg: ViTConfig, image_size=(224, 224)):
    image_size = tuple(image_size)
    return ModelSpec(
        name=name,
        cfg=cfg,
        module=lambda: VisionTransformer(cfg, image_size),
        init=lambda gen: init_vit_params(cfg, image_size, gen),
        input_size=image_size,
        prune_exclude=("qkv",),
        # the JAX ViT applies qkv and attention/out by einsum: no int8 site
        quantize_exclude=("qkv", "attention/out"),
        patch_size=cfg.patch_size,
        family="vit",
        num_classes=cfg.num_classes,
        rebuild=lambda c: _build(name, c, image_size),
    )


# The JAX registry's ViTs (``vipers/models/vit.py:557-584``); ``kw`` are
# ViTConfig's optional fields (dropout rates, representation_size).
@register_model("vit_s_16")
def vit_s_16(num_classes=1000, image_size=(224, 224), **kw):
    """ViT-Small/16, the LOST throughput flagship."""
    return _build("vit_s_16", ViTConfig(16, 12, 6, 384, 1536, num_classes, **kw), image_size)


@register_model("vit_b_16")
def vit_b_16(num_classes=1000, image_size=(224, 224), **kw):
    """ViT-Base/16, the paper's pruned ViT."""
    return _build("vit_b_16", ViTConfig(16, 12, 12, 768, 3072, num_classes, **kw), image_size)


@register_model("vit_b_32")
def vit_b_32(num_classes=1000, image_size=(224, 224), **kw):
    return _build("vit_b_32", ViTConfig(32, 12, 12, 768, 3072, num_classes, **kw), image_size)


@register_model("vit_l_16")
def vit_l_16(num_classes=1000, image_size=(224, 224), **kw):
    return _build("vit_l_16", ViTConfig(16, 24, 16, 1024, 4096, num_classes, **kw), image_size)


@register_model("vit_l_32")
def vit_l_32(num_classes=1000, image_size=(224, 224), **kw):
    return _build("vit_l_32", ViTConfig(32, 24, 16, 1024, 4096, num_classes, **kw), image_size)


@register_model("vit_h_14")
def vit_h_14(num_classes=1000, image_size=(224, 224), **kw):
    """ViT-Huge/14: 16 heads of 80 (the flash forward's hd-80 instance)."""
    return _build("vit_h_14", ViTConfig(14, 32, 16, 1280, 5120, num_classes, **kw), image_size)
