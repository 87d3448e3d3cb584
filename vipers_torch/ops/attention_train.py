"""Short-T training attention with a one-pass backward (port of
``vipers/ops/attention_train.py``).

Kernel: ``vipers_torch/csrc/attention_train.cu``, hand-written CUDA for
``sm_90a`` on Hopper's TMA, mbarriers and ``wgmma`` (the building blocks in
``csrc/hopper.cuh``). Its forward replaces the TPU's ``_fwd`` and
``_fwd_packed``, its backward ``_bwd`` and ``_bwd_packed``: both take q, k,
v (and write dq, dk, dv) through three base pointers over (B, H, T, 64), so
the packed entry hands them the three slabs of one (3, B, H, T, 64) buffer
and gets one packed dqkv back, and the unpacked entry hands them three
tensors. The forward keeps the exact softmax in one pass where T <= 256
(two passes over 256-key chunks beyond); the backward is one CTA per (b, h)
at a time with dK/dV in registers and dQ from a staged dS, summed in an
f32 scratch only where T > 256. TMA needs 16-byte-aligned base pointers, so
the wrappers raise on a CUDA tensor that is not. At the ViT-S/16 train
shape (B*H = 768, T = 256, bf16) both are bound by bytes (12.9 GFLOP on
~101 MB forward, 32.2 GFLOP on ~202 MB backward).

``attention_train_fwd`` / ``attention_train_bwd`` launch the kernels for
CUDA tensors (bf16 and head dim 64 only; anything else raises) and run the
plain versions, ``attention_train_fwd_plain`` / ``attention_train_bwd_plain``,
for CPU tensors. ``LAUNCHES`` counts kernel launches per variant;
``design()`` reads back the compiled block shapes.

``variant=`` selects the softmax precision of the TPU's A/B tool
``tools/bench_softmax_prec.py`` (forward ``f32`` / ``bf16exp`` / ``normP``,
backward ``f32`` / ``bf16exp``), template instances of the same kernels;
the model path runs ``f32`` and never passes it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
import torch.nn.functional as F

from vipers_torch.ops import _build
from vipers_torch.ops.flash_attention import NEG_INF, _check_aligned
from vipers_torch.ops.tokens import round_up

MAX_T = 1024
HEAD_DIM = 64
CHUNK = 256  # keys the kernels hold at once; beyond, dQ sums in an f32 scratch
FWD_VARIANTS = ("f32", "bf16exp", "normP")
BWD_VARIANTS = ("f32", "bf16exp")

# kernel launches per variant ("fwd", "bwd": the f32 variant the model
# runs); chip_smoke.py resets and reads these
LAUNCHES = {"fwd": 0, "bwd": 0, "fwd[bf16exp]": 0, "fwd[normP]": 0,
            "bwd[bf16exp]": 0}


def _launch_key(kind: str, variant: str) -> str:
    return kind if variant == "f32" else f"{kind}[{variant}]"


def _check_variant(variant: str, allowed):
    if variant not in allowed:
        raise ValueError(f"variant must be one of {allowed}, got {variant!r}")


def fused_attention_supported(t: int, hd: int) -> bool:
    """T padded to a 128 multiple must stay within ``MAX_T`` and hd must be
    a multiple of 8: the JAX package's envelope, kept so both packages route
    the same calls."""
    return round_up(t, 128) <= MAX_T and hd % 8 == 0


def attention_train_enabled(dtype) -> bool:
    """Product-path gate: bf16 compute only, on any device (the f32 path
    keeps the einsum, the parity anchor); ``VIPERS_FUSED_ATTN=0`` turns it
    off, as in the JAX package."""
    if os.environ.get("VIPERS_FUSED_ATTN") == "0":
        return False
    return dtype == torch.bfloat16


def _check_envelope(name: str, t: int, hd: int):
    if not fused_attention_supported(t, hd):
        raise ValueError(
            f"{name}: T={t} (pads to {round_up(t, 128)}) / hd={hd} outside the "
            f"kernel's envelope (MAX_T={MAX_T}, hd%8==0); use "
            "ops.flash_attention for long sequences")


def attention_train_fwd_plain(q, k, v, ok, scale: float, variant: str = "f32"):
    """Plain PyTorch version of the forward kernel: (B, H, T, hd) q, k, v,
    (B, T) bool key mask -> (out in the input dtype, lse (B, H, T) f32).
    ``variant`` follows ``tools/bench_softmax_prec.py``'s ``fwd_kernel``."""
    _check_variant(variant, FWD_VARIANTS)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    s = torch.where(ok[:, None, None, :], s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    if variant == "bf16exp":
        pb = torch.exp((s - m).to(torch.bfloat16))
        l = pb.float().sum(dim=-1, keepdim=True)
    else:
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pb = p.to(v.dtype)
    if variant == "normP":
        o = torch.matmul((p / l).to(v.dtype).float(), v.float())
        return o.to(q.dtype), (m + torch.log(l))[..., 0]
    o = torch.matmul(pb.float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def attention_train_bwd_plain(q, k, v, o, lse, do, ok, scale: float,
                              variant: str = "f32"):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    input dtype from the forward's residuals and the cotangent ``do``.
    ``variant`` follows ``tools/bench_softmax_prec.py``'s ``bwd_kernel``:
    ``bf16exp`` keeps p = exp(bf16(s - lse)) in bf16 for dV and dS."""
    _check_variant(variant, BWD_VARIANTS)
    dt = q.dtype
    qs = (q * torch.tensor(scale, dtype=dt)).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    s = torch.where(ok[:, None, None, :], s, torch.full((), NEG_INF, device=s.device))
    if variant == "bf16exp":
        p = torch.exp((s - lse[..., None]).to(torch.bfloat16)).float()
    else:
        p = torch.exp(s - lse[..., None])
    do32 = do.float()
    d = (do32 * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do32).to(dt)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = ((dp - d) * p).to(dt).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), qs).to(dt)
    return dq, dk, dv


def _fn(name, nptr):
    fn = getattr(_build.load("attention_train"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * nptr + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [p]
        fn.restype = ctypes.c_int
    return fn


def design() -> dict:
    """The compiled kernels' shapes: the forward's query rows a tile, keys a
    chunk (the backward's keys a round) and K/V stages; the backward's
    query rows a block and ring stages. Builds the library if needed."""
    fn = _build.load("attention_train").vipers_attention_train_design
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 5
        fn.restype = None
    vals = [ctypes.c_int() for _ in range(5)]
    fn(*map(ctypes.byref, vals))
    return dict(zip(("fwd_block_q", "chunk", "fwd_stages", "bwd_block_q", "bwd_stages"),
                    (v.value for v in vals)))


def _check_cuda(q, ok):
    b, h, t, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the attention_train kernel is bf16 only, got {q.dtype}")
    if hd != HEAD_DIM or t % 64 or t > MAX_T:
        raise ValueError(f"the attention_train kernel needs head dim {HEAD_DIM} "
                         f"and T % 64 == 0, T <= {MAX_T}; got T={t}, hd={hd} (other head "
                         f"dims: ROADMAP B1)")
    if ok.device != q.device:
        raise ValueError("inputs on several devices")


def _launch(name, fn, args, q):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def attention_train_fwd(q, k, v, ok, scale: float, variant: str = "f32"):
    """(out, lse) for (B, H, T, hd) q, k, v and a (B, T) bool key mask."""
    _check_variant(variant, FWD_VARIANTS)
    if q.device.type == "cpu":
        return attention_train_fwd_plain(q, k, v, ok, scale, variant)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, ok)
    b, h, t, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(q, k, v)
    okb = ok.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch("attention_train_fwd", _fn("vipers_attention_train_fwd", 6),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), okb.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b * h, h, t, hd, float(scale),
             FWD_VARIANTS.index(variant), q.device.index), q)
    LAUNCHES[_launch_key("fwd", variant)] += 1
    return out, lse


def attention_train_bwd(q, k, v, o, lse, do, ok, scale: float, out=None,
                        variant: str = "f32"):
    """(dq, dk, dv) for the forward's residuals and cotangent ``do``. On the
    card the kernel writes into ``out`` (three contiguous (B, H, T, hd)
    tensors, e.g. the slabs of one packed dqkv) when given."""
    _check_variant(variant, BWD_VARIANTS)
    if q.device.type == "cpu":
        grads = attention_train_bwd_plain(q, k, v, o, lse, do, ok, scale, variant)
        if out is not None:
            for dst, src in zip(out, grads):
                dst.copy_(src)
            return tuple(out)
        return grads
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, ok)
    b, h, t, hd = q.shape
    ins = [z.contiguous() for z in (q, k, v, o, do)]
    lse = lse.contiguous()
    okb = ok.contiguous().view(torch.uint8)
    if out is None:
        out = tuple(torch.empty_like(ins[0]) for _ in range(3))
    if any(not z.is_contiguous() or z.shape != q.shape or z.dtype != q.dtype for z in out):
        raise ValueError("out must be three contiguous tensors shaped like q")
    _check_aligned(*ins, lse, *out)
    scratch = (torch.empty((b, h, t, hd), dtype=torch.float32, device=q.device)
               if t > CHUNK else None)
    qc, kc, vc, oc, doc = ins
    _launch("attention_train_bwd", _fn("vipers_attention_train_bwd", 11),
            (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(),
             lse.data_ptr(), doc.data_ptr(), okb.data_ptr(), out[0].data_ptr(),
             out[1].data_ptr(), out[2].data_ptr(),
             scratch.data_ptr() if scratch is not None else None,
             b * h, h, t, hd, float(scale), BWD_VARIANTS.index(variant), q.device.index), q)
    LAUNCHES[_launch_key("bwd", variant)] += 1
    return tuple(out)


class _AttentionTrain(torch.autograd.Function):
    """Separate q, k, v (the TPU's ``_attn`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, ok, scale):
        o, lse = attention_train_fwd(q, k, v, ok, scale)
        ctx.save_for_backward(q, k, v, o, lse, ok)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, ok = ctx.saved_tensors
        dq, dk, dv = attention_train_bwd(q, k, v, o, lse, g.to(q.dtype), ok, ctx.scale)
        return dq, dk, dv, None, None


class _AttentionTrainPacked(torch.autograd.Function):
    """One (3, B, H, T, hd) q|k|v buffer in, one packed dqkv out (the TPU's
    ``_attn_packed`` custom VJP)."""

    @staticmethod
    def forward(ctx, qkv, ok, scale):
        q, k, v = qkv.unbind(0)
        o, lse = attention_train_fwd(q, k, v, ok, scale)
        ctx.save_for_backward(qkv, o, lse, ok)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, o, lse, ok = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        q, k, v = qkv.unbind(0)
        attention_train_bwd(q, k, v, o, lse, g.to(qkv.dtype), ok, ctx.scale,
                            out=dqkv.unbind(0))
        return dqkv, None, None


def _pad_t(z, pad: int, dim: int):
    if not pad:
        return z
    widths = [0, 0] * (z.dim() - 1 - dim) + [0, pad]
    return F.pad(z, widths)


def _prepare(b, t, valid, device):
    pad_t = round_up(t, 128)
    if valid is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=device)
    return pad_t - t, _pad_t(valid.to(torch.bool), pad_t - t, 1)


def attention_train(q, k, v, valid: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """(B, H, T, hd) attention for short T, differentiable through the
    one-pass backward. ``valid``: (B, T) bool key mask. T is padded to a
    128 multiple inside; pad-query rows must get zero cotangents (true when
    the caller slices them away, as here)."""
    b, h, t, hd = q.shape
    _check_envelope("attention_train", t, hd)
    scale = float(hd) ** -0.5 if scale is None else float(scale)
    pad, ok = _prepare(b, t, valid, q.device)
    q, k, v = (_pad_t(z, pad, 2) for z in (q, k, v))
    return _AttentionTrain.apply(q, k, v, ok, scale)[:, :, :t]


def attention_train_packed(qkv, valid: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None):
    """``attention_train`` over a packed (3, B, H, T, hd) q|k|v tensor, the
    layout the ViT qkv projection yields; the gradient comes back as one
    packed dqkv."""
    s3, b, h, t, hd = qkv.shape
    if s3 != 3:
        raise ValueError(f"attention_train_packed: leading dim {s3} != 3")
    _check_envelope("attention_train_packed", t, hd)
    scale = float(hd) ** -0.5 if scale is None else float(scale)
    pad, ok = _prepare(b, t, valid, qkv.device)
    qkv = _pad_t(qkv, pad, 3).contiguous()
    return _AttentionTrainPacked.apply(qkv, ok, scale)[:, :, :t]
