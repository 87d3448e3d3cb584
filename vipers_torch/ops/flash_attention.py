"""Masked blockwise attention forward (port of ``vipers/ops/flash_attention.py``).

Kernel: ``vipers_torch/csrc/flash_attention_fwd.cu``, hand-written CUDA for
``sm_90a``. It replaces the TPU's ``_fwd_kernel`` (``_flash_fwd``) and the
library Pallas kernel behind ``flash_attention_official``, which the TPU
build ran at T >= 512. One block per (batch*head, 64-query tile) streams
64-key K/V tiles through shared memory with an f32 online softmax; pad keys
get -1e9 on the f32 scores. The f32 instance runs on plain FMA (no TF32);
the bf16 instance on ``mma.sync`` with f32 accumulation. At the ViT-S/16
LOST shape the bf16 instance is bound by its operations (158 GFLOP against
352 MB of I/O).

``flash_attention_fwd`` launches the kernel for CUDA tensors and runs the
plain version, ``flash_attention_plain``, for CPU tensors; a build or
launch failure raises. ``LAUNCHES`` counts kernel launches per instance.
``flash_attention`` is a ``torch.autograd.Function`` whose backward is the
JAX package's recomputation VJP in plain torch (it is plain XLA there too).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vipers_torch.ops import _build

NEG_INF = -1e9
FLASH_MIN_T = 512
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per instance; chip_smoke.py resets and reads these
LAUNCHES = {"float32": 0, "bfloat16": 0}


def flash_min_t() -> int:
    """T at and above which the models route attention to the kernel (the
    JAX package's threshold). Read at call time by the models and the LOST
    driver's seq-pad decision, so the three stay consistent."""
    return FLASH_MIN_T


def attention_reference(q, k, v, scale: Optional[float] = None, mask=None):
    """Einsum attention returning (out, probs), the JAX parity path: q*scale
    in the input dtype, f32 logits, -1e9 where ``mask`` is False, softmax in
    f32, probabilities cast back to the input dtype."""
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v), probs


def flash_attention_plain(q, k, v, valid=None, scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: (out, lse) with the kernel's
    arithmetic (q in f32 times scale, f32 scores, -1e9 key mask, f32
    softmax, out in the input dtype, f32 logsumexp)."""
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _check(q, k, v, valid):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash attention needs head dim {HEAD_DIM}, got {q.shape[-1]}")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (q.shape[0], q.shape[2])):
        raise ValueError(f"valid must be a (B, T) bool mask, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    devs = {z.device for z in (q, k, v) + ((valid,) if valid is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _lib():
    lib = _build.load("flash_attention_fwd")
    fn = lib.vipers_flash_attention_fwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, valid=None, scale: Optional[float] = None):
    """(B, H, T, 64) masked attention -> (out in the input dtype, lse f32
    (B, H, T)). ``valid``: (B, T) bool key mask (True = attend). Query rows
    that are pad attend the valid keys, like the JAX einsum path."""
    _check(q, k, v, valid)
    b, h, t, hd = q.shape
    scale = (hd ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    fn = _lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    vmask = valid.contiguous().view(torch.uint8) if valid is not None else None
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                vmask.data_ptr() if vmask is not None else None,
                out.data_ptr(), lse.data_ptr(), b * h, h, t, hd, scale,
                _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {rc}")
    LAUNCHES[str(q.dtype).replace("torch.", "")] += 1
    return out, lse


def flash_attention_bwd(q, k, v, valid, out, lse, g, scale: float):
    """The JAX package's recomputation VJP (``_flash_vjp_bwd``): f32 scores
    from the saved lse, ``delta = sum(g * out)``, dq and dk times
    ``scale``; gradients in the inputs' dtypes. Plain XLA on the TPU too."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.exp(s - lse[..., None])
    g32 = g.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    delta = (g32 * out.float()).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (plain version on the CPU), backward by
    the JAX package's recomputation VJP."""

    @staticmethod
    def forward(ctx, q, k, v, valid, scale):
        out, lse = flash_attention_fwd(q, k, v, valid, scale)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, valid, out, lse, g, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, valid=None, scale: Optional[float] = None):
    """(B, H, T, 64) attention without materializing (T, T) in the forward;
    returns out, differentiable in q, k and v."""
    scale = (q.shape[-1] ** -0.5) if scale is None else float(scale)
    return _FlashAttention.apply(q, k, v, valid, scale)
