"""Fused LayerNorm -> fc1 -> tanh-GELU forward, bf16 (port of
``vipers/ops/fused_mlp.py``).

Kernel: ``vipers_torch/csrc/fused_mlp.cu``, hand-written CUDA for
``sm_90a``; it replaces the TPU's ``_kernel`` (``_fused_fwd_impl``). A
persistent CTA per SM takes row tiles of x by TMA into shared memory,
normalizes them there in f32 (no affine) to bf16 xhat, and multiplies
xhat by 128-column tiles of W_eff streamed by TMA on wgmma with f32
accumulation; an epilogue warpgroup adds b_eff, applies tanh-GELU in f32
and stores bf16 while the next tile multiplies. At the ViT-S/16 LOST shape
its operation and byte bounds nearly coincide (135 GFLOP, 441 MB).

The LayerNorm affine is folded into the weights in f32 outside the kernel,
``W_eff = gamma * W`` and ``b_eff = beta @ W + b``, as the JAX wrapper does.
``fused_ln_dense_gelu_core`` launches the kernel for CUDA tensors and runs
``fused_ln_dense_gelu_plain`` for CPU tensors; a build or launch failure
raises, and so does a CUDA tensor that is not 16-byte aligned (TMA). The
kernel is the ``torch.library`` custom op ``vipers_torch::fused_ln_dense_gelu``
(CPU implementation the plain version, CUDA the ctypes launch, a fake
implementation for ``torch.export``), so an exported program calls it again
when it runs.
``LAUNCHES`` counts kernel launches, ``WIDTH_LAUNCHES`` the same launches by
width D; ``design(d)`` reads back the compiled instance that width ``d``
runs (the ViT family's: D = 384, 768, 1024 and 1280). The op's backward
(``fused_ln_dense_gelu``'s) is the JAX package's recompute VJP in plain
torch; the gradients reach ln_2 and fc1 through the fold.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
from typing import Optional

import torch

from vipers_torch.ops import _build
from vipers_torch.ops.flash_attention import _check_aligned

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)

# kernel launches, and the same by width D; chip_smoke.py resets and reads these
LAUNCHES = {"bfloat16": 0}
WIDTH_LAUNCHES = {384: 0, 768: 0, 1024: 0, 1280: 0}


def gelu_tanh_f32(y):
    inner = _SQRT_2_OVER_PI * (y + 0.044715 * (y * y * y))
    return 0.5 * y * (1.0 + torch.tanh(inner))


def pick_block_m(m: int) -> Optional[int]:
    """The JAX kernel's row-block rule; the gate below keeps it so both
    packages fuse exactly the same calls."""
    for bm in (512, 256, 128):
        if m % bm == 0:
            return bm
    return None


# open scopes of the quantize hooks (``train.quantize``): the JAX gate stays
# off while flax interceptors are active, so that fc1 stays a Dense call
_INTERCEPTORS = [0]


@contextlib.contextmanager
def interceptors():
    """The scope of a forward whose Dense and Conv calls are watched."""
    _INTERCEPTORS[0] += 1
    try:
        yield
    finally:
        _INTERCEPTORS[0] -= 1


def interceptors_active() -> bool:
    return _INTERCEPTORS[0] > 0


def fused_supported(x, train: bool = False) -> bool:
    """The product-path gate: inference, bf16, and a row count the JAX
    kernel's block rule accepts; off while quantize hooks are active
    (``interceptors``), as the JAX gate is under flax interceptors, and
    with ``VIPERS_FUSED_MLP=0``, as in the JAX package. Like the JAX gate
    it sets no width condition: the card's kernel takes any F and refuses
    a D it has no instance for (see ``fused_ln_dense_gelu_core``)."""
    if os.environ.get("VIPERS_FUSED_MLP") == "0" or interceptors_active():
        return False
    rows = x.numel() // x.shape[-1]
    return (not train and x.dtype == torch.bfloat16
            and pick_block_m(rows) is not None)


def fused_ln_dense_gelu_plain(x2d, w_eff_t, b_eff, eps: float):
    """Plain PyTorch version of the kernel: (M, D) x, (F, D) W_eff^T,
    (F,) f32 b_eff -> (M, F) in x's dtype, with the kernel's arithmetic."""
    x = x2d.float()
    mu = x.mean(dim=1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
    xhat = ((x - mu) * torch.rsqrt(var + eps)).to(w_eff_t.dtype)
    y = torch.matmul(xhat.float(), w_eff_t.float().t()) + b_eff.float()
    return gelu_tanh_f32(y).to(x2d.dtype)


def _lib():
    fn = _build.load("fused_mlp").vipers_fused_ln_dense_gelu
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def design(d: int) -> dict:
    """The compiled instance that width ``d`` runs on the card: rows a CTA
    owns, output columns a tile, W_eff ring stages (64 k each), and whether
    an epilogue warpgroup takes the staged tiles (rows 0: no instance
    fits)."""
    fn = _build.load("fused_mlp").vipers_fused_mlp_design
    keys = ("rows", "block_n", "stages", "staged")
    vals = [ctypes.c_int() for _ in keys]
    fn(ctypes.c_int(d), *(ctypes.byref(v) for v in vals))
    return dict(zip(keys, (v.value for v in vals)))


def fused_ln_dense_gelu_core(x2d, w_eff_t, b_eff, eps: float = 1e-6):
    """gelu_tanh(LN_noaffine(x2d) @ W_eff + b_eff): x2d (M, D) bf16,
    w_eff_t (F, D) bf16, b_eff (F,) f32, through the custom op
    ``vipers_torch::fused_ln_dense_gelu`` (differentiable by the recompute
    VJP). CPU tensors take any width; on the card any F (a slimmed MLP's),
    D % 64 == 0 and an instance of ``fused_mlp.cu`` that fits D
    (``design(d)``), else a ``ValueError``."""
    d = x2d.shape[1]
    f = w_eff_t.shape[0]
    if x2d.dtype != torch.bfloat16 or w_eff_t.dtype != torch.bfloat16:
        raise ValueError(f"the fused MLP kernel is bf16 only, got "
                         f"{x2d.dtype}, {w_eff_t.dtype}")
    if tuple(w_eff_t.shape) != (f, d) or tuple(b_eff.shape) != (f,) \
            or b_eff.dtype != torch.float32:
        raise ValueError("w_eff_t must be (F, D) and b_eff (F,) float32")
    if len({x2d.device, w_eff_t.device, b_eff.device}) != 1:
        raise ValueError("inputs on several devices")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2d.device}")
    if x2d.device.type == "cuda" and (d % 64 or design(d)["rows"] == 0):
        raise ValueError(f"the fused MLP kernel needs D % 64 == 0 and an instance that "
                         f"fits D, got D={d}")
    return torch.ops.vipers_torch.fused_ln_dense_gelu.default(x2d, w_eff_t, b_eff, float(eps))


@torch.library.custom_op("vipers_torch::fused_ln_dense_gelu", mutates_args=(),
                         device_types="cpu")
def _fused_op(x2d: torch.Tensor, w_eff_t: torch.Tensor, b_eff: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Row 4 as an operator: the plain version on the CPU."""
    return fused_ln_dense_gelu_plain(x2d, w_eff_t, b_eff, eps)


@_fused_op.register_kernel("cuda")
def _fused_cuda(x2d, w_eff_t, b_eff, eps):
    """Row 4 on the card: one launch of ``fused_mlp.cu``."""
    m, d = x2d.shape
    f = w_eff_t.shape[0]
    fn = _lib()
    x2d, w_eff_t, b_eff = x2d.contiguous(), w_eff_t.contiguous(), b_eff.contiguous()
    _check_aligned(x2d, w_eff_t, b_eff)
    out = torch.empty((m, f), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), w_eff_t.data_ptr(), b_eff.data_ptr(),
                out.data_ptr(), m, d, f, eps, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_dense_gelu kernel launch failed: CUDA error {rc}")
    LAUNCHES["bfloat16"] += 1
    WIDTH_LAUNCHES[d] = WIDTH_LAUNCHES.get(d, 0) + 1
    return out


@_fused_op.register_fake
def _fused_fake(x2d, w_eff_t, b_eff, eps):
    return x2d.new_empty((x2d.shape[0], w_eff_t.shape[0]))


def fold_ln_affine(ln_scale, ln_bias, kernel, bias, dtype):
    """(W_eff^T (F, D) in ``dtype``, b_eff (F,) f32) from LayerNorm
    (scale, bias) and a Dense ``kernel`` (D, F) + ``bias``, folded in f32."""
    k32 = kernel.float()
    w_eff = (ln_scale.float()[:, None] * k32).to(dtype)
    b_eff = torch.matmul(ln_bias.float(), k32) + bias.float()
    return w_eff.t().contiguous(), b_eff


def fused_ln_dense_gelu_bwd(x2d, w_eff_t, b_eff, eps: float, dy):
    """The JAX package's recompute VJP (``fused_mlp.py`` ``_make_bwd``):
    xhat again, the tanh-GELU derivative, dW_eff^T, db, and dx through the
    LayerNorm statistics. Returns (dx, dW_eff^T, db) in the inputs' dtypes."""
    x = x2d.float()
    mu = x.mean(dim=1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=1, keepdim=True) - mu * mu, min=0.0)
    r = torch.rsqrt(var + eps)
    xhat = (x - mu) * r
    xh = xhat.to(w_eff_t.dtype).float()
    y = torch.matmul(xh, w_eff_t.float().t()) + b_eff.float()
    t = torch.tanh(_SQRT_2_OVER_PI * (y + 0.044715 * y * y * y))
    inner_p = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * y * y)
    dgelu = 0.5 * (1.0 + t) + 0.5 * y * (1.0 - t * t) * inner_p
    g = dy.float() * dgelu
    gb = g.to(w_eff_t.dtype).float()
    dw_t = torch.matmul(gb.t(), xh)
    db = g.sum(dim=0)
    dxhat = torch.matmul(gb, w_eff_t.float())
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = r * (dxhat - m1 - xhat * m2)
    return dx.to(x2d.dtype), dw_t.to(w_eff_t.dtype), db.to(b_eff.dtype)


def _fused_setup(ctx, inputs, output):
    x2d, w_eff_t, b_eff, eps = inputs
    ctx.save_for_backward(x2d, w_eff_t, b_eff)
    ctx.eps = eps


def _fused_backward(ctx, dy):
    x2d, w_eff_t, b_eff = ctx.saved_tensors
    return (*fused_ln_dense_gelu_bwd(x2d, w_eff_t, b_eff, ctx.eps, dy), None)


_fused_op.register_autograd(_fused_backward, setup_context=_fused_setup)


def fused_ln_dense_gelu(x, ln_scale, ln_bias, kernel, bias, *, eps=1e-6):
    """``gelu_tanh(LayerNorm(x; scale, bias) @ kernel + bias)`` in one
    kernel pass over rows; ``x`` is (..., D) bf16, ``kernel`` (D, F) as in
    the JAX package. Returns (..., F)."""
    d = x.shape[-1]
    w_eff_t, b_eff = fold_ln_affine(ln_scale, ln_bias, kernel, bias, x.dtype)
    out = fused_ln_dense_gelu_core(x.reshape(-1, d), w_eff_t, b_eff, eps)
    return out.reshape(*x.shape[:-1], w_eff_t.shape[0])
