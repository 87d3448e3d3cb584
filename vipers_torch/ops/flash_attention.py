"""Masked blockwise attention forward (port of ``vipers/ops/flash_attention.py``).

Kernel: ``vipers_torch/csrc/flash_attention_fwd.cu``, hand-written CUDA for
``sm_90a``. It replaces the TPU's ``_fwd_kernel`` (``_flash_fwd``) and the
library Pallas kernel behind ``flash_attention_official``, which the TPU
build ran at T >= 512. K/V stream past a block of queries with an f32
online softmax; pad keys get -1e9 on the f32 scores. Both instances are
Hopper's: TMA loads of query and K/V tiles into a ring of shared-memory
stages, mbarriers, a producer warp, ``wgmma`` for both products
(``csrc/attention_tile.cuh``; each instance's shape in ``tile_shape``).
The f32 instance runs every product as three TF32 products on the tensor
cores (3xTF32: x = big + small, small.big + big.small + big.big), within
1e-5 / 1e-4 of the exact-f32 plain version. TMA needs 16-byte-aligned base
pointers, so the wrappers raise on a CUDA tensor that is not. At the
ViT-S/16 LOST shape both instances are bound by their operations (158
GFLOP, three times over in f32, against 352 MB of bf16 I/O). Each instance
is compiled for head dim 64 and for 80 (vit_h_14's 16 heads of 80): the
tile splits an 80-column row into its first 64 columns and a 16-column
tail, each its own TMA box and wgmma operand, so the products do the 80
columns' work and nothing is padded.

The kernels are ``torch.library`` custom ops, so ``torch.export`` traces
them as graph nodes and an exported program calls them again when it runs
(importing ``vipers_torch.ops`` registers them):
``vipers_torch::flash_attention_fwd`` (q, k, v, valid or None, scale) ->
(out, lse), ``vipers_torch::flash_attention_bwd`` and
``vipers_torch::flash_attention_packed``. Each op's CPU implementation is
the plain version, its CUDA implementation the ctypes launch, and its fake
implementation gives the output shapes; the wrappers check the inputs and
the card's gates (head dims) before they call the op.
``flash_attention_fwd`` launches the kernel for CUDA tensors and runs the
plain version, ``flash_attention_plain``, for CPU tensors; a build or
launch failure raises. ``LAUNCHES`` counts kernel launches per instance:
``"float32"`` and ``"bfloat16"`` at head dim 64, ``"float32[hd80]"`` and
``"bfloat16[hd80]"`` at 80.
``flash_attention`` is differentiable: the op's backward,
``flash_attention_bwd``, launches ``vipers_torch/csrc/flash_attention_bwd.cu``
for CUDA tensors. On the TPU the product path's backward is the library's
two Pallas kernels, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``, which that file replaces with the same split:
a row pass computes D and lse in log2 units into a small workspace, then a
dk/dv and a dq kernel on TMA + wgmma, bf16 products for bf16 and, for f32,
every product as three TF32 products on the tensor cores (3xTF32, within
1e-4 of each gradient's scale of exact f32; each instance's design in
``bwd_design``). Each block owns its outputs, so dq is deterministic with
no atomics and no scratch. Its plain version, ``flash_attention_bwd_plain``,
is the JAX package's ``_flash_vjp_bwd``, the ``use_official=False`` VJP,
and runs for CPU tensors. ``BWD_LAUNCHES`` counts backward calls that
launched the kernels, per instance (``"float32[hd80]"`` and
``"bfloat16[hd80]"`` at head dim 80). The backward, like the forward, is
compiled for head dim 64 and 80 (the tile splits a row as the forward's
does); the packed kernel for 64 only (128 % 80 != 0: no packed layout for
vit_h_14 in either package). At any other head dim they raise before
launching anything.

The packed token-major route (``flash_attention_packed``, opt-in with
``VIPERS_PACKED_ATTENTION=1`` in the models, as in the JAX package) reads q,
k and v straight from the (B, T, 3D) output of one projection whose columns
are permuted into head-pair stripes (``packed_qkv_permutation``) and writes
(B, T, D) h-major. Kernel: ``vipers_torch/csrc/flash_attention_packed.cu``,
replacing the TPU's ``_packed_fwd_kernel`` (``_packed_fwd``); it runs the
same tile as the head-major kernel, the head's stripe a TMA coordinate.
``PACKED_LAUNCHES`` counts its launches per instance.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vipers_torch.ops import _build
from vipers_torch.ops.tokens import round_up

NEG_INF = -1e9
FLASH_MIN_T = 512
HEAD_DIM = 64  # the packed kernel's head dim
FWD_HEAD_DIMS = (64, 80)  # the head-major forward's and the backward's instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per instance; chip_smoke.py resets and reads these
LAUNCHES = {"float32": 0, "bfloat16": 0, "float32[hd80]": 0, "bfloat16[hd80]": 0}
PACKED_LAUNCHES = {"float32": 0, "bfloat16": 0}
# backward calls on the card per instance: one count a call, which launches
# the row pass, then the dk/dv and the dq kernel
BWD_LAUNCHES = {"float32": 0, "bfloat16": 0, "float32[hd80]": 0, "bfloat16[hd80]": 0}


def flash_min_t() -> int:
    """T at and above which the models route attention to the kernel (the
    JAX package's threshold; ``VIPERS_FLASH_MIN_T`` overrides it, as there).
    Read at call time by the models and the LOST driver's seq-pad decision,
    so the three stay consistent."""
    return int(os.environ.get("VIPERS_FLASH_MIN_T", FLASH_MIN_T))


def attention_probs(q, k, scale: Optional[float] = None, mask=None):
    """The einsum path's attention probabilities: q*scale in the input
    dtype, f32 logits, -1e9 where ``mask`` is False, softmax in f32, cast
    back to the input dtype."""
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = torch.where(mask, logits, torch.full((), NEG_INF, device=logits.device))
    return torch.softmax(logits, dim=-1).to(q.dtype)


def attention_reference(q, k, v, scale: Optional[float] = None, mask=None):
    """Einsum attention returning (out, probs), the JAX parity path
    (``attention_probs``)."""
    probs = attention_probs(q, k, scale, mask)
    return torch.matmul(probs, v), probs


def _scores(q, k, valid, scale: float):
    """f32 scores (q * scale) . k^T with -1e9 on the keys ``valid`` (a (B,
    T) bool mask, or None) marks invalid."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    return s


def flash_attention_plain(q, k, v, valid=None, scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: (out, lse) with the kernel's
    arithmetic (q in f32 times scale, f32 scores, -1e9 key mask, p =
    exp(s - m), l_safe = max(sum p, 1e-20), out = p.v / l_safe in the input
    dtype, lse = m + log(l_safe) in f32). A row whose keys are all invalid
    is the uniform average of v, as in the JAX kernel (lse rounds to -1e9
    there, so exp(s - lse) would sum v instead)."""
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else scale
    s = _scores(q, k, valid, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    out = torch.matmul(p, v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _check(q, k, v, valid):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (q.shape[0], q.shape[2])):
        raise ValueError(f"valid must be a (B, T) bool mask, got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    devs = {z.device for z in (q, k, v) + ((valid,) if valid is not None else ())}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_kernel_head_dim(hd: int):
    """The packed kernel takes head dim 64 only on the card (no packed
    layout has 80); the plain version (CPU tensors) takes any."""
    if hd != HEAD_DIM:
        raise ValueError(f"the packed attention kernel needs head dim {HEAD_DIM}, got {hd}")


def _check_head_dim(hd: int, kernel: str = "flash attention"):
    """The head-major forward's and the backward's instances: head dim 64
    and 80 (``FWD_HEAD_DIMS``, the name older checkouts' A/B tools read)."""
    if hd not in FWD_HEAD_DIMS:
        raise ValueError(f"the {kernel} kernel needs head dim 64 or 80, got {hd}")


def launch_key(dtype: torch.dtype, hd: int) -> str:
    """The ``LAUNCHES`` (and ``BWD_LAUNCHES``) key of the instance of
    ``dtype`` and head dim ``hd``."""
    name = str(dtype).replace("torch.", "")
    return name if hd == HEAD_DIM else f"{name}[hd{hd}]"


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


def tile_shape(dtype: torch.dtype = torch.bfloat16, head_dim: int = HEAD_DIM) -> dict:
    """The forward tile of the ``dtype`` instance at ``head_dim`` as
    compiled into the flash and packed kernels (``attn_tile::hopper``):
    query rows, keys a K/V tile (bf16) or stage (f32) and K/V ring stages;
    for f32 also the stages of split K/V copies and the TF32 products an
    f32 product takes. Builds the flash library if needed."""
    _check_head_dim(head_dim)
    fn = _build.load("flash_attention_fwd").vipers_flash_attention_tile
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    vals = (ctypes.c_int * 5)()
    fn(_DTYPE_CODE[dtype], head_dim, vals)
    keys = ("block_q", "block_k", "stages")
    if dtype == torch.float32:
        keys += ("split_stages", "tf32_products")
    return dict(zip(keys, vals))


def _check_aligned(*tensors):
    """TMA reads from 16-byte-aligned base pointers only: raise rather than
    copy a CUDA tensor that is not (a view at an odd offset)."""
    for z in tensors:
        if z is not None and z.data_ptr() % 16:
            raise ValueError(f"CUDA tensors must be 16-byte aligned, got data_ptr "
                             f"{z.data_ptr():#x} (a view at an offset?)")


def flash_attention_fwd(q, k, v, valid=None, scale: Optional[float] = None):
    """(B, H, T, hd) masked attention -> (out in the input dtype, lse f32
    (B, H, T)). ``valid``: (B, T) bool key mask (True = attend). Query rows
    that are pad attend the valid keys, like the JAX einsum path. The card's
    kernel takes hd 64 and 80; the plain version (CPU tensors) takes any.
    The checks run here, then the custom op ``vipers_torch::flash_attention_fwd``,
    differentiable in q, k and v through ``flash_attention_bwd``."""
    _check(q, k, v, valid)
    hd = q.shape[-1]
    scale = (hd ** -0.5) if scale is None else float(scale)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        _check_head_dim(hd)
    return torch.ops.vipers_torch.flash_attention_fwd.default(q, k, v, valid, scale)


@torch.library.custom_op("vipers_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor], scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 1 as an operator: the plain version on the CPU."""
    return flash_attention_plain(q, k, v, valid, scale)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, valid, scale):
    """Row 1 on the card: one launch of ``flash_attention_fwd.cu``."""
    b, h, t, hd = q.shape
    fn = _lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(q, k, v)
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
    LAUNCHES[launch_key(q.dtype, hd)] += 1
    return out, lse


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, valid, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, valid, scale = inputs
    ctx.save_for_backward(q, k, v, valid, *output)
    ctx.scale = scale


def _flash_fwd_backward(ctx, g, _g_lse):
    """out's cotangent through the backward kernels; lse is not
    differentiated (only the backward reads it)."""
    q, k, v, valid, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, valid, out, lse, g.to(q.dtype), ctx.scale)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def _vjp_from_p(p, q, k, v, out, g, scale: float):
    """The attention VJP given the f32 probabilities p: dv, dp, ``delta =
    sum(g * out)``, ds = p (dp - delta), dq and dk times ``scale``; f32."""
    g32 = g.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    delta = (g32 * out.float()).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, valid, out, lse, g, scale: float):
    """Plain PyTorch version of the backward kernel: the JAX package's
    recomputation VJP (``_flash_vjp_bwd``), p from the f32 scores and the
    saved lse, then ``_vjp_from_p``; gradients in the inputs' dtypes."""
    p = torch.exp(_scores(q, k, valid, scale) - lse[..., None])
    dq, dk, dv = _vjp_from_p(p, q, k, v, out, g, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, valid, out, lse, g):
    _check(q, k, v, valid)
    for name, z in (("out", out), ("g", g)):
        if z.shape != q.shape or z.dtype != q.dtype or z.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device: {tuple(z.shape)} "
                             f"{z.dtype} on {z.device}, q {tuple(q.shape)} {q.dtype}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != tuple(q.shape[:3])
            or lse.device != q.device):
        raise ValueError(f"lse must be a float32 (B, H, T) = {tuple(q.shape[:3])} tensor on "
                         f"q's device, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _bwd_lib():
    fn = _build.load("flash_attention_bwd").vipers_flash_attention_bwd
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2 + [p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def bwd_design(dtype: torch.dtype = torch.bfloat16, head_dim: int = HEAD_DIM) -> dict:
    """The backward's design for ``dtype`` at ``head_dim`` as compiled: the
    dk/dv kernel's keys a tile, queries a stage and ring stages, the dq
    kernel's queries a tile, keys a stage and ring stages, the workspace's
    row padding, the number of main kernels and the TF32 products an f32
    product takes (0 for bf16). Builds the backward library if needed."""
    _check_head_dim(head_dim, "flash attention backward")
    fn = _build.load("flash_attention_bwd").vipers_flash_attention_bwd_design
    keys = ("dkv_keys", "dkv_queries", "dkv_stages", "dq_queries", "dq_keys", "dq_stages",
            "row_pad", "kernels", "tf32_products")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    vals = (ctypes.c_int * len(keys))()
    fn(_DTYPE_CODE[dtype], head_dim, vals)
    return dict(zip(keys, vals))


def flash_attention_bwd(q, k, v, valid, out, lse, g, scale: float):
    """(dq, dk, dv) in the input dtype for (B, H, T, hd) q, k, v, the (B, T)
    bool key mask (or None), the forward's ``out`` and f32 ``lse`` and the
    cotangent ``g``, through the custom op ``vipers_torch::flash_attention_bwd``.
    CUDA tensors go to the kernel (hd 64 or 80, any T; a build or launch
    failure raises, and another hd raises before any launch), CPU tensors
    to ``flash_attention_bwd_plain`` (any hd)."""
    _check_bwd(q, k, v, valid, out, lse, g)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda":
        _check_head_dim(q.shape[-1], "flash attention backward")
    return torch.ops.vipers_torch.flash_attention_bwd.default(q, k, v, valid, out, lse, g,
                                                      float(scale))


@torch.library.custom_op("vipers_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: Optional[torch.Tensor], out: torch.Tensor, lse: torch.Tensor,
                  g: torch.Tensor, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows 12-13 as an operator: the plain version on the CPU."""
    return flash_attention_bwd_plain(q, k, v, valid, out, lse, g, scale)


@_flash_bwd_op.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, valid, out, lse, g, scale):
    """Rows 12-13 on the card: the row pass, the dk/dv and the dq kernel of
    ``flash_attention_bwd.cu``, one count a call."""
    b, h, t, hd = q.shape
    fn = _bwd_lib()
    q, k, v, out, g = (z.contiguous() for z in (q, k, v, out, g))
    lse = lse.contiguous()
    _check_aligned(q, k, v, out, g)
    vmask = valid.contiguous().view(torch.uint8) if valid is not None else None
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # lse in log2 units and D of every query row, rows padded
    rows = torch.empty((2, b * h, round_up(t, bwd_design(q.dtype)["row_pad"])),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                g.data_ptr(), vmask.data_ptr() if vmask is not None else None,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                rows.data_ptr(),
                b * h, h, t, hd, scale, _DTYPE_CODE[q.dtype], q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES[launch_key(q.dtype, hd)] += 1
    return dq, dk, dv


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, valid, out, lse, g, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention(q, k, v, valid=None, scale: Optional[float] = None):
    """(B, H, T, hd) attention without materializing (T, T) (hd 64 or 80 on
    the card); returns out, differentiable in q, k and v through the
    backward kernels."""
    return flash_attention_fwd(q, k, v, valid, scale)[0]


# ------------------------- packed token-major route ------------------------

def packed_qkv_permutation(d: int, num_heads: int) -> np.ndarray:
    """Index permutation taking a fused qkv projection laid out [q(D) | k(D)
    | v(D)] to the packed stripe layout [q h0 h1 | k h0 h1 | v h0 h1] per
    head pair (``128 // hd`` heads a stripe). int64 (3D,); the permuted
    torch weight is ``W[perm]`` (rows of the (out, in) layout)."""
    if not packed_layout_supported(d, num_heads):
        raise ValueError(f"no packed layout for D={d} with {num_heads} heads")
    hd = d // num_heads
    pack = 128 // hd
    cols = []
    for p in range(num_heads // pack):
        for s in range(3):  # q, k, v
            for h in range(p * pack, (p + 1) * pack):
                base = s * d + h * hd
                cols.extend(range(base, base + hd))
    return np.asarray(cols, np.int64)


def packed_layout_supported(d: int, num_heads: int) -> bool:
    hd = d // num_heads
    return hd <= 128 and 128 % hd == 0 and num_heads % (128 // hd) == 0


def _unpack_bhtd(qkv, num_heads: int):
    """(B, T, 3D) packed stripes -> (q, k, v) each (B, H, T, hd)."""
    b, t, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    pack = 128 // hd
    z = qkv.reshape(b, t, num_heads // pack, 3, pack, hd)
    z = z.permute(3, 0, 2, 4, 1, 5).reshape(3, b, num_heads, t, hd)
    return z[0], z[1], z[2]


def _pack_bhtd(dq, dk, dv, num_heads: int):
    """Inverse of ``_unpack_bhtd``: three (B, H, T, hd) -> (B, T, 3D)."""
    b, h, t, hd = dq.shape
    pack = 128 // hd
    z = torch.stack([dq, dk, dv]).reshape(3, b, h // pack, pack, t, hd)
    return z.permute(1, 4, 2, 0, 3, 5).reshape(b, t, 3 * h * hd)


def _ntd_to_bhtd(x, num_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _bhtd_to_ntd(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def flash_attention_packed_plain(qkv, valid, num_heads: int, scale: float):
    """Plain PyTorch version of the packed kernel, with the TPU kernel's
    arithmetic: f32 scores times ``scale``, -1e9 on invalid keys, exact
    softmax with p rounded to the input dtype before P.V, the output divided
    by l = max(sum p, 1e-20). (B, T, 3D) -> (B, T, D) h-major."""
    q, k, v = _unpack_bhtd(qkv, num_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return _bhtd_to_ntd(o.to(qkv.dtype))


def _check_packed(qkv, valid, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3 * heads * hd), got {tuple(qkv.shape)} "
                         f"with {num_heads} heads")
    d = qkv.shape[2] // 3
    if not packed_layout_supported(d, num_heads):
        raise ValueError(f"no packed layout for D={d} with {num_heads} heads")
    if qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"packed attention takes float32 or bfloat16, got {qkv.dtype}")
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != tuple(qkv.shape[:2])
                              or valid.device != qkv.device):
        raise ValueError(f"valid must be a (B, T) bool mask on the device of qkv, got "
                         f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")


def _packed_lib():
    fn = _build.load("flash_attention_packed").vipers_flash_attention_packed
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_packed_fwd(qkv, valid, num_heads: int, scale: float):
    """(B, T, 3D) packed qkv and a (B, T) bool key mask (or None) -> (B, T,
    D) h-major attention output in qkv's dtype, through the custom op
    ``vipers_torch::flash_attention_packed`` (differentiable in qkv). The
    kernel needs head dim 64; the plain version (CPU tensors) takes any
    packed layout."""
    _check_packed(qkv, valid, num_heads)
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.device.type == "cuda":
        _check_kernel_head_dim(qkv.shape[2] // 3 // num_heads)
    return torch.ops.vipers_torch.flash_attention_packed.default(qkv, valid, num_heads,
                                                         float(scale))


@torch.library.custom_op("vipers_torch::flash_attention_packed", mutates_args=(),
                         device_types="cpu")
def _packed_op(qkv: torch.Tensor, valid: Optional[torch.Tensor], num_heads: int,
               scale: float) -> torch.Tensor:
    """Row 3 as an operator: the plain version on the CPU."""
    return flash_attention_packed_plain(qkv, valid, num_heads, scale)


@_packed_op.register_kernel("cuda")
def _packed_cuda(qkv, valid, num_heads, scale):
    """Row 3 on the card: one launch of ``flash_attention_packed.cu``."""
    b, t, three_d = qkv.shape
    d = three_d // 3
    fn = _packed_lib()
    qkv = qkv.contiguous()
    _check_aligned(qkv)
    vmask = valid.contiguous().view(torch.uint8) if valid is not None else None
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = fn(qkv.data_ptr(), vmask.data_ptr() if vmask is not None else None,
                out.data_ptr(), b, num_heads, t, d // num_heads, scale,
                _DTYPE_CODE[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_packed kernel launch failed: CUDA error {rc}")
    PACKED_LAUNCHES[str(qkv.dtype).replace("torch.", "")] += 1
    return out


@_packed_op.register_fake
def _packed_fake(qkv, valid, num_heads, scale):
    b, t, three_d = qkv.shape
    return qkv.new_empty((b, t, three_d // 3))


def flash_attention_packed_bwd(qkv, valid, out, g, num_heads: int, scale: float):
    """The JAX package's einsum-recompute VJP (``_packed_vjp_bwd``) on the
    unpacked views: p normalized explicitly (exp of the scores less their
    row max, over its row sum), so an image whose keys are all invalid gets
    p = 1/T as in JAX (a logsumexp of -1e9 scores rounds to -1e9 and would
    give p = 1); then ``_vjp_from_p``, repacked into one (B, T, 3D)
    gradient in qkv's dtype. Plain XLA on the TPU too."""
    q, k, v = _unpack_bhtd(qkv, num_heads)
    s = _scores(q, k, valid, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    grads = _vjp_from_p(p, q, k, v, _ntd_to_bhtd(out, num_heads), _ntd_to_bhtd(g, num_heads),
                        scale)
    return _pack_bhtd(*grads, num_heads).to(qkv.dtype)


def _packed_setup(ctx, inputs, output):
    qkv, valid, num_heads, scale = inputs
    ctx.save_for_backward(qkv, valid, output)
    ctx.num_heads, ctx.scale = num_heads, scale


def _packed_backward(ctx, g):
    qkv, valid, out = ctx.saved_tensors
    return (flash_attention_packed_bwd(qkv, valid, out, g, ctx.num_heads, ctx.scale),
            None, None, None)


_packed_op.register_autograd(_packed_backward, setup_context=_packed_setup)


def flash_attention_packed(qkv, valid=None, *, num_heads: int,
                           scale: Optional[float] = None):
    """Token-major attention on a packed (B, T, 3D) qkv (columns permuted by
    ``packed_qkv_permutation``), differentiable in qkv. Returns (B, T, D)
    with the heads h-major, ready for a plain out-projection. T is padded to
    a 128 multiple inside (pad keys masked) and sliced back, as in the JAX
    wrapper."""
    b, t, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    scale = (hd ** -0.5) if scale is None else float(scale)
    if valid is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=qkv.device)
    pad = round_up(t, 128) - t
    if pad:
        qkv = F.pad(qkv, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    return flash_attention_packed_fwd(qkv, valid, num_heads, scale)[:, :t]
