"""Unmasked multi-head attention on pre-scaled bf16 q: the port of the
splash-attention A/B (``tools/bench_splash.py``).

Kernel: ``vipers_torch/csrc/splash_attention.cu``, hand-written CUDA for
``sm_90a``. It replaces the library splash kernel that the TPU tool's
``make_splash`` builds (``make_splash_mha`` over a ``FullMask`` per head,
vmapped over the batch): O = softmax(q K^T) V on (B, H, T, 64) with q
already multiplied by the scale and rounded to bf16 by the caller, f32
scores and softmax, bf16 out. The tool builds only full masks, so there are
no block-sparse masks here. Its instances run the flash kernels' Hopper tile
(``csrc/attention_tile.cuh``: TMA, mbarriers, wgmma) with ``block_q`` query
rows a CTA (64 or 128: one or two consumer warpgroups) and ``block_kv``
keys a K/V ring stage (64 or 128), with K either (T, 64) per head
(``"head_dim_minor"``) or (64, T) (``"seq_minor"``, the caller's transposed
copy, read as it lies). At the tool's shape (B*H = 32*6, T = 896) the work
is bound by its operations (39.5 GFLOP on 88 MB).

``splash_attention`` launches the kernel for CUDA tensors and runs the
plain version, ``splash_attention_plain``, for CPU tensors; a build or
launch failure raises, and so does a CUDA tensor that is not 16-byte
aligned (TMA). ``LAUNCHES`` counts kernel launches per instance.
The model path never calls it: it is the A/B tool's kernel.
"""

from __future__ import annotations

import ctypes

import torch

from vipers_torch.ops import _build
from vipers_torch.ops.flash_attention import _check_aligned

HEAD_DIM = 64
BLOCKS = (64, 128)
K_LAYOUTS = ("head_dim_minor", "seq_minor")


def instance_name(block_q: int, block_kv: int, k_layout: str) -> str:
    return f"{block_q}x{block_kv},{k_layout}"


INSTANCES = tuple((bq, bkv, lay) for lay in K_LAYOUTS for bq in BLOCKS for bkv in BLOCKS)

# kernel launches per instance; chip_smoke.py resets and reads these
LAUNCHES = {instance_name(*i): 0 for i in INSTANCES}


def _head_dim_minor_k(k, k_layout: str):
    if k_layout not in K_LAYOUTS:
        raise ValueError(f"k_layout must be one of {K_LAYOUTS}, got {k_layout!r}")
    return k.transpose(-1, -2) if k_layout == "seq_minor" else k


def splash_attention_plain(q, k, v, k_layout: str = "head_dim_minor"):
    """Plain PyTorch version of the kernel: f32 scores of the already
    scaled q, an f32 softmax, the output in q's dtype."""
    k = _head_dim_minor_k(k, k_layout)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _lib():
    fn = _build.load("splash_attention").vipers_splash_attention
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p] + [ctypes.c_int] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def splash_attention(q, k, v, block_q: int = 128, block_kv: int = 128,
                     k_layout: str = "head_dim_minor"):
    """Unmasked attention of (B, H, T, hd) q (pre-scaled) over k and v;
    ``k`` is (B, H, T, hd), or (B, H, hd, T) with ``k_layout="seq_minor"``.
    On the card: bf16, hd = 64, T a multiple of 128."""
    if q.dim() != 4 or v.shape != q.shape or _head_dim_minor_k(k, k_layout).shape != q.shape:
        raise ValueError(f"q, v must be (B, H, T, hd) and k match them in layout "
                         f"{k_layout}: {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if block_q not in BLOCKS or block_kv not in BLOCKS:
        raise ValueError(f"block_q and block_kv must be in {BLOCKS}, got {block_q}, {block_kv}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("inputs on several devices")
    if q.device.type == "cpu":
        return splash_attention_plain(q, k, v, k_layout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, t, hd = q.shape
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise ValueError(f"the splash kernel is bf16 only, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd != HEAD_DIM or t % 128:
        raise ValueError(f"the splash kernel needs head dim {HEAD_DIM} and T % 128 == 0, "
                         f"got T={t}, hd={hd}")
    fn = _lib()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, t, hd,
                block_q, block_kv, int(k_layout == "seq_minor"), stream)
    if rc != 0:
        raise RuntimeError(f"splash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES[instance_name(block_q, block_kv, k_layout)] += 1
    return out
