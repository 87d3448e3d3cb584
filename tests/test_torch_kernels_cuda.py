"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``requires_cuda``: each test skips where torch has no usable card.
This file imports neither jax nor the JAX package, so it runs on the GPU
machine, whose installation has no jax:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because tests/conftest.py configures jax.)
"""

import numpy as np
import pytest
import torch

from vipers_torch.ops import flash_attention as tfa
from vipers_torch.ops import fused_mlp as tfm

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA build of torch); the kernels "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


def _qkv(b, h, t, dtype, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, h, t, 64, generator=g).to(dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [896, 200, 64])
def test_flash_kernel_matches_plain(cuda, dtype, atol, rtol, t):
    q, k, v = _qkv(3, 2, t, dtype, cuda, seed=t)
    g = torch.Generator(device="cpu").manual_seed(1)
    valid = (torch.rand(3, t, generator=g) < 0.8).to(cuda)
    valid[:, 0] = True
    valid[2] = True
    n0 = tfa.LAUNCHES[str(dtype)[6:]]
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[str(dtype)[6:]] == n0 + 1
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=1e-4)


@pytest.mark.parametrize("m,d,f", [(128 * 64, 384, 1536), (1000, 128, 256)])
def test_fused_mlp_kernel_matches_plain(cuda, m, d, f):
    g = torch.Generator(device="cpu").manual_seed(m)
    x = torch.randn(m, d, generator=g).to(cuda, torch.bfloat16)
    w_t = (torch.randn(f, d, generator=g) / np.sqrt(d)).to(cuda, torch.bfloat16)
    b = (torch.randn(f, generator=g) * 0.1).to(cuda)
    n0 = tfm.LAUNCHES["bfloat16"]
    out = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["bfloat16"] == n0 + 1
    want = tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * scale
