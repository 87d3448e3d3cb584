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


def _qkv(b, h, t, dtype, dev, seed, hd=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, h, t, hd, generator=g).to(dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [896, 769, 577, 200, 129, 64, 33, 1])
def test_flash_kernel_matches_plain(cuda, dtype, atol, rtol, t):
    """Both instances against the plain version with a ragged key mask and
    one image (1) whose keys are all invalid: its rows are the average of v
    over the t keys and its lse is -1e9 + log(t). The t cover partial key
    stages (f32: 32 keys; bf16: 128) and query tiles (f32: 128 rows; bf16:
    192), one tile and several, and t = 1."""
    q, k, v = _qkv(3, 2, t, dtype, cuda, seed=t)
    g = torch.Generator(device="cpu").manual_seed(1)
    valid = (torch.rand(3, t, generator=g) < 0.8).to(cuda)
    valid[:, 0] = True
    valid[1] = False
    valid[2] = True
    n0 = tfa.LAUNCHES[str(dtype)[6:]]
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[str(dtype)[6:]] == n0 + 1
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=1e-4)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(2, t, 64)
    torch.testing.assert_close(out[1].float(), mean_v, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[1], torch.full_like(lse[1], -1e9 + np.log(t)),
                               atol=0, rtol=1e-6)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1024, 1009, 769, 200, 129, 64, 33, 1])
def test_flash_hd80_kernel_matches_plain(cuda, dtype, atol, rtol, t):
    """The hd-80 instances (vit_h_14's heads: each row a 64-column part and
    a 16-column tail) against the plain version at B*H = 3*4 with a ragged
    key mask and one image (1) whose keys are all invalid: its rows are the
    average of v over the t keys and its lse is -1e9 + log(t). T = 1024
    with 1009 valid keys is vit_h_14's LOST bucket; the others cover
    partial key stages and query tiles and t = 1."""
    q, k, v = _qkv(3, 4, t, dtype, cuda, seed=80 + t, hd=80)
    g = torch.Generator(device="cpu").manual_seed(4)
    valid = (torch.rand(3, t, generator=g) < 0.8).to(cuda)
    valid[:, 0] = True
    valid[1] = False
    valid[2] = True
    valid[2, 1009:] = False
    key = "float32[hd80]" if dtype == torch.float32 else "bfloat16[hd80]"
    n0 = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**n0, key: n0[key] + 1}
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=1e-4)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(4, t, 80)
    torch.testing.assert_close(out[1].float(), mean_v, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse[1], torch.full_like(lse[1], -1e9 + np.log(t)),
                               atol=0, rtol=1e-6)


def test_flash_hd80_is_deterministic_and_many_tiles_a_cta(cuda):
    """Both hd-80 instances where each CTA walks several (head, query tile)
    pairs (B*H = 64*16 at t = 257, vit_h_14's 224x224 length): two calls
    bit-equal, within tolerance of the plain version."""
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-4), (torch.bfloat16, 2e-2, 2e-2)):
        q, k, v = _qkv(64, 16, 257, dtype, cuda, seed=81, hd=80)
        valid = torch.ones(64, 257, dtype=torch.bool, device=cuda)
        valid[1::2, 200:] = False
        first = tfa.flash_attention_fwd(q, k, v, valid)
        second = tfa.flash_attention_fwd(q, k, v, valid)
        want, _ = tfa.flash_attention_plain(q, k, v, valid)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, second))
        torch.testing.assert_close(first[0].float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("t", [896, 769, 200, 64, 1])
def test_flash_bf16_tile_matches_plain(cuda, t):
    """The bf16 Hopper tile against the plain version at B*H = 3*5, a ragged
    key mask, and one image whose keys are all invalid: its rows are the
    uniform average of v over the t keys and lse is -1e9 + log(t), as in the
    JAX kernel."""
    q, k, v = _qkv(3, 5, t, torch.bfloat16, cuda, seed=t)
    g = torch.Generator(device="cpu").manual_seed(2)
    valid = (torch.rand(3, t, generator=g) < 0.8).to(cuda)
    valid[0, 0] = True
    valid[1] = False
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(5, t, 64)
    n0 = tfa.LAUNCHES["bfloat16"]
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["bfloat16"] == n0 + 1
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=2e-2, rtol=1e-4)
    torch.testing.assert_close(out[1].float(), mean_v, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse[1], torch.full_like(lse[1], -1e9 + np.log(t)),
                               atol=0, rtol=1e-6)


@pytest.mark.parametrize("heads", [6, 12])
@pytest.mark.parametrize("t", [896, 577])
def test_packed_bf16_tile_matches_plain(cuda, t, heads):
    """The bf16 Hopper tile on the packed layout against the plain version
    (T = 577 padded to 640 as the wrapper does)."""
    tp = -(-t // 128) * 128
    qkv, _, valid = _packed_inputs(3, tp, heads, torch.bfloat16, cuda, seed=t + heads)
    valid[:, t:] = False
    want = tfa.flash_attention_packed_plain(qkv, valid, heads, 0.125)
    n0 = tfa.PACKED_LAUNCHES["bfloat16"]
    out = tfa.flash_attention_packed_fwd(qkv, valid, heads, 0.125)
    torch.cuda.synchronize()
    assert tfa.PACKED_LAUNCHES["bfloat16"] == n0 + 1
    _close_to_scale(out, want)


def test_bf16_tile_shape(cuda):
    """The compiled tile: 192 query rows (three consumer warpgroups),
    128-key K/V tiles, a ring of 3 stages."""
    assert tfa.tile_shape() == {"block_q": 192, "block_k": 128, "stages": 3}


def test_f32_tile_shape(cuda):
    """The compiled f32 tile: 128 query rows (two consumer warpgroups),
    32-key stages of raw K/V in a ring of 3, three buffers of split K/V,
    every product three TF32 products."""
    assert tfa.tile_shape(torch.float32) == {"block_q": 128, "block_k": 32, "stages": 3,
                                             "split_stages": 3, "tf32_products": 3}


def test_hd80_tile_shapes(cuda):
    """The hd-80 instances: bf16 on two consumer warpgroups (128 query
    rows: their registers hold the wider accumulator), f32 with two split
    stages (three do not fit in shared memory at 80 columns)."""
    assert tfa.tile_shape(torch.bfloat16, 80) == {"block_q": 128, "block_k": 128, "stages": 3}
    assert tfa.tile_shape(torch.float32, 80) == {"block_q": 128, "block_k": 32, "stages": 3,
                                                 "split_stages": 2, "tf32_products": 3}


@pytest.mark.parametrize("t", [1, 33, 129])
def test_f32_forward_many_tiles_a_cta(cuda, t):
    """The f32 kernel where each CTA walks several (head, query tile) pairs
    of one or a few key stages (B*H = 64*6 heads of short t; the persistent
    grid has one CTA an SM), ragged keys and an all-invalid image, against
    the plain version."""
    q, k, v = _qkv(64, 6, t, torch.float32, cuda, seed=30 + t)
    g = torch.Generator(device="cpu").manual_seed(3)
    valid = (torch.rand(64, t, generator=g) < 0.8).to(cuda)
    valid[:, 0] = True
    valid[1] = False
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


def test_f32_forward_is_deterministic(cuda):
    """Two calls of each f32 forward kernel (head-major with lse, packed)
    give bit-equal results."""
    q, k, v = _qkv(4, 6, 896, torch.float32, cuda, seed=21)
    valid = torch.ones(4, 896, dtype=torch.bool, device=cuda)
    valid[1::2, 769:] = False
    first, second = tfa.flash_attention_fwd(q, k, v, valid), tfa.flash_attention_fwd(q, k, v, valid)
    qkv, _, pvalid = _packed_inputs(4, 896, 6, torch.float32, cuda, seed=22)
    p1 = tfa.flash_attention_packed_fwd(qkv, pvalid, 6, 0.125)
    p2 = tfa.flash_attention_packed_fwd(qkv, pvalid, 6, 0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second)) and torch.equal(p1, p2)


def test_wrappers_reject_unaligned_cuda_tensors(cuda):
    """TMA needs 16-byte-aligned base pointers: a view one element into its
    storage is refused, not copied, by the flash and packed wrappers."""
    n = 2 * 3 * 128 * 64
    base = torch.randn(2 * 64 * 3 * 6 * 64 + 1, device=cuda).to(torch.bfloat16)
    q = base[1:1 + n].view(2, 3, 128, 64)
    k = v = torch.randn(2, 3, 128, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_fwd(q, k, v)
    qkv = base[1:1 + 2 * 64 * 3 * 6 * 64].view(2, 64, 3 * 6 * 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_packed_fwd(qkv, None, 6, 0.125)


def _fused_mlp_inputs(m, d, f, dev):
    g = torch.Generator(device="cpu").manual_seed(m)
    x = torch.randn(m, d, generator=g).to(dev, torch.bfloat16)
    w_t = (torch.randn(f, d, generator=g) / np.sqrt(d)).to(dev, torch.bfloat16)
    b = (torch.randn(f, generator=g) * 0.1).to(dev)
    return x, w_t, b


# (16*896, 768, 3072): vit_b's width, one consumer warpgroup; (128*896,
# 768, 3072): vit_b_16's LOST shape at B = 128; (16*896, 1024, 4096): vit_l's
# width; (130, 1280, 5120): vit_h's, on the instance without an epilogue
# warpgroup (4 stages), a ragged last row tile; (200, 1664, 256): the widest
# the kernel takes, the same instance on one stage
@pytest.mark.parametrize("m,d,f", [(128 * 64, 384, 1536), (1000, 128, 256),
                                   (16 * 896, 768, 3072), (130, 1280, 5120),
                                   (200, 1664, 256), (128 * 896, 768, 3072),
                                   (16 * 896, 1024, 4096)])
def test_fused_mlp_kernel_matches_plain(cuda, m, d, f):
    x, w_t, b = _fused_mlp_inputs(m, d, f, cuda)
    n0 = tfm.LAUNCHES["bfloat16"]
    w0 = tfm.WIDTH_LAUNCHES.get(d, 0)
    out = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["bfloat16"] == n0 + 1 and tfm.WIDTH_LAUNCHES[d] == w0 + 1
    want = tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("d", [192, 384, 768])
@pytest.mark.parametrize("f", [1, 130, 461, 768])
def test_fused_mlp_kernel_at_any_f(cuda, d, f):
    """A slimmed MLP's width (``slim --round-to 1`` leaves any F): the last
    column tile reads W_eff^T rows past F as TMA zeros, masks the bias and
    writes no column >= F; F % 8 != 0 takes element stores. 600 rows: a
    ragged last row tile. Columns past F are checked untouched through a
    wider view of the output's storage."""
    x, w_t, b = _fused_mlp_inputs(600, d, f, cuda)
    n0 = tfm.LAUNCHES["bfloat16"]
    out = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["bfloat16"] == n0 + 1 and out.shape == (600, f)
    want = tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * scale
    # the kernel writes 600 * f elements and nothing after them
    guard = torch.full((600 * f + 256,), 7.0, dtype=torch.bfloat16, device=cuda)
    fn = tfm._lib()
    x, w_t, b = x.contiguous(), w_t.contiguous(), b.contiguous()
    rc = fn(x.data_ptr(), w_t.data_ptr(), b.data_ptr(), guard.data_ptr(), 600, d, f, 1e-6,
            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(guard[:600 * f].view(600, f), out)
    assert bool((guard[600 * f:] == 7.0).all())


def test_fused_mlp_deterministic(cuda):
    """At (1000, 384, 1536) two calls give bit-equal outputs (no atomics, a
    fixed order of sums), within 2e-2 of the plain version's scale."""
    x, w_t, b = _fused_mlp_inputs(1000, 384, 1536, cuda)
    out = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    again = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want = tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * scale


def test_fused_mlp_design_and_rejection(cuda):
    assert tfm.design(384) == {"rows": 128, "block_n": 128, "stages": 4, "staged": 1}
    assert tfm.design(768) == {"rows": 64, "block_n": 128, "stages": 4, "staged": 1}
    assert tfm.design(1280) == {"rows": 64, "block_n": 128, "stages": 4, "staged": 0}
    assert tfm.design(1664) == {"rows": 64, "block_n": 128, "stages": 1, "staged": 0}
    assert tfm.design(1728)["rows"] == 0
    x, w_t, b = _fused_mlp_inputs(64, 1728, 128, cuda)
    with pytest.raises(ValueError, match="instance that fits D"):
        tfm.fused_ln_dense_gelu_core(x, w_t, b)


@pytest.mark.parametrize("d,f", [(96, 192), (160, 200), (1728, 6912)])
def test_fused_mlp_refuses_widths_outside_the_kernel_on_the_card(cuda, d, f):
    """The gate sets no width condition, as in the JAX package; on the card
    the wrapper refuses a D its kernel does not take (any F is taken), and
    launches nothing, while the same call on CPU tensors takes the plain
    version."""
    x = torch.zeros(128, d, dtype=torch.bfloat16, device=cuda)
    w_t = torch.zeros(f, d, dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(f, device=cuda)
    assert tfm.fused_supported(x) and tfm.fused_supported(x.cpu())
    before = tfm.LAUNCHES["bfloat16"]
    with pytest.raises(ValueError, match="fused MLP kernel needs"):
        tfm.fused_ln_dense_gelu_core(x, w_t, b)
    assert tfm.LAUNCHES["bfloat16"] == before
    assert tfm.fused_ln_dense_gelu_core(x.cpu(), w_t.cpu(), b.cpu()).shape == (128, f)


@pytest.mark.parametrize("hd", [32, 96])
def test_flash_wrappers_reject_other_head_dims_on_the_card(cuda, hd):
    """The flash forward and backward kernels take head dim 64 and 80 (the
    plain versions on CPU tensors take any); a refused call launches
    nothing."""
    q, k, v = (z[..., :1].expand(-1, -1, -1, hd).contiguous()
               for z in _qkv(1, 2, 16, torch.float32, cuda, seed=hd))
    valid = torch.ones(1, 16, dtype=torch.bool, device=cuda)
    n0, b0 = dict(tfa.LAUNCHES), dict(tfa.BWD_LAUNCHES)
    with pytest.raises(ValueError, match="head dim 64 or 80"):
        tfa.flash_attention_fwd(q, k, v, valid)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="backward kernel needs head dim 64 or 80"):
        tfa.flash_attention_bwd(q, k, v, valid, q, lse, q, hd ** -0.5)
    assert tfa.LAUNCHES == n0 and tfa.BWD_LAUNCHES == b0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_hd80_backward_and_training_wrappers_run_packed_raises(cuda, dtype):
    """At head dim 80 the flash backward through autograd and (bf16) the
    training kernels through their packed entry launch their hd-80
    instances and match autograd through the plain versions (1e-4 of each
    gradient's scale in f32, 2e-2 in bf16); the packed route still raises,
    as in the JAX package (128 % 80 != 0: no packed layout), and launches
    nothing."""
    frac = 1e-4 if dtype == torch.float32 else 2e-2
    qkv, cot, valid = _attention_train_inputs(2, 16, 256, cuda, seed=82, hd=80)
    ins = [z.to(dtype).requires_grad_(True) for z in qkv.unbind(0)]
    key = tfa.launch_key(dtype, 80)
    b0, p0 = tfa.BWD_LAUNCHES[key], dict(tfa.PACKED_LAUNCHES)
    got = torch.autograd.grad(tfa.flash_attention(*ins, valid=valid), ins, cot.to(dtype))
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES[key] == b0 + 1
    ref_ins = [z.detach().clone().requires_grad_(True) for z in ins]
    want = torch.autograd.grad(tfa.flash_attention_plain(*ref_ins, valid)[0], ref_ins,
                               cot.to(dtype))
    for a, c in zip(got, want):
        _close_to_scale(a, c, frac)
    assert not tfa.packed_layout_supported(1280, 16)
    with pytest.raises(ValueError, match="no packed layout"):
        tfa.flash_attention_packed(torch.randn(2, 256, 3 * 1280, device=cuda).to(dtype), valid,
                                   num_heads=16)
    assert tfa.PACKED_LAUNCHES == p0
    if dtype == torch.bfloat16:
        _check_attention_train(qkv, cot, valid, packed=True)


def test_vit_h_style_train_step_runs_the_hd80_training_kernels(cuda):
    """A bf16 training forward and backward of an hd-80 ViT (vit_h_14's
    heads at patch 14, 224x224: T = 257 seq-padded to 384) routes attention
    to the training kernels, as the JAX package does, launches their hd-80
    instances once a block each way, and its loss and gradients match the
    same step on the CPU (plain versions) within 2e-2 and 3e-2 (relative
    L2)."""
    from vipers_torch.models.vit import ViTConfig, VisionTransformer
    from vipers_torch.ops import attention_train as tat

    torch.manual_seed(0)
    model = VisionTransformer(ViTConfig(14, 2, 2, 160, 320, 10), (224, 224)).train()
    x = torch.randn(2, 224, 224, 3)
    grads, losses = [], []
    for dev in ("cpu", cuda):
        m = model.to(dev, torch.bfloat16)
        n0 = dict(tat.LAUNCHES)
        logits, _ = m(x.to(dev, torch.bfloat16), need_attn=False)
        loss = logits.float().square().mean()
        gs = torch.autograd.grad(loss, list(m.parameters()))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tat.LAUNCHES == {**n0, "fwd[hd80]": n0["fwd[hd80]"] + 2,
                                    "bwd[hd80]": n0["bwd[hd80]"] + 2}
        losses.append(float(loss))
        grads.append(torch.cat([g.float().flatten().cpu() for g in gs]))
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[0]), losses
    assert ((grads[1] - grads[0]).norm() / grads[0].norm()).item() <= 3e-2


def _attention_train_inputs(b, h, t, dev, seed, all_invalid=False, hd=64):
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(3, b, h, t, hd, generator=g).to(dev, torch.bfloat16)
    cot = torch.randn(b, h, t, hd, generator=g).to(dev, torch.bfloat16)
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[1::2, t - t // 5:] = False  # ragged pad keys on half the batch
    if all_invalid:
        valid[-1] = False  # the last image attends no key
    return qkv, cot, valid.to(dev)


def _close_to_scale(got, want, frac=2e-2):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= frac * scale, (err, scale)


def _check_attention_train(qkv, cot, valid, packed, all_invalid=False):
    """Forward and backward kernels through the packed or unpacked entry and
    its autograd Function: one launch of the head dim's instance each way,
    and every output within 2e-2 of its scale of the plain versions on the
    same padded inputs; with ``all_invalid`` the last image's forward is the
    average of v over the padded T."""
    from vipers_torch.ops import attention_train as tat
    from vipers_torch.ops.tokens import round_up

    _, b, h, t, hd = qkv.shape
    n0 = dict(tat.LAUNCHES)
    if packed:
        x = qkv.clone().requires_grad_(True)
        out = tat.attention_train_packed(x, valid=valid)
        (grad,) = torch.autograd.grad(out, x, cot)
    else:
        q, k, v = (z.clone().requires_grad_(True) for z in qkv.unbind(0))
        out = tat.attention_train(q, k, v, valid=valid)
        grad = torch.stack(torch.autograd.grad(out, (q, k, v), cot))
    torch.cuda.synchronize()
    fk, bk = (tat._launch_key(kind, "f32", hd) for kind in ("fwd", "bwd"))
    assert tat.LAUNCHES == {**n0, fk: n0[fk] + 1, bk: n0[bk] + 1}

    tp, scale = round_up(t, 128), hd ** -0.5
    pad = lambda z: torch.nn.functional.pad(z, (0, 0, 0, tp - t))  # noqa: E731
    q, k, v = (pad(z) for z in qkv.unbind(0))
    ok = torch.nn.functional.pad(valid, (0, tp - t))
    o, lse = tat.attention_train_fwd_plain(q, k, v, ok, scale)
    want = tat.attention_train_bwd_plain(q, k, v, o, lse, pad(cot), ok, scale)
    _close_to_scale(out, o[:, :, :t])
    if all_invalid:
        _close_to_scale(out[-1],
                        v[-1].float().mean(dim=1, keepdim=True).expand(h, tp, hd)[:, :t])
    for a, c in zip(grad, want):
        _close_to_scale(a, c[:, :, :t])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("t", [128, 197, 256, 384, 1024])
def test_attention_train_kernels_match_plain(cuda, t, packed):
    """Forward and backward kernels (through the entries and their autograd
    Functions) against the plain versions on the same padded inputs, bf16
    at 2e-2 of each output's scale. One kernel pair serves both entries.
    T <= 256 (padded) takes the one-pass forward and the backward without
    scratch, 384 and 1024 the two-pass forward and the key rounds. The last
    image attends no key: its forward is the average of v over the padded
    T and its backward the p = 1 one, as in JAX."""
    qkv, cot, valid = _attention_train_inputs(4, 3, t, cuda, seed=t, all_invalid=True)
    _check_attention_train(qkv, cot, valid, packed, all_invalid=True)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
@pytest.mark.parametrize("t", [384, 896, 257, 129, 64, 1])
def test_attention_train_hd80_kernels_match_plain(cuda, t, packed):
    """The hd-80 instances (vit_h_14's heads) as the test above holds the
    hd-64 ones: T = 257 (vit_h_14 at 224x224, padded to 384) and 384 take
    the two-pass forward and two key rounds, 896 four, 129 and below one
    pass; the last image attends no key."""
    qkv, cot, valid = _attention_train_inputs(4, 3, t, cuda, seed=t + 80, all_invalid=True,
                                              hd=80)
    _check_attention_train(qkv, cot, valid, packed, all_invalid=True)


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("t", [256, 640])
def test_attention_train_backward_is_deterministic(cuda, t, hd):
    """Two backward calls on the same inputs give bit-equal dq, dk and dv:
    dQ is summed in a fixed order with no atomics (at T = 640 across key
    rounds in the f32 scratch), so an LRR round repeats."""
    from vipers_torch.ops import attention_train as tat

    qkv, cot, valid = _attention_train_inputs(8, 6, t, cuda, seed=3, all_invalid=True, hd=hd)
    q, k, v = qkv.unbind(0)
    o, lse = tat.attention_train_fwd(q, k, v, valid, 0.125)
    first = tat.attention_train_bwd(q, k, v, o, lse, cot, valid, 0.125)
    second = tat.attention_train_bwd(q, k, v, o, lse, cot, valid, 0.125)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_attention_train_rejects_unaligned_cuda_tensors(cuda):
    """TMA needs 16-byte-aligned base pointers: the training attention
    wrappers refuse a view one element into its storage (an input, or an
    ``out`` slab of the backward), and copy nothing."""
    from vipers_torch.ops import attention_train as tat

    n = 2 * 3 * 128 * 64
    qkv, cot, valid = _attention_train_inputs(2, 3, 128, cuda, seed=4)
    q, k, v = qkv.unbind(0)
    base = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)
    odd = base[1:].view(2, 3, 128, 64)
    odd.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tat.attention_train_fwd(odd, k, v, valid, 0.125)
    o, lse = tat.attention_train_fwd(q, k, v, valid, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tat.attention_train_bwd(q, k, v, o, lse, cot, valid, 0.125,
                                out=(odd, torch.empty_like(q), torch.empty_like(q)))


def test_attention_train_design(cuda):
    """The compiled training kernels: 128-query forward tiles over 256-key
    chunks in two K/V stages; 64-query backward blocks in three ring stages
    over rounds of 256 keys, 128 at hd 80 (registers)."""
    from vipers_torch.ops import attention_train as tat

    want = {"fwd_block_q": 128, "chunk": 256, "fwd_stages": 2, "bwd_block_q": 64,
            "bwd_stages": 3, "bwd_chunk": 256}
    assert tat.design() == tat.design(64) == want
    assert tat.design(80) == {**want, "bwd_chunk": 128}
    with pytest.raises(ValueError, match="head dims"):
        tat.design(96)


def test_flash_attention_gradient_through_kernel(cuda):
    """The flash Function's gradient on the card equals autograd through the
    plain version (the wrapper once returned tensors without autograd
    history, so the gradient was lost on the card), and comes from the
    backward kernel."""
    for dtype, frac in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qkv, cot, valid = _attention_train_inputs(2, 3, 640, cuda, seed=5)
        ins = [z.to(dtype).requires_grad_(True) for z in qkv.unbind(0)]
        n0 = tfa.BWD_LAUNCHES[str(dtype)[6:]]
        out = tfa.flash_attention(*ins, valid=valid)
        got = torch.autograd.grad(out, ins, cot.to(dtype))
        torch.cuda.synchronize()
        assert tfa.BWD_LAUNCHES[str(dtype)[6:]] == n0 + 1
        ref_ins = [z.detach().clone().requires_grad_(True) for z in ins]
        ref, _ = tfa.flash_attention_plain(*ref_ins, valid)
        want = torch.autograd.grad(ref, ref_ins, cot.to(dtype))
        for a, c in zip(got, want):
            _close_to_scale(a, c, frac)


def _flash_bwd_inputs(t, dtype, dev, seed, hd=64):
    """B*H = 3*5 at (3, 5, t, hd), a ragged key mask (about 20% pad keys,
    key 0 valid), image 1 attending no key, residuals from the forward
    kernel, cotangents on every row."""
    q, k, v = _qkv(3, 5, t, dtype, dev, seed, hd)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    cot = torch.randn(3, 5, t, hd, generator=g).to(dev, dtype)
    valid = torch.rand(3, t, generator=g) < 0.8
    valid[:, 0] = True
    valid[1] = False
    valid = valid.to(dev)
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    return q, k, v, valid, out, lse, cot, 0.125


@pytest.mark.parametrize("dtype,frac", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 64, 128, 129, 200, 577, 640, 896, 1025, 1152])
def test_flash_backward_kernel_matches_plain(cuda, dtype, frac, t):
    """dq, dk, dv of the backward kernels against the plain version within
    1e-4 (f32) or 2e-2 (bf16) of each gradient's scale, at ragged and
    multiple-of-64 t: one 128-key (dk/dv) and 128-query (dq) tile and
    several, and t one past a tile's edge (129, 1025: a last tile of one
    row), with an image whose keys are all invalid and cotangents on every
    row. At t = 1 the softmax over one key is constant, so the exact dq
    and dk are 0 and both versions give rounding noise: there they are held
    to dv's scale."""
    args = _flash_bwd_inputs(t, dtype, cuda, seed=t)
    n0 = tfa.BWD_LAUNCHES[str(dtype)[6:]]
    got = tfa.flash_attention_bwd(*args)
    want = tfa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES[str(dtype)[6:]] == n0 + 1
    dv_scale = want[2].float().abs().max().item()
    for a, c in zip(got, want):
        assert a.dtype == dtype and a.shape == c.shape
        if t == 1:
            assert (a.float() - c.float()).abs().max().item() <= frac * dv_scale
        else:
            _close_to_scale(a, c, frac)


@pytest.mark.parametrize("dtype,frac", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [384, 896, 257, 129, 64, 1])
def test_flash_backward_hd80_kernel_matches_plain(cuda, dtype, frac, t):
    """The hd-80 instances (vit_h_14's heads; T = 896 is its 392x392 train
    shape) as the test above holds the hd-64 ones: dq, dk, dv within 1e-4
    (f32) or 2e-2 (bf16) of each gradient's scale, an image attending no
    key, cotangents on every row (t = 1: dq, dk held to dv's scale)."""
    args = _flash_bwd_inputs(t, dtype, cuda, seed=t + 80, hd=80)
    key = tfa.launch_key(dtype, 80)
    n0 = dict(tfa.BWD_LAUNCHES)
    got = tfa.flash_attention_bwd(*args)
    want = tfa.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == {**n0, key: n0[key] + 1}
    dv_scale = want[2].float().abs().max().item()
    for a, c in zip(got, want):
        assert a.dtype == dtype and a.shape == c.shape
        if t == 1:
            assert (a.float() - c.float()).abs().max().item() <= frac * dv_scale
        else:
            _close_to_scale(a, c, frac)


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("t", [640, 1152])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_is_deterministic(cuda, dtype, t, hd):
    """Two backward calls give bit-equal dq, dk and dv: no float atomics,
    every block owns its outputs (bf16 sums dq over 5 or 9 key tiles in
    one block's registers)."""
    args = _flash_bwd_inputs(t, dtype, cuda, seed=11, hd=hd)
    first = tfa.flash_attention_bwd(*args)
    second = tfa.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for a, c in zip(first, second):
        assert torch.equal(a, c)


def test_flash_backward_rejects_unaligned_cuda_tensors(cuda):
    """The backward wrapper refuses a CUDA input one element into its
    storage, and copies nothing."""
    q, k, v, valid, out, lse, cot, scale = _flash_bwd_inputs(128, torch.bfloat16, cuda, seed=12)
    base = torch.zeros(cot.numel() + 1, device=cuda, dtype=torch.bfloat16)
    odd = base[1:].view(cot.shape)
    odd.copy_(cot)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_attention_bwd(q, k, v, valid, out, lse, odd, scale)


def test_flash_backward_design(cuda):
    """Both instances' compiled designs. bf16: 128-key dk/dv tiles (64 keys
    a consumer warpgroup) over 64-query stages, 128-query dq tiles over
    128-key stages. f32: the same tiles over 32-query and 32-key stages of
    a 2- and a 3-stage ring (at hd 80 a 1- and a 2-stage ring: shared
    memory), every product three TF32 products. Two kernels each, and the
    workspace padding the wrapper allocates by."""
    bf16 = {"dkv_keys": 128, "dkv_queries": 64, "dkv_stages": 4, "dq_queries": 128,
            "dq_keys": 128, "dq_stages": 3, "row_pad": 128, "kernels": 2, "tf32_products": 0}
    f32 = {"dkv_keys": 128, "dkv_queries": 32, "dkv_stages": 2, "dq_queries": 128, "dq_keys": 32,
           "dq_stages": 3, "row_pad": 128, "kernels": 2, "tf32_products": 3}
    assert tfa.bwd_design(torch.bfloat16) == tfa.bwd_design(torch.bfloat16, 80) == bf16
    assert tfa.bwd_design(torch.float32) == f32
    assert tfa.bwd_design(torch.float32, 80) == {**f32, "dkv_stages": 1, "dq_stages": 2}


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_backward_f32_nearer_f32_than_tf32(cuda, hd):
    """The f32 kernel (three TF32 products a product) lies at least 10x
    nearer the exact-f32 plain version than that plain version run with
    cuBLAS in TF32 (one TF32 product a product), in each of dq, dk, dv."""
    args = _flash_bwd_inputs(640, torch.float32, cuda, seed=13, hd=hd)
    assert not torch.backends.cuda.matmul.allow_tf32
    got = tfa.flash_attention_bwd(*args)
    want = tfa.flash_attention_bwd_plain(*args)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = tfa.flash_attention_bwd_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    for a, c, y in zip(got, want, tf32):
        err, yard = (a - c).abs().max().item(), (y - c).abs().max().item()
        assert 10 * err <= yard, (err, yard)


def test_fused_mlp_gradient_through_kernel(cuda):
    """The fused LN->fc1->GELU Function's gradients (x, ln_2 scale and bias,
    fc1 kernel and bias) on the card equal autograd through the plain
    version."""
    g = torch.Generator(device="cpu").manual_seed(7)
    d, f = 384, 1536
    x = torch.randn(2, 256, d, generator=g).to(cuda, torch.bfloat16)
    leaves = [1 + 0.3 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g),
              torch.randn(d, f, generator=g) / np.sqrt(d), 0.1 * torch.randn(f, generator=g)]
    dy = torch.randn(2, 256, f, generator=g).to(cuda, torch.bfloat16)

    def run(fused):
        xs = x.clone().requires_grad_(True)
        ps = [p.to(cuda).requires_grad_(True) for p in leaves]
        if fused:
            y = tfm.fused_ln_dense_gelu(xs, *ps)
        else:
            w_t, b_eff = tfm.fold_ln_affine(*ps, torch.bfloat16)
            y = tfm.fused_ln_dense_gelu_plain(xs.reshape(-1, d), w_t, b_eff, 1e-6)
        return torch.autograd.grad(y.reshape(-1, f), [xs] + ps, dy.reshape(-1, f))

    n0 = tfm.LAUNCHES["bfloat16"]
    got = run(True)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES["bfloat16"] == n0 + 1
    for a, c in zip(got, run(False)):
        _close_to_scale(a, c)


def _packed_inputs(b, t, heads, dtype, dev, seed):
    """Packed (B, T, 3D) qkv and a key mask with a ragged tail of pad keys
    on every other image."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * heads * 64, generator=g).to(dev, dtype)
    cot = torch.randn(b, t, heads * 64, generator=g).to(dev, dtype)
    valid = torch.ones(b, t, dtype=torch.bool)
    valid[1::2, t - t // 7:] = False
    return qkv, cot, valid.to(dev)


@pytest.mark.parametrize("dtype,frac", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [6, 12])
@pytest.mark.parametrize("t", [896, 577])
def test_packed_kernel_matches_plain(cuda, dtype, frac, t, heads):
    """The packed token-major kernel against its plain version at 6 and 12
    heads (three and six head-pair stripes), forward (at t = 577 unpadded:
    partial key stages and query tiles) and the gradient through the
    autograd Function against autograd through the plain version (T = 577
    pads to 640 inside the wrapper)."""
    qkv, cot, valid = _packed_inputs(3, t, heads, dtype, cuda, seed=t)
    key = str(dtype)[6:]
    n0 = tfa.PACKED_LAUNCHES[key]
    out = tfa.flash_attention_packed_fwd(qkv, valid, heads, 0.125)
    torch.cuda.synchronize()
    assert tfa.PACKED_LAUNCHES[key] == n0 + 1
    _close_to_scale(out, tfa.flash_attention_packed_plain(qkv, valid, heads, 0.125), frac)

    x = qkv.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(tfa.flash_attention_packed(x, valid, num_heads=heads), x, cot)
    xr = qkv.clone().requires_grad_(True)
    ref = tfa.flash_attention_packed_plain(xr, valid, heads, 0.125)
    (want,) = torch.autograd.grad(ref, xr, cot)
    _close_to_scale(got, want, 2e-2 if dtype == torch.bfloat16 else 1e-4)


def _own_variant(got, want, want_f32):
    """``got`` is its variant's result and not f32's (which lies within the
    2e-2 tolerance): its mean distance from the variant's plain version is
    at most half the distance from that to f32's plain version."""
    gap = (want.float() - want_f32.float()).abs().mean().item()
    err = (got.float() - want.float()).abs().mean().item()
    assert gap > 0 and err <= 0.5 * gap, (err, gap)


@pytest.mark.parametrize("variant", ["f32", "bf16exp", "normP"])
def test_softmax_variants_match_plain(cuda, variant):
    """Each softmax-precision instance of the training kernels against its
    plain version (normP's backward is f32's), bf16 at 2e-2 of each output's
    scale, with a ragged key mask; bf16exp and normP are also clearly their
    own variant, not f32."""
    from vipers_torch.ops import attention_train as tat

    qkv, cot, valid = _attention_train_inputs(4, 3, 256, cuda, seed=11)
    q, k, v = qkv.unbind(0)
    bwd_variant = "f32" if variant == "normP" else variant
    n0 = dict(tat.LAUNCHES)
    o, lse = tat.attention_train_fwd(q, k, v, valid, 0.125, variant=variant)
    grads = tat.attention_train_bwd(q, k, v, o, lse, cot, valid, 0.125, variant=bwd_variant)
    torch.cuda.synchronize()
    fkey = "fwd" if variant == "f32" else f"fwd[{variant}]"
    bkey = "bwd" if bwd_variant == "f32" else f"bwd[{bwd_variant}]"
    assert tat.LAUNCHES[fkey] == n0[fkey] + 1 and tat.LAUNCHES[bkey] == n0[bkey] + 1
    want_o, want_lse = tat.attention_train_fwd_plain(q, k, v, valid, 0.125, variant)
    _close_to_scale(o, want_o)
    _close_to_scale(lse, want_lse)
    want = tat.attention_train_bwd_plain(q, k, v, o, lse, cot, valid, 0.125, bwd_variant)
    for a, c in zip(grads, want):
        _close_to_scale(a, c)
    if variant != "f32":
        _own_variant(o, want_o, tat.attention_train_fwd_plain(q, k, v, valid, 0.125)[0])
    if bwd_variant != "f32":
        want_f32 = tat.attention_train_bwd_plain(q, k, v, o, lse, cot, valid, 0.125)
        for a, c, c32 in zip(grads, want, want_f32):
            _own_variant(a, c, c32)


@pytest.mark.parametrize("variant", ["bf16exp", "normP"])
def test_own_variant_rejects_the_f32_instance(cuda, variant):
    """The own-variant check fails the f32 instance held against a
    variant's plain version, as it would fail a variant's launch that
    computed f32 (which the 2e-2 tolerance alone lets through)."""
    from vipers_torch.ops import attention_train as tat

    qkv, cot, valid = _attention_train_inputs(4, 3, 256, cuda, seed=11)
    q, k, v = qkv.unbind(0)
    o, lse = tat.attention_train_fwd(q, k, v, valid, 0.125)
    want = tat.attention_train_fwd_plain(q, k, v, valid, 0.125, variant)[0]
    _close_to_scale(o, want)
    with pytest.raises(AssertionError):
        _own_variant(o, want, tat.attention_train_fwd_plain(q, k, v, valid, 0.125)[0])
    if variant == "bf16exp":
        grads = tat.attention_train_bwd(q, k, v, o, lse, cot, valid, 0.125)
        want = tat.attention_train_bwd_plain(q, k, v, o, lse, cot, valid, 0.125, variant)
        want_f32 = tat.attention_train_bwd_plain(q, k, v, o, lse, cot, valid, 0.125)
        for a, c, c32 in zip(grads, want, want_f32):
            with pytest.raises(AssertionError):
                _own_variant(a, c, c32)


@pytest.mark.parametrize("layout", ["head_dim_minor", "seq_minor"])
@pytest.mark.parametrize("block_q,block_kv", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_splash_instances_match_plain(cuda, block_q, block_kv, layout):
    from vipers_torch.ops import splash_attention as tsa

    q, k, v = _qkv(2, 3, 384, torch.bfloat16, cuda, seed=block_q + block_kv)
    q = (q * 0.125).to(torch.bfloat16)
    kk = k.transpose(-1, -2).contiguous() if layout == "seq_minor" else k
    name = tsa.instance_name(block_q, block_kv, layout)
    n0 = tsa.LAUNCHES[name]
    out = tsa.splash_attention(q, kk, v, block_q, block_kv, layout)
    torch.cuda.synchronize()
    assert tsa.LAUNCHES[name] == n0 + 1
    _close_to_scale(out, tsa.splash_attention_plain(q, k, v))


def test_train_cli_launches_the_training_kernels(cuda, tmp_path):
    """``vipers_torch train --amp`` on the card (the default device) for one
    epoch of 2 steps at a tiny size (patch 8, 2 blocks, D 128, 2 heads of
    64, 32x32 crops: T = 17 seq-padded to 128): the training attention's
    forward and backward kernels once a block a step, finite losses, and
    the .pth written."""
    import json

    from PIL import Image

    import vipers_torch.core.registry as treg
    import vipers_torch.models.vit as tvit
    from vipers_torch.cli.main import main
    from vipers_torch.ops import attention_train as tat
    from vipers_torch.train import driver

    name = "vit_tiny_cuda_cli_test"
    treg._ensure_builtins_imported()
    treg._BUILTIN_MODELS[name] = lambda num_classes=1000, image_size=(224, 224): \
        tvit._build(name, tvit.ViTConfig(8, 2, 2, 128, 256, num_classes), image_size)
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        for cls in ("a", "b"):
            d = tmp_path / "data" / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                    d / f"{i}.jpg")
    before = {k: tat.LAUNCHES[tat._launch_key(k, "f32", 64)] for k in ("fwd", "bwd")}
    try:
        assert main(["train", "--model", name, "--data-path", str(tmp_path / "data"),
                     "--num-classes", "2", "--batch-size", "4", "--epochs", "1",
                     "--train-crop-size", "32", "--val-resize-size", "40",
                     "--val-crop-size", "32", "--amp", "--workers", "2", "--print-freq", "1",
                     "--output-dir", str(tmp_path / "out")]) == 0
    finally:
        del treg._BUILTIN_MODELS[name]
    torch.cuda.synchronize()
    got = {k: tat.LAUNCHES[tat._launch_key(k, "f32", 64)] - before[k] for k in ("fwd", "bwd")}
    assert got == {"fwd": 4, "bwd": 4}, got  # 2 blocks x 2 steps
    assert driver.LAST_RUN["train_images"] == 8 + 4  # SNIP's batch, then 2 steps
    assert (tmp_path / "out" / f"{name}_epoch_0_snip_0.9.pth").exists()
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        train = [r for r in map(json.loads, f) if r["tag"] == "train"]
    assert len(train) == 1 and np.isfinite(train[0]["loss"])


def test_f32_convolutions_run_as_exact_f32(cuda):
    """cuDNN allows TF32 convolutions by default; the port's f32 scope
    (``models.cnn.exact_f32_convs``) turns them off for its forward and
    backward and restores the switch after. Inside it a ResNet-50 stem
    convolution and its input gradient sit within 1e-5 of their scale of
    an f64 run; with TF32 on, 10x farther at least. In bf16 the scope
    changes nothing."""
    from vipers_torch.models.cnn import exact_f32_convs

    g = torch.Generator(device="cpu").manual_seed(0)
    x64 = torch.randn(8, 64, 56, 56, generator=g, dtype=torch.float64)
    w64 = torch.randn(64, 64, 3, 3, generator=g, dtype=torch.float64) / 24

    def conv(dtype):
        x = x64.to(cuda, dtype).requires_grad_(True)
        y = torch.nn.functional.conv2d(x, w64.to(cuda, dtype), padding=1)
        gx, = torch.autograd.grad(y.square().sum(), x)
        return y.double().cpu(), gx.double().cpu()

    y_ref, g_ref = conv(torch.float64)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with exact_f32_convs(torch.float32):
            assert not torch.backends.cudnn.allow_tf32
            y, gx = conv(torch.float32)
        assert torch.backends.cudnn.allow_tf32
        y_tf, g_tf = conv(torch.float32)
        with exact_f32_convs(torch.bfloat16):
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = old
    for got, tf, ref in ((y, y_tf, y_ref), (gx, g_tf, g_ref)):
        scale = ref.abs().max().item()
        err, tf_err = (got - ref).abs().max().item(), (tf - ref).abs().max().item()
        assert err <= 1e-5 * scale, (err, scale)
        assert tf_err >= 10 * err, (tf_err, err)


def test_swin_f32_forward_matches_the_cpu(cuda):
    """swin_v2_t at full width and depth (seed-0 weights, biases drawn so
    they are not zero), f32 at B = 2 on a 256x256 and a 100x76 input (a
    padded, shift-off last stage): logits, the final map and the last
    block's qkv on the card within 1e-4 of their scale of the CPU's (the
    patch convolution as exact f32); no port kernel launches."""
    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_model
    from vipers_torch.models.cnn import exact_f32_convs
    from vipers_torch.ops import attention_train as tat

    spec = build_model("swin_v2_t")
    params = spec.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    sd = {k: (v + 0.02 * torch.randn(v.shape, generator=g) if k.endswith("bias") else v)
          for k, v in family(spec).state_dict(params).items()}
    model = spec.module().eval()
    model.load_state_dict(sd)
    counters = (tfa.LAUNCHES, tfa.PACKED_LAUNCHES, tfa.BWD_LAUNCHES, tfm.LAUNCHES, tat.LAUNCHES)
    before = sum(v for c in counters for v in c.values())
    for hw in ((256, 256), (100, 76)):
        x = torch.randn(2, *hw, 3, generator=g)
        with torch.no_grad(), exact_f32_convs():
            ref = model(x)
            got = model.to(cuda)(x.to(cuda))
            model.cpu()
        torch.cuda.synchronize()
        for r, c in ((ref[0], got[0]), (ref[1]["features"], got[1]["features"]),
                     (ref[1]["qkv"], got[1]["qkv"])):
            scale = r.abs().max().item()
            assert (c.cpu() - r).abs().max().item() <= 1e-4 * scale
    assert sum(v for c in counters for v in c.values()) == before


def test_drop_path_generator_on_the_card(cuda):
    """Stochastic depth's generator on the card: over 4096 samples the keep
    frequency lies within 5 sigma of 1 - rate, kept samples are scaled by
    exactly 1 / keep and dropped ones are zero; the same (seed, step)
    draws the same mask, another step another."""
    from vipers_torch.models.stochastic import drop_path, dropout_generator

    rate, keep = 0.2, 0.8
    y = torch.randn(4096, 4, 4, 8, device=cuda)
    gen = dropout_generator(0, 3, cuda)
    assert gen.device.type == "cuda"
    out = drop_path(y, rate, True, gen)
    kept = (out != 0).flatten(1).any(dim=1)
    assert abs(kept.float().mean().item() - keep) <= 5 * (keep * rate / y.shape[0]) ** 0.5
    assert torch.equal(out[kept], y[kept] / keep) and not out[~kept].any()
    assert torch.equal(drop_path(y, rate, True, dropout_generator(0, 3, cuda)), out)
    assert not torch.equal(drop_path(y, rate, True, dropout_generator(0, 4, cuda)), out)


def test_fused_mlp_dino_tiny_width(cuda):
    """D = 192 (``dino_vit_tiny``, F = 768) at its LOST shape, M = 128*896
    (T = 769 padded to 896, B = 128): the two-consumer instance, within 2e-2
    of the plain version's scale, counted under its width."""
    assert tfm.design(192) == {"rows": 128, "block_n": 128, "stages": 4, "staged": 1}
    x, w_t, b = _fused_mlp_inputs(128 * 896, 192, 768, cuda)
    w0 = tfm.WIDTH_LAUNCHES.get(192, 0)
    out = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    torch.cuda.synchronize()
    assert tfm.WIDTH_LAUNCHES[192] == w0 + 1
    want = tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6)
    scale = want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)],
                         ids=["f32", "bf16"])
def test_flash_kernel_at_the_patch8_lost_shape(cuda, dtype, atol, rtol):
    """``dino_vit_small`` at patch 8 on a 512x384 image: T = 3073 tokens
    seq-padded to 3200, the 127 pad keys masked; a second image with a
    smaller valid grid (bucket-pad keys) and a third with every key valid.
    Against the plain version."""
    t = 3200
    q, k, v = _qkv(3, 2, t, dtype, cuda, seed=3073)
    valid = torch.zeros(3, t, dtype=torch.bool, device=cuda)
    valid[0, :3073] = True
    valid[1, :2401] = True
    valid[2] = True
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=1e-4)


def test_dino_forward_launches_rows_1_and_4(cuda):
    """A 2-block ``dino_vit_small`` (D 384) on two 512x384 images in bf16,
    tokens seq-padded to 896: each block one flash forward and one fused
    MLP launch; with ``need_attn`` the last block computes its attention
    and launches no flash. The card's CLS features within 2e-2 of their
    scale of the CPU's (plain versions)."""
    from vipers_torch.models import dino_vit

    cfg = dino_vit.DinoViTConfig(16, 384, 2, 6, 4.0, 0)
    spec = dino_vit._build("dino_cuda_test", cfg)
    model = spec.module()
    from vipers_torch.core.checkpoint import family

    model.load_state_dict(family(spec).state_dict(spec.init(torch.Generator().manual_seed(0))))
    model = model.to(torch.bfloat16).eval()
    x = torch.randn(2, 512, 384, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        ref = model(x, need_attn=False, seq_pad_multiple=128)[0]
        f0, m0 = tfa.LAUNCHES["bfloat16"], tfm.WIDTH_LAUNCHES.get(384, 0)
        got = model.to(cuda)(x.to(cuda), need_attn=False, seq_pad_multiple=128)[0]
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES["bfloat16"] - f0, tfm.WIDTH_LAUNCHES[384] - m0) == (2, 2)
        f1 = tfa.LAUNCHES["bfloat16"]
        aux = model(x.to(cuda), need_attn=True)[1]
        torch.cuda.synchronize()
        assert tfa.LAUNCHES["bfloat16"] - f1 == 1 and aux["attn"].shape == (2, 6, 769, 769)
    scale = ref.float().abs().max().item()
    assert (got.float().cpu() - ref.float()).abs().max().item() <= 2e-2 * scale


def test_dropout_generator_on_the_card(cuda):
    """Dropout's masks on the card: the keep share within 5 sigma of
    1 - rate, kept elements scaled by exactly 1 / keep; the same (seed,
    step) draws the same mask, another step another."""
    from vipers_torch.models.stochastic import dropout, dropout_generator

    rate, keep = 0.1, 0.9
    x = torch.randn(256, 4096, device=cuda) + 5.0
    out = dropout(x, rate, True, dropout_generator(0, 3, cuda))
    kept = out != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - keep) <= 5 * (keep * rate / n) ** 0.5
    assert torch.equal(out[kept], x[kept] / keep)
    assert torch.equal(dropout(x, rate, True, dropout_generator(0, 3, cuda)), out)
    assert not torch.equal(dropout(x, rate, True, dropout_generator(0, 4, cuda)), out)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)],
                         ids=["f32", "bf16"])
def test_flash_kernel_at_a_slim_head_count(cuda, dtype, atol, rtol):
    """A ViT-S/16 slimmed to 3 heads of 64 (``slim --heads-keep 0.5
    --round-to 1``) at its LOST shape on 512x384: T = 769 tokens padded to
    896, the second image's keys cut by a smaller bucket grid. Against the
    plain version."""
    t = 896
    q, k, v = _qkv(4, 3, t, dtype, cuda, seed=3)
    valid = torch.zeros(4, t, dtype=torch.bool, device=cuda)
    valid[:, :769] = True
    valid[1, 600:] = False
    n0 = tfa.LAUNCHES[str(dtype)[6:]]
    out, lse = tfa.flash_attention_fwd(q, k, v, valid)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[str(dtype)[6:]] == n0 + 1
    want, want_lse = tfa.flash_attention_plain(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4 if dtype == torch.float32 else 2e-2,
                               rtol=1e-4)


# ---- int8 quantization: the library's int8 products must give the CPU's
# ---- int32 accumulators exactly, whatever route the shape takes

def _int8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("m,k,n", [(33, 64, 24), (7, 9, 12), (16, 24, 1000),
                                   (4096, 384, 1536), (128, 1280, 1000)])
def test_int8_matmul_accumulators_equal_the_cpu(cuda, m, k, n):
    """``matmul_int32`` on the card (``torch._int_mm``; M <= 16, K and N
    off a multiple of 8 zero-padded) equals the CPU's int32 product, with
    all-extreme rows (-128 x 127, -128 x -128)."""
    from vipers_torch.train import quantize as tq

    g = torch.Generator().manual_seed(m + k + n)
    a, w = _int8((m, k), g), _int8((n, k), g)
    a[0], w[0] = -128, 127
    a[1], w[1] = -128, -128
    calls = tq.INT_MM_CALLS[0]
    got = tq.matmul_int32(a.to(cuda), w.to(cuda))
    assert tq.INT_MM_CALLS[0] == calls + 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), tq.matmul_int32(a, w))


@pytest.mark.parametrize("c,h,o,kk,st,dil,grp", [
    (16, 12, 24, 3, 1, 1, 1), (16, 13, 8, 3, 2, 1, 1), (8, 14, 16, 3, 1, 2, 1),
    (24, 13, 24, 3, 2, 1, 24), (16, 14, 16, 3, 1, 2, 16), (8, 9, 12, 3, 1, 1, 2),
    (32, 11, 40, 1, 2, 1, 1), (3, 29, 16, 7, 2, 1, 1)],
    ids=["3x3", "strided", "dilated", "depthwise-strided", "depthwise-dilated", "grouped",
         "1x1-strided", "7x7"])
def test_int8_conv_accumulators_equal_the_cpu(cuda, c, h, o, kk, st, dil, grp):
    """``conv_int32`` on the card (im2col + ``_int_mm``, depthwise per tap)
    equals the CPU's int32 convolution, extreme operands included."""
    from vipers_torch.train import quantize as tq

    g = torch.Generator().manual_seed(c * h + o)
    xs, w = _int8((2, c, h, h), g), _int8((o, c // grp, kk, kk), g)
    xs[0], w[0] = -128, 127
    got = tq.conv_int32(xs.to(cuda), w.to(cuda), (st, st), (dil, dil), grp)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), tq.conv_int32(xs, w, (st, st), (dil, dil), grp))


def test_int8_lost_keeps_the_fused_mlp_off(cuda):
    """A bf16 ViT forward under the int8 sites runs fc1 as a Dense call:
    the flash kernel launches in each block, the fused MLP never; the same
    forward in bf16 fuses. The card's int8 features are within 2e-2 of
    their scale of the CPU's."""
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.models.vit import ViTConfig, _build

    spec = _build("tiny", ViTConfig(16, 2, 6, 384, 1536, 0), (512, 384))
    params = spec.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (512, 384, 3), dtype=np.uint8) for _ in range(2)]
    hw = [(512, 384)] * 2
    feats = {}
    for tag, dt, dev in (("int8", "int8", "cuda"), ("bf16", torch.bfloat16, "cuda"),
                         ("cpu", "int8", "cpu")):
        ex = LostFeatureExtractor(spec, params, compute_dtype=dt, device=dev)
        inp = ex.prepare_batch(imgs, 16, exact_hw=hw)
        f0, m0 = tfa.LAUNCHES["bfloat16"], tfm.LAUNCHES["bfloat16"]
        feats[tag] = ex.batched_features(*inp).float().cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert tfa.LAUNCHES["bfloat16"] - f0 == 2
            assert tfm.LAUNCHES["bfloat16"] - m0 == (0 if tag == "int8" else 2), tag
    scale = feats["cpu"].abs().max().item()
    assert (feats["int8"] - feats["cpu"]).abs().max().item() <= 2e-2 * scale


def _op_cases(dev):
    """(op, args) of every kernel's custom op at small shapes on ``dev``,
    f32 and bf16, with and without inputs that require grad."""
    g = torch.Generator().manual_seed(21)
    valid = torch.rand(2, 256, generator=g) < 0.8
    valid[:, 0] = True
    valid = valid.to(dev)
    ops = torch.ops.vipers_torch
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 3, 256, 64, generator=g).to(dev, dt) for _ in range(3))
        out, lse = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
        qkv = torch.randn(2, 256, 3 * 384, generator=g).to(dev, dt)
        cases += [(ops.flash_attention_fwd.default, (q, k, v, valid, 0.125)),
                  (ops.flash_attention_fwd.default, (q.clone().requires_grad_(),
                                                     k.clone().requires_grad_(),
                                                     v.clone().requires_grad_(), None, 0.125)),
                  (ops.flash_attention_bwd.default, (q, k, v, valid, out, lse,
                                                     torch.randn_like(q), 0.125)),
                  (ops.flash_attention_packed.default, (qkv, valid, 6, 0.125)),
                  (ops.flash_attention_packed.default, (qkv.clone().requires_grad_(), valid,
                                                        6, 0.125))]
    x = torch.randn(256, 384, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(1536, 384, generator=g) / 20).to(dev, torch.bfloat16)
    b = torch.randn(1536, generator=g).to(dev)
    cases += [(ops.fused_ln_dense_gelu.default, (x, w, b, 1e-6)),
              (ops.fused_ln_dense_gelu.default, (x.clone().requires_grad_(),
                                                 w.clone().requires_grad_(), b, 1e-6))]
    return cases


def test_custom_ops_pass_opcheck_on_the_card(cuda):
    """The kernels' ``torch.library`` ops on CUDA tensors: schema, fake
    implementation against the launch, autograd registration (the flash
    backward kernels, the recompute VJPs) and AOT dispatch; the launches
    are counted."""
    n0 = (dict(tfa.LAUNCHES), dict(tfa.BWD_LAUNCHES), dict(tfa.PACKED_LAUNCHES),
          dict(tfm.LAUNCHES))
    for op, args in _op_cases(cuda):
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)
    n1 = (tfa.LAUNCHES, tfa.BWD_LAUNCHES, tfa.PACKED_LAUNCHES, tfm.LAUNCHES)
    for before, after in zip(n0, n1):
        assert all(after[k] > before[k] for k in ("float32", "bfloat16") if k in before)


def test_while_loop_fill_on_the_card_equals_the_cpu(cuda):
    """The flood fill's ``while_loop`` on the card gives the CPU's
    components: random grids at the LOST bucket, seeds on the background
    among them, and a 60 x 60 grid at 40% density (long paths)."""
    from vipers_torch.discovery.components import flood_fill_from_seed

    g = torch.Generator().manual_seed(3)
    for shape, p in (((128, 24, 32), 0.5), ((4, 60, 60), 0.4)):
        mask = torch.rand(*shape, generator=g) > p
        seed = torch.stack([torch.randint(0, shape[1], (shape[0],), generator=g),
                            torch.randint(0, shape[2], (shape[0],), generator=g)], 1)
        want = flood_fill_from_seed(mask, seed)
        got = flood_fill_from_seed(mask.to(cuda), seed.to(cuda))
        assert torch.equal(got.cpu(), want)
        if shape[0] == 128:
            assert (~mask[torch.arange(128), seed[:, 0], seed[:, 1]]).any()


def test_dino_explain_shape_flash_forward_and_backward(cuda):
    """``explain-eval`` on ``dino_vit_small`` at a VOC size: rows 1 and
    12-13 in f32 at B*H = 1*6, T = 769 (a 32 x 24 grid and the CLS), no key
    mask; the forward within the f32 tolerance, the gradients within 1e-4
    of each one's scale; both launches counted."""
    q, k, v = _qkv(1, 6, 769, torch.float32, cuda, seed=769)
    n0, b0 = tfa.LAUNCHES["float32"], tfa.BWD_LAUNCHES["float32"]
    out, lse = tfa.flash_attention_fwd(q, k, v, None, 0.125)
    want, want_lse = tfa.flash_attention_plain(q, k, v, None, 0.125)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    cot = torch.randn(1, 6, 769, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    args = (q, k, v, None, out, lse, cot, 0.125)
    for a, c in zip(tfa.flash_attention_bwd(*args), tfa.flash_attention_bwd_plain(*args)):
        _close_to_scale(a, c, 1e-4)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["float32"] == n0 + 1 and tfa.BWD_LAUNCHES["float32"] == b0 + 1


def test_per_image_vit_shape_flash_and_fused_mlp(cuda):
    """``lost --visualize`` on ViT-S/16: one image at a time on its bucket
    (512 x 384: 769 tokens sequence-padded to 896), row 1 bf16 at B*H = 1*6
    with the pad keys invalid, and row 4 at M = 1*896, D = 384, F = 1536;
    held to 2e-2 of the plain versions' scale, both launches counted."""
    q, k, v = _qkv(1, 6, 896, torch.bfloat16, cuda, seed=896)
    valid = torch.zeros(1, 896, dtype=torch.bool, device=cuda)
    valid[:, :769] = True
    n0, m0 = tfa.LAUNCHES["bfloat16"], tfm.LAUNCHES["bfloat16"]
    out, _lse = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    want, _ = tfa.flash_attention_plain(q, k, v, valid, 0.125)
    _close_to_scale(out, want, 2e-2)
    x, w_t, b = _fused_mlp_inputs(896, 384, 1536, cuda)
    got = tfm.fused_ln_dense_gelu_core(x, w_t, b)
    _close_to_scale(got, tfm.fused_ln_dense_gelu_plain(x, w_t, b, 1e-6), 2e-2)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["bfloat16"] == n0 + 1 and tfm.LAUNCHES["bfloat16"] == m0 + 1


def test_one_rank_nccl_data_parallel_step_equals_the_plain_step(cuda):
    """A one-rank NCCL group: the data-parallel train step (its gradients
    all-reduced through NCCL, ``parallel.mesh.average_gradients``) leaves
    resnet18's parameters and running statistics (bf16 step, 2 steps of 8
    images at 64 px) equal to the plain step's from the same state."""
    import socket

    import torch.distributed as dist

    from vipers_torch.core.registry import build_model
    from vipers_torch.parallel import mesh
    from vipers_torch.pruning import init_masks
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    spec = build_model("resnet18", num_classes=10)
    params = spec.init(torch.Generator().manual_seed(0))
    masks = init_masks(params, exclude=spec.prune_exclude)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 64, 64, 3, generator=g).to(cuda)
    y = torch.randint(0, 10, (8,), generator=g).to(cuda)
    step = make_train_step(10, compute_dtype=torch.bfloat16)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    states = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dp in (False, True):
            if dp:
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                        world_size=1, rank=0)
                assert mesh.active() and mesh.world() == 1
            st = create_train_state(spec, params, masks, OptimConfig(lr=0.1), 1, device=cuda)
            for _ in range(2):
                st, _ = step(st, (x, y))
            states.append({**{k: v.detach().clone() for k, v in st.params.items()},
                           **{k: v.clone() for k, v in st.batch_stats.items()}})
    finally:
        torch.backends.cudnn.deterministic = prev
        if dist.is_initialized():
            dist.destroy_process_group()
    assert states[0].keys() == states[1].keys()
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def _one_rank_layout_steps(cuda, axis, size):
    """vit_s_16 bf16 at ``size`` (224: T = 197 -> 256, the training kernels;
    384: T = 577 -> 640, the flash forward and backward; B = 8, 2 SGD
    steps, a 50% mask) through the ``axis`` layout of a one-rank NCCL group
    (``parallel.tp`` at k = 1: the block's collectives and
    bias-after-reduce; ``parallel.pp`` at S = 1: the microbatched forward
    and backward and the outer-gradient reduce) against the plain step
    from the same state. Returns (plain, layout) parameters and the
    layout's steps' launches of the attention kernels the size selects."""
    import socket

    import torch.distributed as dist

    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_model
    from vipers_torch.ops import attention_train as tat
    from vipers_torch.parallel import mesh
    from vipers_torch.parallel.pp import PipelineParallel, make_pp_train_step
    from vipers_torch.parallel.tp import TensorParallel
    from vipers_torch.pruning import init_masks, magnitude_prune
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    def launches():
        if size == 224:
            return tat.LAUNCHES[tat._launch_key("fwd", "f32", 64)]
        return tfa.LAUNCHES["bfloat16"] + tfa.BWD_LAUNCHES["bfloat16"]

    spec = build_model("vit_s_16", num_classes=10, image_size=(size, size))
    params = spec.init(torch.Generator().manual_seed(0))
    masks = magnitude_prune(params, init_masks(params, exclude=spec.prune_exclude), 0.5)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, size, size, 3, generator=g).to(cuda)
    y = torch.randint(0, 10, (8,), generator=g).to(cuda)
    ocfg = OptimConfig(lr=0.01, momentum=0.9)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = []
    try:
        for layout in (False, True):
            step = make_train_step(10, compute_dtype=torch.bfloat16)
            if layout:
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                        world_size=1, rank=0)
                mesh.make_grid(1)
                fam = family(spec)
                lay = (TensorParallel(spec, None, 0, 1) if axis == "model"
                       else PipelineParallel(spec, None, 0, 1, microbatch=4))
                params = fam.trees(lay.part(fam.state_dict(params)))[0]
            st = create_train_state(spec, params, masks, ocfg, 1, device=cuda)
            if layout:
                lay.wire(st.model)
                st.opt.sq_norm = lay.sq_norm
                if axis == "pipe":
                    step = make_pp_train_step(lay, 10, compute_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                n0 = launches()
            for _ in range(2):
                st, metrics = step(st, (x, y))
            assert bool(torch.isfinite(metrics["loss"]))
            out.append({k: v.detach().clone() for k, v in st.params.items()})
        torch.cuda.synchronize()
        n = launches() - n0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out[0], out[1], n


@pytest.mark.parametrize("size", [224, 384])
@pytest.mark.parametrize("axis", ["model", "pipe"], ids=["tensor_parallel", "pipeline"])
def test_one_rank_model_parallel_step_matches_the_plain_step(cuda, axis, size):
    """The one-rank form of ``train --model-parallel`` and
    ``--pipeline-parallel`` on the card (NCCL puts no two ranks on one
    card; ``chip_smoke.py`` phase 21 runs 2 gloo ranks): the parameters
    after 2 steps within the multi-process tolerance of the plain step's;
    at 224 the training attention kernels (rows 7-8) forward, at 384 the
    flash forward and backward (rows 1, 12-13: 2 calls a block, 3 kernels a
    backward counted once), 12 blocks x 2 steps (x 2 microbatches
    pipelined)."""
    plain, got, launches = _one_rank_layout_steps(cuda, axis, size)
    assert plain.keys() == got.keys()
    for k, v in plain.items():
        torch.testing.assert_close(got[k].float(), v.float(), rtol=5e-2, atol=3e-3)
    per_block = 1 if size == 224 else 2
    assert launches == 12 * 2 * per_block * (2 if axis == "pipe" else 1)
