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


@pytest.mark.parametrize("d,f", [(96, 192), (384, 200), (1728, 6912)])
def test_fused_mlp_refuses_widths_outside_the_kernel_on_the_card(cuda, d, f):
    """The gate sets no width condition, as in the JAX package; on the card
    the wrapper refuses a width its kernel does not take, and launches
    nothing, while the same call on CPU tensors takes the plain version."""
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
