"""vipers_torch.ops.attention_train against the JAX package on the CPU.

The JAX kernels run in interpret mode (VIPERS_FUSED_ATTN_INTERPRET=1, as
tests/test_attention_train.py runs them); the port's autograd Functions run
their plain versions for CPU tensors, forward and backward. Shapes are the
JAX tests': B=4, H=3, T=197 (padded to 256 inside both), hd=64, f32, with a
key mask; and vit_h_14's head dim 80 at B=2, H=2, T=257 (its 224x224 token
count, padded to 384 inside both). Tolerances are the JAX tests' own: out
2e-5, gradients 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.ops.attention_train as jat
from vipers_torch.ops import attention_train as tat

B, H, T, HD = 4, 3, 197, 64


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VIPERS_FUSED_ATTN_INTERPRET", "1")
    monkeypatch.delenv("VIPERS_FUSED_ATTN", raising=False)


def _inputs(seed, b=B, t=T, h=H, hd=HD):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, hd)).astype(np.float32) for _ in range(3))
    valid = rng.random((b, t)) > 0.15
    g = rng.normal(size=(b, h, t, hd)).astype(np.float32)
    return q, k, v, valid, g


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _check_against_jax(inputs, packed, masked):
    """The entry's forward and gradients against the JAX package's: out
    within 2e-5, each gradient within 5e-5."""
    q, k, v, valid, g = inputs
    jvalid = jnp.asarray(valid) if masked else None
    tvalid = torch.from_numpy(valid) if masked else None
    jg = jnp.asarray(g)
    if packed:
        qkv = np.stack([q, k, v])

        def jloss(x):
            return jnp.vdot(jat.attention_train_packed(x, valid=jvalid), jg)

        jout = jat.attention_train_packed(jnp.asarray(qkv), valid=jvalid)
        jgrad = jax.grad(jloss)(jnp.asarray(qkv))
        tqkv = torch.from_numpy(qkv).requires_grad_(True)
        tout = tat.attention_train_packed(tqkv, valid=tvalid)
        (tgrad,) = torch.autograd.grad(tout, tqkv, torch.from_numpy(g))
        pairs = [("dqkv", tgrad, jgrad)]
    else:
        def jloss(a, b_, c):
            return jnp.vdot(jat.attention_train(a, b_, c, valid=jvalid), jg)

        jq, jk, jv = map(jnp.asarray, (q, k, v))
        jout = jat.attention_train(jq, jk, jv, valid=jvalid)
        jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
        tq, tk, tv = (z.requires_grad_(True) for z in _t(q, k, v))
        tout = tat.attention_train(tq, tk, tv, valid=tvalid)
        tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
        pairs = list(zip(("dq", "dk", "dv"), tgrads, jgrads))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    for name, a, c in pairs:
        diff = float(np.abs(a.numpy() - np.asarray(c)).max())
        assert diff < 5e-5, (name, diff)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("masked", [True, False], ids=["key-mask", "all-valid"])
def test_forward_and_gradients_match_jax_kernels(packed, masked):
    """One kernel pair serves both entries: the packed entry hands the three
    slabs of one (3, B, H, T, hd) buffer to the same forward and backward
    the unpacked entry calls with three tensors."""
    _check_against_jax(_inputs(0 if masked else 1), packed, masked)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("masked", [True, False], ids=["key-mask", "all-valid"])
def test_hd80_forward_and_gradients_match_jax_kernels(packed, masked):
    """Head dim 80 (vit_h_14's 16 heads of 80) at T = 257, vit_h_14's
    224x224 token count: both packages pad to 384 inside, where the card's
    kernels take the two-pass forward and two key rounds."""
    _check_against_jax(_inputs(6 if masked else 7, b=2, t=257, h=2, hd=80), packed, masked)


def test_plain_backward_matches_pallas_bwd_on_the_same_residuals():
    """The port's plain backward against the JAX ``_bwd`` kernel (interpret)
    fed the JAX forward's own residuals at a padded T=256."""
    q, k, v, valid, g = _inputs(2, t=256)
    ok = jnp.asarray(valid)[:, None, :].astype(jnp.int8)
    scale = HD ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jat._fwd(jq, jk, jv, ok, scale, True)
    want = jat._bwd(jq, jk, jv, o, lse, jg, ok, scale, True)
    to, tlse = tat.attention_train_fwd(*_t(q, k, v), torch.from_numpy(valid), scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, :, 0], atol=2e-5, rtol=0)
    got = tat.attention_train_bwd(*_t(q, k, v, np.asarray(o), np.asarray(lse)[:, :, 0], g),
                                  torch.from_numpy(valid), scale)
    for a, c in zip(got, want):
        assert float(np.abs(a.numpy() - np.asarray(c)).max()) < 5e-5


def test_bf16_plain_matches_jax_kernel_in_bf16():
    """In bf16 the plain versions round where the Pallas kernel rounds
    (q*scale, P and dS in bf16, outputs in bf16): same inputs through both
    agree within a bf16 ulp of the output scale."""
    q, k, v, valid, g = _inputs(3, t=256)
    jvalid = jnp.asarray(valid)
    qkv16 = jnp.asarray(np.stack([q, k, v]), jnp.bfloat16)
    g16 = jnp.asarray(g, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda x: jat.attention_train_packed(x, valid=jvalid), qkv16)
    (jgrad,) = vjp(g16)
    tqkv = torch.from_numpy(np.array(qkv16.astype(jnp.float32))).bfloat16().requires_grad_(True)
    tout = tat.attention_train_packed(tqkv, valid=torch.from_numpy(valid))
    tg = torch.from_numpy(np.array(g16.astype(jnp.float32))).bfloat16()
    (tgrad,) = torch.autograd.grad(tout, tqkv, tg)
    for a, c in ((tout, jout), (tgrad, jgrad)):
        a = a.float().detach().numpy()
        c = np.asarray(c.astype(jnp.float32))
        assert np.abs(a - c).max() <= 2 ** -7 * np.abs(c).max(), np.abs(a - c).max()


def test_gates_match_jax():
    for t, hd in ((197, 64), (1024, 64), (1025, 64), (197, 65), (17, 64), (897, 32),
                  (257, 80), (785, 80)):
        assert tat.fused_attention_supported(t, hd) == jat.fused_attention_supported(t, hd)
    assert tat.MAX_T == jat.MAX_T
    assert tat.attention_train_enabled(torch.bfloat16)
    assert not tat.attention_train_enabled(torch.float32)


def test_rejections():
    ok = torch.zeros(3, 2, 1, 64, 64)
    with pytest.raises(ValueError, match="leading dim"):
        tat.attention_train_packed(ok[:2])
    big = torch.zeros(3, 1, 1, 1025, 64)
    with pytest.raises(ValueError, match="envelope"):
        tat.attention_train_packed(big)
    with pytest.raises(ValueError, match="envelope"):
        tat.attention_train(big[0], big[1], big[2])
    odd = torch.zeros(1, 1, 64, 60)
    with pytest.raises(ValueError, match="hd%8"):
        tat.attention_train(odd, odd, odd)


def test_cpu_runs_plain_and_counts_no_launch():
    q, k, v, valid, g = _inputs(4, b=2, t=128)
    before = dict(tat.LAUNCHES)
    x = torch.from_numpy(np.stack([q, k, v])).requires_grad_(True)
    out = tat.attention_train_packed(x, valid=torch.from_numpy(valid))
    out.backward(torch.from_numpy(g))
    want, _ = tat.attention_train_fwd_plain(*_t(q, k, v), torch.from_numpy(valid), HD ** -0.5)
    assert torch.equal(out.detach(), want)
    assert tat.LAUNCHES == before


def test_all_invalid_image_contract_at_t256():
    """An image whose keys are all invalid, at T = 256: its lse rounds to
    -1e9 in f32, so the forward is the uniform average of V and the
    backward's p = exp(s - lse) is 1 for every key (not 1/T). The port's
    plain versions meet that contract three ways: against the JAX kernels in
    interpret mode (f32 tolerances), against the average of V, and against
    the p = 1 backward written out in numpy. The CUDA kernels are held to
    these plain versions on the card."""
    q, k, v, valid, g = _inputs(5, b=2, t=256)
    valid[1] = False
    scale = HD ** -0.5
    ok = jnp.asarray(valid)[:, None, :].astype(jnp.int8)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jat._fwd(jq, jk, jv, ok, scale, True)
    want = jat._bwd(jq, jk, jv, o, lse, jg, ok, scale, True)
    tvalid = torch.from_numpy(valid)
    to, tlse = tat.attention_train_fwd(*_t(q, k, v), tvalid, scale)
    got = tat.attention_train_bwd(*_t(q, k, v), to, tlse, *_t(g), tvalid, scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse)[:, :, 0], atol=2e-5, rtol=0)
    for a, c in zip(got, want):
        assert float(np.abs(a.numpy() - np.asarray(c)).max()) < 5e-5

    assert np.all(tlse[1].numpy() == np.float32(-1e9))
    np.testing.assert_allclose(to[1].numpy(), np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                               v[1].shape), atol=2e-5, rtol=0)
    qs, o1, g1 = (q[1] * np.float32(scale)), to[1].numpy(), g[1]
    d = (g1 * o1).sum(-1, keepdims=True)
    ds = g1 @ v[1].transpose(0, 2, 1) - d  # (dP - D) * p with p = 1
    for a, c in zip(got, ((ds @ k[1]) * scale, ds.transpose(0, 2, 1) @ qs,
                          np.broadcast_to(g1.sum(axis=1, keepdims=True), g1.shape))):
        np.testing.assert_allclose(a[1].numpy(), c, atol=5e-4, rtol=1e-5)
