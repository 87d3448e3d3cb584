"""vipers_torch.ops.fused_mlp against the JAX package on the CPU.

The JAX kernel runs in interpret mode (VIPERS_FUSED_MLP_INTERPRET=1, as
tests/test_fused_mlp.py runs it); the port's wrapper runs its plain version
for CPU tensors. Tolerances are those of tests/test_fused_mlp.py: f32 rel
2e-3, bf16 0.05 of the output scale; the block wiring 0.02 of the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.ops.fused_mlp as jfm
import vipers_torch.models.vit as tvit
from vipers_torch.ops import fused_mlp as tfm

D, F = 384, 1536


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("VIPERS_FUSED_MLP_INTERPRET", "1")
    monkeypatch.delenv("VIPERS_FUSED_MLP", raising=False)


def _params(rng):
    g = (rng.normal(size=(D,)) * 0.3 + 1).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    W = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    bb = (rng.normal(size=(F,)) * 0.1).astype(np.float32)
    return g, b, W, bb


def _ref(x, g, b, W, bb, eps=1e-6):
    x = x.astype(np.float64)
    mu = x.mean(-1, keepdims=True)
    var = np.maximum((x * x).mean(-1, keepdims=True) - mu * mu, 0.0)
    y = (g * (x - mu) / np.sqrt(var + eps) + b) @ W + bb
    return 0.5 * y * (1 + np.tanh(np.sqrt(2 / np.pi) * (y + 0.044715 * y ** 3)))


def test_forward_matches_jax_bf16():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 256, D)).astype(np.float32)
    g, b, W, bb = _params(rng)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jfm.fused_ln_dense_gelu(
        xb, jnp.asarray(g), jnp.asarray(b), jnp.asarray(W, jnp.bfloat16),
        jnp.asarray(bb)).astype(jnp.float32))
    got = tfm.fused_ln_dense_gelu(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(g), torch.from_numpy(b),
        torch.from_numpy(W).bfloat16(), torch.from_numpy(bb)).float().numpy()
    ref = _ref(np.asarray(xb.astype(jnp.float32)), g, b, W, bb)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 0.05 * scale
    assert np.abs(got - want).max() < 0.05 * scale


def test_plain_matches_jax_kernel_f32():
    """The plain version's arithmetic (f32 inputs) against the JAX kernel's
    in interpret mode, at the JAX f32 test's relative tolerance."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 128, D)).astype(np.float32)
    g, b, W, bb = _params(rng)
    want = np.asarray(jfm.fused_ln_dense_gelu(*map(jnp.asarray, (x, g, b, W, bb))))
    w_eff_t, b_eff = tfm.fold_ln_affine(*map(torch.from_numpy, (g, b, W, bb)),
                                        torch.float32)
    got = tfm.fused_ln_dense_gelu_plain(
        torch.from_numpy(x).reshape(-1, D), w_eff_t, b_eff, 1e-6).reshape(2, 128, F)
    rel = np.max(np.abs(got.numpy() - want) / (np.abs(want) + 1e-3))
    assert rel < 2e-3


def test_gate_matches_jax_block_rule():
    for m in (64, 128, 130, 256, 384, 512, 896, 1000, 114688):
        assert tfm.pick_block_m(m) == jfm._pick_block_m(m)
    ok = torch.zeros(2, 64, D, dtype=torch.bfloat16)
    assert tfm.fused_supported(ok)
    assert not tfm.fused_supported(torch.zeros(2, 65, D, dtype=torch.bfloat16))
    assert not tfm.fused_supported(torch.zeros(2, 64, D))
    assert not tfm.fused_supported(ok, train=True)


def test_wrapper_rejects_non_bf16_and_counts_no_cpu_launch():
    x = torch.zeros(128, D)
    w_eff_t, b_eff = torch.zeros(F, D), torch.zeros(F)
    with pytest.raises(ValueError):
        tfm.fused_ln_dense_gelu_core(x, w_eff_t, b_eff)
    before = dict(tfm.LAUNCHES)
    tfm.fused_ln_dense_gelu_core(x.bfloat16(), w_eff_t.bfloat16(), b_eff)
    assert tfm.LAUNCHES == before


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    blk = tvit.EncoderBlock(D, 6, F)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.from_numpy(
                (rng.normal(size=tuple(p.shape)) * 0.05).astype(np.float32)))
        blk.ln_2.weight.add_(1.0)
    x = torch.from_numpy(rng.normal(size=(2, 64, D)).astype(np.float32))
    return blk.to(torch.bfloat16), x.bfloat16()


def test_encoder_block_fused_matches_unfused(monkeypatch):
    """The block takes the fused branch in bf16 at inference only, and its
    output matches the unfused LayerNorm -> Dense -> tanh-GELU sequence."""
    blk, x = _block_inputs(3)
    calls = {"n": 0}
    orig = tvit.fused_ln_dense_gelu

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tvit, "fused_ln_dense_gelu", spy)
    with torch.no_grad():
        out_f, _, _ = blk.eval()(x)
        assert calls["n"] == 1, "fused path did not engage"
        out_u, _, _ = blk.train()(x)
        assert calls["n"] == 1, "fused path engaged on a training forward"
    a, c = out_f.float().numpy(), out_u.float().numpy()
    assert np.abs(a - c).max() < 0.02 * max(np.abs(c).max(), 1.0)


def test_encoder_block_matches_jax_bf16():
    """The port's bf16 block (fused branch) against the JAX block (fused
    branch in interpret mode) on the same weights."""
    import jax

    import vipers.models.vit as jvit
    from vipers_torch.core.checkpoint import vit_state_dict_from_flax

    jblk = jvit.EncoderBlock(num_heads=6, mlp_dim=F)
    x = np.random.default_rng(4).normal(size=(2, 64, D)).astype(np.float32)
    v = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    vb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _, _ = jblk.apply(vb, xb, train=False)

    tblk = tvit.EncoderBlock(D, 6, F)
    sd = vit_state_dict_from_flax(
        {"encoder_layer_0": jax.tree.map(lambda a: np.asarray(a, np.float32), v["params"])})
    tblk.load_state_dict({k.split(".", 2)[2]: w for k, w in sd.items()})
    tblk = tblk.eval().to(torch.bfloat16)
    with torch.no_grad():
        got, _, _ = tblk(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    a = got.float().numpy()
    c = np.asarray(want.astype(jnp.float32))
    assert np.abs(a - c).max() < 0.02 * max(np.abs(c).max(), 1.0)


def test_backward_matches_jax_vjp_f32():
    """The port's explicit backward against the JAX package's custom-VJP
    backward on the same f32 residuals and cotangent, at
    tests/test_fused_mlp.py's elementwise relative 5e-3."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(128, D)).astype(np.float32)
    g, b, W, bb = _params(rng)
    w_eff_t, b_eff = tfm.fold_ln_affine(*map(torch.from_numpy, (g, b, W, bb)), torch.float32)
    dy = (rng.normal(size=(128, F)) * 0.01).astype(np.float32)
    want = jfm._make_bwd()[1](1e-6, (jnp.asarray(x), jnp.asarray(w_eff_t.t().numpy()),
                                     jnp.asarray(b_eff.numpy())), jnp.asarray(dy))
    got = tfm.fused_ln_dense_gelu_bwd(torch.from_numpy(x), w_eff_t, b_eff, 1e-6,
                                      torch.from_numpy(dy))
    got = (got[0], got[1].t(), got[2])
    for name, a, c in zip(("dx", "dW_eff", "db_eff"), got, want):
        rel = float(np.max(np.abs(a.numpy() - np.asarray(c)) / (np.abs(np.asarray(c)) + 1e-4)))
        assert rel < 5e-3, (name, rel)


def test_autograd_backward_matches_jax_vjp_bf16():
    """Gradients through the port's fused Function (its explicit backward,
    run here on the CPU) against ``jax.grad`` of the JAX kernel (interpret
    mode, its custom VJP) in bf16 on the same numpy inputs, for x, the
    LayerNorm scale and bias and the Dense kernel and bias (these reach the
    kernel through the fold in both packages). Both round dW_eff and the
    gradients to bf16 after f32 sums taken in another order, so an element
    may differ by a bf16 step: the tolerance is 2^-7 of each gradient's
    largest magnitude (both sit 0.0039 from an f32 autodiff reference at a
    scale of 0.65 for the kernel)."""
    import jax

    rng = np.random.default_rng(2)
    x = rng.normal(size=(128, D)).astype(np.float32)
    g, b, W, bb = _params(rng)
    xb = jnp.asarray(x, jnp.bfloat16)
    Wb = jnp.asarray(W, jnp.bfloat16)

    def loss(*a):
        return (jfm.fused_ln_dense_gelu(*a).astype(jnp.float32) * 0.01).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        xb, jnp.asarray(g), jnp.asarray(b), Wb, jnp.asarray(bb))
    ins = [torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
           torch.from_numpy(g), torch.from_numpy(b),
           torch.from_numpy(np.array(Wb.astype(jnp.float32))).bfloat16(),
           torch.from_numpy(bb)]
    ins = [z.requires_grad_(True) for z in ins]
    got = torch.autograd.grad((tfm.fused_ln_dense_gelu(*ins).float() * 0.01).sum(), ins)
    for name, a, c in zip("x g b W bb".split(), got, want):
        a, c = a.float().numpy(), np.asarray(c.astype(jnp.float32))
        assert a.shape == c.shape, name
        assert np.abs(a - c).max() <= 2 ** -7 * np.abs(c).max(), (name, np.abs(a - c).max())


def test_port_tool_runs_on_the_cpu(capsys):
    """The port of tools/bench_fused_mlp.py at a tiny M on the plain
    versions: one line each for the sequence and the fused path."""
    from vipers_torch.tools import bench_fused_mlp

    res = bench_fused_mlp.main(["--device", "cpu", "--m", "256", "--iters", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu (plain versions)"
    assert [ln.split()[0] for ln in lines[1:]] == ["seq", "fused"]
    assert set(res["ms"]) == {"seq", "fused"} and all(v > 0 for v in res["ms"].values())
