"""vipers_torch.ops.flash_attention against the JAX package on the CPU.

The port's wrapper runs its plain PyTorch version for CPU tensors; the JAX
side runs its Pallas kernel in interpret mode (as tests/test_flash_attention.py
does) and its einsum reference. Tolerances are the JAX tests': einsum
fallback 1e-5/1e-4, interpret kernel 2e-5/1e-3 (lse 1e-4).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipers_torch.ops import flash_attention as tfa

# vipers.ops re-exports the function under the module's name
jfa = importlib.import_module("vipers.ops.flash_attention")


def _rand(b, h, t, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _valid(b, t, seed, keep=0.7):
    v = np.random.default_rng(seed).random((b, t)) < keep
    v[:, 0] = True  # CLS is always valid on the LOST path
    return v


def test_attention_reference_matches_jax():
    q, k, v = _rand(2, 3, 40, 64, seed=0)
    valid = _valid(2, 40, seed=1)
    want_o, want_p = jfa.attention_reference(
        *map(jnp.asarray, (q, k, v)), mask=jnp.asarray(valid)[:, None, None, :])
    got_o, got_p = tfa.attention_reference(
        *map(torch.from_numpy, (q, k, v)),
        mask=torch.from_numpy(valid)[:, None, None, :])
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "key-mask"])
def test_plain_matches_pallas_kernel_interpret(masked):
    """O and lse of the port's kernel contract (plain version on the CPU)
    equal the JAX kernel's dataflow, pad-query rows included (both use
    key-mask semantics)."""
    q, k, v = _rand(1, 2, 256, 64, seed=3)
    valid = _valid(1, 256, seed=4) if masked else np.ones((1, 256), bool)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)),
                                          jnp.asarray(valid), scale, 128, 128)
    got_o, got_lse = tfa.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid), scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=1e-4)


def test_plain_all_invalid_image_matches_pallas_kernel_interpret():
    """An image whose keys are all invalid: every score is -1e9, so the JAX
    kernel's online softmax gives each key p = 1 and divides by l = T: O is
    the uniform average of V and lse = -1e9 + log(T). The plain version (the
    kernel's contract on the card) must do the same, not sum V."""
    q, k, v = _rand(2, 2, 256, 64, seed=9)
    valid = _valid(2, 256, seed=10)
    valid[1] = False
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)),
                                          jnp.asarray(valid), scale, 128, 128)
    got_o, got_lse = tfa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid), scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_o[1].numpy(), np.broadcast_to(v[1].mean(axis=1, keepdims=True),
                                                                 v[1].shape), atol=1e-5)


def test_flash_matches_einsum_on_valid_rows():
    """The flash route and the einsum route of the model agree on every
    valid query row at a ragged (non-64-multiple) length."""
    q, k, v = _rand(2, 2, 200, 64, seed=5)
    valid = _valid(2, 200, seed=6)
    tq, tk, tv, tm = (*map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid))
    got = tfa.flash_attention(tq, tk, tv, valid=tm)
    want, _ = tfa.attention_reference(tq, tk, tv, mask=tm[:, None, None, :])
    for b in range(2):
        np.testing.assert_allclose(got[b][:, valid[b]].numpy(),
                                   want[b][:, valid[b]].numpy(), atol=1e-5, rtol=1e-4)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    q, k, v = map(torch.from_numpy, _rand(1, 1, 64, 64, seed=7))
    before = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v)
    want, want_lse = tfa.flash_attention_plain(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert tfa.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "mask"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Head dims other than 64 are refused on the card only
    (``test_torch_kernels_cuda.py``): the plain version takes any."""
    q, k, v = map(torch.from_numpy, _rand(1, 2, 16, 64, seed=8))
    valid = torch.ones(1, 16, dtype=torch.bool)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    if bad == "mask":
        valid = torch.ones(1, 15, dtype=torch.bool)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, v, valid)


@pytest.mark.parametrize("hd", [32, 80])
def test_wrapper_at_other_head_dims_matches_jax(hd):
    """CPU tensors at head dims the card's kernel does not take run the plain
    version, which matches the JAX package's ``flash_attention`` (its einsum
    fallback off the TPU) at the einsum tolerance on the valid query rows, and
    its Pallas kernel in interpret mode, pad rows and lse included."""
    q, k, v = _rand(2, 2, 256, hd, seed=hd)
    valid = _valid(2, 256, seed=hd + 1)
    scale = hd ** -0.5
    got_o, got_lse = tfa.flash_attention_fwd(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(valid), scale)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), valid=jnp.asarray(valid))
    for b in range(2):
        np.testing.assert_allclose(got_o[b][:, valid[b]].numpy(),
                                   np.asarray(want)[b][:, valid[b]], atol=1e-5, rtol=1e-4)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)),
                                          jnp.asarray(valid), scale, 128, 128)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-4, rtol=1e-4)


def test_alignment_check_rejects_an_offset_view():
    """The card's wrappers refuse, rather than copy, a tensor whose base is
    not 16-byte aligned (TMA reads from aligned addresses only): a view one
    element into its storage fails the check, the storage itself passes."""
    base = torch.zeros(1 + 2 * 16 * 64)
    tfa._check_aligned(base)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_aligned(base[1:].view(1, 2, 16, 64))


def test_flash_min_t_matches_jax():
    assert tfa.flash_min_t() == jfa.FLASH_MIN_T == 512


def test_autograd_backward_matches_jax_custom_vjp():
    """The port's flash Function backward (its explicit recomputation VJP,
    run here on the CPU) against the JAX package's ``_flash_vjp_bwd`` on the
    same residuals, f32, at the JAX test's 2e-5."""
    import jax

    rng = np.random.default_rng(0)
    b, h, t, hd = 2, 3, 24, 64
    q, k, v, cot = (rng.normal(size=(b, h, t, hd)).astype(np.float32) for _ in range(4))
    valid = rng.random((b, t)) > 0.2
    scale = hd ** -0.5
    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    logits = jnp.where(jvalid[:, None, None, :],
                       jnp.einsum("bhqd,bhkd->bhqk", jq * scale, jk), jfa.NEG_INF)
    lse = jax.scipy.special.logsumexp(logits, axis=-1)
    out, _ = jfa.attention_reference(jq, jk, jv, scale=scale, mask=jvalid[:, None, None, :])
    want = jfa._flash_vjp_bwd(scale, 128, 128, (jq, jk, jv, jvalid, out, lse),
                              jnp.asarray(cot))[:3]
    tq, tk, tv = (torch.from_numpy(z).requires_grad_(True) for z in (q, k, v))
    got_out = tfa.flash_attention(tq, tk, tv, valid=torch.from_numpy(valid), scale=scale)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(cot))
    direct = tfa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v, valid, np.array(out), np.array(lse), cot)), scale)
    for a, d, c in zip(got, direct, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-5)
        np.testing.assert_allclose(d.numpy(), np.asarray(c), atol=2e-5)
