"""vipers_torch's packed token-major attention route against the JAX package
on the CPU: the stripe permutation and support matrix, the pack/unpack
layout helpers, the plain version against the Pallas ``_packed_fwd`` kernel
in interpret mode (f32 atol 1e-4, bf16 within 2e-2 of the output scale),
the autograd backward against ``jax.grad`` through ``_packed_flash`` (f32
atol 2e-3, ``tests/test_flash_packed.py``'s tolerances), and the port's
ViT under ``VIPERS_PACKED_ATTENTION=1`` against the JAX ViT under the same
variable (rtol/atol 2e-4)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vit as jvit
import vipers_torch.models.vit as tvit
import vipers_torch.ops.flash_attention as tfa
from vipers_torch.core.checkpoint import vit_state_dict_from_flax

# vipers.ops re-exports a function of this name, so import the module itself
jfa = importlib.import_module("vipers.ops.flash_attention")

B, T, H, HD = 2, 256, 4, 64
D = H * HD


def _inputs(seed, dtype=np.float32, t=T):
    """Packed qkv and a key mask with 200 valid keys on the second image."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, t, 3 * D)).astype(np.float32)
    valid = np.ones((B, t), bool)
    valid[1, 200:] = False
    g = rng.normal(size=(B, t, D)).astype(np.float32)
    return qkv, valid, g


@pytest.mark.parametrize("d,heads", [(384, 6), (128, 2), (768, 12), (1280, 16), (192, 3)])
def test_permutation_and_support_match_jax(d, heads):
    assert tfa.packed_layout_supported(d, heads) == jfa.packed_layout_supported(d, heads)
    if jfa.packed_layout_supported(d, heads):
        np.testing.assert_array_equal(tfa.packed_qkv_permutation(d, heads),
                                      np.asarray(jfa.packed_qkv_permutation(d, heads)))
    else:
        with pytest.raises(ValueError, match="no packed layout"):
            tfa.packed_qkv_permutation(d, heads)


def test_pack_and_unpack_match_jax():
    qkv, _, _ = _inputs(0)
    got = tfa._unpack_bhtd(torch.from_numpy(qkv), H)
    want = jfa._unpack_bhtd(jnp.asarray(qkv), H)
    for a, c in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    np.testing.assert_array_equal(tfa._pack_bhtd(*got, H).numpy(), qkv)
    np.testing.assert_array_equal(
        np.asarray(jfa._pack_bhtd(*want, H)), tfa._pack_bhtd(*got, H).numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_packed_kernel(dtype):
    """The plain version against the TPU kernel itself in interpret mode,
    on the same inputs (bf16: rounded once, fed to both)."""
    qkv, valid, _ = _inputs(1)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jqkv = jnp.asarray(qkv, jdt)
    want = np.asarray(jfa._packed_flash(jqkv, jnp.asarray(valid), 0.125, H, 128, 128, True)
                      .astype(jnp.float32))
    tqkv = torch.from_numpy(np.array(jqkv.astype(jnp.float32)))
    if dtype == "bf16":
        tqkv = tqkv.bfloat16()
    got = tfa.flash_attention_packed_plain(tqkv, torch.from_numpy(valid), H, 0.125)
    assert got.dtype == tqkv.dtype and got.shape == (B, T, D)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _packed_grads(qkv, valid, g):
    """(port, JAX) gradients of <out, g> in qkv: the port's autograd
    Function (plain forward on the CPU, the einsum-recompute backward) and
    jax.grad through the interpret-mode ``_packed_flash`` and its VJP."""
    jvalid, jg = jnp.asarray(valid), jnp.asarray(g)

    def jloss(x):
        return jnp.vdot(jfa._packed_flash(x, jvalid, 0.125, H, 128, 128, True), jg)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = tfa.flash_attention_packed(x, torch.from_numpy(valid), num_heads=H, scale=0.125)
    (got,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    return got.numpy(), want


def test_autograd_backward_matches_jax_grad():
    """Gradient of <out, g> through the port's autograd Function (plain
    forward on the CPU, the einsum-recompute backward with p normalized by
    its row sum, as ``_packed_vjp_bwd`` computes it) against jax.grad
    through the interpret-mode ``_packed_flash`` and its custom VJP, on
    200 valid keys of 256 on the second image."""
    got, want = _packed_grads(*_inputs(2))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_autograd_backward_all_invalid_image_matches_jax_grad():
    """An image whose keys are all invalid: JAX's backward normalizes p
    explicitly, so p = 1/T on every key there. A p taken from the logsumexp
    of its -1e9 scores (which rounds to -1e9) would be 1 on every key and
    give T times the gradient. Both images held at atol 2e-3."""
    qkv, valid, g = _inputs(5)
    valid[1] = False
    got, want = _packed_grads(qkv, valid, g)
    assert np.abs(want[1]).max() > 0.1  # the all-invalid image has a gradient
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_wrapper_pads_to_128_and_matches_the_jax_wrapper():
    """T = 200 pads to 256 inside and slices back; off the TPU the JAX
    wrapper runs its einsum reference, the same function."""
    qkv, valid, _ = _inputs(3, t=200)
    want = np.asarray(jfa.flash_attention_packed(jnp.asarray(qkv), jnp.asarray(valid),
                                                 num_heads=H))
    before = dict(tfa.PACKED_LAUNCHES)
    got = tfa.flash_attention_packed(torch.from_numpy(qkv), torch.from_numpy(valid),
                                     num_heads=H)
    assert got.shape == (B, 200, D) and tfa.PACKED_LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_rejections():
    with pytest.raises(ValueError, match="no packed layout"):
        tfa.flash_attention_packed_fwd(torch.zeros(1, 8, 3 * 192), None, 3, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_packed_fwd(torch.zeros(1, 8, 3 * 128, dtype=torch.float64),
                                       None, 2, 0.1)
    with pytest.raises(ValueError, match="valid must be"):
        tfa.flash_attention_packed_fwd(torch.zeros(1, 8, 3 * 128), torch.ones(1, 7).bool(),
                                       2, 0.1)


def test_vit_packed_route_matches_jax(monkeypatch):
    """2 layers, D=128, 2 heads, 384x384 -> 577 tokens (>= 512, so the
    flash gate is open): with VIPERS_PACKED_ATTENTION=1 both packages take
    the packed route; the port's runs the permuted projection and the
    packed Function."""
    cfg = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
               num_classes=10)
    image = (384, 384)
    jspec = jvit._build("tiny", jvit.ViTConfig(**cfg), image)
    x = np.random.default_rng(0).normal(size=(1, *image, 3)).astype(np.float32)
    variables = jspec.module.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    model = tvit._build("tiny", tvit.ViTConfig(**cfg), image).module()
    model.load_state_dict(vit_state_dict_from_flax(params))
    model.eval()
    monkeypatch.setenv("VIPERS_PACKED_ATTENTION", "1")
    monkeypatch.delenv("VIPERS_FLASH_MIN_T", raising=False)
    calls = []
    real = tvit.flash_attention_packed
    monkeypatch.setattr(tvit, "flash_attention_packed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    logits_j, aux_j = jspec.module.apply(variables, jnp.asarray(x), train=False,
                                         need_attn=False)
    with torch.no_grad():
        logits_t, aux_t = model(torch.from_numpy(x), need_attn=False)
    assert len(calls) == 2
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(aux_t["qkv_input"].numpy(), np.asarray(aux_j["qkv_input"]),
                               rtol=2e-4, atol=2e-4)
