"""The flash attention backward of vipers_torch against the JAX side on the CPU.

On the TPU, differentiating the product path (``flash_attention_official``)
runs the library's two Pallas backward kernels, ``_flash_attention_bwd_dkv``
and ``_flash_attention_bwd_dq``; the port's ``flash_attention_bwd`` replaces
them with ``csrc/flash_attention_bwd.cu`` and, for CPU tensors, runs its
plain version. That plain version is held here against the library's own
oracle, ``jax.grad`` of ``mha_reference_no_custom_vjp`` with the repo's
segment ids (``valid_to_segment_ids``), under the library's contract: zero
cotangents on pad-query rows. ``mha_reference_bwd`` raises for segment ids,
so the oracle is the variant without a custom VJP. It is also held against
the JAX package's ``_flash_vjp_bwd`` with an image whose keys are all
invalid and cotangents on every row. f32, atol 2e-5 (the JAX flash tests'
interpret-kernel tolerance).

On the card the f32 kernel runs every product as three TF32 products
(3xTF32: big = tf32(x), small = tf32(x - big), small.big + big.small +
big.big). A plain-torch emulation of that arithmetic is held here against
the same oracles at the kernel's tolerance, 1e-4 of each gradient's scale,
and one TF32 product a product is shown to miss it: the reason for three.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as ofa

from vipers_torch.ops import flash_attention as tfa

# vipers.ops re-exports the function under the module's name
jfa = importlib.import_module("vipers.ops.flash_attention")

HD = 64
SCALE = HD ** -0.5


def _inputs(b, h, t, seed, all_invalid=False):
    """q, k, v and a cotangent (B, H, T, 64) f32, a (B, T) key mask with
    about 20% pad keys (key 0 always valid), from a seeded numpy generator;
    with ``all_invalid`` the last image has no valid key."""
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.normal(size=(b, h, t, HD)).astype(np.float32) for _ in range(4))
    valid = rng.random((b, t)) > 0.2
    valid[:, 0] = True
    if all_invalid:
        valid[-1] = False
    return q, k, v, cot, valid


def _residuals(q, k, v, valid):
    """The forward's out and lse from the port's plain version (f32)."""
    out, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v, valid)), scale=SCALE)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("t", [40, 200, 640])
def test_plain_backward_matches_library_oracle(t):
    """dq, dk, dv of the plain backward against ``jax.grad`` of the
    library's reference with segment ids, cotangents zeroed on pad-query
    rows (on those rows the two differ by design: segment ids make pad
    queries attend pad keys, the -1e9 mask makes them attend valid keys)."""
    b, h = (2, 3) if t < 640 else (1, 2)
    q, k, v, cot, valid = _inputs(b, h, t, seed=t)
    cot = cot * valid[:, None, :, None]
    out, lse = _residuals(q, k, v, valid)

    seg = jfa.valid_to_segment_ids(jnp.asarray(valid))

    def loss(q, k, v):
        o = ofa.mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=SCALE)
        return jnp.sum(o * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, valid, out, lse, cot)), SCALE)
    for name, a, c in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-5, err_msg=f"d{name}")


def test_plain_backward_all_invalid_image_matches_jax_vjp():
    """With cotangents on every row and one image whose keys are all invalid
    (its lse rounds to -1e9, so p = 1 on each of its t keys), the plain
    backward equals the JAX package's ``_flash_vjp_bwd`` on the same
    residuals."""
    q, k, v, cot, valid = _inputs(3, 2, 72, seed=5, all_invalid=True)
    out, lse = _residuals(q, k, v, valid)
    assert np.all(lse[-1] == np.float32(-1e9))
    want = jfa._flash_vjp_bwd(SCALE, 128, 128, tuple(map(jnp.asarray, (q, k, v, valid, out, lse))),
                              jnp.asarray(cot))[:3]
    got = tfa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, valid, out, lse, cot)), SCALE)
    for name, a, c in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-5, err_msg=f"d{name}")
    assert np.abs(got[1][-1].numpy()).max() > 0  # the all-invalid image has gradients


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_backward_runs_plain_and_counts_no_launch(dtype):
    """CPU tensors take the plain version, bit for bit, and launch nothing
    (with and without a key mask)."""
    q, k, v, cot, valid = _inputs(2, 2, 48, seed=7)
    out, lse = _residuals(q, k, v, valid)
    args = [torch.from_numpy(z).to(dtype) for z in (q, k, v)]
    before = dict(tfa.BWD_LAUNCHES)
    for mask in (torch.from_numpy(valid), None):
        o, g = (torch.from_numpy(z).to(dtype) for z in (out, cot))
        got = tfa.flash_attention_bwd(*args, mask, o, torch.from_numpy(lse), g, SCALE)
        want = tfa.flash_attention_bwd_plain(*args, mask, o, torch.from_numpy(lse), g, SCALE)
        for a, c in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, c)
    assert tfa.BWD_LAUNCHES == before


def _bad(case):
    q, k, v, cot, valid = (torch.from_numpy(z) for z in _inputs(2, 2, 16, seed=9))
    out, lse = (torch.from_numpy(z) for z in _residuals(*(z.numpy() for z in (q, k, v, valid))))
    args = dict(q=q, k=k, v=v, valid=valid, out=out, lse=lse, g=cot)
    if case == "head-dim":
        for name in ("q", "k", "v", "out", "g"):
            args[name] = args[name][..., :32]
    elif case == "mixed-dtype":
        args["g"] = cot.to(torch.bfloat16)
    elif case == "out-shape":
        args["out"] = out[:, :, :8]
    elif case == "kv-shape":
        args["k"] = k[:, :1]
    elif case == "lse-shape":
        args["lse"] = lse[..., None]
    elif case == "lse-dtype":
        args["lse"] = lse.double()
    return args


@pytest.mark.parametrize("case", ["head-dim", "mixed-dtype", "out-shape", "kv-shape",
                                  "lse-shape", "lse-dtype"])
def test_backward_rejects_what_the_kernel_does_not_take(case):
    args = _bad(case)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(args["q"], args["k"], args["v"], args["valid"], args["out"],
                                args["lse"], args["g"], SCALE)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude's bit pattern, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, terms):
    """a @ b in f32 from TF32 operands: the big parts alone (terms 1) or,
    with the small parts x - tf32(x) rounded to TF32, small.big + big.small
    + big.big (terms 3). TF32 x TF32 is exact in f32, so each product is a
    plain f32 matmul."""
    ab, bb = _tf32(a), _tf32(b)
    if terms == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _bwd_tf32(q, k, v, valid, out, lse, g, scale, terms):
    """The f32 kernel's backward with its products in TF32 (``_mm_tf32``):
    scores scaled after the product, -1e9 on invalid keys, p = exp(s -
    lse), D = rowsum(dO * out), dv = p^T dO, dp = dO v^T, ds = p (dp - D),
    dq = ds k scale, dk = ds^T q scale; exponentials, D and ds in f32."""
    q, k, v, out, g, lse = (torch.from_numpy(z) for z in (q, k, v, out, g, lse))
    s = _mm_tf32(q, k.transpose(-1, -2), terms) * scale
    s = torch.where(torch.from_numpy(valid)[:, None, None, :], s, torch.tensor(-1e9))
    p = torch.exp(s - lse[..., None])
    dv = _mm_tf32(p.transpose(-1, -2), g, terms)
    dp = _mm_tf32(g, v.transpose(-1, -2), terms)
    ds = p * (dp - (g * out).sum(-1)[..., None])
    dq = _mm_tf32(ds, k, terms) * scale
    dk = _mm_tf32(ds.transpose(-1, -2), q, terms) * scale
    return dq.numpy(), dk.numpy(), dv.numpy()


def _worst_share(got, want, t):
    """The worst error of (dq, dk, dv) as a share of each gradient's scale;
    at t = 1 (a constant softmax: the exact dq and dk are 0) dq and dk as a
    share of dv's scale."""
    dv_scale = np.abs(np.asarray(want[2])).max()
    shares = []
    for a, c in zip(got, want):
        c = np.asarray(c)
        scale = dv_scale if t == 1 else np.abs(c).max()
        shares.append(np.abs(a - c).max() / scale)
    return max(shares)


def _tf32_inputs(t, seed):
    """(2, 3) heads below t = 577, (1, 2) from there; ragged keys and an
    image whose keys are all invalid; the forward's residuals."""
    b, h = (2, 3) if t < 577 else (1, 2)
    q, k, v, cot, valid = _inputs(b, h, t, seed=seed, all_invalid=b > 1)
    out, lse = _residuals(q, k, v, valid)
    return q, k, v, cot, valid, out, lse


@pytest.mark.parametrize("t", [1, 64, 129, 577, 640])
def test_tf32x3_backward_matches_library_oracle(t):
    """The 3xTF32 emulation against ``jax.grad`` of the library's reference
    with segment ids, cotangents zeroed on pad-query rows (the library's
    contract), within 1e-4 of each gradient's scale."""
    q, k, v, cot, valid, out, lse = _tf32_inputs(t, seed=100 + t)
    cot = cot * valid[:, None, :, None]
    seg = jfa.valid_to_segment_ids(jnp.asarray(valid))

    def loss(q, k, v):
        o = ofa.mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=SCALE)
        return jnp.sum(o * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _bwd_tf32(q, k, v, valid, out, lse, cot, SCALE, terms=3)
    assert _worst_share(got, want, t) <= 1e-4


@pytest.mark.parametrize("t", [1, 64, 129, 577, 640])
def test_tf32x3_backward_matches_jax_vjp_on_every_row(t):
    """The 3xTF32 emulation against the JAX package's ``_flash_vjp_bwd``
    with cotangents on every row and (below t = 577) an image whose keys are
    all invalid, within 1e-4 of each gradient's scale."""
    q, k, v, cot, valid, out, lse = _tf32_inputs(t, seed=200 + t)
    want = jfa._flash_vjp_bwd(SCALE, 128, 128, tuple(map(jnp.asarray, (q, k, v, valid, out, lse))),
                              jnp.asarray(cot))[:3]
    got = _bwd_tf32(q, k, v, valid, out, lse, cot, SCALE, terms=3)
    assert _worst_share(got, want, t) <= 1e-4


def test_tf32x1_backward_misses_the_tolerance():
    """One TF32 product a product misses 1e-4 of a gradient's scale at t =
    640 where three stay inside it: why the kernel takes three."""
    q, k, v, cot, valid, out, lse = _tf32_inputs(640, seed=300)
    want = jfa._flash_vjp_bwd(SCALE, 128, 128, tuple(map(jnp.asarray, (q, k, v, valid, out, lse))),
                              jnp.asarray(cot))[:3]
    one = _worst_share(_bwd_tf32(q, k, v, valid, out, lse, cot, SCALE, terms=1), want, 640)
    three = _worst_share(_bwd_tf32(q, k, v, valid, out, lse, cot, SCALE, terms=3), want, 640)
    assert three <= 1e-4 < one, (three, one)
