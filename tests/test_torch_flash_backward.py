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
The f32 forward kernels (flash and packed, ``attention_tile.cuh``'s f32
tile) run the same 3xTF32 products; an emulation in the kernel's order
(32-key stages, the running max and sum in log2 units, P split as it
stands) is held against the JAX package's Pallas ``_flash_fwd`` and
``_packed_fwd`` in interpret mode at the forward's tolerance (atol 1e-5,
rtol 1e-4; lse 1e-4), and one TF32 product a product misses it at the LOST
shape.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
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


@pytest.mark.parametrize("hd", [32, 80])
def test_backward_at_other_head_dims_matches_library_oracle(hd):
    """The wrapper on CPU tensors at head dims the card's kernel does not
    take: the plain backward against ``jax.grad`` of the library's reference
    with segment ids, pad-query cotangents zeroed, at atol 2e-5."""
    rng = np.random.default_rng(hd)
    q, k, v, cot = (rng.normal(size=(2, 2, 72, hd)).astype(np.float32) for _ in range(4))
    valid = rng.random((2, 72)) > 0.2
    valid[:, 0] = True
    cot = cot * valid[:, None, :, None]
    scale = hd ** -0.5
    out, lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v, valid)), scale=scale)
    seg = jfa.valid_to_segment_ids(jnp.asarray(valid))

    def loss(q, k, v):
        o = ofa.mha_reference_no_custom_vjp(q, k, v, segment_ids=seg, sm_scale=scale)
        return jnp.sum(o * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = tfa.flash_attention_bwd(*map(torch.from_numpy, (q, k, v, valid)), out, lse,
                                  torch.from_numpy(cot), scale)
    for name, a, c in zip("qkv", got, want):
        assert a.shape[-1] == hd
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
    if case == "mixed-dtype":
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


@pytest.mark.parametrize("case", ["mixed-dtype", "out-shape", "kv-shape",
                                  "lse-shape", "lse-dtype"])
def test_backward_rejects_what_the_kernel_does_not_take(case):
    """Head dims other than 64 are refused on the card only
    (``test_torch_kernels_cuda.py``): the plain version takes any."""
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


LOG2E = np.float32(1.4426950408889634)
NEG2 = np.float32(-1e9) * LOG2E  # the mask in log2 units


def _fwd_tf32(q, k, v, valid, scale, terms):
    """The f32 forward kernel's arithmetic with its products in TF32
    (``_mm_tf32``), in its order: keys in stages of 32; per stage the raw
    scores s = q k^T, in log2 units x = s scale log2(e), -1e9 log2(e) on
    invalid keys; the running max m (from the mask value) and sum l, alpha =
    exp2(m_old - m), p = exp2(x - m); O = (O + the last stage's P V) alpha,
    this stage's P V from p as it stands. The end: l_safe = max(l, 1e-20),
    out = O / l_safe, lse = m ln 2 + log(l_safe), exactly -1e9 +
    log(l_safe) where m never left the mask value. numpy in and out."""
    q, k, v = (torch.from_numpy(np.ascontiguousarray(z)) for z in (q, k, v))
    ok = torch.from_numpy(valid)[:, None, None, :]
    c = np.float32(scale) * LOG2E
    m = torch.full(q.shape[:3], float(NEG2))
    l = torch.zeros(q.shape[:3])
    o, pv = torch.zeros(q.shape), torch.zeros(q.shape)
    t = q.shape[2]
    for k0 in range(0, t, 32):
        keys = slice(k0, min(t, k0 + 32))
        s = _mm_tf32(q, k[:, :, keys].transpose(-1, -2), terms)
        x = torch.where(ok[..., keys], s * c, torch.tensor(NEG2))
        mx = torch.maximum(m, x.amax(-1))
        al = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * al + p.sum(-1)
        o = (o + pv) * al[..., None]
        pv = _mm_tf32(p, v[:, :, keys], terms)
        m = mx
    l = torch.clamp(l, min=1e-20)
    lse = torch.where(m == float(NEG2), torch.tensor(-1e9), m * np.float32(np.log(2))) + torch.log(l)
    return ((o + pv) / l[..., None]).numpy(), lse.numpy()


def _flash_fwd_interpret(q, k, v, valid):
    """The JAX package's Pallas forward in interpret mode: (out, lse)."""
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), jnp.asarray(valid), SCALE, 128,
                                  128)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("t", [64, 256, 896])
def test_tf32x3_forward_matches_pallas_kernel_interpret(t):
    """The 3xTF32 emulation of the f32 forward kernel against the Pallas
    ``_flash_fwd`` in interpret mode, with ragged keys and an image whose
    keys are all invalid (its rows the uniform average of v, lse -1e9 +
    log(t)): out within atol 1e-5 / rtol 1e-4, lse within 1e-4."""
    b, h = (2, 3) if t < 896 else (2, 2)
    q, k, v, _, valid = _inputs(b, h, t, seed=400 + t, all_invalid=True)
    want, want_lse = _flash_fwd_interpret(q, k, v, valid)
    got, got_lse = _fwd_tf32(q, k, v, valid, SCALE, terms=3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_lse[-1], np.float32(-1e9) + np.log(t), atol=0, rtol=1e-6)


@pytest.mark.parametrize("t", [64, 256, 896])
def test_tf32x3_packed_forward_matches_pallas_kernel_interpret(t):
    """The same emulation on the packed layout (4 heads in two head-pair
    stripes, unpacked and packed back by the port's helpers) against the
    Pallas ``_packed_fwd`` in interpret mode: within atol 1e-5 / rtol
    1e-4."""
    b, heads = 2, 4
    rng = np.random.default_rng(600 + t)
    qkv = rng.normal(size=(b, t, 3 * heads * HD)).astype(np.float32)
    valid = rng.random((b, t)) > 0.2
    valid[:, 0] = True
    valid[-1] = False
    want = np.asarray(jfa._packed_fwd(jnp.asarray(qkv), jnp.asarray(valid), SCALE, heads, 128,
                                      128, True))
    q, k, v = (z.numpy() for z in tfa._unpack_bhtd(torch.from_numpy(qkv), heads))
    out, _ = _fwd_tf32(q, k, v, valid, SCALE, terms=3)
    got = tfa._bhtd_to_ntd(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_tf32x1_forward_misses_the_tolerance():
    """At the LOST shape (T = 896, 769 keys valid, head dim 64; two images
    of two heads) one TF32 product a product misses atol 1e-5 / rtol 1e-4
    against the Pallas kernel in interpret mode, where three stay inside
    it: why the f32 forward kernels take three."""
    q, k, v, _, _ = _inputs(2, 2, 896, seed=500)
    valid = np.zeros((2, 896), bool)
    valid[:, :769] = True
    want, _ = _flash_fwd_interpret(q, k, v, valid)

    def worst(terms):
        got, _ = _fwd_tf32(q, k, v, valid, SCALE, terms)
        return np.max(np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want)))

    one, three = worst(1), worst(3)
    assert three <= 1 < one, (three, one)
