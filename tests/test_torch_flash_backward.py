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
