"""vipers_torch's int8 quantization primitives (``train/quantize.py``)
against the JAX package's on the CPU, on the same numpy inputs from a
seed: fake-quant values and straight-through gradients, per-channel weight
scales and baked int8 kernels, the moving-average observers and their
qparams, the int32 accumulators of the integer products (the CPU's plain
versions and the card's lowered route: im2col / per-tap int32, run here
on int32 matmuls) and the int8 Dense and Conv outputs. The activation
sites of each family: ``tests/test_torch_quantize_sites.py``.

Tolerances: fake-quant values, observers and qparams exact (f32); int8
kernels equal and scales within 1 ulp (the flax kernel's last axis is
torch's axis 0: compared after the transpose; under ``jax.jit`` XLA
computes the scale's ``amax / 127`` as ``amax * (1 / 127)``), the
dequantized and fake-quantized kernels within 2 ulp of the jitted JAX
ones; int32 accumulators equal; int8 Dense / Conv outputs within 1e-6 of
their scale.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_explain_fixtures as fx
import vipers.train.quantize as jq
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict
from vipers_torch.train import quantize as tq


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- fake quant

@pytest.mark.parametrize("qmin,qmax,zp", [(-128, 127, 0.0), (0, 255, 37.0)],
                         ids=["weights", "activations"])
def test_fake_quant_values_and_ste_gradients_match_jax(qmin, qmax, zp):
    rng = np.random.default_rng(0)
    scale = np.float32(0.0625)
    x = rng.normal(0, 6, 4096).astype(np.float32)
    # exactly on the range's ends (inclusive: gradient 1) and just past them
    ends = np.array([(qmin - zp) * scale, (qmax - zp) * scale], np.float32)
    x[:4] = np.concatenate([ends, np.nextafter(ends, np.array([-np.inf, np.inf], np.float32))])
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    want = np.asarray(jq.fake_quant(jnp.asarray(x), scale, zp, qmin, qmax))
    gwant = np.asarray(jax.grad(lambda v: jnp.sum(jq.fake_quant(v, scale, zp, qmin, qmax) * cot))(
        jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = tq.fake_quant(xt, torch.tensor(scale), torch.tensor(np.float32(zp)), qmin, qmax)
    (g,) = torch.autograd.grad((got * _t(cot)).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(g.numpy(), gwant)
    assert g[0] == cot[0] and g[1] == cot[1] and g[2] == 0 and g[3] == 0


# --------------------------------------------------------- weights and scales

@pytest.fixture(scope="module")
def mobilenet_params():
    spec = tbuild("mobilenet_v2", num_classes=10, width_mult=0.25)
    rng = np.random.default_rng(3)
    flat = {p: (a.numpy() + rng.normal(0, 0.02, a.shape)).astype(np.float32)
            for p, a in flatten_dict(spec.init(torch.Generator().manual_seed(0))).items()}
    return spec, flat


def test_quantize_params_int8_matches_jax(mobilenet_params):
    spec, flat = mobilenet_params
    fam = tck.family(spec)
    from vipers_torch.core.tree import unflatten_dict

    tree = unflatten_dict(flat)
    exclude = ("project",)
    jqk, jsc = jax.jit(lambda t: jq.quantize_params_int8(t, exclude))(tree)
    sd = fam.state_dict(tree)
    q, scales = tq.quantize_params_int8(sd, fam, exclude)
    assert set(q) == {"/".join(p[:-1]) for p in jqk}
    assert not any("project" in s for s in q)
    for path, want in jqk.items():
        site = "/".join(path[:-1])
        np.testing.assert_array_equal(tck._to_flax_layout(q[site]).numpy(), np.asarray(want))
        np.testing.assert_array_max_ulp(scales[site].numpy().ravel(),
                                        np.asarray(jsc[path]).ravel(), maxulp=1)
    # QDQ weights and the per-channel scale itself
    jd = flatten_dict(jax.jit(jq.dequantize_params)(tree, jqk, jsc))
    td = tq.dequantize_params(sd, fam, q, scales)
    for key, site in tq.weight_sites(sd, fam).items():
        path = fam.flax_path(key, sd[key].dim())
        np.testing.assert_array_max_ulp(tck._to_flax_layout(td[key]).numpy(),
                                        np.asarray(jd[path]), maxulp=2)
    w = sd["features.2.conv.0.0.weight"]
    np.testing.assert_array_max_ulp(
        tq.per_channel_weight_scale(w).numpy().ravel(),
        np.asarray(jq.per_channel_weight_scale(jnp.asarray(tck._to_flax_layout(w).numpy()))).ravel(),
        maxulp=1)


def test_fake_quant_weights_match_jax(mobilenet_params):
    """Exact against the JAX function as written (eager); under ``jax.jit``
    XLA turns its ``amax / 127`` into ``amax * (1 / 127)``, a scale 1 ulp
    off in some channels, so the jitted values (q times that scale) are
    held within 2 ulp."""
    spec, flat = mobilenet_params
    fam = tck.family(spec)
    from vipers_torch.core.tree import unflatten_dict

    keep = {p for p in flat if p[0] in ("stem", "block1_0", "classifier")}
    tree = unflatten_dict({p: a for p, a in flat.items() if p in keep})
    got = tq.fake_quant_weights(fam.state_dict(tree), fam, ("depthwise",))
    eager = flatten_dict(jax.tree.map(np.asarray, jq.fake_quant_weights(
        jax.tree.map(jnp.asarray, tree), ("depthwise",))))
    jitted = flatten_dict(jax.tree.map(np.asarray, jax.jit(
        lambda t: jq.fake_quant_weights(t, ("depthwise",)))(tree)))
    assert len(got) == len(eager) == len(keep)
    for key, v in got.items():
        path = fam.flax_path(key, v.dim())
        v = (tck._to_flax_layout(v) if path[-1] == "kernel" else v).detach().numpy()
        np.testing.assert_array_equal(v, eager[path], err_msg=str(path))
        np.testing.assert_array_max_ulp(v, jitted[path], maxulp=2)
        if "depthwise" in path or path[-1] != "kernel":
            np.testing.assert_array_equal(v, flat[path])  # left float


# ------------------------------------------------------------------ observers

def test_observer_updates_and_qparams_are_f32_exact():
    rng = np.random.default_rng(1)
    jo, to = jq.ObserverState.init(), tq.ObserverState.init()
    for i in range(6):
        x = (rng.normal(0.5 * i, 1 + i, (4, 7, 5)) + (3 if i % 2 else -2)).astype(np.float32)
        jo, to = jo.update(jnp.asarray(x)), to.update(_t(x))
        np.testing.assert_array_equal(to.min_val.numpy(), np.asarray(jo.min_val))
        np.testing.assert_array_equal(to.max_val.numpy(), np.asarray(jo.max_val))
        for a, b in zip(to.qparams(), jo.qparams()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    obs = {"a/b:in": {"min": np.float32(-0.7), "max": np.float32(2.5)},
           "a/b:out": {"min": np.float32(0.1), "max": np.float32(4.0)},
           "c:in": {"min": np.float32(0.3), "max": np.float32(0.9)}}
    jst, tst = jq.static_qparams_from_observers(obs), tq.static_qparams_from_observers(obs)
    assert set(jst) == set(tst) == {"a/b", "c"}
    for k in jst:
        for a, b in zip(tst[k], jst[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tq.static_qparams_from_observers(None) is None


# ------------------------------------------------------- integer accumulators

def _int8(rng, shape, extreme=None):
    if extreme is not None:
        return np.full(shape, extreme, np.int8)
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", [(5, 9, 3), (33, 64, 24), (17, 768, 10)])
@pytest.mark.parametrize("extreme", [None, "min-max", "min-min"])
def test_matmul_int32_equals_jax_dot_general(m, k, n, extreme):
    rng = np.random.default_rng(m + k)
    ea, ew = {None: (None, None), "min-max": (-128, 127), "min-min": (-128, -128)}[extreme]
    a, w = _int8(rng, (m, k), ea), _int8(rng, (n, k), ew)
    want = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(w.T), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = tq.matmul_int32(_t(a), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (N, C, H, W, O, kernel, stride, dilation, groups)
CONVS = {
    "3x3": (2, 16, 9, 11, 24, 3, 1, 1, 1),
    "3x3-strided": (2, 16, 10, 9, 8, 3, 2, 1, 1),
    "3x3-dilated": (1, 8, 12, 12, 16, 3, 1, 2, 1),
    "depthwise-strided": (2, 24, 11, 10, 24, 3, 2, 1, 24),
    "depthwise-dilated": (1, 16, 12, 12, 16, 3, 1, 2, 16),
    "grouped": (1, 8, 7, 7, 12, 3, 1, 1, 2),
    "1x1-strided": (2, 32, 9, 9, 40, 1, 2, 1, 1),
    "7x7-stem": (1, 3, 19, 17, 16, 7, 2, 1, 1),
    "patch": (1, 3, 16, 24, 32, 8, 8, 1, 1),
}


@pytest.mark.parametrize("extreme", [None, "min-max", "min-min"])
@pytest.mark.parametrize("case", list(CONVS))
def test_conv_int32_equals_jax_conv_general_dilated(case, extreme):
    n, c, h, wd, o, k, s, d, g = CONVS[case]
    rng = np.random.default_rng(len(case))
    ea, ew = {None: (None, None), "min-max": (-128, 127), "min-min": (-128, -128)}[extreme]
    xs, w = _int8(rng, (n, h, wd, c), ea), _int8(rng, (k, k, c // g, o), ew)  # NHWC, HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xs), jnp.asarray(w), window_strides=(s, s), padding="VALID",
        rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=g, preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)
    x_t, w_t = _t(xs).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1)
    for fn in (tq.conv_int32, tq.conv_int32_lowered):  # the CPU's, the card's route
        got = fn(x_t, w_t, (s, s), (d, d), g)
        assert got.dtype == torch.int32, fn.__name__
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)


# ------------------------------------------------------ int8 Dense and Conv

def _scaled_close(got, want, rel=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def test_int8_dense_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0.3, 1.5, (3, 17, 48)).astype(np.float32)
    w = rng.normal(0, 0.1, (48, 40)).astype(np.float32)  # flax (in, out)
    b = rng.normal(0, 0.1, 40).astype(np.float32)
    wq_j = jnp.clip(jnp.round(w / jq.per_channel_weight_scale(jnp.asarray(w))), -128, 127
                    ).astype(jnp.int8)
    ws_j = jq.per_channel_weight_scale(jnp.asarray(w))
    s_j, zp_j = jq.dynamic_qparams(jnp.asarray(x))
    want = jq.int8_dense(jnp.asarray(x), wq_j, ws_j, s_j, zp_j, jnp.asarray(b))
    s_t, zp_t = tq.dynamic_qparams(_t(x))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(zp_t.numpy(), np.asarray(zp_j))
    got = tq.int8_dense(_t(x), _t(np.asarray(wq_j).T.copy()), _t(np.asarray(ws_j).T.copy()),
                        s_t, zp_t, _t(b))
    _scaled_close(got.numpy(), want)
    # the bf16 input is cast to f32 before the index is taken
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jq.int8_dense(xb, wq_j, ws_j, s_j, zp_j, None)
    got = tq.int8_dense(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
                        _t(np.asarray(wq_j).T.copy()), _t(np.asarray(ws_j).T.copy()), s_t, zp_t)
    _scaled_close(got.numpy(), want)


def _flax_pads(padding, k, s, d, x_nhwc, w):
    conv = fnn.Conv(w.shape[-1], (k, k), strides=(s, s), padding=padding,
                    kernel_dilation=(d, d))
    return jq._explicit_conv_pads(conv, x_nhwc, w)


@pytest.mark.parametrize("case,padding", [
    ("3x3", "SAME"), ("3x3-strided", "SAME"), ("3x3-dilated", "SAME"),
    ("depthwise-strided", [(1, 1), (1, 1)]), ("depthwise-dilated", [(2, 2), (2, 2)]),
    ("1x1-strided", "VALID"), ("7x7-stem", [(3, 3), (3, 3)]), ("grouped", 1),
    ("patch", "VALID")])
def test_int8_conv_matches_jax(case, padding):
    n, c, h, wd, o, k, s, d, g = CONVS[case]
    rng = np.random.default_rng(11)
    x = rng.normal(0.2, 1.0, (n, h, wd, c)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, c // g, o)).astype(np.float32)
    b = rng.normal(0, 0.1, o).astype(np.float32)
    ws = jq.per_channel_weight_scale(jnp.asarray(w))
    wq = jnp.clip(jnp.round(w / ws), -128, 127).astype(jnp.int8)
    pads, strides, dil = (tuple(map(tuple, v)) if i == 0 else tuple(v)
                          for i, v in enumerate(_flax_pads(padding, k, s, d, x, w)))
    scale, zp = jq.dynamic_qparams(jnp.asarray(x))
    want = np.asarray(jax.jit(jq.int8_conv, static_argnums=(6, 7, 8, 9))(
        jnp.asarray(x), wq, ws, scale, zp, jnp.asarray(b), pads, strides, dil, g)
    ).transpose(0, 3, 1, 2)
    got = tq.int8_conv(_t(x).permute(0, 3, 1, 2), _t(np.asarray(wq)).permute(3, 2, 0, 1),
                       _t(np.asarray(ws)).reshape(-1, 1, 1, 1), _t(np.asarray(scale)),
                       _t(np.asarray(zp)), _t(b), pads, strides, dil, g)
    _scaled_close(got.numpy(), want)


def test_dynamic_qparams_with_token_mask_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 10, 8)).astype(np.float32)
    x[:, 7:] = 50.0  # pad rows: must not widen the range
    mask = np.ones((3, 10), bool)
    mask[:, 7:] = False
    for m in (None, mask):
        want = jq.dynamic_qparams(jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = tq.dynamic_qparams(_t(x), None if m is None else _t(m))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
