"""The softmax-precision variants of vipers_torch's training attention
against the TPU tool's own kernel bodies on the CPU.

``tools/bench_softmax_prec.py``'s ``fwd_kernel`` and ``bwd_kernel`` run in
a test-side ``pl.pallas_call(..., interpret=True)`` (the tool's ``build()``
has no interpret flag), compiled without XLA's excess precision so that
their bf16 casts round as on the TPU, at B=2, H=2, T=128, hd=64, bf16,
block_b=1; the
port's plain versions get the same inputs (the backward the tool's own
forward residuals). Tolerance: 2e-2 of each output's scale, as for the
training kernels. Since a variant differs from f32 by less than that, each
bf16exp and normP result must also be clearly its own variant's: its mean
distance from the tool's variant at most half the tool's distance between
that variant and f32. The tool is imported by file path; its import points
``jax_compilation_cache_dir`` at ``.jax_cache``, restored afterwards.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vipers_torch.ops import attention_train as tat
from vipers_torch.tools import bench_softmax_prec as tool_port

B, H, T, HD = 2, 2, 128, 64
SCALE = HD ** -0.5


@pytest.fixture(scope="module")
def tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "bench_softmax_prec.py"
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("_tpu_bench_softmax_prec", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    return mod


def _pallas(tool, body, variant):
    qkv_spec = pl.BlockSpec((1, 1, T, HD), lambda i, j: (i, j, 0, 0))
    lse_spec = pl.BlockSpec((1, 1, 1, T), lambda i, j: (i, j, 0, 0))
    ok_spec = pl.BlockSpec((1, 1, T), lambda i, j: (i, 0, 0))
    if body is tool.fwd_kernel:
        in_specs = [qkv_spec] * 3 + [ok_spec]
        out_specs = [qkv_spec, lse_spec]
        out_shape = [jax.ShapeDtypeStruct((B, H, T, HD), jnp.bfloat16),
                     jax.ShapeDtypeStruct((B, H, 1, T), jnp.float32)]
    else:
        in_specs = [qkv_spec] * 4 + [lse_spec, qkv_spec, ok_spec]
        out_specs = [qkv_spec] * 3
        out_shape = [jax.ShapeDtypeStruct((B, H, T, HD), jnp.bfloat16)] * 3
    call = pl.pallas_call(
        functools.partial(body, scale=SCALE, block_b=1, variant=variant),
        grid=(B, H), in_specs=in_specs, out_specs=out_specs, out_shape=out_shape,
        interpret=True)

    def run(*args):
        # without this, XLA's CPU compiler may drop the bodies' bf16 casts
        # (excess precision) and the bf16exp variant is partly f32
        return jax.jit(call).lower(*args).compile({"xla_allow_excess_precision": False})(*args)

    return run


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (jnp.asarray(rng.normal(size=(B, H, T, HD)), jnp.bfloat16) for _ in range(4))
    return q, k, v, do


def _t(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max(), np.abs(got - want).max()


def _own_variant(got, want, want_f32):
    """``got`` is the variant's result and not f32's: its mean distance from
    the variant's ``want`` is at most half the distance from ``want`` to the
    f32 ``want_f32`` (so it is also farther from ``want_f32`` than from
    ``want``)."""
    got, want, want_f32 = _np(got), _np(want), _np(want_f32)
    gap = np.abs(want - want_f32).mean()
    err = np.abs(got - want).mean()
    assert gap > 0 and err <= 0.5 * gap, (err, gap)


@pytest.mark.parametrize("variant", ["f32", "bf16exp", "normP"])
def test_forward_matches_tool_kernel(tool, variant):
    q, k, v, _ = _inputs(0)
    ok = jnp.ones((B, 1, T), jnp.int8)
    o, lse = _pallas(tool, tool.fwd_kernel, variant)(q, k, v, ok)
    okt = torch.ones((B, T), dtype=torch.bool)
    to, tlse = tat.attention_train_fwd_plain(_t(q), _t(k), _t(v), okt, SCALE, variant)
    _close(to, o)
    _close(tlse, np.asarray(lse)[:, :, 0])
    if variant != "f32":
        o32, _ = _pallas(tool, tool.fwd_kernel, "f32")(q, k, v, ok)
        _own_variant(to, o, o32)


@pytest.mark.parametrize("variant", ["f32", "bf16exp"])
def test_backward_matches_tool_kernel(tool, variant):
    """On the tool's own forward residuals (o, lse of the same variant)."""
    q, k, v, do = _inputs(1)
    ok = jnp.ones((B, 1, T), jnp.int8)
    o, lse = _pallas(tool, tool.fwd_kernel, variant)(q, k, v, ok)
    want = _pallas(tool, tool.bwd_kernel, variant)(q, k, v, o, lse, do, ok)
    okt = torch.ones((B, T), dtype=torch.bool)
    tlse = torch.from_numpy(np.array(lse)[:, :, 0])
    got = tat.attention_train_bwd_plain(_t(q), _t(k), _t(v), _t(o), tlse, _t(do), okt, SCALE,
                                        variant)
    for a, c in zip(got, want):
        _close(a, c)
    if variant != "f32":
        want32 = _pallas(tool, tool.bwd_kernel, "f32")(q, k, v, o, lse, do, ok)
        for a, c, c32 in zip(got, want, want32):
            _own_variant(a, c, c32)


@pytest.mark.parametrize("variant", ["bf16exp", "normP"])
def test_own_variant_rejects_f32(tool, variant):
    """The port's f32 forward passes the 2e-2 tolerance against the tool's
    variant, but the own-variant check fails it."""
    q, k, v, _ = _inputs(0)
    ok = jnp.ones((B, 1, T), jnp.int8)
    o, _ = _pallas(tool, tool.fwd_kernel, variant)(q, k, v, ok)
    o32, _ = _pallas(tool, tool.fwd_kernel, "f32")(q, k, v, ok)
    okt = torch.ones((B, T), dtype=torch.bool)
    to, _ = tat.attention_train_fwd_plain(_t(q), _t(k), _t(v), okt, SCALE)
    _close(to, o)
    with pytest.raises(AssertionError):
        _own_variant(to, o, o32)


def test_f32_variant_is_todays_plain_version():
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, T, HD)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    ok = torch.from_numpy(rng.random((B, T)) > 0.2)
    o, lse = tat.attention_train_fwd_plain(q, k, v, ok, SCALE)
    o2, lse2 = tat.attention_train_fwd_plain(q, k, v, ok, SCALE, variant="f32")
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    # the model path's entry runs the same function
    x = torch.stack([q, k, v])
    assert torch.equal(tat.attention_train_packed(x, valid=ok, scale=SCALE), o)
    g = tat.attention_train_bwd_plain(q, k, v, o, lse, do, ok, SCALE)
    g2 = tat.attention_train_bwd_plain(q, k, v, o, lse, do, ok, SCALE, variant="f32")
    assert all(torch.equal(a, c) for a, c in zip(g, g2))


def test_variant_rejections_and_no_cpu_launch():
    z = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    ok = torch.ones(1, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="variant"):
        tat.attention_train_fwd(z, z, z, ok, 0.1, variant="fp8")
    with pytest.raises(ValueError, match="variant"):
        tat.attention_train_bwd(z, z, z, z, z[..., 0].float(), z, ok, 0.1, variant="normP")
    before = dict(tat.LAUNCHES)
    tat.attention_train_fwd(z, z, z, ok, 0.1, variant="bf16exp")
    assert tat.LAUNCHES == before


def test_port_tool_runs_on_the_cpu(capsys):
    """The port's tool at a small shape with --device cpu (plain versions):
    every variant timed, the deltas of bf16exp and normP against f32 within
    bf16 rounding and not zero, but for normP's dv (its backward is f32's,
    and dv does not read o)."""
    res = tool_port.main(["--device", "cpu", "--batch", "2", "--heads", "2", "--seq", "128",
                          "--windows", "1", "--iters", "1"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu (plain versions)"
    assert set(res["ms"]) == {"f32", "bf16exp", "normP"} and "speedup:" in out
    delta = dict(res["rel_delta"])
    assert delta.pop(("normP", "dv")) == 0.0
    assert all(0 < d < 2e-2 for d in delta.values()), delta
