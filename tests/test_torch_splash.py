"""vipers_torch's splash attention (the port of the splash A/B,
``tools/bench_splash.py``) against the JAX library splash kernel on the
CPU: ``make_splash_mha`` over a full mask per head, block 128 x 128, in
interpret mode, vmapped over the batch, at B=2, H=2, T=256, hd=64 on
pre-scaled q. f32 within 1e-5 / 1e-4, bf16 within 2e-2 of the output
scale. Also the wrapper's layouts, rejections and the port's tool at a
small shape on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_kernel as sk
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_mask as sm

from vipers_torch.ops import splash_attention as tsa
from vipers_torch.tools import bench_splash as tool_port

B, H, T, HD = 2, 2, 256, 64


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.standard_normal((B, H, T, HD)), dtype) for _ in range(3))
    q = (q * HD ** -0.5).astype(dtype)  # the tool scales q before the kernel
    return q, k, v


def _jax_splash(q, k, v):
    mask = sm.MultiHeadMask([sm.FullMask((T, T)) for _ in range(H)])
    bs = sk.BlockSizes(block_q=128, block_kv=128, block_kv_compute=128)
    kern = sk.make_splash_mha(mask, block_sizes=bs, head_shards=1, q_seq_shards=1,
                              interpret=True)
    return jax.vmap(kern)(q, k, v)


def _t(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_splash(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v = _inputs(jdt)
    want = np.asarray(_jax_splash(q, k, v).astype(jnp.float32))
    got = tsa.splash_attention_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("layout", tsa.K_LAYOUTS)
def test_wrapper_layouts_run_the_plain_version_on_the_cpu(layout):
    q, k, v = (_t(z, torch.float32) for z in _inputs(jnp.float32, seed=1))
    kk = k.transpose(-1, -2).contiguous() if layout == "seq_minor" else k
    before = dict(tsa.LAUNCHES)
    out = tsa.splash_attention(q, kk, v, 64, 128, layout)
    assert tsa.LAUNCHES == before
    torch.testing.assert_close(out, tsa.splash_attention_plain(q, k, v), rtol=0, atol=0)


def test_rejections():
    z = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="block_q"):
        tsa.splash_attention(z, z, z, 256, 128)
    with pytest.raises(ValueError, match="k_layout"):
        tsa.splash_attention(z, z, z, 64, 64, "seq_major")
    with pytest.raises(ValueError, match="match them"):
        tsa.splash_attention(z, z, z, 64, 64, "seq_minor")
    assert len(tsa.INSTANCES) == 8 and set(tsa.LAUNCHES) == {
        tsa.instance_name(*i) for i in tsa.INSTANCES}


def test_port_tool_runs_on_the_cpu(capsys):
    res = tool_port.main(["--device", "cpu", "--batch", "1", "--heads", "2", "--seq", "256",
                          "--valid", "200", "--iters", "1"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu (plain versions)"
    assert "flash kernel + valid mask" in out and "flash kernel no mask" in out
    assert set(res["err"]) == {tsa.instance_name(*i) for i in tsa.INSTANCES}
    assert len(res["ms"]) == 2 + len(tsa.INSTANCES)
