"""vipers_torch's Swin-V2 (``models/swin.py``) against the JAX package on
the CPU: the forward and its ``aux`` outputs, the bf16 dtype flow, the
shift masks and CPB tables, stochastic depth's rates and draws, and the
``.pth`` both ways (``core.checkpoint.import_swin_v2_t`` /
``export_swin_v2_t``, against the JAX importer and the torchvision oracle
of ``tests/torch_swin_oracle.py``).

Small sizes: embed 24, heads (3, 3, 6, 6), depths (2, 2, 6, 2) (the
registry's, which the JAX importer assumes), 10 classes, B = 2, inputs of
64x64, 128x128 and 100x76 (padding, a shift switched off on an axis one
window covers, odd merges). The weights are the port's flax-default init
(seed 0) plus N(0, 0.05) on every leaf, so biases and LayerNorm affines
are not trivial. Tolerance, f32: atol 1e-5 of each tensor's scale (its
largest magnitude, 6-9 here) and rtol 1e-4: twelve res-post-norm blocks
leave both packages ~2-3e-5 (absolute) from an f64 run of the port, as
far from it as from each other.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vipers.core.checkpoint as jck
import vipers.models.swin as jswin
from tests import torch_swin_oracle as oracle
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict
from vipers_torch.models import stochastic
from vipers_torch.models import swin as tswin
from vipers_torch.train import steps as tsteps

CFG = dict(embed_dim=24, num_heads=(3, 3, 6, 6), num_classes=10)


def _spec(sd_prob=0.0):
    return tswin.swin_spec("swin_test", tswin.SwinV2Config(**CFG, stochastic_depth_prob=sd_prob),
                           (64, 64))


@functools.lru_cache(maxsize=None)
def _params():
    params = jax.tree.map(lambda a: a.numpy(), _spec().init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), params)


@functools.lru_cache(maxsize=None)
def _jax_apply():
    return jax.jit(jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(
        **CFG, stochastic_depth_prob=0.0)).apply)


def _model(params, sd_prob=0.0):
    spec = _spec(sd_prob)
    model = spec.module().eval()
    model.load_state_dict(tck.family(spec).state_dict(params))
    return model


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=1e-5 * np.abs(want).max(), rtol=1e-4)


def test_param_tree_matches_jax():
    """The port's init has the JAX module's paths and shapes."""
    jm = jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(**CFG))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = {p: tuple(v.shape) for p, v in flatten_dict(shapes["params"]).items()}
    assert {p: tuple(v.shape) for p, v in flatten_dict(_params()).items()} == want
    init = _spec().init(torch.Generator().manual_seed(0))
    assert float(init["stage0_block0"]["attn"]["logit_scale"][0, 0, 0]) == pytest.approx(
        np.log(10.0))
    assert not init["stage0_block0"]["attn"]["qkv"]["bias"].any()


@pytest.mark.parametrize("hw", [(64, 64), (128, 128), (100, 76)])
def test_forward_matches_jax(hw):
    """Eval mode, f32: logits, the final map, the last block's softmax and
    its qkv in window-major (``qkv``) and image (``qkv_grid``) order."""
    params = _params()
    x = np.random.default_rng(hw[0]).normal(size=(2, *hw, 3)).astype(np.float32)
    jl, ja = _jax_apply()({"params": params}, x)
    with torch.no_grad():
        tl, ta = _model(params)(torch.from_numpy(x))
    _close(tl.numpy(), jl)
    for k in ("features", "attn", "qkv", "qkv_grid"):
        assert tuple(ta[k].shape) == ja[k].shape, k
        _close(ta[k].numpy(), ja[k])


def test_swin_v2_t_matches_the_torchvision_oracle():
    """Full swin_v2_t from a random torchvision-layout state dict through
    ``import_swin_v2_t``, against the hand-built torchvision forward."""
    sd = oracle.random_torchvision_swin_sd(seed=0, num_classes=10)
    params, masks = tck.import_swin_v2_t(tck.normalize_torch_state_dict(sd))
    assert not masks
    spec = tbuild("swin_v2_t", num_classes=10)
    model = spec.module().eval()
    model.load_state_dict(tck.family(spec).state_dict(params))
    for hw in ((64, 64), (100, 76)):
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, *hw, 3)).astype(np.float32))
        want_logits, want_feats, _ = oracle.swin_v2_t_forward(sd, x.permute(0, 3, 1, 2))
        with torch.no_grad():
            logits, aux = model(x)
        _close(logits.numpy(), want_logits.numpy())
        _close(aux["features"].numpy(), want_feats.numpy())


@pytest.mark.parametrize("h,w,sh,sw", [(16, 16, 4, 4), (8, 16, 0, 4), (24, 8, 4, 0),
                                       (16, 24, 4, 4)])
def test_shift_mask_and_cpb_tables_match_jax(h, w, sh, sw):
    got = tswin.shift_attn_mask(h, w, 8, sh, sw, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jswin._shift_attn_mask(h, w, 8, sh, sw)))
    # the JAX table is computed in f64 and enters the model as f32
    np.testing.assert_array_equal(tswin.relative_coords_table_np(8),
                                  np.asarray(jswin._relative_coords_table(8), np.float32))
    np.testing.assert_array_equal(tswin.relative_position_index_np(8),
                                  jswin._relative_position_index(8))
    x = torch.arange(2 * h * w * 3, dtype=torch.float32).reshape(2, h, w, 3)
    win = tswin.window_partition(x, 8)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jswin._window_partition(x.numpy(), 8)))
    assert torch.equal(tswin.window_reverse(win, 8, h, w), x)


class _Products(TorchDispatchMode):
    """Counts the matrix products by (operand dtype, result dtype); an f32
    product whose operands are all exactly bf16 values counts as bf16
    operands with an f32 result (a bf16 einsum with preferred f32)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ops = {torch.ops.aten.mm: args[:2], torch.ops.aten.bmm: args[:2],
               torch.ops.aten.addmm: args[1:3], torch.ops.aten.baddbmm: args[1:3]}
        if func.overloadpacket in ops:
            a, b = ops[func.overloadpacket]
            src = a.dtype
            if src == torch.float32 and all(torch.equal(t.to(torch.bfloat16).float(), t)
                                            for t in (a, b)):
                src = torch.bfloat16
            key = (str(src).replace("torch.", ""), str(out.dtype).replace("torch.", ""))
            self.counts[key] = self.counts.get(key, 0) + 1
        return out


def test_bf16_dtype_flow_matches_jax_jaxpr():
    """The bf16 train forward on a bf16 copy of the parameters: 64 bf16
    products (qkv, proj, fc1, fc2 of 12 blocks, P.V, 3 merges, the head),
    12 q.k^T on bf16 operands into f32, 24 f32 products (the CPB MLP, whose
    f32 table promotes the bf16 kernels): the port's count by dtype equals
    the JAX jaxpr's."""
    params = _params()
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(**CFG, stochastic_depth_prob=0.0))
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jaxpr = jax.make_jaxpr(lambda p, xb: jm.apply({"params": p}, xb, train=True)[0])(
        p16, jnp.asarray(x, jnp.bfloat16))
    want = {}
    for eqn in jaxpr.jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            key = (str(eqn.invars[0].aval.dtype), str(eqn.outvars[0].aval.dtype))
            want[key] = want.get(key, 0) + 1
    assert want == {("bfloat16", "bfloat16"): 64, ("bfloat16", "float32"): 12,
                    ("float32", "float32"): 24}, want
    model = _model(params).train()
    tensors = tsteps.forward_params(dict(model.named_parameters()), {}, torch.bfloat16)
    mode = _Products()
    with mode, torch.no_grad():
        _, logits, _ = tsteps.train_loss(model, tensors, (torch.from_numpy(x),
                                                          torch.zeros(2, dtype=torch.long)),
                                         10, compute_dtype=torch.bfloat16)
    assert mode.counts == want, mode.counts
    assert logits.dtype == torch.bfloat16 and jaxpr.out_avals[0].dtype == jnp.bfloat16


def test_stochastic_depth_rates_match_jax():
    """Each block's rate, 0.2 * block_id / 11, read from the JAX module's
    blocks while it traces."""
    jm = jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(**CFG))
    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jswin.SwinBlockV2) and context.method_name == "__call__":
            rates.append(context.module.sd_rate)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    model = _spec(0.2).module()
    got = [b.sd_rate for b in model.blocks if isinstance(b, tswin.SwinBlockV2)]
    assert len(got) == 12 and got == pytest.approx(rates, abs=0)
    assert got == pytest.approx([0.2 * i / 11 for i in range(12)])


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_drop_path_keeps_at_one_minus_rate_and_scales_by_one_over_keep(rate):
    """Over 4096 samples the keep frequency lies within 5 sigma of 1 -
    rate; kept samples are scaled by exactly 1 / keep (the JAX ``y * mask /
    keep``), dropped ones are zero; the same generator seed draws the same
    mask; eval mode and rate 0 return the input and draw nothing."""
    keep = 1.0 - rate
    y = torch.randn(4096, 2, 2, 3, generator=torch.Generator().manual_seed(0))
    out = stochastic.drop_path(y, rate, True, stochastic.dropout_generator(1, 7, "cpu"))
    kept = (out != 0).flatten(1).any(dim=1)
    n = y.shape[0]
    assert abs(float(kept.float().mean()) - keep) <= 5 * (keep * rate / n) ** 0.5
    assert torch.equal(out[kept], y[kept] / keep) and not out[~kept].any()
    again = stochastic.drop_path(y, rate, True, stochastic.dropout_generator(1, 7, "cpu"))
    other = stochastic.drop_path(y, rate, True, stochastic.dropout_generator(1, 8, "cpu"))
    assert torch.equal(out, again) and not torch.equal(out, other)
    gen = stochastic.dropout_generator(1, 7, "cpu")
    state = gen.get_state()
    assert stochastic.drop_path(y, rate, False, gen) is y
    assert stochastic.drop_path(y, 0.0, True, gen) is y
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        stochastic.drop_path(y, rate, True, None)


def _pruned_torchvision_sd(seed):
    """A random torchvision swin_v2_t state dict with the reference's
    pruned form (``weight_orig`` / ``weight_mask``) on the patch conv, one
    MLP and one merge."""
    sd = oracle.random_torchvision_swin_sd(seed=seed, num_classes=4)
    rng = np.random.default_rng(seed)
    for key in ("features.0.0.weight", "features.5.3.mlp.0.weight",
                "features.4.reduction.weight"):
        w = sd.pop(key)
        sd[key + "_orig"] = w
        sd[key + "_mask"] = torch.from_numpy((rng.random(w.shape) > 0.5).astype(np.float32))
    return sd


def test_import_matches_jax_importer(tmp_path):
    """A pruned torchvision ``.pth`` through the port's importer and the JAX
    package's ``import_torch_checkpoint``: the same tree and masks."""
    path = tmp_path / "swin.pth"
    torch.save({"model": _pruned_torchvision_sd(1)}, path)
    jp, jbs, jm = jck.import_torch_checkpoint(str(path), "swin_v2_t")
    spec = tbuild("swin_v2_t", num_classes=4)
    tp, tbs, tm = tck.family(spec).import_pth(tck.load_torch_state_dict(path), spec)
    assert jbs is None and tbs is None
    jflat, tflat = flatten_dict(jp), flatten_dict(tp)
    assert set(jflat) == set(tflat) and len(tm) == len(jm) == 3
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k], v, err_msg=str(k))
    for k, v in jm.items():
        np.testing.assert_array_equal(tm[k], v, err_msg=str(k))


@pytest.mark.parametrize("bake", [True, False])
def test_export_round_trips_through_the_jax_importer(bake, tmp_path):
    """``export_swin_v2_t`` of a flax tree with masks: torchvision's full key
    set (the oracle's keys and every block's two buffers, recomputed as
    torchvision computes them), read back by the JAX package's importer
    equal to the tree that wrote it (masks baked, or carried in the
    ``weight_orig`` / ``weight_mask`` form)."""
    sd = oracle.random_torchvision_swin_sd(seed=2, num_classes=4)
    params, _ = tck.import_swin_v2_t(tck.normalize_torch_state_dict(sd))
    masks = {p: np.random.default_rng(3).random(np.shape(w)) > 0.4
             for p, w in flatten_dict(params).items()
             if p[-1] == "kernel" and "qkv" not in p[-2] and "cpb" not in p[-2]}
    out = tck.export_swin_v2_t(params, masks, bake_masks=bake)
    ws = oracle.WS
    buffers = {}
    for si, depth in enumerate(oracle.DEPTHS):
        for bi in range(depth):
            t = f"features.{1 + 2 * si}.{bi}.attn"
            buffers[f"{t}.relative_coords_table"] = oracle._relative_coords_table(ws).reshape(
                1, 2 * ws - 1, 2 * ws - 1, 2)
            buffers[f"{t}.relative_position_index"] = oracle._relative_position_index(
                ws).flatten()
    resolved = {k[:-len("_orig")] if k.endswith("_orig") else k for k in out
                if not k.endswith("_mask")}
    assert resolved == set(sd) | set(buffers)
    for k, v in buffers.items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
        assert out[k].dtype == v.numpy().dtype and out[k].shape == tuple(v.shape), k
    path = tmp_path / "out.pth"
    tck.save_torch_state_dict(out, path)
    jp, _, jm = jck.import_torch_checkpoint(str(path), "swin_v2_t")
    flat = flatten_dict(params)
    for k, v in flatten_dict(jp).items():
        want = flat[k] * masks[k] if k in masks else flat[k]
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want, np.float32), err_msg=str(k))
    assert set(jm) == (set() if bake else set(masks))
    for k, m in jm.items():
        np.testing.assert_array_equal(np.asarray(m), masks[k])


def test_infer_num_classes_reads_the_swin_head():
    params = _params()
    assert tck.infer_num_classes(params) == 10
    assert tck.infer_num_classes({k: v for k, v in params.items() if k != "head"}) is None


def test_cached_constants_made_in_inference_mode_train_afterwards():
    """A LOST call (inference mode) may build the CPB table, its index and
    a shift mask first; a training forward and backward then uses them."""
    tswin._relative_coords_table.cache_clear()
    tswin._relative_position_index.cache_clear()
    tswin.shift_attn_mask.cache_clear()
    model = _model(_params())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        model(x)
    model.train()
    loss = model(x)[0].square().mean()
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
