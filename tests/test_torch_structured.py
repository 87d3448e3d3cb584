"""vipers_torch.pruning.structured (structured slimming) against the JAX
package on the CPU.

The slim functions are host numpy in both packages, so on the same numpy
trees and masks they must agree exactly: overrides, reports, kept indices
(``np.argpartition``'s choice among the exactly-zero scores of inert units
included) and the slim trees and masks, ``array_equal``. Then the
exactness contract on the port (drop exactly the inert units: the slim
model's logits equal the masked dense model's; rtol/atol 2e-5 for the
ViT as in ``tests/test_structured.py``, 1e-4 for the CNNs and Swin, its
values there), the port's slim forward against the JAX slim forward on
the same slim tree (1e-5 of the logits' scale + rtol 1e-4), the
registry's ``arch_overrides`` and the fused MLP's plain version at a slim
F against the JAX kernel in interpret mode.

Small models: a ViT of 2 blocks (D 32, 4 heads of 8, mlp 64) at 16x16,
ResNet-18 and -50 at their widths on 32x32, VGG16 narrowed to 8 channels
a conv and fc 16 at 224x224, Swin-V2 narrowed (embed 24, heads 3/3/6/6,
depths 2/2/2/2) at 64x64. Weights: the port's initial parameters (seed
0) as numpy with N(0, 0.02) on every leaf; ResNet running statistics
drawn away from mean 0 / var 1.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.core.registry as jreg
import vipers.models.swin as jswin
import vipers.models.vgg as jvgg
import vipers.models.vit as jvit
import vipers.ops.fused_mlp as jfm
import vipers.pruning.structured as js
from vipers.pruning import apply_masks as japply_masks
from tests import torch_explain_fixtures as fx
import vipers_torch.core.registry as treg
import vipers_torch.pruning.structured as ts
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.models import swin as tswin
from vipers_torch.models import vgg as tvgg
from vipers_torch.models import vit as tvit
from vipers_torch.ops import fused_mlp as tfm

VIT = dict(patch_size=4, num_layers=2, num_heads=4, hidden_dim=32, mlp_dim=64, num_classes=10)
VGG = dict(conv_widths=(8,) * 13, fc_dims=(16, 16))
SWIN = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(3, 3, 6, 6), num_classes=10)
FAMILIES = ["vit", "vgg", "resnet18", "resnet50", "swin"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _np_tree(tree):
    return unflatten_dict({p: np.asarray(a, np.float32) for p, a in flatten_dict(tree).items()})


def _drop(r, n, frac):
    return np.sort(r.choice(n, size=int(n * frac), replace=False))


@functools.lru_cache(maxsize=None)
def case(fam):
    """(port spec, variables {params[, batch_stats]} of numpy, masks that
    make chosen units inert {path: bool array}, {unit: dropped indices},
    slim keyword arguments, input (N, H, W, 3) f32)."""
    r = np.random.default_rng(7)
    if fam == "vit":
        spec = tvit._build("vit_slim_test", tvit.ViTConfig(**VIT), (16, 16))
        size = (16, 16)
    elif fam == "vgg":
        spec = tvgg._spec("vgg16", tvgg.VGGConfig(5, **VGG), (224, 224))
        size = (224, 224)
    elif fam == "swin":
        spec = tswin.swin_spec("swin_slim_test", tswin.SwinV2Config(**SWIN), (64, 64))
        size = (64, 64)
    else:
        spec = tbuild(fam, num_classes=4)
        size = (32, 32)
    params = fx._perturbed(_np_tree(spec.init(torch.Generator().manual_seed(0))))
    flat = flatten_dict(params)
    variables = {"params": params}
    masks, dropped = {}, {}

    def zero(path, idx, axis):
        m = np.array(masks.get(path, np.ones(flat[path].shape, bool)))
        sl = [slice(None)] * m.ndim
        sl[axis] = idx
        m[tuple(sl)] = False
        masks[path] = m

    if fam == "vit":
        hd = VIT["hidden_dim"] // VIT["num_heads"]
        for i, heads in enumerate(([1], [3])):
            layer = f"encoder_layer_{i}"
            dropped[layer] = _drop(r, 64, 0.5)
            zero((layer, "mlp", "fc2", "kernel"), dropped[layer], 0)
            dropped[layer + "/heads"] = np.asarray(heads)
            zero((layer, "attention", "out", "kernel"),
                 np.concatenate([np.arange(a * hd, (a + 1) * hd) for a in heads]), 0)
        # an unstructured mask that must come out sliced along the kept neurons
        zero(("encoder_layer_0", "mlp", "fc1", "kernel"), [0, 5], 0)
        kw = dict(mlp_keep=0.5, heads_keep=0.75, round_to=1)
    elif fam == "vgg":
        for i in range(13):
            dropped[f"conv_{i}"] = _drop(r, 8, 0.25)
            if i < 12:
                zero((f"conv_{i + 1}", "kernel"), dropped[f"conv_{i}"], 2)
            else:  # fc1's row groups: 49 rows a channel at 224 (a 7x7 map)
                rows = (dropped["conv_12"][:, None] * 49 + np.arange(49)[None]).reshape(-1)
                zero(("fc1", "kernel"), rows, 0)
        for name, down in (("fc1", "fc2"), ("fc2", "fc3")):
            dropped[name] = _drop(r, 16, 0.5)
            zero((down, "kernel"), dropped[name], 0)
        kw = dict(conv_keep=0.75, fc_keep=0.5, round_to=1)
    elif fam == "swin":
        for block in sorted({p[0] for p in flat if p[0].startswith("stage")}):
            dropped[block] = _drop(r, flat[(block, "fc1", "kernel")].shape[1], 0.5)
            zero((block, "fc2", "kernel"), dropped[block], 0)
        kw = dict(mlp_keep=0.5, round_to=1)
    else:
        stats = {}
        for path, w in flat.items():
            if path[-1] == "scale":
                stats[path[:-1] + ("mean",)] = r.normal(0, 0.2, w.shape).astype(np.float32)
                stats[path[:-1] + ("var",)] = (np.abs(r.normal(size=w.shape)) + 0.5
                                               ).astype(np.float32)
        variables["batch_stats"] = unflatten_dict(stats)
        blocks = sorted({p[0] for p in flat if p[0].startswith("layer")})
        for block in blocks:
            convs = ("conv1", "conv2") if (block, "conv3", "kernel") in flat else ("conv1",)
            for conv in convs:
                down = {"conv1": "conv2", "conv2": "conv3"}[conv]
                dropped[f"{block}/{conv}"] = _drop(r, flat[(block, conv, "kernel")].shape[3], 0.25)
                zero((block, down, "kernel"), dropped[f"{block}/{conv}"], 2)
        kw = dict(inner_keep=0.75, round_to=1)
    x = np.random.default_rng(1).normal(size=(2 if fam != "vgg" else 1, *size, 3))
    return spec, variables, masks, dropped, kw, x.astype(np.float32)


def _slim(pkg, fam):
    spec, variables, masks, _d, kw, _x = case(fam)
    cfg = spec.cfg if pkg is ts else _jax_cfg(fam)
    if fam == "vit":
        return pkg.slim_vit(variables, masks, cfg, **kw)
    if fam == "vgg":
        return pkg.slim_vgg(variables, masks, cfg, **kw)
    if fam == "swin":
        return pkg.slim_swin(variables, masks, cfg, **kw)
    return pkg.slim_resnet(variables, masks, **kw)


def _jax_cfg(fam, **overrides):
    if fam == "vit":
        return jvit.ViTConfig(**{**VIT, **overrides})
    if fam == "vgg":
        return jvgg.VGGConfig(**{**VGG, **overrides})
    if fam == "swin":
        return jswin.SwinV2Config(**{**SWIN, "stochastic_depth_prob": 0.0, **overrides})
    return None


def _jax_module(fam, overrides):
    if fam == "vit":
        return jvit.VisionTransformer(cfg=_jax_cfg(fam, **overrides), image_size=(16, 16))
    if fam == "vgg":
        return jvgg.VGG16(num_classes=5, cfg=_jax_cfg(fam, **overrides))
    if fam == "swin":
        return jswin.SwinTransformerV2(cfg=_jax_cfg(fam, **overrides))
    return jreg.build_model(fam, num_classes=4,
                            **({"arch_overrides": overrides} if overrides else {})).module


def _port_logits(spec, variables, masks=None):
    model = spec.module()
    sd = tck.family(spec).state_dict(variables["params"], variables.get("batch_stats"), masks)
    model.load_state_dict({**dict(model.named_buffers()), **sd})
    model.eval()
    return model


def _port_forward(spec, variables, x, masks=None):
    with torch.no_grad():
        return _port_logits(spec, variables, masks)(torch.from_numpy(x))[0].numpy()


def _flat_equal(a, b):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert sorted(fa) == sorted(fb)
    for p in fa:
        assert np.array_equal(np.asarray(fa[p]), np.asarray(fb[p])), p


@pytest.mark.parametrize("fam", FAMILIES)
def test_slim_matches_jax_exactly(fam):
    """Overrides, report, kept indices, slim trees and masks equal the JAX
    package's on the same inputs; the kept sets are the non-inert units."""
    jv, jm, jo, jr = _slim(js, fam)
    tv, tm, to, tr = _slim(ts, fam)
    assert to == jo and to
    for f in ("mlp_dim", "num_heads", "head_dim", "params_before", "params_after"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.param_reduction == jr.param_reduction > 0
    for kept_t, kept_j in ((tr.kept_neurons, jr.kept_neurons), (tr.kept_heads, jr.kept_heads)):
        assert sorted(kept_t) == sorted(kept_j)
        for k in kept_t:
            assert np.array_equal(kept_t[k], kept_j[k]), k
    _flat_equal(tv["params"], jv["params"])
    if "batch_stats" in jv:
        _flat_equal(tv["batch_stats"], jv["batch_stats"])
    assert sorted(tm) == sorted(jm)
    for p in tm:
        assert np.array_equal(np.asarray(tm[p]), np.asarray(jm[p])), p
    dropped = case(fam)[3]
    for unit, idx in dropped.items():
        if unit.endswith("/heads"):
            total = VIT["num_heads"]
            kept = tr.kept_heads[unit[:-len("/heads")]]
        else:
            kept = tr.kept_neurons[unit]
            total = len(kept) + len(idx)
        assert np.array_equal(kept, np.setdiff1d(np.arange(total), idx)), unit


@pytest.mark.parametrize("fam", FAMILIES)
def test_slim_forward_exact_and_matches_jax(fam):
    """The exactness contract on the port (the slim model = the masked
    dense model), and the port's slim forward against the JAX slim
    forward on the same slim tree."""
    spec, variables, masks, _d, _kw, x = case(fam)
    tv, tm, overrides, _r = _slim(ts, fam)
    dense = _port_forward(spec, variables, x, masks)
    slim_spec = spec.rebuild(dataclasses.replace(spec.cfg, **overrides))
    got = _port_forward(slim_spec, tv, x, tm)
    tol = 2e-5 if fam == "vit" else 1e-4
    np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)
    jvars = {**tv, "params": japply_masks(tv["params"], tm)}
    apply = jax.jit(functools.partial(_jax_module(fam, overrides).apply, train=False))
    want, _aux = apply(jvars, jnp.asarray(x))
    fx.scaled_close(got, np.asarray(want), rel=1e-5, rtol=1e-4)


def test_vit_slim_masks_are_sliced():
    """A surviving unstructured mask (fc1) comes out sliced along the kept
    neurons, and the slim tree loads strictly into the rebuilt module."""
    spec, _v, masks, _d, _kw, _x = case("vit")
    tv, tm, overrides, _r = _slim(ts, "vit")
    p = ("encoder_layer_0", "mlp", "fc1", "kernel")
    assert tm[p].shape == (32, overrides["mlp_dim"]) == (32, 32)
    slim_spec = spec.rebuild(dataclasses.replace(spec.cfg, **overrides))
    model = slim_spec.module()
    assert model.layers[0].attention.qkv.weight.shape == (3 * 3 * 8, 32)
    assert model.layers[0].attention.out.weight.shape == (32, 3 * 8)
    model.load_state_dict(tck.family(slim_spec).state_dict(tv["params"], None, tm))
    shapes = {k: tuple(v.shape) for k, v in flatten_dict(tv["params"]).items()}
    assert shapes == {k: tuple(v.shape) for k, v in flatten_dict(
        slim_spec.init(torch.Generator().manual_seed(0))).items()}


def test_headless_vgg_keeps_its_last_conv():
    """A headless VGG16 keeps conv_12 whole: its output is the LOST map."""
    spec = tvgg._spec("vgg16_bottom", tvgg.VGGConfig(headless=True, **VGG), (224, 224))
    params = fx._perturbed(_np_tree(spec.init(torch.Generator().manual_seed(4))))
    out_t = ts.slim_vgg({"params": params}, {}, spec.cfg, conv_keep=0.5, round_to=1)
    out_j = js.slim_vgg({"params": params}, {}, jvgg.VGGConfig(**VGG), conv_keep=0.5,
                        round_to=1)
    assert out_t[2] == out_j[2]
    assert out_t[2]["conv_widths"] == (4,) * 12 + (8,)
    slim_spec = spec.rebuild(dataclasses.replace(spec.cfg, **out_t[2]))
    x = np.zeros((1, 32, 32, 3), np.float32)
    feats = _port_forward(slim_spec, out_t[0], x)
    assert feats.shape == (1, 2, 2, 8)


@pytest.mark.parametrize("total,keep,unit,round_to,want", [
    (64, 0.5, 1, 1, 32), (3072, 0.5, 1, 128, 1536), (3072, 0.49, 1, 128, 1536),
    (12, 0.5, 64, 128, 6), (12, 0.4, 64, 128, 6), (12, 0.01, 64, 128, 2),
    (12, 0.999, 64, 128, 12), (12, None, 64, 128, 12), (10, 0.33, 48, 128, 4),
    (1536, 0.3, 1, 1, 461), (6, 0.5, 64, 1, 3), (6, 0.5, 64, 128, 4)])
def test_keep_count_matches_jax(total, keep, unit, round_to, want):
    """The cases of ``tests/test_structured.py``'s lane-alignment test and
    the slim widths of ViT-S/16 (F = 461 at --round-to 1, 3 or 4 heads)."""
    assert ts._keep_count(total, keep, unit, round_to) == want
    assert js._keep_count(total, keep, unit, round_to) == want


def test_sidecar_helpers_match_jax(tmp_path):
    """``merge_overrides`` merges per block in both packages; a missing
    sidecar reads as None."""
    base = {"inner_widths": {"layer1_0": 32, "layer2_0": 64}, "mlp_dim": 8}
    new = {"inner_widths": {"layer2_0": 48}, "mlp_dim": 4}
    assert ts.merge_overrides(base, new) == js.merge_overrides(base, new) == {
        "inner_widths": {"layer1_0": 32, "layer2_0": 48}, "mlp_dim": 4}
    assert ts.arch_sidecar("") is None and ts.arch_sidecar(str(tmp_path / "none")) is None


def test_build_model_arch_overrides():
    """JSON lists come back as tuples (the VGG widths, a Bottleneck's
    pair); ``extra`` follows the new config; a field the config lacks
    raises TypeError, a spec without a config ValueError; the override
    rebuilds at the caller's other arguments."""
    spec = tbuild("vgg16", num_classes=3, arch_overrides={"fc_dims": [2048, 2048]})
    assert spec.cfg.fc_dims == (2048, 2048) and spec.num_classes == 3
    spec = tbuild("resnet50", num_classes=3,
                  arch_overrides={"inner_widths": {"layer1_0": [32, 48]}})
    blk = spec.module().layer1[0]
    assert blk.conv1.weight.shape[0] == 32 and blk.conv2.weight.shape == (48, 32, 3, 3)
    assert blk.conv3.weight.shape == (256, 48, 1, 1)
    spec = tbuild("vit_s_16", image_size=(64, 32),
                  arch_overrides={"num_heads": 4, "head_dim": 64, "mlp_dim": 768})
    assert (spec.cfg.num_heads, spec.cfg.head_dim, spec.input_size) == (4, 64, (64, 32))
    spec = tbuild("dino_vit_tiny", arch_overrides={"num_heads": 2})
    assert spec.extra["num_heads"] == 2
    with pytest.raises(TypeError, match="mlp_dim"):
        tbuild("resnet18", num_classes=10, arch_overrides={"mlp_dim": 8})
    treg._BUILTIN_MODELS["no_cfg_test"] = lambda: dataclasses.replace(
        tbuild("resnet18"), rebuild=None)
    try:
        with pytest.raises(ValueError, match="arch_overrides"):
            tbuild("no_cfg_test", arch_overrides={"mlp_dim": 8})
    finally:
        del treg._BUILTIN_MODELS["no_cfg_test"]


@pytest.mark.parametrize("f", [200, 1])
def test_fused_mlp_plain_at_a_slim_width_matches_jax_kernel(monkeypatch, f):
    """The plain version (the CPU path and the card's oracle) at F = 200
    and F = 1 against the JAX kernel in interpret mode, at the f32
    tolerance of ``tests/test_torch_fused_mlp.py``."""
    monkeypatch.setenv("VIPERS_FUSED_MLP_INTERPRET", "1")
    d = 384
    rng = np.random.default_rng(f)
    x = rng.normal(size=(2, 128, d)).astype(np.float32)
    g = (rng.normal(size=(d,)) * 0.3 + 1).astype(np.float32)
    b = (rng.normal(size=(d,)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    bb = (rng.normal(size=(f,)) * 0.1).astype(np.float32)
    want = np.asarray(jfm.fused_ln_dense_gelu(*map(jnp.asarray, (x, g, b, w, bb))))
    w_eff_t, b_eff = tfm.fold_ln_affine(*map(torch.from_numpy, (g, b, w, bb)), torch.float32)
    got = tfm.fused_ln_dense_gelu_plain(torch.from_numpy(x).reshape(-1, d), w_eff_t, b_eff,
                                        1e-6).reshape(2, 128, f)
    assert got.shape == want.shape
    rel = np.max(np.abs(got.numpy() - want) / (np.abs(want) + 1e-3))
    assert rel < 2e-3
