"""MobileNetV2 LOST in vipers_torch (``lost --arch mobilenet``, any arch but
vit, dino and swin runs the CNN path) against the JAX package on the CPU:
the feature extent, the bucket arithmetic, the batched CNN pipeline in
f32, bf16 and int8 (``quantized_mobilenet_v2``), the exact-shape per-image
path, the int32 accumulators of the model's integer convolutions, and the
CLI on the committed VOC fixture.

Weights: a MobileNetV2 at width 0.25 and 10 classes, the port's
flax-default init (seed 0) as numpy trees, running statistics drawn away
from mean 0 / var 1, a 50% global magnitude mask; both packages read the
same trees. Tolerances: extents, canonical inputs, bucket keys, boxes and
seeds exact (int8 and bf16: tie-aware, as ``test_torch_quantize_lost``);
f32 features 1e-4 of their scale, bf16 2e-2, int8 the int8 tests'; int32
accumulators equal.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cnn_lost as cnnt
import torch_explain_fixtures as fx
import vipers.discovery.driver as jdriver
from test_torch_quantize_lost import _boxes_tie_aware, _features_close
from vipers.core.registry import build_model as jbuild
from vipers_torch.cli.main import main
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.discovery import lost as tlost
from vipers_torch.discovery.driver import LostFeatureExtractor, device_normalize
from vipers_torch.train import quantize as tq

WIDTH = 0.25
KW = dict(num_classes=10, width_mult=WIDTH)
SIZES = [(96, 88), (93, 84), (90, 81)]
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": ("int8", "int8")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@functools.lru_cache(maxsize=None)
def _weights(model="mobilenet_v2", width=WIDTH):
    spec = tbuild(model, num_classes=10, width_mult=width)
    params = jax.tree.map(lambda a: a.numpy(), spec.init(torch.Generator().manual_seed(0)))
    masks = {p: m.numpy() for p, m in cnnt.tprune.magnitude_prune(
        params, cnnt.tprune.init_masks(params), amount=0.5).items()}
    return params, cnnt._stats(params), masks


@functools.lru_cache(maxsize=None)
def _extractors(dtype="f32", cnn_bucket=4, model="mobilenet_v2"):
    params, stats, masks = _weights(model)
    jdt, tdt = DTYPES[dtype]
    jex = jdriver.LostFeatureExtractor(jbuild(model, **KW),
                                       {"params": params, "batch_stats": stats},
                                       {p: jnp.asarray(m) for p, m in masks.items()},
                                       arch="mobilenet", compute_dtype=jdt, cnn_bucket=cnn_bucket)
    tex = LostFeatureExtractor(tbuild(model, **KW), params, masks, device="cpu",
                               batch_stats=stats, compute_dtype=tdt, cnn_bucket=cnn_bucket)
    return jex, tex


def test_feature_extent_matches_jax_eval_shape():
    """``MobileNetV2.feature_extent`` for every px 33-1024 against the JAX
    extractor's ``eval_shape`` of the model: one trace at a symbolic height
    gives the JAX module's own extent formula, evaluated at every px, and
    ``_cnn_fdim`` (one trace a size) agrees with it where probed."""
    jex, tex = _extractors()
    h, = jax.export.symbolic_shape("h")
    out = jax.eval_shape(jex._raw_cnn_feats, jex.variables,
                         jax.ShapeDtypeStruct((1, h, 64, 3), jnp.float32))
    extent = out.shape[1]
    for px in range(33, 1025):
        assert tex.model.feature_extent(px) == extent._evaluate({"h": px}), px
    for px in (33, 64, 65, 385):
        assert jex._cnn_fdim(px) == extent._evaluate({"h": px}) == tex._cnn_fdim(px), px


@pytest.mark.parametrize("cnn_bucket", [4, 3])
def test_canonical_inputs_and_bucket_keys_match_jax(cnn_bucket):
    """``_cnn_canon_input``, ``cnn_bucket_key`` and ``cnn_scales`` for every
    size 33-640 against the JAX extractor's methods on the same extents."""
    tex = _extractors(cnn_bucket=cnn_bucket)[1]
    jrule = cnnt._JaxBucketRule(tex.model.feature_extent, cnn_bucket)
    for px in range(33, 641):
        assert tex.cnn_bucket_key(px, 673 - px) == jrule.cnn_bucket_key(px, 673 - px), px
        f = tex._cnn_fdim(px)
        assert tex._cnn_canon_input(f) == jrule._cnn_canon_input(f), px
        assert tex.cnn_scales(px, px) == jrule.cnn_scales(px, px)


def _pipelines(dtype):
    """Both packages' batched CNN pipeline on one mixed bucket of 3 uint8
    images: (JAX outputs, port outputs, port inputs, port extractor, key)."""
    jex, tex = _extractors(dtype)
    imgs = cnnt._u8_batch(SIZES, 5)
    key = tex.cnn_bucket_key(*SIZES[0])
    assert {tex.cnn_bucket_key(h, w) for h, w in SIZES} == {key}
    jin = jex.prepare_cnn_batch(imgs, key, exact_hw=SIZES)
    tin = tex.prepare_cnn_batch(imgs, key, exact_hw=SIZES)
    jout = [np.asarray(a) for a in jex.make_batched_cnn_pipeline(10)(jex.variables, *jin)]
    tout = [a.numpy() for a in tex.make_batched_cnn_pipeline(10)(*tin)]
    return jex, jin, jout, tex, tin, tout, key


def test_batched_cnn_pipeline_matches_jax():
    """f32: boxes, seeds and background flags equal to the JAX pipeline's,
    the masked slab-LayerNorm features within 1e-4 of their scale."""
    jex, jin, (jbox, jseed, jbg), tex, tin, (tbox, tseed, tbg), _key = _pipelines("f32")
    np.testing.assert_array_equal(tseed, jseed)
    np.testing.assert_array_equal(tbox, jbox)
    np.testing.assert_array_equal(tbg, jbg)
    images = jdriver._device_normalize(jin[0], jin[2])
    feats = np.asarray(jax.jit(jex._raw_cnn_feats)(jex.variables, images))
    with torch.inference_mode():
        got = tex.model(device_normalize(tin[0], tin[2]))[1]["features"].numpy()
    np.testing.assert_allclose(got, feats, atol=1e-4 * np.abs(feats).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_batched_cnn_pipeline_bf16_and_int8_match_jax(dtype):
    """bf16 (the network's parameters cast, BatchNorm in f32) and int8
    (``lost --dtype int8``: every convolution in real int8, dynamic ranges):
    background flags equal, boxes and seeds equal up to a tie at the top
    score, the head map within 2e-2 of its scale (bf16) or the int8 tests'
    tolerance."""
    jex, jin, (jbox, jseed, jbg), tex, tin, (tbox, tseed, tbg), key = _pipelines(dtype)
    np.testing.assert_array_equal(tbg, jbg)
    feats = tex.cnn_features(*tin)
    grid = (tex._cnn_fdim(key[0]), tex._cnn_fdim(key[1]))
    scores = tlost.lost_core(feats.float(), tin[1], grid, k_patches=10)["scores"].numpy()
    _boxes_tie_aware(tbox, tseed, jbox, jseed, scores)
    images = jdriver._device_normalize(jin[0], jin[2]).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jex._raw_cnn_feats)(jex.variables, images), np.float32)
    with torch.inference_mode(), tex._int8_scope():
        got = tex.model(device_normalize(tin[0], tin[2]).to(torch.bfloat16))[1]["features"]
    got = got.float().numpy()
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(), rtol=0)
    else:
        _features_close(got, want)


def test_exact_shape_lost_matches_jax():
    """``--exact-shapes`` (``--cnn-bucket 1``): one host-normalized image at
    its own shape through ``extract`` -> ``lost``: the same box, seed and
    feature grid as the JAX package's per-image path."""
    jex, tex = _extractors(cnn_bucket=1)
    img = np.random.default_rng(7).normal(0, 1, (90, 70, 3)).astype(np.float32)
    jf, jdims, jvalid, jscales, _ = jex.extract(img, 16)
    tf, tdims, tvalid, tscales, _ = tex.extract(img, 16)
    assert (tuple(tdims), tuple(tvalid), list(tscales)) == (tuple(jdims), tuple(jvalid),
                                                            list(jscales))
    want = jdriver.lost(jf, jdims, jscales, (3, 90, 70), k_patches=10, valid_dims=jvalid)
    got = tlost.lost(tf, tdims, tscales, (3, 90, 70), k_patches=10, valid_dims=tvalid)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert int(got[3]) == int(want[3])


# the quantized model's integer convolutions: (cin, cout, kernel, stride,
# groups) of the stem, a 1x1 expand, the stride-2 and stride-1 depthwise, a
# 1x1 project and the head convolution at width 0.25
CONVS = [(3, 8, 3, 2, 1), (8, 48, 1, 1, 1), (48, 48, 3, 2, 48), (48, 48, 3, 1, 48),
         (48, 8, 1, 1, 1), (80, 1280, 1, 1, 1)]


@pytest.mark.parametrize("cin,cout,k,stride,groups", CONVS,
                         ids=["stem", "expand", "dw-s2", "dw-s1", "project", "head"])
def test_quantized_mobilenet_int32_accumulators_equal_jax(cin, cout, k, stride, groups):
    """Each integer convolution ``quantized_mobilenet_v2`` runs, on int8
    inputs and kernels (the extremes -128/127 included): the CPU's and the
    card's lowered route (im2col, per-tap int32 for the depthwise) give
    the JAX package's int32 accumulators exactly."""
    rng = np.random.default_rng(cin * 7 + cout + k + stride + groups)
    x = rng.integers(-128, 128, (2, 17, 15, cin)).astype(np.int8)
    w = rng.integers(-128, 128, (k, k, cin // groups, cout)).astype(np.int8)
    x[0, 0, 0], w[0, 0, 0] = -128, 127
    pad = (k - 1) // 2  # the zero point is 0: padded int8 inputs, VALID products
    x = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    for fn in (tq.conv_int32, tq.conv_int32_lowered):  # the CPU's, the card's route
        got = fn(xt, wt, (stride, stride), (1, 1), groups)
        assert got.dtype == torch.int32, fn.__name__
        np.testing.assert_array_equal(got.numpy(), want)


def test_lost_cli_runs_mobilenet_under_any_cnn_arch(tmp_path):
    """``vipers_torch lost --model mobilenet_v2`` (``--arch mobilenet``, and
    an arch outside vit, dino and swin names no refusal): the batched run
    and the ``--exact-shapes`` run write one prediction an image, and the
    same boxes from one ``.pth`` under two arch names (the registry's width:
    the CLI builds ``mobilenet_v2`` at width 1)."""
    params, stats, masks = _weights(width=1.0)
    pth = str(tmp_path / "mb.pth")
    tck.save_torch_state_dict(tck.export_mobilenet_v2(params, stats, masks, bake_masks=False),
                              pth)
    data = cnnt._voc_subset(tmp_path / "voc")
    preds = {}
    for tag, arch, extra in (("mobilenet", "mobilenet", []), ("cnn", "cnn", []),
                             ("exact", "mobilenet", ["--exact-shapes"])):
        assert main([*cnnt._lost_args(arch, "mobilenet_v2", data, tmp_path / tag, pth, extra),
                     "--device", "cpu"]) == 0
        preds[tag] = {k: np.asarray(v).tolist() for k, v in pickle.load(
            open(tmp_path / tag / "preds.pkl", "rb")).items()}
    assert preds["mobilenet"] == preds["cnn"] and len(preds["mobilenet"]) == 3
    assert sorted(preds["exact"]) == sorted(preds["mobilenet"])
    assert os.path.exists(tmp_path / "exact" / "results_iteration_00.txt")
