"""``lost --dtype int8`` on the batched CNN pipeline (``--arch resnet``,
resnet18 with dilate 2) in vipers_torch against the JAX package on the
CPU, one mixed bucket of 3 uint8 images (the per-image path:
``tests/test_torch_quantize_exact_lost.py``). int8 kernels baked
from the masked f32 weights, real int8 convolutions, the rest in bf16.
Boxes and seeds equal where the seed is not a tie at the top score, the
features within 2e-2 of their scale (see
``tests/test_torch_quantize_lost.py``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cnn_lost as cnnt
import torch_explain_fixtures as fx
from test_torch_quantize_lost import _boxes_tie_aware, _features_close
from vipers_torch.discovery.driver import LostFeatureExtractor, device_normalize
from vipers_torch.discovery.lost import lost_core

jdriver = importlib.import_module("vipers.discovery.driver")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def test_int8_batched_cnn_pipeline_matches_jax():
    params, stats, masks = cnnt._weights("resnet18", 2)
    variables = {"params": params, "batch_stats": stats}
    jex = jdriver.LostFeatureExtractor(cnnt.jbuild("resnet18", dilate=2), variables,
                                       {p: jnp.asarray(m) for p, m in masks.items()},
                                       arch="resnet", compute_dtype="int8")
    tex = LostFeatureExtractor(cnnt.tbuild("resnet18", dilate=2), params, masks, device="cpu",
                               batch_stats=stats, compute_dtype="int8")
    sizes = [(96, 88), (93, 84), (90, 81)]
    imgs = cnnt._u8_batch(sizes, 5)
    key = tex.cnn_bucket_key(96, 88)
    jin = jex.prepare_cnn_batch(imgs, key, exact_hw=sizes)
    tin = tex.prepare_cnn_batch(imgs, key, exact_hw=sizes)
    jbox, jseed, jbg = (np.asarray(a) for a in jex.make_batched_cnn_pipeline(10)(
        jex.variables, *jin))
    tbox, tseed, tbg = (a.numpy() for a in tex.make_batched_cnn_pipeline(10)(*tin))
    np.testing.assert_array_equal(tbg, jbg)
    feats = tex.cnn_features(*tin)
    grid = (tex._cnn_fdim(key[0]), tex._cnn_fdim(key[1]))
    scores = lost_core(feats.float(), tin[1], grid, k_patches=10)["scores"].numpy()
    _boxes_tie_aware(tbox, tseed, jbox, jseed, scores)
    images = jdriver._device_normalize(jin[0], jin[2]).astype(jnp.bfloat16)
    jraw = np.asarray(jex._raw_cnn_feats(jex.variables, images), np.float32)
    with torch.inference_mode(), tex._int8_scope():
        _logits, aux = tex.model(device_normalize(tin[0], tin[2]).to(torch.bfloat16))
    _features_close(aux["features"].float().numpy(), jraw)
