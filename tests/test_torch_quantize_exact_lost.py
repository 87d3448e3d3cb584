"""``lost --dtype int8`` on the per-image CNN path (``--exact-shapes``:
``extract`` at the image's own shape, then ``lost``; resnet18 with dilate
2) in vipers_torch against the JAX package on the CPU: the features within
2e-2 of their scale and the box equal (see
``tests/test_torch_quantize_lost.py``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_cnn_lost as cnnt
import torch_explain_fixtures as fx
from test_torch_quantize_lost import _features_close
from vipers_torch.discovery.driver import LostFeatureExtractor
from vipers_torch.discovery.lost import lost

jdriver = importlib.import_module("vipers.discovery.driver")
jlost = importlib.import_module("vipers.discovery.lost")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def test_int8_per_image_cnn_path_matches_jax():
    """``--exact-shapes``: ``extract`` at the image's own shape, int8."""
    params, stats, masks = cnnt._weights("resnet18", 2)
    variables = {"params": params, "batch_stats": stats}
    jex = jdriver.LostFeatureExtractor(cnnt.jbuild("resnet18", dilate=2), variables,
                                       {p: jnp.asarray(m) for p, m in masks.items()},
                                       arch="resnet", compute_dtype="int8", cnn_bucket=1)
    tex = LostFeatureExtractor(cnnt.tbuild("resnet18", dilate=2), params, masks, device="cpu",
                               batch_stats=stats, compute_dtype="int8", cnn_bucket=1)
    img = np.random.default_rng(4).normal(0, 1, (80, 96, 3)).astype(np.float32)
    jf, jdims, _jv, _js, _ja = jex.extract(img, 16)
    tf, tdims, _tv, scales, _ta = tex.extract(img, 16)
    assert tuple(tdims) == tuple(jdims)
    _features_close(tf.float().numpy(), np.asarray(jf, np.float32))
    jpred = np.asarray(jlost.lost(jf, jdims, scales, (3, 80, 96), k_patches=10)[0])
    tpred = np.asarray(lost(tf, tdims, scales, (3, 80, 96), k_patches=10)[0])
    np.testing.assert_array_equal(tpred, jpred)
