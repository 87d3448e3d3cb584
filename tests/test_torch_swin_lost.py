"""The per-image LOST path of vipers_torch against the JAX package on the
CPU: ``discovery.lost.lost`` and ``detect_box``, ``LostFeatureExtractor
.extract`` for Swin (the first window, and ``swin_all_windows``) and for
the CNNs at their own shape (``--exact-shapes``) and bucketed at B = 1.
The CLI runs are in ``tests/test_torch_swin_lost_cli.py``.

Swin LOST needs weights whose biases are not zero (with zero biases a
window pad token's k is exactly zero, wins the inverse-degree seed and
every image fails, in both packages): the Swin cases read a random
torchvision-layout ``swin_v2_t`` state dict (``tests/torch_swin_oracle``),
as the JAX package's own Swin LOST test does. The CNN cases use
``tests/test_torch_cnn_lost.py``'s ResNet-18 weights (dilate 2, running
statistics away from 0 / 1, 50% masks). f32. Tolerances: seeds, boxes,
dims and scales exact; features 1e-4 of their scale.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.core.checkpoint as jck
import vipers.discovery.driver as jdriver
from tests import torch_swin_oracle as oracle
from tests.test_torch_cnn_lost import _weights
from vipers.core.registry import build_model as jbuild
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.discovery import lost as tlost
from vipers_torch.discovery.driver import LostFeatureExtractor

# the module: the package's ``__init__`` exports the function ``lost``
jlost = importlib.import_module("vipers.discovery.lost")
K = 10


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_lost_and_detect_box_match_jax():
    """``lost`` on random (1, T, D) features of a 5x7 grid with a 4x6
    valid corner, and ``detect_box`` on its mass map: the same box,
    affinity, scores and seed as the JAX package's; a zero feature row is
    the seed and lies in the background: both raise."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1, 35, 16)).astype(np.float32)
    got = tlost.lost(torch.from_numpy(feats), (5, 7), [16, 16], (3, 75, 100), k_patches=K,
                     valid_dims=(4, 6))
    want = jlost.lost(feats, (5, 7), [16, 16], (3, 75, 100), k_patches=K, valid_dims=(4, 6))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    mass = (got[1][:, got[3]] > 0).astype(np.float32) - 0.5
    assert tlost.detect_box(mass, got[3], (5, 7), (75, 100), [16, 16]) == \
        jlost.detect_box(mass, got[3], (5, 7), (75, 100), [16, 16])
    feats[0, 8] = 0.0
    for fn in (tlost.lost, jlost.lost):
        with pytest.raises(ValueError, match="background"):
            fn(feats, (5, 7), [16, 16], (3, 75, 100), k_patches=K)
    with pytest.raises(ValueError, match="background"):
        tlost.detect_box(-np.ones(35), 3, (5, 7), scales=[16, 16])


def _swin_sd():
    return oracle.random_torchvision_swin_sd(seed=0, num_classes=10)


def test_swin_extract_matches_jax_in_both_regimes():
    """A 384x512 image (the last stage 12x16, padded to 16x16 and shifted):
    the first window (dims = the window side, scales image / patch) and
    the whole grid (dims 12x16, the true scales); features, dims, scales,
    then ``lost``'s box and seed, equal to the JAX extractor's."""
    sd = {k: v.numpy() for k, v in _swin_sd().items()}
    params, _ = tck.import_swin_v2_t(sd)
    jparams, _, _ = jck.import_torch_checkpoint(sd, "swin_v2_t")
    jex = jdriver.LostFeatureExtractor(jbuild("swin_v2_t", num_classes=10),
                                       {"params": jparams}, arch="swin", which_features="k")
    img = np.random.default_rng(1).normal(size=(384, 512, 3)).astype(np.float32)
    for all_windows, dims, scales in ((False, (8, 8), [24.0, 32.0]),
                                      (True, (12, 16), [32.0, 32.0])):
        tex = LostFeatureExtractor(tbuild("swin_v2_t", num_classes=10), params, device="cpu",
                                   swin_all_windows=all_windows)
        jex.swin_all_windows = all_windows
        jf, jd, jv, js, jattn = jex.extract(img, 16)
        tf, td, tv, ts, tattn = tex.extract(img, 16)
        assert (tuple(td), tuple(tv), list(ts)) == (tuple(jd), tuple(jv), list(js)) == (
            dims, dims, scales)
        assert tf.shape == jf.shape == (1, dims[0] * dims[1], 768)
        assert tuple(tattn.shape) == jattn.shape
        _close(tf.numpy(), jf)
        got = tlost.lost(tf, td, ts, (3, 384, 512), k_patches=K, valid_dims=tv)
        want = jlost.lost(jf, jd, js, (3, 384, 512), k_patches=K, valid_dims=jv)
        assert got[3] == want[3]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("cnn_bucket", [1, 4])
def test_cnn_extract_matches_jax(cnn_bucket):
    """ResNet-18 dilate 2 on a 100x76 image: at its own shape
    (``--exact-shapes``: the whole-slab LayerNorm) and bucketed at B = 1
    (the grid rounded up to a multiple of 4, pad cells masked): the same
    features, dims, valid dims, scales, box and seed as the JAX
    extractor's."""
    params, stats, masks = _weights("resnet18", 2)
    jex = jdriver.LostFeatureExtractor(
        jbuild("resnet18", dilate=2), {"params": params, "batch_stats": stats},
        {p: jnp.asarray(m) for p, m in masks.items()}, arch="resnet", cnn_bucket=cnn_bucket)
    tex = LostFeatureExtractor(tbuild("resnet18", dilate=2), params, masks, device="cpu",
                               batch_stats=stats, cnn_bucket=cnn_bucket)
    img = np.random.default_rng(2).normal(size=(100, 76, 3)).astype(np.float32)
    jf, jd, jv, js, _ = jex.extract(img, 16)
    tf, td, tv, ts, attn = tex.extract(img, 16)
    assert attn is None and (tuple(td), tuple(tv), list(ts)) == (tuple(jd), tuple(jv), list(js))
    _close(tf.numpy(), jf)
    got = tlost.lost(tf, td, ts, (3, 100, 76), k_patches=K, valid_dims=tv)
    want = jlost.lost(np.asarray(jf), jd, js, (3, 100, 76), k_patches=K, valid_dims=jv)
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[0], want[0])


def test_per_image_vit_extract_names_what_it_serves():
    """The per-image ViT path serves ``--dinoseg`` (ROADMAP A2, now
    ported): with ``need_attn`` it returns the last block's attention on
    the bucket grid; without, none."""
    spec = tbuild("vit_s_16", num_classes=0)
    params = spec.init(torch.Generator().manual_seed(0))
    for need_attn in (True, False):
        ex = LostFeatureExtractor(spec, params, device="cpu", need_attn=need_attn)
        feats, dims, valid, scales, attn = ex.extract(np.zeros((32, 32, 3), np.float32), 16)
        assert (tuple(dims), tuple(valid), scales) == ((4, 4), (2, 2), [16, 16])
        assert feats.shape == (1, 16, 384)
        assert (attn.shape == (1, 6, 17, 17)) if need_attn else attn is None
