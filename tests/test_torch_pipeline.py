"""The whole batched LOST pipeline, vipers_torch against the JAX package:
uint8 images -> device normalize -> masked ViT forward -> qkv scramble ->
batched LOST core, on an exact-fit bucket and a masked bucket, in f32.

Boxes, seeds and seed-in-background flags must be equal. Patch scores are
integer degree counts, so a seed may legitimately differ only inside a tie
at the top score (as in tests/test_reference_parity.py); then both seeds
must hold the maximal score. The small config (2 layers, D=128, 2 heads of
64, mlp 256) reaches the seq-pad/flash route once both packages' flash
threshold is lowered to 16 tokens (``VIPERS_FLASH_MIN_T``, which both read
at call time), and the packed token-major route with
``VIPERS_PACKED_ATTENTION=1`` besides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vipers.models.vit as jvit
import vipers_torch.models.vit as tvit
from vipers.pruning import init_masks, magnitude_prune
from vipers_torch.discovery.driver import LostFeatureExtractor
from vipers_torch.discovery.lost import lost_core

jdriver = importlib.import_module("vipers.discovery.driver")

CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128,
           mlp_dim=256, num_classes=10)
IMAGE = (128, 64)  # an 8 x 4 patch grid: exactly one bucket
K = 10


@pytest.fixture(scope="module")
def model():
    spec = jvit._build("tiny", jvit.ViTConfig(**CFG), IMAGE)
    variables = spec.module.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, *IMAGE, 3), jnp.float32), train=False)
    masks = magnitude_prune(variables["params"],
                            init_masks(variables["params"], exclude=spec.prune_exclude),
                            amount=0.5)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    tspec = tvit._build("tiny", tvit.ViTConfig(**CFG), IMAGE)
    tmasks = {p: np.asarray(m) for p, m in masks.items()}
    return spec, variables, masks, tspec, params, tmasks


def _images(exact_hw, seed):
    """Tier-1-padded uint8 images (zero beyond the exact pixel extent, as
    the native decoder returns them) with a bright block each."""
    rng = np.random.default_rng(seed)
    imgs = []
    for h, w in exact_hw:
        im = np.zeros((-(-h // 16) * 16, -(-w // 16) * 16, 3), np.uint8)
        im[:h, :w] = rng.integers(0, 120, (h, w, 3))
        r, c = rng.integers(0, h // 2), rng.integers(0, w // 2)
        im[r:r + h // 3, c:c + w // 3] = rng.integers(180, 256, 3)
        imgs.append(im)
    return imgs


BUCKETS = {
    "exact": [IMAGE] * 4,
    "masked": [IMAGE, (100, 60), (112, 50), (97, 33)],
}


@pytest.mark.parametrize("bucket,flash,packed", [("exact", True, False),
                                                 ("masked", True, False),
                                                 ("masked", False, False),
                                                 ("masked", True, True)],
                         ids=["exact-flash", "masked-flash", "masked-einsum",
                              "masked-packed"])
def test_batched_pipeline_matches_jax(model, monkeypatch, bucket, flash, packed):
    spec, variables, masks, tspec, params, tmasks = model
    monkeypatch.delenv("VIPERS_PACKED_ATTENTION", raising=False)
    if flash:
        monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    if packed:
        monkeypatch.setenv("VIPERS_PACKED_ATTENTION", "1")
        calls = []
        real = tvit.flash_attention_packed
        monkeypatch.setattr(tvit, "flash_attention_packed",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    exact_hw = BUCKETS[bucket]
    imgs = _images(exact_hw, seed=len(bucket))

    jex = jdriver.LostFeatureExtractor(spec, variables, masks, arch="vit", which_features="k")
    jin = jex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    jbox, jseed, jbg = map(np.asarray, jex.make_batched_pipeline(k_patches=K)(jex.variables, *jin))

    tex = LostFeatureExtractor(tspec, params, tmasks, which_features="k", device="cpu")
    tin = tex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    assert (tin[2] is None) == (bucket == "exact") and (tin[4] is None) == (bucket == "exact")
    tbox, tseed, tbg = (z.numpy() for z in tex.make_batched_pipeline(k_patches=K)(*tin))
    if packed:  # one call per block of the port's forward
        assert len(calls) == CFG["num_layers"]

    np.testing.assert_array_equal(tbg, jbg)
    feats = tex.batched_features(*tin)
    scores = lost_core(feats, tin[3], (8, 4), k_patches=K)["scores"].numpy()
    for i in range(len(imgs)):
        if tseed[i] == jseed[i]:
            np.testing.assert_array_equal(tbox[i], jbox[i])
        else:  # a tie at the top score, broken the same way only by chance
            assert scores[i, tseed[i]] == scores[i, jseed[i]] == scores[i].max()
    assert (tseed == jseed).sum() >= len(imgs) - 1


def test_prepare_batch_matches_jax(model):
    spec, variables, masks, tspec, params, tmasks = model
    exact_hw = BUCKETS["masked"]
    imgs = _images(exact_hw, seed=9)
    jin = jdriver.LostFeatureExtractor(spec, variables, masks).prepare_batch(
        imgs, 16, exact_hw=exact_hw)
    tin = LostFeatureExtractor(tspec, params, tmasks, device="cpu").prepare_batch(
        imgs, 16, exact_hw=exact_hw)
    np.testing.assert_array_equal(tin[0].numpy(), np.asarray(jin[0]))
    np.testing.assert_allclose(tin[1].numpy(), np.asarray(jin[1]), rtol=1e-6, atol=1e-7)
    for a, b in zip(tin[2:], jin[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
