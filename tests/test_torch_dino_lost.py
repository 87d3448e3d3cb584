"""DINO LOST and the DINO attention segmentation, vipers_torch against the
JAX package on the CPU: the batched ``--arch dino`` pipeline (uint8 images
-> device normalize -> masked DINO forward -> true qkv split -> batched
LOST core) on an exact-fit and a masked bucket; the per-image ``extract``
of a ViT and a DINO ViT with the last block's attention; ``dino_seg``
(default and ``reference_bugs``) on model outputs and on seeded attention
maps; ``label_components`` and ``largest_component_mask`` on seeded masks;
``dino_seg`` at bucket 4 equal to exact shapes.

Small models: ``dino_vit_tiny``'s width cut to 2 blocks
(``tests/test_torch_dino.py``'s weights, pos table at 224) and a 2-block
ViT (D 128, 2 heads of 64), both packages' flash threshold lowered to 16
tokens (``VIPERS_FLASH_MIN_T``) so the non-final blocks take the flash
route. Boxes, seeds and flags equal (a seed may differ only inside a tie
at the top score, as in ``tests/test_torch_pipeline.py``); features f32
atol 1e-5 / rtol 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.discovery.components as jcomp
import vipers.models.dino_vit as jdino
import vipers.models.vit as jvit
import vipers_torch.models.vit as tvit
from tests import torch_explain_fixtures as fx
from tests.test_torch_dino import DEPTH, _cfgs, models
from tests.test_torch_pipeline import BUCKETS, IMAGE, _images
from vipers_torch.discovery import components as tcomp
from vipers_torch.discovery import lost as tlost
from vipers_torch.discovery.driver import LostFeatureExtractor
from vipers_torch.models import dino_vit as tdino

jdriver = importlib.import_module("vipers.discovery.driver")
jlost = importlib.import_module("vipers.discovery.lost")

K = 10
VIT_CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
               num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture
def flash(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")


def _dino():
    """(JAX spec, variables, port spec, params) of the 2-block DINO."""
    _, params, _ = models(16)
    jcfg, tcfg = _cfgs(16)
    return jdino._build("dino_test", jcfg), {"params": params}, \
        tdino._build("dino_test", tcfg), params


def _vit():
    spec = tvit._build("vit_test", tvit.ViTConfig(**VIT_CFG), (64, 64))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: a.numpy() + rng.normal(0, 0.02, a.shape).astype(np.float32),
                          spec.init(torch.Generator().manual_seed(0)))
    return jvit._build("vit_test", jvit.ViTConfig(**VIT_CFG), (64, 64)), {"params": params}, \
        spec, params


@pytest.mark.parametrize("bucket", ["exact", "masked"])
def test_batched_dino_pipeline_matches_jax(bucket, flash, monkeypatch):
    jspec, variables, tspec, params = _dino()
    calls = []
    real = tdino.flash_attention
    monkeypatch.setattr(tdino, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    exact_hw = BUCKETS[bucket]
    imgs = _images(exact_hw, seed=len(bucket) + 3)
    jex = jdriver.LostFeatureExtractor(jspec, variables, arch="dino", which_features="k")
    jin = jex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    jbox, jseed, jbg = map(np.asarray, jex.make_batched_pipeline(k_patches=K)(jex.variables, *jin))
    tex = LostFeatureExtractor(tspec, params, which_features="k", device="cpu")
    tin = tex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    np.testing.assert_allclose(tin[1].numpy(), np.asarray(jin[1]), rtol=1e-6, atol=1e-7)
    tbox, tseed, tbg = (z.numpy() for z in tex.make_batched_pipeline(k_patches=K)(*tin))
    assert len(calls) == DEPTH
    np.testing.assert_array_equal(tbg, jbg)
    feats = tex.batched_features(*tin)
    grid = (IMAGE[0] // 16, IMAGE[1] // 16)
    scores = tlost.lost_core(feats, tin[3], grid, k_patches=K)["scores"].numpy()
    for i in range(len(imgs)):
        if tseed[i] == jseed[i]:
            np.testing.assert_array_equal(tbox[i], jbox[i])
        else:  # a tie at the top score, broken the same way only by chance
            assert scores[i, tseed[i]] == scores[i, jseed[i]] == scores[i].max()
    assert (tseed == jseed).sum() >= len(imgs) - 1


@pytest.mark.parametrize("arch", ["vit", "dino"])
@pytest.mark.parametrize("bucket", [1, 4])
def test_per_image_extract_matches_jax(arch, bucket, flash):
    """``extract`` with the last block's attention: features, grids,
    scales and attention equal to the JAX extractor's, and ``lost`` and
    ``dino_seg`` on them give the JAX package's boxes."""
    jspec, variables, tspec, params = _dino() if arch == "dino" else _vit()
    jex = jdriver.LostFeatureExtractor(jspec, variables, arch=arch, bucket=bucket,
                                       need_attn=True)
    tex = LostFeatureExtractor(tspec, params, bucket=bucket, device="cpu", need_attn=True)
    rng = np.random.default_rng(11)
    img = rng.normal(size=(80, 112, 3)).astype(np.float32)  # a 5 x 7 grid
    img[16:56, 32:80] += 2.5
    jf, jd, jv, js, jattn = jex.extract(img, 16)
    tf, td, tv, ts, tattn = tex.extract(img, 16)
    assert (tuple(td), tuple(tv), list(ts)) == (tuple(jd), tuple(jv), list(js))
    assert td == ((5, 7) if bucket == 1 else (8, 8))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), atol=1e-5, rtol=1e-4)
    got = tlost.lost(tf, td, ts, (3, 80, 112), k_patches=K, valid_dims=tv)
    want = jlost.lost(np.asarray(jf), jd, js, (3, 80, 112), k_patches=K, valid_dims=jv)
    assert got[3] == want[3]
    np.testing.assert_array_equal(got[0], want[0])
    for head in range(tattn.shape[1]):
        for bugs in (False, True):
            assert tlost.dino_seg(tattn, td, 16, head=head, reference_bugs=bugs) == \
                jlost.dino_seg(jattn, jd, 16, head=head, reference_bugs=bugs)


def _attention(seed, nh, grid):
    """A seeded (1, nh, T, T) softmax with a few bright keys a head."""
    rng = np.random.default_rng(seed)
    t = 1 + grid[0] * grid[1]
    logits = rng.normal(size=(1, nh, t, t)).astype(np.float32)
    logits[:, :, 0, 1 + rng.integers(0, t - 1, size=6)] += 3.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_dino_seg_on_seeded_attention_matches_jax(seed):
    grid = [(5, 7), (8, 8), (6, 3), (12, 9)][seed]
    attn = _attention(seed, 4, grid)
    for head in range(4):
        for bugs in (False, True):
            assert tlost.dino_seg(torch.from_numpy(attn), grid, 16, head=head,
                                  reference_bugs=bugs) == \
                jlost.dino_seg(attn, grid, 16, head=head, reference_bugs=bugs), (head, bugs)
    want = np.asarray(jlost._mass_threshold(jnp.asarray(attn[0, :, 0, 1:]), 0.6))
    got = tlost._mass_threshold(torch.from_numpy(attn[0, :, 0, 1:]), 0.6).numpy()
    np.testing.assert_array_equal(got, want)


def _masks():
    """Seeded (H, W) masks: densities around the percolation point, an
    empty mask, a full one, one component, and two equal components (a
    tie, whose smaller id must win)."""
    rng = np.random.default_rng(0)
    out = [rng.random((9, 11)) < p for p in (0.3, 0.45, 0.55, 0.6, 0.7)]
    out += [np.zeros((9, 11), bool), np.ones((9, 11), bool)]
    one = np.zeros((9, 11), bool)
    one[2:5, 3:9] = True
    tie = np.zeros((9, 11), bool)
    tie[0:2, 0:3] = True
    tie[6:8, 7:10] = True
    return np.stack(out + [one, tie])


def test_label_components_matches_jax():
    """The batched labelling against the JAX function grid by grid: the
    same components (membership) and, since both number a component by its
    smallest flat index + 1, the same ids."""
    masks = _masks()
    got = tcomp.label_components(torch.from_numpy(masks)).numpy()
    for g, m in zip(got, masks):
        want = np.asarray(jcomp.label_components(jnp.asarray(m)))
        for c in np.unique(want[want > 0]):
            ids = np.unique(g[want == c])
            assert len(ids) == 1 and np.array_equal(g == ids[0], want == c)
        np.testing.assert_array_equal(g, want)
        assert (g > 0).sum() == m.sum()


def test_largest_component_mask_matches_jax():
    masks = _masks()
    got = tcomp.largest_component_mask(torch.from_numpy(masks)).numpy()
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(g, np.asarray(jcomp.largest_component_mask(jnp.asarray(m))))
    assert got[5].all()  # empty: id 0 wins, as in the JAX package
    tie = got[-1]
    assert tie[0:2, 0:3].all() and tie.sum() == 6


@pytest.mark.parametrize("arch", ["vit", "dino"])
def test_dinoseg_bucketed_equals_exact_shape(arch):
    """``dino_seg`` at bucket 4 gives the exact-shape box: the masked
    softmax gives bucket-pad keys exactly zero attention."""
    _, _, tspec, params = _dino() if arch == "dino" else _vit()
    rng = np.random.default_rng(0)
    img = rng.normal(size=(80, 112, 3)).astype(np.float32)
    img[16:56, 32:80] += 2.5
    boxes = {}
    for bucket in (1, 4):
        ex = LostFeatureExtractor(tspec, params, bucket=bucket, device="cpu", need_attn=True)
        _f, dims, valid_dims, _s, attn = ex.extract(img, 16)
        assert tuple(valid_dims) == (5, 7) and tuple(dims) == ((5, 7) if bucket == 1 else (8, 8))
        boxes[bucket] = [tlost.dino_seg(attn, dims, 16, head=h) for h in range(attn.shape[1])]
    assert boxes[1] == boxes[4]
