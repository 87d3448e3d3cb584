"""vipers_torch LOST core, flood fill, box, uint8 normalize, IoU and CorLoc
against the JAX package. Boxes, seeds and background flags must be equal;
affinities within f32 rounding (1e-4)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.data.boxes as jboxes
import vipers.data.preprocess as jpre
import vipers.discovery.components as jcomp
import vipers.discovery.corloc as jcorloc
import vipers_torch.data.boxes as tboxes
import vipers_torch.data.preprocess as tpre
import vipers_torch.discovery.components as tcomp
import vipers_torch.discovery.corloc as tcorloc
import vipers_torch.discovery.lost as tlost
from vipers_torch.discovery.driver import device_normalize

# vipers.discovery re-exports functions under these modules' names
jdriver = importlib.import_module("vipers.discovery.driver")
jlost = importlib.import_module("vipers.discovery.lost")


def _feats(rng, b, gh, gw, d=16):
    """Features with a bright object blob per image, so LOST finds a box."""
    f = rng.normal(size=(b, gh, gw, d)).astype(np.float32) * 0.5
    for i in range(b):
        r, c = rng.integers(0, gh - 2), rng.integers(0, gw - 2)
        f[i, r:r + 3, c:c + 3] += rng.normal(size=d).astype(np.float32) * 2
    return f.reshape(b, gh * gw, d)


@pytest.mark.parametrize("grid,valid", [((6, 5), [(6, 5), (6, 5)]),
                                        ((8, 8), [(8, 8), (5, 7), (8, 3), (6, 6)])],
                         ids=["exact", "bucketed"])
def test_lost_core_matches_jax(grid, valid):
    rng = np.random.default_rng(0)
    feats = _feats(rng, len(valid), *grid)
    vhw = np.asarray(valid, np.int32)
    got = tlost.lost_core(torch.from_numpy(feats), torch.from_numpy(vhw), grid, k_patches=7)
    for b in range(len(valid)):
        want = jlost.lost_core(jnp.asarray(feats[b]), jnp.asarray(vhw[b]),
                               grid_hw=grid, k_patches=7)
        np.testing.assert_allclose(got["affinity"][b].numpy(), np.asarray(want["affinity"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["scores"][b].numpy(), np.asarray(want["scores"]))
        assert int(got["seed"][b]) == int(want["seed"])
        np.testing.assert_array_equal(got["box_feat"][b].numpy(), np.asarray(want["box_feat"]))
        assert bool(got["seed_in_background"][b]) == bool(want["seed_in_background"])
        np.testing.assert_allclose(got["mass"][b].numpy(), np.asarray(want["mass"]),
                                   rtol=1e-4, atol=1e-3)


def test_patch_scoring_ties_go_to_the_lower_index():
    """Integer degree scores tie often; the stable descending sort must put
    the lower index first on both sides, with invalid patches last."""
    rng = np.random.default_rng(1)
    A = np.sign(rng.normal(size=(1, 30, 30))).astype(np.float32)
    valid = rng.random((1, 30)) > 0.2
    order, cent = tlost.patch_scoring(torch.from_numpy(A), torch.from_numpy(valid))
    jorder, jcent = jlost.patch_scoring(jnp.asarray(A[0]), jnp.asarray(valid[0]))
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(cent[0].numpy(), np.asarray(jcent))


def test_flood_fill_and_bbox_match_jax():
    rng = np.random.default_rng(2)
    masks = rng.random((12, 9, 11)) > 0.45
    masks[3] = False  # empty grid: empty box
    seeds = np.stack([rng.integers(0, 9, 12), rng.integers(0, 11, 12)], axis=1)
    comp = tcomp.flood_fill_from_seed(torch.from_numpy(masks), torch.from_numpy(seeds))
    boxes = tcomp.component_bbox(comp)
    for i in range(12):
        want = jcomp.flood_fill_from_seed(jnp.asarray(masks[i]), jnp.asarray(seeds[i]))
        np.testing.assert_array_equal(comp[i].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            boxes[i].numpy(), np.asarray(jcomp.component_bbox(want), np.int64))


@pytest.mark.parametrize("ragged", [False, True])
def test_device_normalize_bit_equal(ragged):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 32, 48, 3), dtype=np.uint8)
    phw = np.array([[32, 48], [30, 41], [17, 48]], np.int32) if ragged else None
    want = jdriver._device_normalize(jnp.asarray(imgs), None if phw is None else jnp.asarray(phw))
    got = device_normalize(torch.from_numpy(imgs), None if phw is None else torch.from_numpy(phw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boxes_corloc_and_shapes_equal(tmp_path):
    rng = np.random.default_rng(4)
    gts = rng.uniform(0, 100, (5, 4))
    gts[:, 2:] += gts[:, :2]
    for _ in range(20):
        pred = rng.uniform(0, 150, 4)
        pred[2:] += pred[:2]
        np.testing.assert_array_equal(tboxes.bbox_iou(pred, gts),
                                      jboxes.bbox_iou(pred, gts))
        assert tcorloc.corloc_hit(pred, gts) == jcorloc.corloc_hit(pred, gts)
    acc_t, acc_j = tcorloc.CorLocAccumulator(), jcorloc.CorLocAccumulator()
    for i, box in enumerate([gts[0], gts[1] + 60.0, [0, 0, 1, 1]]):
        acc_t.add(f"im{i}", box, gts)
        acc_j.add(f"im{i}", box, gts)
    assert (acc_t.hits, acc_t.count, acc_t.corloc, acc_t.preds) == \
        (acc_j.hits, acc_j.count, acc_j.corloc, acc_j.preds)
    txt = acc_t.save(str(tmp_path), 3)
    assert open(txt).read() == f"corloc,{acc_j.corloc:.1f},,\n"
    box = np.array([2, 7, 1, 5])
    for size in ((3, 100, 70), (100, 70), None):
        np.testing.assert_array_equal(tlost.box_feat_to_image(box, [16, 16], size),
                                      jlost.box_feat_to_image(box, [16, 16], size))
    for h, w in ((500, 375), (512, 384), (33, 17)):
        assert tpre.bucket_hw(h, w, 16, 4) == jpre.bucket_hw(h, w, 16, 4)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tpre.lost_pad_to_patch_multiple(img, 16),
                                      jpre.lost_pad_to_patch_multiple(img, 16))
    assert tpre.IMAGENET_MEAN == jpre.IMAGENET_MEAN and tpre.IMAGENET_STD == jpre.IMAGENET_STD
