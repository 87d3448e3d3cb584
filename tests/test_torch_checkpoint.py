"""The port's reference ``.pth`` handling (``vipers_torch.core.checkpoint``)
against ``vipers.core.checkpoint``: the torchvision ViT exporter and
importer, the state-dict normalization (``module.``, ``{"model": ...}``,
``weight_orig`` / ``weight_mask``), and the helpers that size the model from
the checkpoint. Arrays must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.core.checkpoint as jck
import vipers.models.vit as jvit
import vipers_torch.models.vit as tvit
from vipers.pruning import magnitude as jmag
from vipers.pruning import masks as jmasks
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.tree import flatten_dict
from vipers_torch.discovery.driver import load_lost_checkpoint

CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
           num_classes=10)


@pytest.fixture(scope="module")
def tree():
    spec = jvit._build("tiny", jvit.ViTConfig(**CFG), (64, 48))
    v = spec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)), train=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), v["params"])
    masks = jmag.magnitude_prune(params, jmasks.init_masks(params, ("qkv",)), 0.5)
    return params, {k: np.asarray(m) for k, m in masks.items()}


def _equal_flat(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("with_masks", [False, True], ids=["plain", "masks-baked"])
def test_export_matches_jax(tree, with_masks):
    params, masks = tree
    m = masks if with_masks else None
    _equal_flat(tck.export_vit_torchvision(params, m), jck.export_vit_torchvision(params, m))


def test_import_matches_jax_through_a_pth(tree, tmp_path):
    """The pruned form round trip: exported with ``weight_orig`` /
    ``weight_mask``, saved under ``{"model": ...}`` with DDP's ``module.``,
    loaded by both packages: equal params (masks applied) and equal masks;
    the port's tree loads into its module."""
    params, masks = tree
    sd = tck.export_vit_torchvision(params, masks, bake_masks=False)
    assert "encoder.layers.encoder_layer_0.mlp.0.weight_orig" in sd
    assert "encoder.layers.encoder_layer_0.mlp.0.weight" not in sd
    path = tmp_path / "model.pth"
    torch.save({"model": {"module." + k: torch.tensor(v)
                          for k, v in sd.items()}, "epoch": 3}, path)
    tsd, jsd = tck.load_torch_state_dict(str(path)), jck.load_torch_state_dict(str(path))
    _equal_flat(tsd, jsd)
    tp, tm = tck.import_vit_torchvision(tsd, 2)
    jp, jm = jck.import_vit_torchvision(jsd, 2)
    _equal_flat(flatten_dict(tp), flatten_dict(jp))
    _equal_flat(tm, jm)
    assert set(tm) == {k for k in masks}
    for k, m in masks.items():  # the import carries the masks and applies them
        np.testing.assert_array_equal(tm[k], m)
    baked = flatten_dict(tp)
    for k, m in masks.items():
        np.testing.assert_array_equal(baked[k], params_at(params, k) * m)
    model = tvit._build("tiny", tvit.ViTConfig(**CFG), (64, 48)).module()
    model.load_state_dict(tck.vit_state_dict_from_flax(tp, tm))
    p2, s2, m2, _ = load_lost_checkpoint(str(path),
                                         tvit._build("tiny", tvit.ViTConfig(**CFG), (64, 48)))
    assert s2 is None  # a ViT has no running statistics
    _equal_flat(flatten_dict(p2), baked)
    _equal_flat(m2, tm)


def params_at(params, path):
    node = params
    for k in path:
        node = node[k]
    return node


def test_normalize_without_mask_and_headless(tree):
    params, _ = tree
    sd = tck.export_vit_torchvision({k: v for k, v in params.items() if k != "head"})
    sd["extra_orig"] = np.ones(3, np.float32)  # an _orig without its mask keeps its value
    t, j = tck.normalize_torch_state_dict(sd), jck.normalize_torch_state_dict(sd)
    _equal_flat(t, j)
    tp, tm = tck.import_vit_torchvision(t, 2)
    jp, jm = jck.import_vit_torchvision(j, 2)
    _equal_flat(flatten_dict(tp), flatten_dict(jp))
    assert tm == jm == {}
    assert tck.infer_num_classes(tp) is jck.infer_num_classes(jp) is None


def test_sizing_helpers(tree):
    params, _ = tree
    assert tck.infer_num_classes(params) == jck.infer_num_classes(params) == 10
    # a 3x4 grid is not square: no size
    assert tck.infer_vit_image_size(params, 16) == jck.infer_vit_image_size(params, 16) is None
    sq = dict(params, pos_embedding=np.zeros((1, 1 + 14 * 14, 128), np.float32))
    assert tck.infer_vit_image_size(sq, 16) == jck.infer_vit_image_size(sq, 16) == (224, 224)
    for vit, it in ((True, 3), (False, 12), (True, "*")):
        assert tck.reference_sweep_stem("vit_s_16", vit, 299, it) == \
            jck.reference_sweep_stem("vit_s_16", vit, 299, it)


def test_directory_checkpoint_is_refused(tmp_path):
    with pytest.raises(ValueError, match="export_vit_torchvision"):
        load_lost_checkpoint(str(tmp_path), tvit._build("tiny", tvit.ViTConfig(**CFG), (64, 48)))
