"""vipers_torch pruning masks and global magnitude pruning against the JAX
package: equal paths, equal masks (ties at the cutoff included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vit as jvit
from vipers.pruning import magnitude as jmag
from vipers.pruning import masks as jmasks
from vipers_torch.pruning import magnitude as tmag
from vipers_torch.pruning import masks as tmasks

CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128,
           mlp_dim=256, num_classes=10)


@pytest.fixture(scope="module")
def params():
    spec = jvit._build("tiny", jvit.ViTConfig(**CFG), (32, 32))
    v = spec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), v["params"])


def _quantized(params, step):
    """Round every leaf to a coarse grid so |w| ties cross the cutoff."""
    return jax.tree.map(lambda a: (np.round(a / step) * step).astype(np.float32), params)


def _assert_masks_equal(tm, jm):
    assert sorted(tm) == sorted(jm)
    for p in jm:
        np.testing.assert_array_equal(tm[p].numpy(), np.asarray(jm[p]), err_msg=str(p))


def test_prunable_paths_and_init_masks_equal(params):
    assert tmasks.prunable_paths(params, ("qkv",)) == jmasks.prunable_paths(params, ("qkv",))
    _assert_masks_equal(tmasks.init_masks(params, ("qkv",)),
                        jmasks.init_masks(params, ("qkv",)))


@pytest.mark.parametrize("step", [None, 0.02], ids=["distinct", "tied"])
def test_magnitude_prune_masks_equal(params, step):
    """Two rounds (0.5 then 0.2 of the remaining) give the same masks; with
    quantized weights thousands of ties sit at the cutoff, and the stable
    sorted-path ranking must break them the same way."""
    p = params if step is None else _quantized(params, step)
    tm = tmasks.init_masks(p, ("qkv",))
    jm = jmasks.init_masks(p, ("qkv",))
    for amount in (0.5, 0.2):
        tm = tmag.magnitude_prune(p, tm, amount)
        jm = jmag.magnitude_prune(p, jm, amount)
        _assert_masks_equal(tm, jm)
    kept = sum(int(m.sum()) for m in tm.values())
    total = sum(m.numel() for m in tm.values())
    assert kept == total - round(0.5 * total) - round(0.2 * (total - round(0.5 * total)))


def test_apply_masks_and_vector_roundtrip(params):
    jm = jmag.magnitude_prune(params, jmasks.init_masks(params, ("qkv",)), 0.5)
    masks = {p: torch.from_numpy(np.array(m)) for p, m in jm.items()}
    got = tmasks.apply_masks(params, masks)
    want = jmasks.apply_masks(params, jm)
    for path in jm:
        a = got
        b = want
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vec, layout = tmasks.concat_masked_scores(masks)
    back = tmasks.split_vector(vec, layout)
    _assert_masks_equal(back, jm)
    with pytest.raises(ValueError):
        tmag.magnitude_prune(params, masks, 1.5)
