"""vipers_torch.pruning.snip against vipers.pruning.snip on the CPU.

The small train config (2 layers, 2 heads, 64x64 images: T = 17, 10
classes, B = 4, f32) at head dim 64 (D = 128) and 80 (D = 160, vit_h_14's
head dim). Both packages start from the same flax params (numpy) and take
the same numpy batch; the JAX loss is the one ``vipers.train.driver``
builds for SNIP (the module in train mode, cross-entropy). Tolerances:
saliencies within 2e-6 of their scale (the largest saliency: f32 sums in
another order; the head kernel's differ by up to 1.4e-6 of it, the others
by up to 5.4e-7; element by element the relative difference is unbounded
where a gradient nearly cancels); masks equal, except where both
saliencies lie within 1e-5 relative of the threshold (a tie broken by
rounding), with the pruned count exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vit as jvit
import vipers.pruning.snip as jsnip
import vipers_torch.models.vit as tvit
from vipers.train.steps import cross_entropy as j_cross_entropy
from vipers_torch.core.tree import flatten_dict
from vipers_torch.pruning import snip as tsnip

IMAGE, B, CLASSES = (64, 64), 4, 10
CFGS = {64: dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
                 num_classes=CLASSES),
        80: dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=160, mlp_dim=320,
                 num_classes=CLASSES)}


@pytest.fixture(scope="module", params=[64, 80], ids=["hd64", "hd80"])
def setup(request):
    cfg = CFGS[request.param]
    jspec = jvit._build("tiny", jvit.ViTConfig(**cfg), IMAGE)
    params = jspec.module.init(jax.random.PRNGKey(request.param),
                               jnp.zeros((1, *IMAGE, 3)), train=False)["params"]
    rng = np.random.default_rng(request.param)
    batch = (rng.normal(size=(B, *IMAGE, 3)).astype(np.float32),
             rng.integers(0, CLASSES, size=(B,)).astype(np.int32))
    tspec = tvit._build("tiny", tvit.ViTConfig(**cfg), IMAGE)
    return jspec, tspec, params, batch


def _jax_loss(jspec):
    def loss_fn(params, batch):
        images, labels = batch
        logits = jspec.module.apply({"params": params}, images, train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)}, mutable=False)[0]
        return j_cross_entropy(logits, labels, CLASSES, 0.0)

    return loss_fn


def _torch_params(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), params)


_SAL = {}


def _saliencies(setup):
    """Both packages' saliencies of the setup (once a setup: the JAX pass
    compiles)."""
    jspec, tspec, params, (x, y) = setup
    key = id(setup)
    if key not in _SAL:
        base = jsnip.M.init_masks(params, jspec.prune_exclude)
        jsal = jsnip.snip_saliency(_jax_loss(jspec), params, (jnp.asarray(x), jnp.asarray(y)),
                                   masks=base)
        tbase = {p: torch.from_numpy(np.array(m)) for p, m in base.items()}
        tsal = tsnip.snip_saliency(tsnip.snip_loss(tspec, CLASSES), _torch_params(params),
                                   (torch.from_numpy(x), torch.from_numpy(y).long()),
                                   masks=tbase)
        _SAL[key] = ({p: np.asarray(s) for p, s in jsal.items()}, tsal)
    return _SAL[key]


def _run(setup, target):
    """(JAX saliencies, the port's, JAX masks at ``target``, the port's
    ``snip_prune`` masks): the JAX masks are ``snip_prune``'s last step on
    its saliencies (``test_masks_match_jax_up_to_threshold_ties`` also runs
    ``snip_prune`` itself)."""
    jspec, tspec, params, (x, y) = setup
    jsal, tsal = _saliencies(setup)
    thr = jsnip.snip_threshold({p: jnp.asarray(s) for p, s in jsal.items()}, target)
    jmasks = {p: s > np.asarray(thr) for p, s in jsal.items()}
    tmasks = tsnip.snip_prune(tsnip.snip_loss(tspec, CLASSES), _torch_params(params),
                              (torch.from_numpy(x), torch.from_numpy(y).long()), target,
                              tspec.prune_exclude)
    return jsal, tsal, jmasks, tmasks


def test_saliencies_match_jax(setup):
    jsal, tsal, _, _ = _run(setup, 0.5)
    assert tsal.keys() == jsal.keys() and len(tsal) == 2 * 3 + 2  # out, fc1, fc2; embed, head
    scale = max(float(np.abs(np.asarray(s)).max()) for s in jsal.values())
    for p, s in jsal.items():
        assert tsal[p].dtype == torch.float32
        np.testing.assert_allclose(tsal[p].numpy(), np.asarray(s), atol=2e-6 * scale, rtol=0,
                                   err_msg=str(p))


@pytest.mark.parametrize("target", [0.5, 0.9])
def test_masks_match_jax_up_to_threshold_ties(setup, target):
    jsal, tsal, jmasks, tmasks = _run(setup, target)
    if target == 0.5:  # the JAX package's own one-shot entry
        jspec, _, params, (x, y) = setup
        direct = jsnip.snip_prune(_jax_loss(jspec), params, (jnp.asarray(x), jnp.asarray(y)),
                                  target, jspec.prune_exclude)
        assert all(np.array_equal(np.asarray(direct[p]), m) for p, m in jmasks.items())
    vec = np.sort(np.concatenate([np.asarray(jsal[p]).ravel() for p in sorted(jsal)]))
    n = vec.size
    thr = vec[int(n * target) - 1]
    kept = sum(int(m.sum()) for m in tmasks.values())
    assert kept == sum(int(np.asarray(m).sum()) for m in jmasks.values())
    assert abs(1 - kept / n - target) <= 1 / n
    for p, m in jmasks.items():
        diff = tmasks[p].numpy() != np.asarray(m)
        near = (np.abs(np.asarray(jsal[p]) - thr) <= 1e-5 * thr) \
            & (np.abs(tsal[p].numpy() - thr) <= 1e-5 * thr)
        assert not np.any(diff & ~near), p


@pytest.mark.parametrize("target", [0.0, 1e-9, 1.0, 1.5])
def test_threshold_edges_match_jax(setup, target):
    """k = int(n * target) <= 0 keeps every weight (threshold -1), k >= n
    prunes every one (threshold inf), as in the JAX package."""
    jsal, tsal, jmasks, tmasks = _run(setup, target)
    jthr = float(jsnip.snip_threshold({p: jnp.asarray(s) for p, s in jsal.items()}, target))
    tthr = float(tsnip.snip_threshold(tsal, target))
    assert tthr == jthr == (-1.0 if target < 1 else float("inf"))
    for p, m in jmasks.items():
        assert np.array_equal(tmasks[p].numpy(), np.asarray(m))
        assert bool(tmasks[p].all()) == (target < 1) and bool((~tmasks[p]).all()) == (target >= 1)


def test_snip_reaches_every_block_and_runs_on_the_params_device(setup):
    """The port's loss is the train-mode forward without attention outputs:
    every block's attention goes through the routed path (here T = 17: the
    einsum), the saliencies come back on the params' device in f32, and the
    pruned flax paths are exactly the JAX package's prunable kernels."""
    jspec, tspec, params, (x, y) = setup
    tparams = _torch_params(params)
    sal = tsnip.snip_saliency(tsnip.snip_loss(tspec, CLASSES), tparams,
                              (torch.from_numpy(x), torch.from_numpy(y).long()))
    want = set(jsnip.M.prunable_paths(params))
    assert set(sal) == want
    assert all(s.device.type == "cpu" and s.dtype == torch.float32 for s in sal.values())
    assert all(bool((s >= 0).all()) and bool((s > 0).any()) for s in sal.values())
    flat = flatten_dict(tparams)
    assert all(not flat[p].requires_grad for p in want)
