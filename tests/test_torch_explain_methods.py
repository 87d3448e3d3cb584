"""vipers_torch's explain methods against the JAX package's on the CPU, on
the same inputs (numpy seeds) and the same weights
(``tests/torch_explain_fixtures.py``): the six poolings and RMA/RRA, the
bilinear resize against ``jax.image.resize``, the guided ReLU, GradCAM and
Guided-GradCAM on resnet18 and on a 2-block ViT whose blocks take the
flash route (``VIPERS_FLASH_MIN_T=16`` in both packages, T = 17), IG
(Gauss-Legendre and Riemann, 32 x 32 inputs) and the SmoothGrad body on
both, the
SmoothGrad draw, and the ViT attention map.

Tolerances: RMA/RRA and the poolings are float64 numpy copies, held equal
bit for bit; the resize within 1e-6 absolute (maps of O(1) values; both
are f32 sums of 2 to 4 weighted terms); GradCAM maps (in [0, 1]) within
1e-5; gradients, IG and Guided-GradCAM within 1e-5 of the map's largest
magnitude plus 1e-4 relative.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.explain.attribution as jattr
import vipers.explain.metrics as jmetrics
from tests import torch_explain_fixtures as fx
from vipers.models.activations import guided_relu as jguided_relu
from vipers_torch.explain import attribution as tattr
from vipers_torch.explain import gradcam as tgc
from vipers_torch.explain import metrics as tmetrics
from vipers_torch.models import activations as tact
from vipers_torch.models.interpolate import bilinear_weight_matrix_np, resize_bilinear

# the JAX package's explain/__init__ re-exports a function named gradcam
jgc = importlib.import_module("vipers.explain.gradcam")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(autouse=True)
def _flash_route(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")


# ------------------------------------------------------------ metrics

# CHW maps under every pooling; 2D maps without pooling (the
# explain-eval rule for GradCAM and attention)
SCORED = [((3, 20, 24), p) for p in tmetrics.ALL_POOLINGS] + [((20, 24), None)]


@pytest.mark.parametrize("shape,pooling", SCORED, ids=[f"{len(s)}d-{p}" for s, p in SCORED])
def test_evaluate_single_equals_jax(shape, pooling):
    rng = np.random.default_rng(len(shape) * 7 + len(str(pooling)))
    hm = rng.normal(0, 1, shape).astype(np.float32)
    gt = (rng.random((18, 22)) > 0.6).astype(np.float64) * 255
    got, got_gt = tmetrics.evaluate_single(hm, gt, pooling)
    want, want_gt = jmetrics.evaluate_single(hm, gt, pooling)
    assert got == want
    np.testing.assert_array_equal(got_gt, want_gt)
    if pooling is not None:
        np.testing.assert_array_equal(tmetrics.pool_heatmap(hm.astype(np.float64), pooling),
                                      jmetrics.pool_heatmap(hm.astype(np.float64), pooling))
    assert (tmetrics.evaluate_heatmap_all_poolings(hm.reshape(-1, *shape[-2:]), gt)
            == jmetrics.evaluate_heatmap_all_poolings(hm.reshape(-1, *shape[-2:]), gt))


# ------------------------------------------------------------ resize

RESIZES = [
    ((4, 6), (32, 48)),          # the CAM of a patch-8 ViT / a ResNet map, up
    ((7, 7), (224, 224)),
    ((24, 32), (384, 512)),      # a VOC image's ViT-B/16 grid
    ((2, 24, 32), (2, 384, 512)),  # per-head upsample (heads untouched)
    ((50, 40), (17, 13)),        # down: antialiased
    ((33, 21), (33, 20)),        # one axis down by one
    ((5, 9), (5, 9)),            # identity
]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a}->{b}" for a, b in RESIZES])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).random(src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_downscale_is_not_align_corners_false():
    """The trap: on a downscale jax.image.resize antialiases, which
    F.interpolate(align_corners=False) does not; the weights differ."""
    w = bilinear_weight_matrix_np(50, 17)
    assert (w > 0).sum(axis=0).max() > 2  # more than two taps a sample


# ------------------------------------------------------------ guided ReLU

def test_guided_relu_backward_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 64).astype(np.float32)
    g = rng.normal(0, 1, 64).astype(np.float32)
    _, vjp = jax.vjp(jguided_relu, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tact.guided_relu(xt), xt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tact.relu(xt) is not None and not tact.is_guided()
    with tact.guided_backprop():
        assert tact.is_guided()
        y = tact.relu(xt)
    (guided,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(guided.numpy(), np.asarray(want))


# ------------------------------------------------------------ gradcam

def _apply_pair(fam):
    """(JAX model_apply(variables, x, train, tap_delta), variables, port
    model_apply(x, tap_delta), tap shape, token grid, aux key)."""
    jspec, variables, _ts, _p, _s = fx.family_models(fam)
    _tspec, model = fx.port_model(fam)
    x = fx.images(fam)
    if fam == "vit":
        gh, gw = x.shape[1] // 8, x.shape[2] // 8
        return (jspec.module.apply, variables, model, (1, gh * gw + 1, 64), (gh, gw),
                "qkv_input")
    with torch.no_grad():
        feats = model(torch.from_numpy(x))[1]["features"]
    return jspec.module.apply, variables, model, tuple(feats.shape), None, "features"


def _port_apply(model):
    def apply(x, tap_delta=None):
        return model(x, tap_delta=tap_delta)
    return apply


@pytest.mark.parametrize("fam", ["resnet", "vit"])
def test_gradcam_matches_jax(fam):
    japply, variables, model, tap_shape, grid, key = _apply_pair(fam)
    x = fx.images(fam)
    cam_j, tgt_j = jgc.make_gradcam(japply, variables, tap_shape, grid, key)(jnp.asarray(x))
    cam_t, tgt_t = tgc.make_gradcam(_port_apply(model), tap_shape, grid, key)(torch.from_numpy(x))
    assert int(tgt_t) == int(tgt_j)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), atol=1e-5, rtol=0)
    assert cam_t.shape == x.shape[1:3] and float(cam_t.max()) > 0.99


@pytest.mark.parametrize("fam", ["resnet", "vit"])
def test_guided_gradcam_matches_jax(fam):
    japply, variables, model, tap_shape, grid, key = _apply_pair(fam)
    x = fx.images(fam)
    want, tgt_j = jgc.guided_gradcam(japply, variables, jnp.asarray(x), tap_shape, grid, key)
    got, tgt_t = tgc.guided_gradcam(_port_apply(model), torch.from_numpy(x), tap_shape, grid,
                                    key)
    assert tgt_t == tgt_j
    fx.scaled_close(got, want)


def test_guided_backprop_changes_resnet_gradients():
    """Inside guided_backprop() the ResNet's ReLUs are guided: the input
    gradient differs from the plain one, as in the JAX package."""
    _japply, _v, model, *_ = _apply_pair("resnet")
    x = torch.from_numpy(fx.images("resnet"))
    plain = tgc.input_gradient(_port_apply(model), x, 1)
    guided = tgc.guided_backprop_attr(_port_apply(model), x, target=1)
    assert not np.allclose(plain.numpy(), guided) and np.abs(guided).sum() > 0


# ------------------------------------------------------------ IG + SmoothGrad

def _score_pair(fam):
    jspec, variables, _ts, _p, _s = fx.family_models(fam)
    _tspec, model = fx.port_model(fam)

    def jscore(x, target):
        logits, _ = jspec.module.apply(variables, x, train=False)
        return logits[jnp.arange(x.shape[0]), target]

    def tscore(x, target):
        logits, _ = model(x)
        return logits[torch.arange(x.shape[0]), target]

    return jscore, tscore


@pytest.mark.parametrize("method", ["gausslegendre", "riemann_trapezoid"])
@pytest.mark.parametrize("fam", ["resnet", "vit"])
def test_integrated_gradients_match_jax(fam, method):
    jscore, tscore = _score_pair(fam)
    x = fx.images(fam, seed=1, size=(32, 32))
    want = jattr.make_integrated_gradients(jscore, 4, method)(jnp.asarray(x), jnp.asarray([3]))
    got = tattr.make_integrated_gradients(tscore, 4, method)(torch.from_numpy(x),
                                                            torch.tensor([3]))
    fx.scaled_close(got.numpy(), want)


@pytest.mark.parametrize("fam", ["resnet", "vit"])
def test_smoothgrad_body_matches_jax_ig_on_the_same_noise(fam):
    """The deterministic body: the mean over the port's noise tensors of
    IG(x + noise), against the JAX package's IG on the same noisy inputs."""
    jscore, tscore = _score_pair(fam)
    x = torch.from_numpy(fx.images(fam, seed=2))
    noises = tattr.draw_smoothgrad_noise(x, 2, 1.0, torch.Generator().manual_seed(0))
    ig_t = tattr.make_integrated_gradients(tscore, 3)
    got = tattr.make_smoothgrad(ig_t, 2)(torch.Generator().manual_seed(0), x, torch.tensor([1]))
    body = tattr.smoothgrad_from_noise(ig_t, x, torch.tensor([1]), noises)
    np.testing.assert_array_equal(got.numpy(), body.numpy())
    ig_j = jattr.make_integrated_gradients(jscore, 3)
    want = sum(np.asarray(ig_j(jnp.asarray((x + n).numpy()), jnp.asarray([1])))
               for n in noises) / 2
    fx.scaled_close(got.numpy(), want)


def test_smoothgrad_draw_statistics():
    """The draw stands where the JAX package's stands statistically: zero
    mean, unit deviation before the scale, spread = (max - min) * nt_stdev,
    the samples independent; the same seed repeats it."""
    x = torch.from_numpy(fx.images("resnet", seed=4)) * 0.5
    spread = float((x.max() - x.min()) * 0.7)
    noises = tattr.draw_smoothgrad_noise(x, 3, 0.7, torch.Generator().manual_seed(5))
    z = torch.stack(noises).numpy() / spread
    assert z.shape == (3, *x.shape)
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert abs(np.corrcoef(z[0].ravel(), z[1].ravel())[0, 1]) < 0.05
    again = tattr.draw_smoothgrad_noise(x, 3, 0.7, torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(noises, again))
    # the JAX draw's moments, for the record of what "statistically" means
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    zj = np.stack([np.asarray(jax.random.normal(k, x.shape)) for k in keys])
    assert abs(zj.mean() - z.mean()) < 0.03 and abs(zj.std() - z.std()) < 0.03


# ------------------------------------------------------------ attention map

@pytest.mark.parametrize("grid,patch,out_hw", [((3, 4), 16, (48, 64)),
                                               ((4, 6), 8, (32, 48)),
                                               ((3, 4), 16, (40, 70))])
def test_vit_attention_heatmap_matches_jax(grid, patch, out_hw):
    rng = np.random.default_rng(6)
    t = grid[0] * grid[1] + 1
    attn = rng.random((1, 3, t, t)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    want = jgc.vit_attention_heatmap(jnp.asarray(attn), grid, out_hw, patch_size=patch)
    got = tgc.vit_attention_heatmap(torch.from_numpy(attn), grid, out_hw, patch_size=patch)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
