"""vipers_torch's explain methods on MobileNetV2 and the DINO ViT against
the JAX package's on the CPU, on the same inputs (numpy seeds) and the
same weights (``tests/torch_explain_fixtures.py``: MobileNetV2 at width
0.25, 10 classes, 64 x 64; DINO ViT-Tiny cut to 2 blocks, no head, 64 x 96,
block 0 on the flash route at ``VIPERS_FLASH_MIN_T=16`` in both packages):
the tap, GradCAM, integrated gradients, LRP per family, ``compute_heatmaps``
(GradCAM, Guided-GradCAM and the attention map against the JAX package's
jitted kit; MobileNetV2's relu6 is no guided site in either package) and
the ``explain-eval`` txt rows.

Tolerances, the other explain tests': GradCAM maps within 1e-5; gradients,
IG and Guided-GradCAM within 1e-5 of the map's scale plus 1e-4 relative;
LRP at eps 1e-2 within 2e-3 of its scale; RMA/RRA rows within 1e-6.
"""

import argparse
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.explain.attribution as jattr
from tests import torch_explain_fixtures as fx
from vipers_torch.explain import attribution as tattr
from vipers_torch.explain import driver as tdriver
from vipers_torch.explain import gradcam as tgc
from vipers_torch.explain import lrp as tlrp

jgc = importlib.import_module("vipers.explain.gradcam")
jdriver = importlib.import_module("vipers.explain.driver")

FAMS = ["mobilenet", "dino"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(autouse=True)
def _flash_route(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")


def _apply_pair(fam):
    """(JAX model_apply, variables, port model, tap shape, token grid, aux
    key), the explain driver's kit for the family."""
    jspec, variables, _ts, _p, _s = fx.family_models(fam)
    _tspec, model = fx.port_model(fam)
    x = fx.images(fam)
    if fam == "dino":
        gh, gw = x.shape[1] // 16, x.shape[2] // 16
        return (jspec.module.apply, variables, model, (1, gh * gw + 1, 192), (gh, gw),
                "qkv_input")
    with torch.no_grad():
        feats = model(torch.from_numpy(x))[1]["features"]
    return jspec.module.apply, variables, model, tuple(feats.shape), None, "features"


def _port_apply(model):
    def apply(x, tap_delta=None):
        return model(x, tap_delta=tap_delta)
    return apply


@pytest.mark.parametrize("fam", FAMS)
def test_tap_matches_jax(fam):
    fx.check_tap(fam)


@pytest.mark.parametrize("fam", FAMS)
def test_gradcam_matches_jax(fam):
    japply, variables, model, tap_shape, grid, key = _apply_pair(fam)
    x = fx.images(fam)
    cam_j, tgt_j = jgc.make_gradcam(japply, variables, tap_shape, grid, key)(jnp.asarray(x))
    cam_t, tgt_t = tgc.make_gradcam(_port_apply(model), tap_shape, grid, key)(torch.from_numpy(x))
    assert int(tgt_t) == int(tgt_j)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), atol=1e-5, rtol=0)
    assert cam_t.shape == x.shape[1:3] and float(cam_t.max()) > 0.99


def test_mobilenet_relu6_is_not_guided():
    """The JAX MobileNetV2 clamps with minimum/maximum, not the guided ReLU:
    inside ``guided_backprop()`` its input gradient is the plain one, bit for
    bit, so Guided-GradCAM is the plain gradient times the CAM."""
    _japply, _v, model, *_ = _apply_pair("mobilenet")
    x = torch.from_numpy(fx.images("mobilenet"))
    plain = tgc.input_gradient(_port_apply(model), x, 2)
    guided = tgc.guided_backprop_attr(_port_apply(model), x, target=2)
    np.testing.assert_array_equal(np.asarray(guided), plain.numpy())


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


@pytest.mark.parametrize("fam", FAMS)
def test_integrated_gradients_match_jax(fam):
    jscore, tscore = _score_pair(fam)
    x = fx.images(fam, seed=1)
    want = jax.jit(jattr.make_integrated_gradients(jscore, 4))(jnp.asarray(x), jnp.asarray([3]))
    got = tattr.make_integrated_gradients(tscore, 4)(torch.from_numpy(x), torch.tensor([3]))
    fx.scaled_close(got.numpy(), want)


@pytest.mark.parametrize("fam", FAMS)
def test_lrp_matches_jax(fam):
    fx.check_lrp_matches_jax(fam)


def test_lrp_sites_per_family():
    """DINO's qkv and proj are sites (``nn.Dense`` in the JAX model), as are
    its patch convolution, fc1 and fc2; MobileNetV2's sites are its 52
    convolutions and the classifier, no BatchNorm."""
    _s, dino = fx.port_model("dino")
    names = {n for n, m in dino.named_modules()
             if any(o is m for o, _a in tlrp.lrp_sites(dino))}
    assert names == {"patch_embed", *(f"block_{i}.{n}" for i in range(2)
                                      for n in ("attn.qkv", "attn.proj", "fc1", "fc2"))}
    _s, mobilenet = fx.port_model("mobilenet")
    sites = [o for o, _a in tlrp.lrp_sites(mobilenet)]
    assert len(sites) == 53 and all(isinstance(o, (torch.nn.Conv2d, torch.nn.Linear))
                                    for o in sites)


def test_dino_lrp_misses_jax_under_the_old_suffix_rule(monkeypatch):
    """The trap the per-family rule closes: one suffix list for every
    family skipped DINO's ``attn.qkv``, which the JAX interceptor wraps. With
    that rule the map misses the JAX package's by far more than the
    tolerance that the per-family rule meets."""
    x = fx.image("dino")[None]
    want, _t = fx.jax_lrp("dino", x, 1e-2)
    monkeypatch.setattr(tlrp, "_not_dense",
                        lambda model: ("attention.qkv", "attention.out", "attn.qkv"))
    got, _t = fx.port_lrp("dino", x, 1e-2)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err > 2e-2, err


@pytest.mark.parametrize("fam", FAMS)
def test_compute_heatmaps_matches_jax(fam):
    fx.check_compute_heatmaps(fam)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClass").mkdir()
    rng = np.random.default_rng(0)
    h, w = 60, 90
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        root / "JPEGImages" / "000000.jpg")
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4: 3 * h // 4, w // 5: w // 2] = 15
    Image.fromarray(mask).save(root / "SegmentationClass" / "000000.png")
    return str(root)


@pytest.mark.parametrize("fam", FAMS)
def test_explain_eval_rows_match_jax(fam, voc, tmp_path, monkeypatch):
    """``explain-eval`` on one VOC image (a DINO ViT's padded to 64 x 96):
    the same files, GradCAM's (and DINO's attention map's) mass and rank
    within 1e-6; IG's within [0, 1] (its SmoothGrad noise is drawn
    differently, the documented difference)."""
    jspec, variables, *_ = fx.family_models(fam)
    monkeypatch.setattr(jdriver, "_load_model", lambda *a, **k: (jspec, variables))
    monkeypatch.setattr(tdriver, "_load_model", lambda *a, **k: fx.port_model(fam))
    args = dict(model=fam, checkpoint="", voc_root=voc, num_images=1, pooling="sum,abs",
                iteration=2)
    assert jdriver.run_explain_eval(argparse.Namespace(**args,
                                                       output_dir=str(tmp_path / "jax"))) == 0
    assert tdriver.run_explain_eval(argparse.Namespace(**args, device="cpu",
                                                       output_dir=str(tmp_path / "torch"))) == 0
    methods = ("gradCAM", "ig") + (("attention",) if fam == "dino" else ())
    names = sorted(f"{m}_{fam}_pruning_iteration_02.txt" for m in methods)
    assert fx.file_tree(tmp_path / "torch") == fx.file_tree(tmp_path / "jax") == names
    for name in names:
        got, want = ([float(ln.split(":")[-1]) if ":" in ln else ln
                      for ln in open(tmp_path / p / name).read().splitlines()]
                     for p in ("torch", "jax"))
        assert got[2] == want[2] == "On a total of 1 images."
        if name.startswith("ig_"):
            assert all(0.0 <= v <= 1.0 for v in got[:2])
        else:
            np.testing.assert_allclose(got[:2], want[:2], atol=1e-6, rtol=0)
