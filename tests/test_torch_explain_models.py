"""vipers_torch's explain path through the ViT, resnet18 and a narrow
VGG16 against the JAX package on the CPU: the explain tap, and epsilon-LRP
(the layer set the JAX interceptor wraps) on the same weights
(``tests/torch_explain_fixtures.py``, whose ``check_*`` functions hold the
bodies; the Swin's cases are in ``test_torch_explain_swin.py``). The ViT
runs at 32 x 48 on a 32 x 32 pos table (the interpolated table) with its
blocks on the flash route (``VIPERS_FLASH_MIN_T=16`` in both packages).

Tolerances: maps within 1e-5 of their largest magnitude plus 1e-4
relative; the predicted class equal. LRP at eps 1e-2 within 2e-3 of the
map's scale; at the default eps (ill conditioned in f32 in both packages)
finite and for the same target.
"""

import numpy as np
import pytest
import torch

from tests import torch_explain_fixtures as fx
from vipers_torch.explain import driver as tdriver
from vipers_torch.explain import lrp as tlrp

FAMILIES = ["vit", "resnet", "vgg"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(autouse=True)
def _flash_route(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")


@pytest.mark.parametrize("fam", FAMILIES)
def test_tap_is_added_where_jax_adds_it(fam):
    fx.check_tap(fam)


@pytest.mark.parametrize("fam", FAMILIES)
def test_lrp_attribution_matches_jax(fam):
    fx.check_lrp_matches_jax(fam)


@pytest.mark.parametrize("fam", FAMILIES)
def test_lrp_at_the_default_eps(fam):
    fx.check_lrp_default_eps(fam)


def test_lrp_layer_sets():
    """The epsilon rule's sites are the JAX interceptor's nn.Dense / nn.Conv
    calls: no ViT qkv/out, no Swin qkv."""
    _s, vit = fx.port_model("vit")
    _s, swin = fx.port_model("swin")
    _s, resnet = fx.port_model("resnet")
    vit_names = {n for n, m in vit.named_modules()
                 for o, _a in tlrp.lrp_sites(vit) if o is m}
    assert vit_names == {"", "layers.0.mlp.fc1", "layers.0.mlp.fc2", "layers.1.mlp.fc1",
                         "layers.1.mlp.fc2", "head"}  # "": the patch embedding
    swin_names = {n for n, m in swin.named_modules() for o, _a in tlrp.lrp_sites(swin) if o is m}
    assert not any(n.endswith("qkv") for n in swin_names)
    assert {"patch_embed", "head", "merge0.reduction", "stage0_block0.attn.proj",
            "stage0_block0.attn.cpb_fc1", "stage3_block1.fc2"} <= swin_names
    n_conv_linear = sum(isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
                        for m in resnet.modules())
    assert len(tlrp.lrp_sites(resnet)) == n_conv_linear == 21


def test_guided_gradcam_uses_guided_relus_in_the_driver():
    """compute_heatmaps' Guided-GradCAM on resnet18 differs from GradCAM
    times the plain input gradient (and matches the JAX one, above)."""
    tspec, model = fx.port_model("resnet")
    img = fx.image("resnet", seed=5)
    got = tdriver.compute_heatmaps(tspec, model, img, ["guided_gradcam", "gradcam"])
    apply = tdriver._apply_fn(tspec, model, 64, 64)
    from vipers_torch.explain.gradcam import input_gradient

    plain = input_gradient(apply, torch.from_numpy(img)[None],
                           int(np.argmax(got["prediction"]))).numpy()
    plain_ggc = np.transpose((plain * got["gradcam"][None, :, :, None])[0], (2, 0, 1))
    assert not np.allclose(plain_ggc, got["guided_gradcam"])


def test_untrained_seed_is_reproducible_within_the_port():
    """``--untrained`` draws from the port's generator (the JAX init RNG
    differs, so it is compared within the port only)."""
    _s, a = tdriver._load_model("resnet18", "", seed=3, device="cpu")
    _s, b = tdriver._load_model("resnet18", "", seed=3, device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(p.requires_grad for p in a.parameters()) and not a.training
