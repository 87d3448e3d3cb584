"""``vipers_torch.explain.driver.compute_heatmaps`` as a whole against the
JAX package's on the CPU, on the ViT (32 x 48 on a 32 x 32 pos table, the
flash route), resnet18 and a narrow VGG16 with the same weights
(``tests/torch_explain_fixtures.py``): GradCAM, Guided-GradCAM, the ViT's
attention map and the prediction; IG on the same SmoothGrad noise (32 x
48, 2 x 3 steps).

Tolerances: maps within 1e-5 of their largest magnitude plus 1e-4
relative, GradCAM maps (in [0, 1]) within 1e-5 absolute; the predicted
class equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_explain_fixtures as fx
from vipers_torch.explain import attribution as tattr
from vipers_torch.explain import driver as tdriver


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(autouse=True)
def _flash_route(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")


@pytest.mark.parametrize("fam", ["vit", "resnet", "vgg"])
def test_compute_heatmaps_matches_jax(fam):
    fx.check_compute_heatmaps(fam)


@pytest.mark.parametrize("fam", ["vit", "resnet"])
def test_compute_heatmaps_ig_is_jax_ig_on_the_same_noise(fam):
    """``ig`` through ``compute_heatmaps`` (seed-0 CPU generator) against the
    JAX package's IG of the same model at the same noisy inputs: the maps
    differ from the JAX package's own ``ig`` by the noise draw alone."""
    jspec, variables, *_ = fx.family_models(fam)
    tspec, model = fx.port_model(fam)
    img = fx.image(fam, seed=4, size=(32, 48))
    got = tdriver.compute_heatmaps(tspec, model, img, ["ig"], ig_steps=3)
    target = int(np.argmax(got["prediction"]))
    noises = tattr.draw_smoothgrad_noise(torch.from_numpy(img)[None], 2, 1.0,
                                         torch.Generator().manual_seed(0))
    h, w = img.shape[:2]
    pos = fx.jax_pos(fam, h, w).get("override_pos_embedding")
    ig = fx.jdriver.make_integrated_gradients(fx.jdriver._score_fn(jspec, variables, pos),
                                              n_steps=3)
    want = sum(np.asarray(ig(jnp.asarray(img[None] + n.numpy()), jnp.asarray([target])))
               for n in noises) / 2
    fx.scaled_close(got["ig"], np.transpose(want[0], (2, 0, 1)))
