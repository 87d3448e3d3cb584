"""The port's batched CNN LOST program as a ``torch.export`` artifact
(``vipers_torch/core/export.py``) against the JAX package's
``make_cnn_lost_serving_forward``, on the CPU: resnet18 (the port's init,
seed 0, running statistics drawn away from 0/1, 50% magnitude masks, the
same numpy weights in both packages) at its canonical bucket input, as
``tests/test_export.py`` holds the JAX artifact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import vipers.core.export as jexport
from vipers.core.registry import build_model as jbuild
from tests import torch_explain_fixtures as fx
from tests.test_torch_cnn_lost import _weights as cnn_weights
from tests.test_torch_export import _images, _roundtrip
from vipers_torch.core import export as texport
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.discovery.driver import LostFeatureExtractor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def test_cnn_lost_artifact_matches_jax(tmp_path):
    """The reloaded resnet18 LOST artifact at its canonical bucket input
    against ``make_cnn_lost_serving_forward``: boxes, seeds and background
    flags equal; a shape that is no canonical input raises in both."""
    params, stats, masks = cnn_weights("resnet18")
    jspec = jbuild("resnet18", num_classes=1000)
    tspec = tbuild("resnet18")
    variables = {"params": params, "batch_stats": stats}
    jmasks = {p: jnp.asarray(m) for p, m in masks.items()}
    hw = LostFeatureExtractor(tspec, params, masks, device="cpu",
                              batch_stats=stats).cnn_bucket_key(96, 128)
    x = _images(2, 5, hw)
    jfn = jexport.make_cnn_lost_serving_forward(jspec, variables, batch_size=2, image_size=hw,
                                                masks=jmasks, k_patches=20)
    want = [np.asarray(o) for o in jfn(jnp.asarray(x))]
    prog, meta = texport.export_lost_pipeline(tspec, params, batch_size=2, image_size=hw,
                                              masks=masks, batch_stats=stats, k_patches=20,
                                              device="cpu")
    assert meta["family"] == "resnet" and meta["custom_ops"] == []
    fn, _ = _roundtrip(tmp_path, prog, meta)
    for g, w in zip(fn(x), want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="canonical"):
        texport.make_cnn_lost_serving_forward(tspec, params, batch_size=2, image_size=(100, 100),
                                              batch_stats=stats, device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        jexport.make_cnn_lost_serving_forward(jspec, variables, batch_size=2,
                                              image_size=(100, 100))
