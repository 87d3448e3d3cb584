"""The activation sites of vipers_torch's quantize hooks against the JAX
package's ``observer_sites`` on the CPU, for every family: the same flax
module paths (``layer1_0/downsample_conv``, ``encoder_layer_0/mlp/fc1``,
``block1_0/expand/conv``) in the same call order, less each spec's
``quant_exclude``, and the same ``:in`` / ``:out`` observer keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_explain_fixtures as fx
import vipers.train.quantize as jq
from vipers.core.registry import build_model as jbuild
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.train import quantize as tq


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _jax_sites(jspec, variables, x, exclude):
    return jq.observer_sites(jspec.module, variables, jnp.asarray(x),
                             exclude=exclude, train=False, need_attn=False)


def _port_sites(tspec, model, x):
    return tq.observer_sites(model, tck.family(tspec), torch.from_numpy(x), exclude=tspec.quant_exclude,
                             need_attn=False)


@pytest.mark.parametrize("fam", ["vit", "resnet", "vgg", "swin"])
def test_observer_sites_match_jax(fam):
    jspec, variables, tspec, _p, _s = fx.family_models(fam)
    _tspec, model = fx.port_model(fam)
    x = fx.images(fam)
    # the fixtures' JAX Swin spec is built by hand: the registry's exclusions
    assert tuple(tspec.quant_exclude) == tuple(jbuild(
        {"vit": "vit_s_16", "resnet": "resnet18", "vgg": "vgg16", "swin": "swin_v2_t"}[fam]
    ).quant_exclude)
    want = _jax_sites(jspec, variables, x, tspec.quant_exclude)
    assert _port_sites(tspec, model, x) == want
    assert list(tq.init_observers(want)) == list(jq.init_observers(want))


@pytest.mark.parametrize("name,size", [("mobilenet_v2", 32), ("dino_vit_tiny", 224),
                                       ("quantized_resnet18", 32)])
def test_observer_sites_match_jax_registered(name, size):
    kw = {"width_mult": 0.25} if "mobilenet" in name else {}
    tspec, jspec = tbuild(name, **kw), jbuild(name, **kw)
    x = np.zeros((1, size, size, 3), np.float32)
    variables = jax.eval_shape(lambda: jspec.module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                         train=False))
    model = tspec.module().eval()
    want = _jax_sites(jspec, variables, x, jspec.quant_exclude)
    assert len(want) > 10
    assert _port_sites(tspec, model, x) == want
