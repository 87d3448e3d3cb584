"""vipers_torch's DINO ViT (``models/dino_vit.py``) against the JAX package
on the CPU: the forward and its ``aux`` outputs at patch 16 and 8, at 224
and at sizes whose position table is interpolated; the flash route (its
plain version here) at T >= 512; bf16 through the fused MLP's plain
version; the facebookresearch/dino import; the registry.

Small sizes: ``dino_vit_tiny``'s width (D 192, 3 heads of 64, mlp 768) cut
to 2 blocks, B = 1 (2 for the flash route's masks and for bf16). The
weights are the port's initial parameters (seed 0) as numpy with N(0,
0.02) on every leaf, so the class token and the biases are not zero; the
JAX module (jitted) takes them as its variables and the port through
``core.checkpoint.dino_state_dict_from_flax``. Tolerances:
f32 atol 1e-5 / rtol 1e-4 (the einsum's and the flash plain version's);
bf16 2e-2 of each output's scale.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import vipers.core.checkpoint as jck
import vipers.core.registry as jreg
import vipers.models.dino_vit as jdino
from tests import torch_explain_fixtures as fx
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict
from vipers_torch.models import dino_vit as tdino

DEPTH = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _cfgs(patch):
    return (jdino.DinoViTConfig(patch, 192, DEPTH, 3, 4.0, 0),
            tdino.DinoViTConfig(patch, 192, DEPTH, 3, 4.0, 0))


@functools.lru_cache(maxsize=None)
def models(patch):
    """(the JAX module's jitted apply, params as numpy, the port's module in
    eval mode)."""
    jcfg, tcfg = _cfgs(patch)
    spec = tdino._build("dino_test", tcfg)
    rng = np.random.default_rng(patch)
    params = jax.tree.map(lambda a: a.numpy() + rng.normal(0, 0.02, a.shape).astype(np.float32),
                          spec.init(torch.Generator().manual_seed(0)))
    model = spec.module()
    model.load_state_dict(tck.dino_state_dict_from_flax(params))
    jm = jdino.DinoVisionTransformer(cfg=jcfg, base_grid=224 // patch)
    return (jax.jit(jm.apply, static_argnames=("need_attn", "seq_pad_multiple")), params,
            model.eval())


def _images(hw, b=1, seed=0):
    return np.random.default_rng(seed).normal(size=(b, *hw, 3)).astype(np.float32)


def _close(got, want, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("patch,hw", [(16, (224, 224)), (16, (160, 96)), (8, (112, 120)),
                                      (8, (224, 224))],
                         ids=["p16-224", "p16-160x96", "p8-112x120", "p8-224"])
def test_forward_matches_jax(patch, hw, monkeypatch):
    """f32, ``need_attn``: the CLS feature, the last block's qkv, attn and
    norm1 output and the final tokens; the pos table resized where the
    grid is not 224 // patch a side. At patch 8 and 224 (T = 785) the
    first block takes the flash route (its plain version here)."""
    japply, params, model = models(patch)
    calls = []
    real = tdino.flash_attention
    monkeypatch.setattr(tdino, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    x = _images(hw)
    jout, jaux = japply({"params": params}, x)
    with torch.no_grad():
        tout, taux = model(torch.from_numpy(x))
    _close(tout, jout)
    for key in ("qkv", "attn", "tokens", "qkv_input"):
        assert taux[key].shape == jaux[key].shape, key
        _close(taux[key], jaux[key])
    t = (hw[0] // patch) * (hw[1] // patch) + 1
    assert len(calls) == (DEPTH - 1 if t >= 512 else 0)


@pytest.mark.parametrize("patch,hw", [(8, (224, 224))], ids=["p8-224"])
def test_flash_route_matches_jax(patch, hw, monkeypatch):
    """The LOST forward (no attention probabilities, tokens padded to a
    128 multiple, bucket keys masked): every block through
    ``flash_attention`` at T >= 512, against the JAX package's route."""
    japply, params, model = models(patch)
    calls = []
    real = tdino.flash_attention
    monkeypatch.setattr(tdino, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    x = _images(hw, b=2, seed=1)
    t = (hw[0] // patch) * (hw[1] // patch) + 1
    mask = np.ones((2, t), bool)
    mask[1, t // 2:] = False  # the second image's last keys are bucket pad
    kw = dict(need_attn=False, seq_pad_multiple=128)
    jout, jaux = japply({"params": params}, x, token_mask=mask, **kw)
    with torch.no_grad():
        tout, taux = model(torch.from_numpy(x), token_mask=torch.from_numpy(mask), **kw)
    assert len(calls) == DEPTH and calls[0][2] == -(-t // 128) * 128
    assert taux["attn"] is None and jaux["attn"] is None
    _close(tout, jout)
    _close(taux["qkv"], jaux["qkv"])


def test_bf16_fused_mlp_matches_jax(monkeypatch):
    """bf16 inference with the rows on the fused kernel's block rule: every
    block's norm2 -> fc1 -> GELU through ``fused_ln_dense_gelu`` (its plain
    version here), within 2e-2 of each output's scale of the JAX package's
    bf16 forward."""
    japply, params, model = models(16)
    calls = []
    real = tdino.fused_ln_dense_gelu
    monkeypatch.setattr(tdino, "fused_ln_dense_gelu",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    x = _images((224, 224), b=2, seed=2)
    jparams = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), params)
    jout, jaux = japply({"params": jparams}, x.astype(jax.numpy.bfloat16),
                          need_attn=False, seq_pad_multiple=128)
    bf16 = tdino.DinoVisionTransformer(_cfgs(16)[1])
    bf16.load_state_dict(model.state_dict())
    bf16 = bf16.to(torch.bfloat16).eval()
    with torch.no_grad():
        tout, taux = bf16(torch.from_numpy(x).to(torch.bfloat16), need_attn=False,
                          seq_pad_multiple=128)
    assert len(calls) == DEPTH and calls[0] == (2, 256, 192)
    for got, want in ((tout, jout), (taux["qkv"], jaux["qkv"]), (taux["tokens"], jaux["tokens"])):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_import_dino_vit_matches_jax(qkv_bias):
    """A facebookresearch/dino state dict (with its head, which neither
    importer reads) through ``import_dino_vit``: the JAX package's tree;
    ``export_dino_vit`` writes it back key for key."""
    _, params, _ = models(16)
    sd = tck.export_dino_vit(params)
    assert "patch_embed.proj.weight" in sd and "blocks.1.mlp.fc2.bias" in sd
    if not qkv_bias:
        for i in range(DEPTH):
            del sd[f"blocks.{i}.attn.qkv.bias"]
    sd_full = {**sd, "head.weight": np.zeros((5, 192), np.float32),
               "head.bias": np.zeros(5, np.float32)}
    got, got_masks = tck.import_dino_vit(sd_full, DEPTH)
    want, want_masks = jck.import_dino_vit(sd_full, DEPTH)
    got, want = flatten_dict(got), flatten_dict(want)
    assert got.keys() == want.keys() and got_masks == want_masks == {}
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=str(path))
    if qkv_bias:
        assert tck.export_dino_vit(tck.import_dino_vit(sd, DEPTH)[0]).keys() == sd.keys()
        spec = tdino._build("dino_test", _cfgs(16)[1])
        back, stats, masks = tck.family(spec).import_pth(sd, spec)
        assert stats is None and masks == {}
        for path, w in flatten_dict(back).items():
            np.testing.assert_array_equal(w, flatten_dict(params)[path])


@pytest.mark.parametrize("name", ["dino_vit_tiny", "dino_vit_small", "dino_vit_base"])
@pytest.mark.parametrize("patch", [8, 16])
def test_registry_matches_jax(name, patch):
    """The three backbones at patch 8 and 16: the JAX registry's
    metadata, and parameter shapes equal to the JAX module's."""
    jspec = jreg.build_model(name, patch_size=patch)
    tspec = tbuild(name, patch_size=patch)
    assert (tspec.family, tspec.patch_size, tspec.input_size, tspec.num_classes,
            tuple(tspec.prune_exclude), tspec.extra) == \
        (jspec.family, jspec.patch_size, jspec.input_size, jspec.num_classes,
         tuple(jspec.prune_exclude), jspec.extra)
    shapes = jax.eval_shape(lambda: jspec.module.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 224, 224, 3))))["params"]
    want = {p: tuple(s.shape) for p, s in flatten_dict(shapes).items()}
    with torch.device("meta"):
        module = tspec.module()
    got = {p: tuple(w.shape) for p, w in flatten_dict(
        tck.family(tspec).trees(dict(module.named_parameters()))[0]).items()}
    assert got == want
