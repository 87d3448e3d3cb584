"""``lost --dtype int8`` in vipers_torch against the JAX package on the
CPU: the batched ViT pipeline on a masked bucket (token masks at the raw
and the seq-padded T) through the flash, the einsum and the packed
routes, with dynamic qparams and with static ones from calibrated
observers; the fused MLP off under the int8 sites (fc1 stays a Dense call,
as the JAX gate keeps it under flax interceptors). The CNN paths:
``tests/test_torch_quantize_cnn_lost.py``.

Models: the pipeline tests' ViT (2 layers, D=128, 2 heads, mlp 256, 50%
magnitude masks; ``VIPERS_FLASH_MIN_T=16`` puts both packages on the
seq-pad/flash route), resnet18 with dilate 2. Both packages bake int8
kernels from the masked f32 weights and run the rest in bf16; XLA's CPU
bf16 and torch's round differently, and an activation a bf16 ulp apart
lands in the neighbouring uint8 bin, so features are held at 2e-2 of their
scale (bf16's), boxes and seeds equal where the seed is not a tie at the
top score, as in ``tests/test_torch_pipeline.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_pipeline as pt
import torch_explain_fixtures as fx
import vipers.train.quantize as jq
import vipers_torch.models.vit as tvit
from vipers_torch.discovery.driver import LostFeatureExtractor
from vipers_torch.discovery.lost import lost_core

jdriver = importlib.import_module("vipers.discovery.driver")

model = pt.model  # the pipeline tests' module-scoped fixture


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _features_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(), rtol=0)


def _boxes_tie_aware(tbox, tseed, jbox, jseed, scores):
    for i in range(len(tseed)):
        if tseed[i] == jseed[i]:
            np.testing.assert_array_equal(tbox[i], jbox[i])
        else:
            assert scores[i, tseed[i]] == scores[i, jseed[i]] == scores[i].max()


def _calibrated_observers(spec, variables, masks, imgs):
    """The JAX package's PTQ observers of the masked model on ``imgs``
    (host-normalized, one bucket), as a checkpoint carries them."""
    from vipers.pruning.masks import apply_masks

    mp = jax.jit(apply_masks)(variables["params"], masks)
    x = np.zeros((len(imgs), *pt.IMAGE, 3), np.float32)
    for i, im in enumerate(imgs):
        x[i, :im.shape[0], :im.shape[1]] = (im.astype(np.float32) / 255.0 - 0.45) / 0.25
    sites = jq.observer_sites(spec.module, {"params": mp}, jnp.asarray(x),
                              exclude=spec.quant_exclude, train=False, need_attn=False)
    obs = jq.ptq_calibrate(spec.module, {"params": mp}, jq.init_observers(sites),
                           [(jnp.asarray(x), None)], exclude=spec.quant_exclude)
    return {k: {"min": np.asarray(o.min_val), "max": np.asarray(o.max_val)}
            for k, o in obs.items()}


@pytest.mark.parametrize("route,static", [("flash", False), ("einsum", False),
                                          ("packed", False), ("flash", True)],
                         ids=["flash", "einsum", "packed", "flash-static"])
def test_int8_batched_vit_pipeline_matches_jax(model, monkeypatch, route, static):
    spec, variables, masks, tspec, params, tmasks = model
    monkeypatch.delenv("VIPERS_PACKED_ATTENTION", raising=False)
    if route != "einsum":
        monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    if route == "packed":
        monkeypatch.setenv("VIPERS_PACKED_ATTENTION", "1")
    fused = []
    real_fused = tvit.fused_ln_dense_gelu
    monkeypatch.setattr(tvit, "fused_ln_dense_gelu",
                        lambda *a, **k: fused.append(1) or real_fused(*a, **k))
    exact_hw = pt.BUCKETS["masked"]
    imgs = pt._images(exact_hw, seed=7)
    observers = _calibrated_observers(spec, variables, masks, imgs) if static else None

    jex = jdriver.LostFeatureExtractor(spec, variables, masks, arch="vit", which_features="k",
                                       compute_dtype="int8", observers=observers)
    jin = jex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    jbox, jseed, jbg = map(np.asarray, jex.make_batched_pipeline(k_patches=pt.K)(
        jex.variables, *jin))
    tex = LostFeatureExtractor(tspec, params, tmasks, which_features="k", device="cpu",
                               compute_dtype="int8", observers=observers)
    assert tex.compute_dtype == torch.bfloat16 and tex.int8
    assert set(tex._q) == {"/".join(p[:-1]) for p in jex._q}
    if static:
        assert set(tex._static_qparams) == {k[:-3] for k in observers if k.endswith(":in")}
    tin = tex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    assert tin[2] is not None  # a masked bucket: token masks reach the qparams
    tbox, tseed, tbg = (z.numpy() for z in tex.make_batched_pipeline(k_patches=pt.K)(*tin))
    assert not fused  # the fused MLP stays off while the int8 sites watch fc1
    np.testing.assert_array_equal(tbg, jbg)
    feats = tex.batched_features(*tin)
    scores = lost_core(feats.float(), tin[3], (8, 4), k_patches=pt.K)["scores"].numpy()
    _boxes_tie_aware(tbox, tseed, jbox, jseed, scores)
    # and the same batch in bf16 runs the fused MLP on this route
    if route != "einsum":
        bex = LostFeatureExtractor(tspec, params, tmasks, device="cpu",
                                   compute_dtype=torch.bfloat16)
        bex.make_batched_pipeline(k_patches=pt.K)(*bex.prepare_batch(imgs, 16,
                                                                    exact_hw=exact_hw))
        assert len(fused) == 2


def test_int8_vit_features_match_jax_dynamic_apply(model, monkeypatch):
    """The features of the int8 forward against ``int8_dynamic_apply`` with
    the JAX driver's token masks (raw and seq-padded T)."""
    spec, variables, masks, tspec, params, tmasks = model
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    exact_hw = pt.BUCKETS["masked"]
    imgs = pt._images(exact_hw, seed=8)
    jex = jdriver.LostFeatureExtractor(spec, variables, masks, arch="vit", compute_dtype="int8")
    jin = jex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    images = jdriver._device_normalize(jin[0], jin[4]).astype(jnp.bfloat16)
    spm = jdriver._seq_pad(images.shape, 16, False)
    _, jaux = jax.jit(lambda v, im, pos, tm: jex._module_apply(
        v, im, train=False, override_pos_embedding=pos, token_mask=tm, need_attn=False,
        seq_pad_multiple=spm))(jex.variables, images, jin[1].astype(jnp.bfloat16), jin[2])
    tex = LostFeatureExtractor(tspec, params, tmasks, device="cpu", compute_dtype="int8")
    tin = tex.prepare_batch(imgs, 16, exact_hw=exact_hw)
    with torch.inference_mode():
        from vipers_torch.discovery.driver import device_normalize

        taux = tex._transformer_aux(device_normalize(tin[0], tin[4]), tin[1], tin[2])
    _features_close(taux["qkv_input"].float().numpy(), np.asarray(jaux["qkv_input"], np.float32))
