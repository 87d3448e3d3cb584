"""vipers_torch ViT forward, weight carry-over, qkv scramble, pos-embedding
weights and token padding against the JAX package, on a small config
(2 layers, D=128, 2 heads of 64, mlp 256) in f32 at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.interpolate as jinterp
import vipers.models.vit as jvit
import vipers.ops.tokens as jtok
import vipers_torch.models.interpolate as tinterp
import vipers_torch.models.vit as tvit
import vipers_torch.ops.tokens as ttok
from vipers_torch.core.checkpoint import vit_state_dict_from_flax
from vipers_torch.core.registry import build_model
from vipers_torch.core.tree import flatten_dict

CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128,
           mlp_dim=256, num_classes=10)
IMAGE = (64, 48)


@pytest.fixture(scope="module")
def models():
    jspec = jvit._build("tiny", jvit.ViTConfig(**CFG), IMAGE)
    x0 = jnp.zeros((1, *IMAGE, 3), jnp.float32)
    variables = jspec.module.init(jax.random.PRNGKey(0), x0, train=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    tspec = tvit._build("tiny", tvit.ViTConfig(**CFG), IMAGE)
    model = tspec.module()
    model.load_state_dict(vit_state_dict_from_flax(params))
    return jspec, variables, model.eval()


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("mode", ["plain", "masked-override", "seq-pad-flash"])
def test_forward_matches_jax_f32(models, monkeypatch, mode):
    jspec, variables, model = models
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *IMAGE, 3)).astype(np.float32)
    kw_j, kw_t = {}, {}
    need_attn = mode == "plain"
    if mode != "plain":
        t = (IMAGE[0] // 16) * (IMAGE[1] // 16) + 1
        pos = (rng.normal(size=(1, t, 128)) * 0.02).astype(np.float32)
        tm = np.ones((2, t), bool)
        tm[1, 5:9] = False
        kw_j = dict(override_pos_embedding=jnp.asarray(pos), token_mask=jnp.asarray(tm))
        kw_t = dict(override_pos_embedding=torch.from_numpy(pos),
                    token_mask=torch.from_numpy(tm))
    if mode == "seq-pad-flash":
        # lower both packages' threshold so the padded flash route runs
        monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
        kw_j["seq_pad_multiple"] = kw_t["seq_pad_multiple"] = 128
    logits_j, aux_j = jspec.module.apply(variables, jnp.asarray(x), train=False,
                                         need_attn=need_attn, **kw_j)
    with torch.no_grad():
        logits_t, aux_t = model(torch.from_numpy(x), need_attn=need_attn, **kw_t)
    np.testing.assert_allclose(_np(aux_t["qkv_input"]), np.asarray(aux_j["qkv_input"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(logits_t), np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(aux_t["cls"]), np.asarray(aux_j["cls"]),
                               rtol=1e-4, atol=1e-4)
    if need_attn:
        np.testing.assert_allclose(_np(aux_t["attn"]), np.asarray(aux_j["attn"]),
                                   rtol=1e-4, atol=1e-5)
    else:
        assert aux_t["attn"] is None


def test_init_tree_and_state_dict_match_jax_layout(models):
    """spec.init draws a tree with the JAX package's paths and shapes, and
    every leaf lands in the module's state dict."""
    jspec, variables, _ = models
    tspec = tvit._build("tiny", tvit.ViTConfig(**CFG), IMAGE)
    tree = tspec.init(torch.Generator().manual_seed(0))
    want = {p: tuple(a.shape) for p, a in flatten_dict(
        jax.tree.map(np.asarray, variables["params"])).items()}
    assert {p: tuple(a.shape) for p, a in flatten_dict(tree).items()} == want
    model = tspec.module()
    missing, unexpected = model.load_state_dict(vit_state_dict_from_flax(tree))
    assert not missing and not unexpected
    k = tree["encoder_layer_1"]["mlp"]["fc1"]["kernel"]
    assert torch.equal(model.layers[1].mlp.fc1.weight, k.t())
    ck = tree["conv_proj"]["kernel"]
    assert torch.equal(model.conv_proj.weight, ck.permute(3, 2, 0, 1))


def test_vit_s_16_registered():
    spec = build_model("vit_s_16", num_classes=1000, image_size=(512, 384))
    assert (spec.cfg.num_layers, spec.cfg.hidden_dim, spec.cfg.num_heads,
            spec.cfg.mlp_dim) == (12, 384, 6, 1536)
    assert spec.prune_exclude == ("qkv",) and spec.patch_size == 16


def test_scramble_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 21, 12)).astype(np.float32)
    t1 = np.array([21, 13, 7])
    for which in "qkv":
        got = tvit.scrambled_qkv_gather(torch.from_numpy(x), torch.from_numpy(t1), which)
        for b in range(3):
            want = jvit.scrambled_qkv_gather(jnp.asarray(x[b]), int(t1[b]), which)
            np.testing.assert_array_equal(_np(got[b]), np.asarray(want))
        got_c = tvit.scrambled_qkv_gather(torch.from_numpy(x), 21, which)
        np.testing.assert_array_equal(
            _np(got_c[0]), np.asarray(jvit.scrambled_qkv_gather(jnp.asarray(x[0]), 21, which)))
    dump = np.concatenate([x[:1]] * 3, axis=0)
    for a, b in zip(tvit.split_qkv_torchvision(torch.from_numpy(dump), 3),
                    jvit.split_qkv_torchvision(jnp.asarray(dump), 3)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("align", [True, False])
def test_resize_weight_matrix_equal(align):
    for i, o in [(14, 14), (14, 32), (32, 24), (24, 7), (1, 5)]:
        np.testing.assert_array_equal(tinterp.resize_weight_matrix_np(i, o, align),
                                      jinterp.resize_weight_matrix_np(i, o, align))


def test_pad_and_unpad_tokens_equal():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 33, 4)).astype(np.float32)
    tm = rng.random((2, 33)) > 0.3
    for mask in (None, tm):
        xj, mj = jtok.pad_tokens(jnp.asarray(x), None if mask is None else jnp.asarray(mask), 33, 16)
        xt, mt = ttok.pad_tokens(torch.from_numpy(x),
                                 None if mask is None else torch.from_numpy(mask), 33, 16)
        np.testing.assert_array_equal(_np(xt), np.asarray(xj))
        np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    attn = rng.normal(size=(2, 1, 48, 48)).astype(np.float32)
    got = ttok.unpad_tokens(xt, xt, torch.from_numpy(attn), 33)
    want = jtok.unpad_tokens(xj, xj, jnp.asarray(attn), 33)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert ttok.round_up(769, 128) == jtok.round_up(769, 128) == 896
