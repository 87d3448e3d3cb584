"""The JAX package's four routing switches, read at call time, move the
port's ViT onto the same route as the JAX ViT: ``VIPERS_FLASH_MIN_T``,
``VIPERS_PACKED_ATTENTION=1``, ``VIPERS_FUSED_MLP=0`` and
``VIPERS_FUSED_ATTN=0``.

Each case runs both packages with the switch set and without it, recording
which kernel entry points each ViT calls (the port's in
``vipers_torch.models.vit``, the JAX package's in its ops modules; the
recorders call through). The JAX fused-MLP and training-attention gates
run with their ``*_INTERPRET`` overrides, so on the CPU they open exactly
where they would on a TPU. The routes must be equal and as expected; with
the switch set, the f32 outputs must agree at 1e-4.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vit as jvit
import vipers_torch.models.vit as tvit
from vipers_torch.core.checkpoint import vit_state_dict_from_flax

CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
           num_classes=10)
IMAGE = (64, 48)  # 13 tokens; 128 once seq-padded, so 128-row MLP blocks

JAX_ENTRIES = {"flash": ("vipers.ops.flash_attention", "flash_attention"),
               "packed": ("vipers.ops.flash_attention", "flash_attention_packed"),
               "fused_mlp": ("vipers.ops.fused_mlp", "fused_ln_dense_gelu"),
               "attention_train": ("vipers.ops.attention_train", "attention_train_packed")}
PORT_ENTRIES = {"flash": "flash_attention", "packed": "flash_attention_packed",
                "fused_mlp": "fused_ln_dense_gelu",
                "attention_train": "attention_train_packed"}

# switch, the environment besides it, the mode that exercises it, and the
# route with the switch set / unset
CASES = {
    "flash_min_t": ({"VIPERS_FLASH_MIN_T": "16"}, {}, "infer-f32", {"flash"}, set()),
    "packed": ({"VIPERS_PACKED_ATTENTION": "1"}, {"VIPERS_FLASH_MIN_T": "16"}, "infer-f32",
               {"packed"}, {"flash"}),
    "fused_mlp_off": ({"VIPERS_FUSED_MLP": "0"}, {}, "infer-bf16", set(), {"fused_mlp"}),
    "fused_attn_off": ({"VIPERS_FUSED_ATTN": "0"}, {}, "train-bf16", set(),
                       {"attention_train"}),
}
SWITCHES = ("VIPERS_FLASH_MIN_T", "VIPERS_PACKED_ATTENTION", "VIPERS_FUSED_MLP",
            "VIPERS_FUSED_ATTN")


@pytest.fixture(scope="module")
def models():
    jspec = jvit._build("tiny", jvit.ViTConfig(**CFG), IMAGE)
    variables = jspec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, *IMAGE, 3)),
                                  train=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    model = tvit._build("tiny", tvit.ViTConfig(**CFG), IMAGE).module()
    model.load_state_dict(vit_state_dict_from_flax(params))
    return jspec.module, variables, model


def _run(models, mode, x, calls):
    """(JAX logits, port logits) for ``mode``, recording the routes."""
    module, variables, model = models
    train = mode.startswith("train")
    kw = {} if train else {"seq_pad_multiple": 128}
    jv, jx = variables, jnp.asarray(x)
    tm, tx = copy.deepcopy(model).train(train), torch.from_numpy(x)
    if mode.endswith("bf16"):
        jv = jax.tree.map(lambda a: a.astype(jnp.bfloat16), variables)
        jx = jx.astype(jnp.bfloat16)
        tm, tx = tm.to(torch.bfloat16), tx.bfloat16()
    with pytest.MonkeyPatch.context() as mp:
        for tag, (mod, name) in JAX_ENTRIES.items():
            m = importlib.import_module(mod)
            mp.setattr(m, name, lambda *a, _r=getattr(m, name), _t=tag, **k:
                       calls["jax"].add(_t) or _r(*a, **k))
        for tag, name in PORT_ENTRIES.items():
            mp.setattr(tvit, name, lambda *a, _r=getattr(tvit, name), _t=tag, **k:
                       calls["port"].add(_t) or _r(*a, **k))
        jout, _ = module.apply(jv, jx, train=train, need_attn=False, **kw)
        with torch.no_grad():
            tout, _ = tm(tx, need_attn=False, **kw)
    return np.asarray(jout.astype(jnp.float32)), tout.float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_switch_moves_both_packages_onto_one_route(models, monkeypatch, case):
    switch, base, mode, with_switch, without = CASES[case]
    x = np.random.default_rng(3).normal(size=(2, *IMAGE, 3)).astype(np.float32)
    for env, want in ((switch, with_switch), ({}, without)):
        for name in SWITCHES:
            monkeypatch.delenv(name, raising=False)
        for name, value in {**base, **env, "VIPERS_FUSED_MLP_INTERPRET": "1",
                            "VIPERS_FUSED_ATTN_INTERPRET": "1"}.items():
            monkeypatch.setenv(name, value)
        calls = {"jax": set(), "port": set()}
        _run(models, mode, x, calls)
        assert calls["port"] == calls["jax"] == want, (env, calls)

    for name, value in switch.items():
        monkeypatch.setenv(name, value)
    jout, tout = _run(models, mode.replace("bf16", "f32"), x, {"jax": set(), "port": set()})
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)
