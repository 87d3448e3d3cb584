"""Dropout in vipers_torch (``models/stochastic.dropout``, VGG16's classifier
and the ViT's ``dropout_rate`` / ``attention_dropout_rate``) against the
JAX package on the CPU.

At rate 0 a masked f32 train step equals the JAX step (VGG16 narrowed to 8
channels a conv and fc 16 at 224x224, as ``tests/test_torch_resnet.py``;
a 2-block ViT, D 64, 2 heads of 32, patch 8). Above 0 the packages draw
different bits (a ``torch.Generator`` against flax's ``dropout`` rng), so
the port is held to the definition: the keep share within a binomial
5-sigma band, kept elements scaled by exactly 1 / keep, the identity in
eval mode and at rate 0, the same masks from the same (seed, step), a
raise without a generator; and the ViT's routes under attention dropout
are the JAX package's gates: no flash (``VIPERS_FLASH_MIN_T=16``) and no
short-T training kernel (bf16; the JAX kernel in interpret mode) where
attention dropout is on, the same calls as JAX at rate 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vgg as jvgg
import vipers.models.vit as jvit
import vipers.pruning as jprune
import vipers.train.optim as joptim
import vipers.train.steps as jsteps
from tests import torch_explain_fixtures as fx
from vipers_torch.models import stochastic
from vipers_torch.models import vgg as tvgg
from vipers_torch.models import vit as tvit
from vipers_torch.train import optim as toptim
from vipers_torch.train import steps as tsteps

jfa = importlib.import_module("vipers.ops.flash_attention")
jat = importlib.import_module("vipers.ops.attention_train")

CLASSES = 10
VGG = dict(conv_widths=(8,) * 13, fc_dims=(16, 16))
VIT = dict(fx.VIT_CFG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _vgg(rate, fc=(16, 16)):
    cfg = dict(VGG, fc_dims=fc)
    jm = jvgg.VGG16(num_classes=CLASSES, dropout_rate=rate, cfg=jvgg.VGGConfig(**cfg))
    spec = tvgg._spec("vgg_test", tvgg.VGGConfig(CLASSES, dropout_rate=rate, **cfg), (224, 224))
    return jm, spec, (224, 224)


def _vit(rate=0.0, attn_rate=0.0):
    cfg = dict(VIT, dropout_rate=rate, attention_dropout_rate=attn_rate)
    jm = jvit.VisionTransformer(cfg=jvit.ViTConfig(**cfg), image_size=(32, 32))
    spec = tvit._build("vit_test", tvit.ViTConfig(**cfg), (32, 32))
    return jm, spec, (32, 32)


def _params(spec, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a.numpy() + rng.normal(0, 0.02, a.shape).astype(np.float32),
                        spec.init(torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("family", ["vgg", "vit"])
def test_train_step_at_rate_0_matches_jax(family):
    """2 masked f32 SGD steps (momentum 0.9, lr 0.01) at dropout rate 0:
    losses, accuracies and parameters (atol 2e-5) equal to
    ``vipers.train.steps.make_train_step``'s; at rate 0 the model has no
    random layer, so the port's step seeds no generator."""
    jm, spec, hw = _vgg(0.0) if family == "vgg" else _vit()
    params = _params(spec)
    masks = {p: np.asarray(m) for p, m in jprune.magnitude_prune(
        params, jprune.init_masks(params, exclude=spec.prune_exclude), 0.5).items()}
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(2, *hw, 3)).astype(np.float32),
                rng.integers(0, CLASSES, size=(2,)).astype(np.int32)) for _ in range(2)]
    jocfg = joptim.OptimConfig(opt="sgd", lr=0.01)
    tx = joptim.make_optimizer(jocfg, params, joptim.make_lr_schedule(jocfg, 1))
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                               masks=masks, opt_state=tx.init(params))
    jstep = jsteps.make_train_step(jm.apply, tx, num_classes=CLASSES, donate=False)
    tstate = tsteps.create_train_state(spec, params, masks, toptim.OptimConfig(opt="sgd", lr=0.01),
                                       1, device="cpu")
    assert not stochastic.has_random_layers(tstate.model)
    tstep = tsteps.make_train_step(CLASSES, seed=7)
    for x, y in batches:
        jstate, jm_ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert abs(float(tm["loss"]) - float(jm_["loss"])) <= 1e-5 * abs(float(jm_["loss"]))
        assert float(tm["acc1"]) == float(jm_["acc1"])
    want = tstate.family.state_dict(jstate.params)
    for k, v in tstate.params.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=2e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_share_scaling_and_draws(rate):
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(0)) + 3.0
    out = stochastic.dropout(x, rate, True, stochastic.dropout_generator(1, 2, "cpu"))
    kept = out != 0
    keep = 1.0 - rate
    n = x.numel()
    assert abs(int(kept.sum()) - keep * n) <= 5 * np.sqrt(n * keep * rate)
    assert torch.equal(out[kept], x[kept] / keep)
    # the same (seed, step) draws the same mask, another step another
    again = stochastic.dropout(x, rate, True, stochastic.dropout_generator(1, 2, "cpu"))
    other = stochastic.dropout(x, rate, True, stochastic.dropout_generator(1, 3, "cpu"))
    assert torch.equal(again, out) and not torch.equal(other, out)
    assert stochastic.dropout(x, rate, False, None) is x
    assert stochastic.dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="needs a generator"):
        stochastic.dropout(x, rate, True, None)
    bf16 = stochastic.dropout(x.to(torch.bfloat16), rate, True,
                              stochastic.dropout_generator(1, 2, "cpu"))
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16 != 0, kept)


def test_vgg_classifier_dropout():
    """VGG16's two dropouts at the JAX model's rate of 0.5: the eval
    forward equals the JAX eval forward; in train mode each dropout keeps
    its input's nonzero entries at 1 / keep within the binomial band,
    from the forward's generator, and raises without one (fc 256 here, so
    the band is narrow)."""
    jm, spec, _ = _vgg(0.5, fc=(256, 256))
    assert spec.cfg.dropout_rate == 0.5 == tvgg.VGGConfig().dropout_rate
    params = _params(spec)
    model = spec.module()
    assert stochastic.has_random_layers(model)
    model.load_state_dict(tvgg_state(spec, params))
    x = np.random.default_rng(1).normal(size=(8, 224, 224, 3)).astype(np.float32)
    jout, _ = jm.apply({"params": params}, x)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(torch.from_numpy(x))[0].numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-4)
    seen = {}
    hooks = [model.classifier[i].register_forward_hook(
        lambda m, a, o, i=i: seen.__setitem__(i, o.detach().clone())) for i in (2, 5)]
    hooks += [model.classifier[i].register_forward_pre_hook(
        lambda m, a, i=i: seen.__setitem__(i, a[0].detach().clone())) for i in (3, 6)]
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x), generator=stochastic.dropout_generator(0, 5, "cpu"))[0]
        again = model(torch.from_numpy(x), generator=stochastic.dropout_generator(0, 5, "cpu"))[0]
    for h in hooks:
        h.remove()
    assert torch.equal(out, again)
    for before, after in ((2, 3), (5, 6)):
        live = seen[before] != 0
        kept = seen[after][live] != 0
        n = int(live.sum())
        assert n > 500 and abs(int(kept.sum()) - 0.5 * n) <= 5 * np.sqrt(n * 0.25)
        assert torch.equal(seen[after][live][kept], seen[before][live][kept] / 0.5)
        assert not seen[after][~live].any()
    with pytest.raises(ValueError, match="needs a generator"):
        model(torch.from_numpy(x))


def tvgg_state(spec, params):
    from vipers_torch.core.checkpoint import family

    return family(spec).state_dict(params)


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("route", ["flash", "train-kernel"])
@pytest.mark.parametrize("attn_rate", [0.0, 0.1])
def test_vit_routes_under_attention_dropout(route, attn_rate, monkeypatch):
    """A train forward of the 2-block ViT at 32x48 (T = 25): with
    ``VIPERS_FLASH_MIN_T=16`` in f32 every block takes the flash route, in
    bf16 below the threshold the short-T training kernel, at attention
    dropout 0; at 0.1 neither, as the JAX gates decide (counted in both
    packages), the tokens unpadded and the output finite and unlike the
    rate-0 forward's."""
    monkeypatch.setenv("VIPERS_FUSED_ATTN_INTERPRET", "1")
    if route == "flash":
        monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
        port = _count(monkeypatch, tvit, "flash_attention")
        want = _count(monkeypatch, jfa, "flash_attention")
        dtype, jdtype = torch.float32, jnp.float32
    else:
        port = _count(monkeypatch, tvit, "attention_train_packed")
        want = _count(monkeypatch, jat, "attention_train_packed")
        dtype, jdtype = torch.bfloat16, jnp.bfloat16
    jm, spec, _ = _vit(attn_rate=attn_rate)
    params = _params(spec)
    x = np.random.default_rng(2).normal(size=(2, 32, 48, 3)).astype(np.float32)
    pos = tvit.init_vit_params(spec.cfg, (32, 48), torch.Generator().manual_seed(1))
    pos = pos["pos_embedding"].numpy()
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
    jm.apply({"params": jparams}, jnp.asarray(x, jdtype), train=True, need_attn=False,
             override_pos_embedding=jnp.asarray(pos, jdtype),
             rngs={"dropout": jax.random.PRNGKey(0)})
    model = spec.module()
    model.load_state_dict(tvgg_state(spec, params))
    model = model.to(dtype).train()
    assert tvit._auto_seq_pad(25, dtype, True, False, spec.cfg) == (None if attn_rate else 128)

    def forward(m):
        with torch.no_grad():
            return m(torch.from_numpy(x).to(dtype), need_attn=False,
                     override_pos_embedding=torch.from_numpy(pos).to(dtype),
                     generator=stochastic.dropout_generator(0, 0, "cpu"))[0]

    out = forward(model)
    assert len(port) == len(want) == (0 if attn_rate else VIT["num_layers"])
    assert torch.isfinite(out.float()).all()
    if attn_rate:
        base = spec.module()
        base.load_state_dict(model.state_dict())
        for blk in base.layers:
            blk.attention.dropout_rate = 0.0
        assert not torch.equal(forward(base.to(dtype).train()), out)
