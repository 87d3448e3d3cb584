"""Training vipers_torch's Swin-V2 against the JAX package on the CPU: the
masked train step and EMA, SNIP, the optimizer's decay groups, and
stochastic depth in the train step and in SNIP's loss.

The configuration of ``tests/test_torch_swin.py`` (embed 24, heads (3, 3,
6, 6), 10 classes) with two blocks a stage, at 256x256 (swin_v2_t's input: no stage pads its map),
B = 2, its weights (flax init, seed 0, plus N(0, 0.05) on every leaf). At
sizes where a stage pads, the JAX package's gradients are NaN (a pad
token's k is zero and the sqrt in its norm has an infinite derivative
there); the port gives it torch's zero gradient, as torchvision does
(``test_gradients_stay_finite_where_a_stage_pads``). Exact parity needs stochastic depth at rate 0:
the JAX package draws its masks from the ``dropout`` rng, the port from a
torch generator (``models.stochastic``), so at rate 0.2 the two agree by
distribution (``test_torch_swin.py``) and each package only with itself:
the same (seed, step) draws the same masks, a resumed run included.
Tolerances: params after 3 SGD steps atol 2e-5 (the ViT and ResNet
tests'); SNIP's saliencies against an f64 yardstick (see its test).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.swin as jswin
import vipers.pruning as jprune
import vipers.pruning.snip as jsnip
import vipers.train.optim as joptim
import vipers.train.steps as jsteps
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.tree import flatten_dict
import vipers_torch.pruning as tprune
from vipers_torch.models import swin as tswin
from vipers_torch.pruning import snip as tsnip
from vipers_torch.train import optim as toptim
from vipers_torch.train import steps as tsteps
from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


# two blocks a stage (the registry's (2, 2, 6, 2) is held by
# tests/test_torch_swin.py): every kind of block, at 2/3 of the compile time
CFG = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(3, 3, 6, 6), num_classes=10)
CLASSES = 10


def _spec(sd_prob=0.0):
    return tswin.swin_spec("swin_test", tswin.SwinV2Config(**CFG, stochastic_depth_prob=sd_prob),
                           (64, 64))


@functools.lru_cache(maxsize=None)
def _setup():
    """Weights, 50% global magnitude masks over the prunable kernels (qkv
    and the CPB MLP excluded) and three B=2 256x256 batches."""
    spec = _spec()
    params = jax.tree.map(lambda a: a.numpy(), spec.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params, exclude=spec.prune_exclude), amount=0.5).items()}
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(2, 256, 256, 3)).astype(np.float32),
                rng.integers(0, CLASSES, size=(2,)).astype(np.int32)) for _ in range(3)]
    return params, masks, batches


def _jax_module(sd_prob=0.0):
    return jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(**CFG, stochastic_depth_prob=sd_prob))


def test_prunable_kernels_exclude_qkv_and_cpb():
    params, masks, _ = _setup()
    names = {"/".join(p) for p in masks}
    assert not any("qkv" in n or "cpb" in n for n in names)
    assert {"patch_embed/kernel", "stage0_block0/attn/proj/kernel", "stage2_block1/fc2/kernel",
            "merge0/reduction/kernel", "head/kernel"} <= names


def test_gradients_stay_finite_where_a_stage_pads():
    """At 64x64 the last two stages pad their maps (4x4 and 2x2 to 8x8):
    the JAX package's gradients are NaN there, the port's finite (the
    forward is the same function)."""
    params, _, _ = _setup()
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    y = np.array([1, 2], np.int32)
    jm = _jax_module()

    def jloss(p):
        return jsteps.cross_entropy(jm.apply({"params": p}, jnp.asarray(x), train=True)[0],
                                    jnp.asarray(y), CLASSES)

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jgrads))
    spec = _spec()
    model = spec.module()
    model.load_state_dict(tck.family(spec).state_dict(params))
    loss, _, grads = tsteps.loss_and_grads(model, {}, (torch.from_numpy(x),
                                                       torch.from_numpy(y).long()), CLASSES)
    assert abs(float(loss) - float(jl)) <= 1e-5 * float(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def test_masked_train_step_matches_jax():
    """3 f32 SGD steps (momentum 0.9, wd 1e-4, lr 0.01) at stochastic depth
    0 with an EMA: loss and accuracies per step, params and EMA weights
    after, against ``vipers.train.steps.make_train_step``; pruned slots
    unchanged."""
    params, masks, batches = _setup()
    jocfg = joptim.OptimConfig(opt="sgd", lr=0.01)
    tx = joptim.make_optimizer(jocfg, params, joptim.make_lr_schedule(jocfg, 1))
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                               masks=masks, opt_state=tx.init(params), ema_params=params)
    jstep = jsteps.make_train_step(_jax_module().apply, tx, num_classes=CLASSES, ema_decay=0.9,
                                   donate=False)
    spec = _spec()
    tstate = tsteps.create_train_state(spec, params, {p: np.array(m) for p, m in masks.items()},
                                       toptim.OptimConfig(opt="sgd", lr=0.01), 1, device="cpu",
                                       ema=True)
    tstep = tsteps.make_train_step(CLASSES, ema_decay=0.9, seed=0)
    before = {k: p.detach().clone() for k, p in tstate.params.items()}
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(tm["acc1"]) == float(jm["acc1"]) and float(tm["acc5"]) == float(jm["acc5"])
    fam = tstate.family
    for got, want in ((tstate.params, fam.state_dict(jstate.params)),
                      (tstate.ema_params, fam.state_dict(jstate.ema_params))):
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=2e-5, rtol=0,
                                       err_msg=k)
    for k, m in tstate.masks.items():
        assert torch.equal(tstate.params[k].detach()[~m], before[k][~m]), k


def test_snip_saliencies_match_jax():
    """SNIP's saliencies of the dense model in f32 at stochastic depth 0,
    against ``vipers.pruning.snip.snip_saliency`` with the JAX driver's
    loss (train mode, the dropout rng from the seed). A 64x64 stage-0 map
    sums each patch-embedding and stage-0 gradient over 8192 positions:
    both packages' f32 saliencies lie ~8e-6 of their scale from an f64
    run of the port (the ViT test's 2e-6 of the scale is below f32's reach
    here), so each leaf is held within 2e-6 of the scale plus twice the
    JAX package's own distance from the f64 run, and the port no farther
    from the f64 run than 2x the JAX package overall."""
    params, _, batches = _setup()
    x, y = batches[0]
    jm = _jax_module()
    spec = _spec()

    def jloss(p, batch):
        logits = jm.apply({"params": p}, batch[0], train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})[0]
        return jsteps.cross_entropy(logits, batch[1], CLASSES)

    jmasks = jprune.init_masks(params, exclude=spec.prune_exclude)
    want = jsnip.snip_saliency(jloss, params, (jnp.asarray(x), jnp.asarray(y)), masks=jmasks)
    got = {}
    for dt in (torch.float32, torch.float64):
        tparams = jax.tree.map(lambda a: torch.from_numpy(a).to(dt), params)
        got[dt] = tsnip.snip_saliency(
            tsnip.snip_loss(spec, CLASSES, seed=0), tparams,
            (torch.from_numpy(x).to(dt), torch.from_numpy(y).long()),
            masks=tprune.init_masks(tparams, exclude=spec.prune_exclude))
    assert set(got[torch.float32]) == set(want)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    worst = {"port": 0.0, "jax": 0.0}
    for k, v in want.items():
        v, ref = np.asarray(v, np.float64), got[torch.float64][k].numpy()
        port = got[torch.float32][k].numpy().astype(np.float64)
        own = float(np.abs(v - ref).max())
        assert float(np.abs(port - v).max()) <= 2e-6 * scale + 2 * own, k
        worst["port"] = max(worst["port"], float(np.abs(port - ref).max()))
        worst["jax"] = max(worst["jax"], own)
    assert worst["port"] <= 2 * worst["jax"], worst


def _state(sd_prob, seed=0):
    params, masks, _ = _setup()
    spec = _spec(sd_prob)
    state = tsteps.create_train_state(spec, params, {p: np.array(m) for p, m in masks.items()},
                                      toptim.OptimConfig(opt="sgd", lr=0.01), 1, device="cpu")
    return state, tsteps.make_train_step(CLASSES, seed=seed)


def test_train_step_draws_stochastic_depth_from_seed_and_step():
    """At rate 0.2 the step's masks come from (seed, step): two runs from
    the same weights agree step for step; a run resumed at step 1 (its
    weights, momentum and step count restored) draws what the run it
    continues drew; another seed draws other masks; rate 0 draws nothing
    that changes the loss."""
    _, _, batches = _setup()
    batch = [(torch.from_numpy(x), torch.from_numpy(y).long()) for x, y in batches]
    runs = {}
    for tag, sd, seed in (("a", 0.2, 0), ("b", 0.2, 0), ("other", 0.2, 1), ("zero", 0.0, 0)):
        state, step = _state(sd, seed)
        losses = []
        for i, b in enumerate(batch):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if i == 0 and tag == "a":
                resume = ({k: v.detach().clone() for k, v in state.params.items()},
                          copy.deepcopy(state.opt.state_dict()))
        runs[tag] = (losses, {k: v.detach().clone() for k, v in state.params.items()})
    assert runs["a"][0] == runs["b"][0]
    assert runs["a"][0] != runs["other"][0] and runs["a"][0] != runs["zero"][0]
    state, step = _state(0.2, 0)
    with torch.no_grad():
        for k, v in resume[0].items():
            state.params[k].copy_(v)
    state.opt.load_state_dict(resume[1])
    state.step = 1
    losses = [float(step(state, b)[1]["loss"]) for b in batch[1:]]
    assert losses == runs["a"][0][1:]
    for k, v in runs["a"][1].items():
        assert torch.equal(state.params[k].detach(), v), k


def test_snip_loss_draws_stochastic_depth_from_the_seed():
    """SNIP on a Swin runs in train mode: at rate 0.2 its saliencies depend
    on the seed's draw (the same seed twice gives the same saliencies,
    another seed others) and at rate 0 they do not."""
    params, _, batches = _setup()
    x, y = batches[0]
    tparams = jax.tree.map(torch.from_numpy, params)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())

    def sal(sd_prob, seed):
        spec = _spec(sd_prob)
        return tsnip.snip_saliency(tsnip.snip_loss(spec, CLASSES, seed=seed), tparams, batch,
                                   masks=tprune.init_masks(tparams, exclude=spec.prune_exclude))

    a, b, c = sal(0.2, 0), sal(0.2, 0), sal(0.2, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    z0, z1 = sal(0.0, 0), sal(0.0, 1)
    assert all(torch.equal(z0[k], z1[k]) for k in z0)


@pytest.mark.parametrize("ocfg", [dict(norm_weight_decay=0.0), dict(bias_weight_decay=0.0),
                                  dict(norm_weight_decay=0.0, transformer_embedding_decay=0.5)])
def test_optimizer_decay_groups_match_jax(ocfg):
    """The decay rate of every Swin parameter (norms, biases, the logit
    scale and the CPB MLP) is the JAX package's, on the flax paths."""
    spec = _spec()
    params = spec.init(torch.Generator().manual_seed(0))
    state = tsteps.create_train_state(spec, params, {}, toptim.OptimConfig(**ocfg), 1,
                                      device="cpu")
    rates = {id(p): g["weight_decay"] for g in state.opt.opt.param_groups for p in g["params"]}
    jr = joptim.weight_decay_rates(jax.tree.map(np.asarray, params), joptim.OptimConfig(**ocfg))
    fam = tck.family(spec)
    assert {fam.state_key(p): r for p, r in flatten_dict(jr).items()} == {
        k: rates[id(p)] for k, p in state.params.items()}


def test_eval_step_matches_jax():
    """The f32 eval step (masks applied, no stochastic depth) against
    ``vipers.train.steps.make_eval_step`` at rate 0.2: eval draws nothing."""
    params, masks, batches = _setup()
    x, y = batches[0]
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                               masks=masks, opt_state=None)
    jout = jsteps.make_eval_step(_jax_module(0.2).apply, CLASSES)(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    state, _ = _state(0.2)
    tout = tsteps.make_eval_step(CLASSES)(state, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert abs(float(tout["loss_sum"]) - float(jout["loss_sum"])) <= 1e-5 * abs(
        float(jout["loss_sum"]))
    assert int(tout["top1"]) == int(jout["top1"]) and int(tout["top5"]) == int(jout["top5"])
