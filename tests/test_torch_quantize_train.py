"""vipers_torch's quantization drivers' steps against the JAX package's on
the CPU: PTQ calibration and the int8 eval (real int8 Dense and Conv from
the calibrated observers) here; two QAT steps of each observer /
BatchNorm freeze variant (``check_two_qat_steps``) in
``tests/test_torch_quantize_qat*.py``.

``mobilenet_v2`` at ``width_mult`` 0.25, 10 classes, 64x64 images, B=4,
the port's initial weights (seed 0) perturbed by N(0, 0.02), BatchNorm
biases at +3 (the ResNet tests' remedy: train-mode BatchNorm couples every
cell of a channel, and relu6 inputs near a kink flip between packages), the
classifier scaled by 0.1, running statistics away from mean 0 / var 1, 50%
magnitude masks; SGD lr 0.01, momentum 0.9, wd 1e-4.

Tolerances: calibrated observers 1e-6 of their scale; after two QAT steps
(in f64, see the test) parameters 1e-4 and observers 1e-5 (of max(1,
|value|)), running statistics 1e-4 of their scale; int8 logits: see the
test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_explain_fixtures as fx
import vipers.train.optim as joptim
import vipers.train.quantize as jq
import vipers.train.steps as jsteps
from vipers.core.registry import build_model as jbuild
import vipers_torch.pruning as tprune
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.train import optim as toptim
from vipers_torch.train import quantize as tq
from vipers_torch.train import steps as tsteps

CLASSES = 10
KW = {"num_classes": CLASSES, "width_mult": 0.25}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@functools.lru_cache(maxsize=None)
def _setup():
    spec = tbuild("mobilenet_v2", **KW)
    rng = np.random.default_rng(3)
    flat = {}
    for p, a in flatten_dict(spec.init(torch.Generator().manual_seed(0))).items():
        a = (a.numpy() + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        if p[-2:] == ("bn", "bias"):
            a = a + np.float32(3.0)
        elif p[0] == "classifier":
            a = a * np.float32(0.1)
        flat[p] = a
    params = unflatten_dict(flat)
    stats = {}
    for path, w in flat.items():
        if path[-1] == "scale":
            stats[path[:-1] + ("mean",)] = rng.normal(0, 0.2, w.shape).astype(np.float32)
            stats[path[:-1] + ("var",)] = rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
    stats = unflatten_dict(stats)
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params), amount=0.5).items()}
    batches = [(rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
                rng.integers(0, CLASSES, size=(4,)).astype(np.int32)) for _ in range(3)]
    jspec = jbuild("mobilenet_v2", **KW)
    variables = {"params": jax.tree.map(jnp.asarray, params), "batch_stats": stats}
    sites = jq.observer_sites(jspec.module, variables, jnp.zeros((1, 64, 64, 3)),
                              train=False, need_attn=False)
    return spec, jspec, params, stats, masks, batches, sites


def _port_state(spec, params, stats, masks):
    return tsteps.create_train_state(spec, params, {p: np.array(m) for p, m in masks.items()},
                                     toptim.OptimConfig(opt="sgd", lr=0.01), 1, device="cpu",
                                     batch_stats=stats)


def _close_observers(got, want, rel):
    assert set(got) == set(want)
    for k, o in want.items():
        for a, b in ((got[k].min_val, o.min_val), (got[k].max_val, o.max_val)):
            b = float(np.asarray(b))
            assert abs(float(a) - b) <= rel * max(1.0, abs(b)), (k, float(a), b)


def _masked_params(params, masks):
    from vipers.pruning.masks import apply_masks

    return jax.jit(apply_masks)(params, masks)


def test_ptq_calibration_matches_jax():
    spec, jspec, params, stats, masks, batches, sites = _setup()
    mp = _masked_params(params, masks)
    jobs = jq.ptq_calibrate(jspec.module, {"params": mp, "batch_stats": stats},
                            jq.init_observers(sites), [(jnp.asarray(x), y) for x, y in batches],
                            num_batches=2)
    state = _port_state(spec, params, stats, masks)
    tensors = tsteps.forward_params(state.params, state.masks)
    model, fam = state.model, state.family
    assert tq.observer_sites(model, fam, torch.zeros((1, 64, 64, 3)), tensors=tensors,
                             need_attn=False) == sites
    tobs = tq.ptq_calibrate(model, fam, tq.init_observers(sites),
                            [(torch.from_numpy(x), y) for x, y in batches], num_batches=2,
                            tensors=tensors)
    _close_observers(tobs, jobs, 1e-6)
    assert model.training  # calibration leaves the model's mode as it was


def check_two_qat_steps(variant):
    """Two steps of the variant under test (``observer_update``,
    ``bn_frozen``) from observers that both packages take from one
    calibration pass (the port's ``ptq_calibrate`` on a third batch), so
    that frozen observers hold real ranges. Both packages run the steps in
    f64 (JAX under ``jax.enable_x64``, where its observers are f64 and
    each batch's min and max come in as f32): in f32 two activations an ulp
    apart straddle a uint8 bin somewhere in ~10^5 of them, the one quantum
    that flips moves the next layer's values by more than their own
    rounding and the flips cascade (with these weights the deepest
    observers end up 20-40% apart after one f32 step while the losses
    agree to every printed digit). f64 leaves the logic under test, the
    fake-quant, observers, freeze variants, masked gradients and updates,
    and nothing for a flip to start from."""
    spec, jspec, params, stats, masks, batches, sites = _setup()
    obs_up, bn_fr = variant
    f64 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
    tstate = _port_state(spec, params, stats, masks)
    tstate.model.double()
    before = {k: p.detach().clone() for k, p in tstate.params.items()}
    stats0 = {k: v.clone() for k, v in tstate.batch_stats.items()}
    zero = torch.zeros((), dtype=torch.float64)
    tobs = tq.ptq_calibrate(
        tstate.model, tstate.family,
        {k: tq.ObserverState(zero, zero, o.initialized) for k, o in tq.init_observers(sites).items()},
        [(torch.from_numpy(batches[2][0].astype(np.float64)), None)],
        tensors=tsteps.forward_params(tstate.params, tstate.masks))
    with jax.enable_x64(True):
        params64, stats64 = f64(params), f64(stats)
        jocfg = joptim.OptimConfig(opt="sgd", lr=0.01)
        tx = joptim.make_optimizer(jocfg, params64, joptim.make_lr_schedule(jocfg, 1))
        jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params64,
                                   batch_stats=stats64, masks=masks,
                                   opt_state=tx.init(params64))
        jobs = {k: jq.ObserverState(jnp.asarray(o.min_val.numpy()), jnp.asarray(o.max_val.numpy()),
                                    jnp.ones((), bool)) for k, o in tobs.items()}
        jstep = jq.make_qat_train_step(jspec.module, tx, CLASSES, observer_update=obs_up,
                                       bn_frozen=bn_fr)
        tstep = tq.make_qat_train_step(CLASSES, observer_update=obs_up, bn_frozen=bn_fr)
        for x, y in batches[:2]:
            x = x.astype(np.float64)
            jstate, jobs, jm = jstep(jstate, jobs, (jnp.asarray(x), jnp.asarray(y)),
                                     jax.random.PRNGKey(1))
            tstate, tobs, tm = tstep(tstate, tobs, (torch.from_numpy(x),
                                                    torch.from_numpy(y).long()))
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        jparams, jstats = jax.tree.map(np.asarray, (jstate.params, jstate.batch_stats))
    _close_observers(tobs, jobs, 1e-5)
    fam = tstate.family
    want = fam.state_dict(jparams, jstats)
    for k, v in {**tstate.params, **tstate.batch_stats}.items():
        w = want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.detach().numpy(), w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0, err_msg=k)
            # frozen BatchNorm: neither step moved the running statistics
            assert torch.equal(v, stats0[k].double()) == bn_fr, k
        else:
            np.testing.assert_allclose(v.detach().numpy(), w, atol=1e-4, rtol=0, err_msg=k)
    for k, m in tstate.masks.items():
        assert torch.equal(tstate.params[k].detach()[~m], before[k][~m]), k


def test_int8_eval_matches_jax():
    """Calibrated observers (the JAX package's, carried across) drive real
    int8 Dense and Conv in both packages on the masked weights. The int32
    accumulators are exact, but an activation that the packages compute an
    ulp apart can round into the neighbouring uint8 bin, one quantum of its
    site's scale, and later layers carry that on: the logits are held at
    2e-3 of their scale, and the eval step's metrics equal."""
    spec, jspec, params, stats, masks, batches, sites = _setup()
    mp = _masked_params(params, masks)
    variables = {"params": mp, "batch_stats": stats}
    jobs = jq.ptq_calibrate(jspec.module, variables, jq.init_observers(sites),
                            [(jnp.asarray(x), y) for x, y in batches], num_batches=3)
    qk, sc = jax.jit(jq.quantize_params_int8)(mp)
    x, y = batches[0]
    want, _ = jax.jit(lambda v, xx, o: jq.int8_apply(jspec.module, v, xx, qk, sc, o, train=False,
                                                     need_attn=False))(variables, x, jobs)
    state = _port_state(spec, params, stats, masks)
    fam = state.family
    tobs = {k: tq.ObserverState(torch.tensor(np.asarray(o.min_val)),
                                torch.tensor(np.asarray(o.max_val)),
                                torch.tensor(bool(o.initialized))) for k, o in jobs.items()}
    tensors = {k: v.detach() for k, v in tsteps.forward_params(state.params, state.masks).items()}
    q, scales = tq.quantize_params_int8(tensors, fam)
    state.model.eval()
    with torch.no_grad():
        got, _ = tq.int8_apply(state.model, fam, torch.from_numpy(x), q, scales, tobs,
                               tensors=tensors, need_attn=False)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * np.abs(want).max(), rtol=0)
    # the eval step: the same metrics as the JAX step on every batch
    jeval = jq.make_int8_eval_step(jspec.module, qk, sc, jobs, CLASSES)
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               masks=masks, opt_state=None)
    teval = tq.make_int8_eval_step(q, scales, tobs, CLASSES)
    for x, y in batches:
        jm = jeval(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tm = teval(state, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert int(tm["top1"]) == int(jm["top1"]) and int(tm["top5"]) == int(jm["top5"])
        assert int(tm["n"]) == int(jm["n"]) == 4
        assert abs(float(tm["loss_sum"]) - float(jm["loss_sum"])) <= 1e-3 * float(jm["loss_sum"])
