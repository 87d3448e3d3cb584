"""vipers_torch's masked train step, eval step, optimizer chain, LR
schedule, decay grouping, EMA, LRR round and reverse weight carry-over
against the JAX package on the CPU.

Small config: 2 layers, D=128, 2 heads of 64, mlp 256, 10 classes, 64x64
images (T=17), B=4, 50% global magnitude masks on unbaked params, f32; the
kernel and flash cases also at D=160 with 2 heads of 80 (vit_h_14's head
dim), mlp 320.
Both packages start from the same flax parameters (numpy) and masks and
take 3 steps on the same numpy batches. Tolerances: loss per step 1e-5
relative; params after 3 steps atol 2e-5 (f32 sums in another order
through 3 SGD steps at lr 0.1); accuracies exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.models.vit as jvit
import vipers.ops.attention_train as jat
import vipers.pruning as jprune
import vipers.train.optim as joptim
import vipers.train.steps as jsteps
from vipers.data.preprocess import make_device_normalize as j_normalize
import vipers_torch.models.vit as tvit
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.tree import flatten_dict
from vipers_torch.data.preprocess import make_device_normalize as t_normalize
from vipers_torch.ops import attention_train as tat
from vipers_torch.train import loop as tloop
from vipers_torch.train import optim as toptim
from vipers_torch.train import steps as tsteps
from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128,
           mlp_dim=256, num_classes=10)
CFG80 = dict(CFG, hidden_dim=160, mlp_dim=320)  # 2 heads of 80
IMAGE = (64, 64)
B, STEPS = 4, 3


@functools.lru_cache(maxsize=None)
def _setup(hd=64):
    """Both packages' specs of the small config at head dim ``hd`` (64 or
    80), its flax params, 50% masks and the numpy batches."""
    cfg = CFG if hd == 64 else CFG80
    jspec = jvit._build("tiny", jvit.ViTConfig(**cfg), IMAGE)
    variables = jspec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, *IMAGE, 3)),
                                  train=False)
    params = variables["params"]
    masks = jprune.magnitude_prune(
        params, jprune.init_masks(params, exclude=jspec.prune_exclude), amount=0.5)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, *IMAGE, 3)).astype(np.float32),
                rng.integers(0, 10, size=(B,)).astype(np.int32)) for _ in range(STEPS)]
    tspec = tvit._build("tiny", tvit.ViTConfig(**cfg), IMAGE)
    return jspec, tspec, params, masks, batches


@pytest.fixture(scope="module")
def setup():
    return _setup(64)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _np_masks(masks):
    return {p: np.array(m) for p, m in masks.items()}


_JAX_RUNS: dict = {}


def _run_jax(jspec, params, masks, batches, ocfg, ema_decay=None, ema_warmup=0):
    """The JAX steps' (state, metrics), each configuration compiled and run
    once a module: the routing switches the steps read are in the key."""
    key = (id(jspec), repr(ocfg), ema_decay, ema_warmup,
           os.environ.get("VIPERS_FUSED_ATTN_INTERPRET"), os.environ.get("VIPERS_FLASH_MIN_T"))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _run_jax_steps(jspec, params, masks, batches, ocfg, ema_decay,
                                        ema_warmup)
    return _JAX_RUNS[key]


def _run_jax_steps(jspec, params, masks, batches, ocfg, ema_decay, ema_warmup):
    tx = joptim.make_optimizer(ocfg, params, joptim.make_lr_schedule(ocfg, 1))
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=None, masks=masks, opt_state=tx.init(params),
                              ema_params=params if ema_decay is not None else None)
    step = jsteps.make_train_step(jspec.module.apply, tx, num_classes=10,
                                  ema_decay=ema_decay, ema_warmup_steps=ema_warmup,
                                  donate=False)
    metrics = []
    for x, y in batches:
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _run_torch(tspec, params, masks, batches, ocfg, ema_decay=None, ema_warmup=0):
    state = tsteps.create_train_state(tspec, _np_tree(params), _np_masks(masks), ocfg,
                                      steps_per_epoch=1, device="cpu",
                                      ema=ema_decay is not None)
    step = tsteps.make_train_step(10, ema_decay=ema_decay, ema_warmup_steps=ema_warmup)
    metrics = []
    for x, y in batches:
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y).long()))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _flax_np(named):
    return {p: w.numpy() for p, w in flatten_dict(tck.flax_tree_from_vit_state_dict(named)).items()}


CASES = {
    "einsum": dict(ocfg=dict(opt="sgd")),
    "kernel": dict(ocfg=dict(opt="sgd"), kernel=True),
    "flash": dict(ocfg=dict(opt="sgd"), flash=True),
    "kernel-hd80": dict(ocfg=dict(opt="sgd"), kernel=True, hd=80),
    "flash-hd80": dict(ocfg=dict(opt="sgd"), flash=True, hd=80),
    "sgd_nesterov-clip": dict(ocfg=dict(opt="sgd_nesterov", clip_grad_norm=0.5)),
    "rmsprop-clip": dict(ocfg=dict(opt="rmsprop", lr=0.01, clip_grad_norm=0.5)),
    "adamw-clip": dict(ocfg=dict(opt="adamw", lr=1e-3, weight_decay=0.05,
                                 clip_grad_norm=0.5)),
    "ema-warmup": dict(ocfg=dict(opt="sgd"), ema=(0.9, 1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_masked_train_step_matches_jax(monkeypatch, case):
    """3 f32 steps: loss, acc1, acc5 per step, params (and the EMA) after.
    "kernel": the JAX packed kernel in interpret mode and the port's gate on
    for f32, so T=17 is seq-padded to 128 and every block's attention goes
    through attention_train_packed on both sides. "flash": VIPERS_FLASH_MIN_T=16
    for both packages, so T=17 is seq-padded to 128 and every block's
    attention goes through flash_attention on the port side (forward and
    backward: the kernels' plain versions here). "-hd80": the same at head
    dim 80."""
    spec = CASES[case]
    hd = spec.get("hd", 64)
    jspec, tspec, params, masks, batches = _setup(hd)
    kw = dict(lr=0.1, weight_decay=1e-4, epochs=10, lr_scheduler="cosineannealinglr")
    kw.update(spec["ocfg"])
    ema_decay, ema_warmup = spec.get("ema", (None, 0))
    calls = []
    if spec.get("kernel"):
        monkeypatch.setenv("VIPERS_FUSED_ATTN_INTERPRET", "1")
        monkeypatch.setattr(tvit, "attention_train_enabled", lambda dtype: True)
        orig = tvit.attention_train_packed

        def spy(qkv, **k):
            calls.append(tuple(qkv.shape))
            return orig(qkv, **k)

        monkeypatch.setattr(tvit, "attention_train_packed", spy)
    else:
        monkeypatch.delenv("VIPERS_FUSED_ATTN_INTERPRET", raising=False)
    if spec.get("flash"):
        monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
        orig_flash = tvit.flash_attention

        def flash_spy(q, k, v, **kw):
            calls.append(tuple(q.shape))
            return orig_flash(q, k, v, **kw)

        monkeypatch.setattr(tvit, "flash_attention", flash_spy)
    jstate, jm = _run_jax(jspec, params, masks, batches, joptim.OptimConfig(**kw),
                          ema_decay, ema_warmup)
    tstate, tm = _run_torch(tspec, params, masks, batches, toptim.OptimConfig(**kw),
                            ema_decay, ema_warmup)
    if spec.get("kernel"):
        assert calls == [(3, B, 2, 128, hd)] * (2 * STEPS)
    if spec.get("flash"):
        assert calls == [(B, 2, 128, hd)] * (2 * STEPS)
    for a, c in zip(tm, jm):
        assert abs(a["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]), (a, c)
        assert a["acc1"] == c["acc1"] and a["acc5"] == c["acc5"], (a, c)
    got = _flax_np(tstate.params)
    want = {p: np.asarray(w) for p, w in flatten_dict(_np_tree(jstate.params)).items()}
    assert got.keys() == want.keys()
    for p in want:
        g, w = got[p], want[p]
        if kw["opt"] == "adamw" and p[-2:] == ("qkv", "bias"):
            # The key bias shifts every score of a row alike, so its exact
            # gradient is 0 and both packages see rounding noise there;
            # Adam's g / sqrt(v) turns noise into steps of up to lr, in
            # either package's own direction.
            d = tspec.cfg.hidden_dim
            assert np.abs(g[d:2 * d] - w[d:2 * d]).max() <= 2 * STEPS * kw["lr"]
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=str(p))
    # pruned slots keep their (unbaked, non-zero) values bit for bit
    start = flatten_dict(_np_tree(params))
    for p, m in masks.items():
        m = np.asarray(m)
        assert np.array_equal(got[p][~m], start[p][~m]), p
        assert np.any(start[p][~m] != 0)
    if ema_decay is not None:
        got_e = _flax_np(tstate.ema_params)
        for p, w in flatten_dict(_np_tree(jstate.ema_params)).items():
            np.testing.assert_allclose(got_e[p], w, atol=2e-5, rtol=0, err_msg=str(p))


def test_eval_step_sums_skip_sentinel_labels(setup):
    jspec, tspec, params, masks, batches = setup
    x = batches[0][0]
    y = np.array([3, -1, 7, -1], np.int32)
    tx = joptim.make_optimizer(joptim.OptimConfig(), params, lambda s: 0.1)
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=None, masks=masks, opt_state=tx.init(params))
    want = jsteps.make_eval_step(jspec.module.apply, 10, label_smoothing=0.1)(
        jstate, (jnp.asarray(x), jnp.asarray(y)))
    tstate = tsteps.create_train_state(tspec, _np_tree(params), _np_masks(masks),
                                       toptim.OptimConfig(), 1, device="cpu")
    got = tsteps.make_eval_step(10, label_smoothing=0.1)(
        tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert int(got["n"]) == int(want["n"]) == 2
    assert int(got["top1"]) == int(want["top1"]) and int(got["top5"]) == int(want["top5"])
    assert abs(float(got["loss_sum"]) - float(want["loss_sum"])) <= 1e-5 * abs(
        float(want["loss_sum"]))
    assert tstate.model.training  # the eval step restores the mode


@pytest.mark.parametrize("sched", ["steplr", "cosineannealinglr", "exponentiallr"])
@pytest.mark.parametrize("warmup", ["none", "linear", "constant"])
def test_lr_schedule_matches_jax(sched, warmup):
    kw = dict(lr=0.1, lr_scheduler=sched, lr_step_size=3, lr_gamma=0.5, lr_min=1e-3,
              epochs=12, lr_warmup_epochs=0 if warmup == "none" else 2,
              lr_warmup_method="constant" if warmup == "none" else warmup)
    js = joptim.make_lr_schedule(joptim.OptimConfig(**kw), steps_per_epoch=5)
    ts = toptim.make_lr_schedule(toptim.OptimConfig(**kw), steps_per_epoch=5)
    for step in range(0, 70, 3):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_weight_decay_rates_match_jax(setup):
    _, tspec, params, _, _ = setup
    kw = dict(weight_decay=1e-4, norm_weight_decay=0.0, bias_weight_decay=1e-5,
              transformer_embedding_decay=0.0)
    want = dict(flatten_dict(joptim.weight_decay_rates(params, joptim.OptimConfig(**kw))))
    got = toptim.weight_decay_rates(_np_tree(params), toptim.OptimConfig(**kw))
    assert got == want
    assert got[("class_token",)] == 0.0 and got[("ln", "scale")] == 0.0
    assert got[("head", "bias")] == 1e-5 and got[("head", "kernel")] == 1e-4
    # and they reach the module's parameters by name, one group per rate
    state = tsteps.create_train_state(tspec, _np_tree(params), {},
                                      toptim.OptimConfig(**kw), 1, device="cpu")
    by_rate = {g["weight_decay"]: len(g["params"]) for g in state.opt.opt.param_groups}
    assert by_rate == {r: list(want.values()).count(r) for r in set(want.values())}


def test_lrr_round_masks_match_jax(setup):
    """Train 3 steps, prune 20% more by global magnitude, bake: the masks
    equal JAX's except where a weight sits at the cutoff within the
    parameter tolerance (an order flip between equal-looking weights), the
    pruned count is exact, pruned weights are exact zeros, and the next
    round restarts the step count and the optimizer state."""
    jspec, tspec, params, masks, batches = setup
    kw = dict(lr=0.1, weight_decay=1e-4, epochs=10, lr_scheduler="cosineannealinglr")
    jstate, _ = _run_jax(jspec, params, masks, batches, joptim.OptimConfig(**kw))
    jmasks = jprune.magnitude_prune(jstate.params, jstate.masks, 0.2)
    jsparsity = jprune.compute_sparsity_global(
        jprune.apply_masks(jstate.params, jmasks), jmasks)

    tstate = tsteps.create_train_state(tspec, _np_tree(params), _np_masks(masks),
                                       toptim.OptimConfig(**kw), 1, device="cpu")
    step = tsteps.make_train_step(10)
    eval_step = tsteps.make_eval_step(10)
    loader = [(torch.from_numpy(x), torch.from_numpy(y).long()) for x, y in batches]
    tstate, _, sparsity = tloop.magnitude_pruning_round(
        step, eval_step, tstate, lambda e: loader, lambda: loader[:1], epochs=1,
        pruning_rate=0.2, print_freq=0)
    assert tstate.step == STEPS and tstate.opt.count == STEPS
    assert sparsity == pytest.approx(jsparsity, abs=1e-9)
    got_m = {p: m.numpy() for p, m in tck.vit_masks_from_state_dict(tstate.masks).items()}
    jflat = flatten_dict(_np_tree(jstate.params))
    cut = np.sort(np.concatenate([np.abs(jflat[p][np.asarray(masks[p])])
                                  for p in sorted(masks)]))
    k = int(round(0.2 * cut.size))
    kth = cut[k - 1]
    for p in jmasks:
        want = np.asarray(jmasks[p])
        diff = got_m[p] != want
        assert np.all(np.abs(jflat[p][diff] - kth) <= 4e-5), p
        assert diff.sum() <= 4
        w = tstate.params[tck._state_key(p)].detach()
        assert torch.all(w[~tstate.masks[tck._state_key(p)]] == 0)
    tloop.reset_for_round(tstate)
    assert tstate.step == 0 and tstate.opt.count == 0 and not tstate.opt.opt.state


def test_bf16_step_wiring_on_cpu(setup, monkeypatch):
    """bf16: every block's attention runs the training kernel's forward once
    and its backward once per step (the plain versions here), T=17 pads to
    128 (197 -> 256 at 224x224), and the loss lies within bf16 tolerance of
    the f32 loss on the same state."""
    jspec, tspec, params, masks, batches = setup
    state = tsteps.create_train_state(tspec, _np_tree(params), _np_masks(masks),
                                      toptim.OptimConfig(), 1, device="cpu")
    seen = {"fwd": [], "bwd": 0}
    fwd, bwd = tat.attention_train_fwd, tat.attention_train_bwd

    def spy_fwd(q, *a, **k):
        seen["fwd"].append(q.shape[2])
        return fwd(q, *a, **k)

    def spy_bwd(*a, **k):
        seen["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(tat, "attention_train_fwd", spy_fwd)
    monkeypatch.setattr(tat, "attention_train_bwd", spy_bwd)
    x, y = (torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]).long())
    loss16, _, grads = tsteps.loss_and_grads(state.model, state.masks, (x, y), 10,
                                             compute_dtype=torch.bfloat16)
    assert seen == {"fwd": [128, 128], "bwd": 2}
    assert all(g.dtype == torch.float32 for g in grads.values())
    loss32, _, _ = tsteps.loss_and_grads(state.model, state.masks, (x, y), 10)
    assert seen["bwd"] == 2  # f32 keeps the einsum
    assert abs(float(loss16) - float(loss32)) <= 2e-2 * abs(float(loss32))
    vit_s = tvit.ViTConfig(16, 12, 6, 384, 1536, 1000)
    assert tvit._auto_seq_pad(197, torch.bfloat16, True, False, vit_s) == 128
    assert tvit._auto_seq_pad(197, torch.float32, True, False, vit_s) is None
    assert tvit._auto_seq_pad(197, torch.bfloat16, False, False, vit_s) is None
    assert tvit._auto_seq_pad(449, torch.bfloat16, True, False, vit_s) is None  # 512 crosses
    assert tvit._auto_seq_pad(769, torch.float32, True, False, vit_s) == 128  # flash


def test_auto_seq_pad_matches_jax(monkeypatch):
    for interp, dtype in (("1", torch.bfloat16), ("0", torch.float32)):
        monkeypatch.setenv("VIPERS_FUSED_ATTN_INTERPRET", interp)
        monkeypatch.setattr(tvit, "attention_train_enabled",
                            lambda d, on=interp == "1": on)
        jcfg = jvit.ViTConfig(16, 12, 6, 384, 1536, 1000)
        tcfg = tvit.ViTConfig(16, 12, 6, 384, 1536, 1000)
        for t in (17, 197, 256, 449, 511, 769, 1025):
            for train, need_attn in ((True, False), (False, False), (True, True)):
                jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
                assert tvit._auto_seq_pad(t, dtype, train, need_attn, tcfg) == \
                    jvit._auto_seq_pad(t, jd, train, need_attn, jcfg), (t, train, need_attn)
    assert jat.MAX_T == tat.MAX_T


def test_reverse_carry_over_round_trips_bit_for_bit(setup):
    _, tspec, params, masks, _ = setup
    flat = flatten_dict(_np_tree(params))
    sd = tck.vit_state_dict_from_flax(_np_tree(params))
    model = tspec.module()
    model.load_state_dict(sd)
    back = flatten_dict(tck.flax_tree_from_vit_state_dict(model.named_parameters()))
    assert back.keys() == flat.keys()
    for p, w in flat.items():
        assert back[p].dtype == torch.float32 and np.array_equal(back[p].numpy(), w), p
    sd_masks = tck.vit_masks_to_state_dict(_np_masks(masks))
    params_by_name = dict(model.named_parameters())
    for k, m in sd_masks.items():
        assert m.dtype == torch.bool and m.shape == params_by_name[k].shape, k
    again = tck.vit_masks_from_state_dict(sd_masks)
    assert again.keys() == masks.keys()
    for p, m in masks.items():
        assert np.array_equal(again[p].numpy(), np.asarray(m)), p


def test_device_normalize_matches_jax():
    """torch's op order (x/255, then (x - mean)/std in f32); XLA rewrites the
    divisions, so the JAX values differ by up to 2 f32 ulps (atol 1e-6 at
    magnitudes below 2.7), and by a bf16 rounding step after the cast."""
    u8 = np.random.default_rng(5).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(j_normalize()(jnp.asarray(u8)))
    got = t_normalize()(torch.from_numpy(u8)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want16 = np.asarray(j_normalize(dtype=jnp.bfloat16)(jnp.asarray(u8)).astype(jnp.float32))
    got16 = t_normalize(dtype=torch.bfloat16)(torch.from_numpy(u8)).float().numpy()
    np.testing.assert_allclose(got16, want16, atol=0, rtol=2 ** -7)
    # RandomErasing erases only in training, where the loop passes a
    # generator (held against the JAX package in test_torch_train_data.py)
    erase = t_normalize(random_erase_prob=0.25)
    assert torch.equal(erase(torch.from_numpy(u8)), t_normalize()(torch.from_numpy(u8)))


def test_ema_decay_adjustment_matches_jax():
    from vipers.train.ema import ema_decay_for as jdecay
    from vipers_torch.train.ema import ema_decay_for as tdecay

    for args in ((0.99998, 8, 32, 32, 600), (0.9, 1, 128, 1, 10), (0.5, 1, 4, 1, 1)):
        assert tdecay(*args) == jdecay(*args)


def test_accuracy_ties_break_toward_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 3.0]]).bfloat16()
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(logits.float().numpy()), 5)[1])
    assert tsteps._topk_indices(logits, 5).tolist() == want_idx.tolist()
    for target in range(7):
        t = torch.tensor([target])
        got = [float(a) for a in tsteps.accuracy_topk(logits, t)]
        want = [float(a) for a in jsteps.accuracy_topk(
            jnp.asarray(logits.float().numpy()), jnp.asarray([target]))]
        assert got == want, target
