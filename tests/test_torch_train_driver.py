"""vipers_torch's pruning drivers (``train.driver``: SNIP, LRR, checkpoints,
resume, the metrics stream) against the JAX package's on the CPU.

A tiny ViT (patch 8, 2 blocks, D 64, 2 heads of 32, mlp 128, 2 classes) is
registered in both registries under one name for this module's lifetime;
the data is the 2-class 40x40 ImageFolder of ``tests/test_train_e2e.py``
(8 train and 4 val images a class, crops of 32: T = 17); both sessions
start from the JAX session's initial parameters (carried into the port);
f32, no dropout, no mixup, B = 4, SGD lr 0.01, one epoch of 4 steps.
Tolerances: parameters within 1e-5 of each leaf's largest magnitude (f32
sums in another order through 4-8 steps); masks, sparsities, accuracies
and the file stems exact; losses 1e-5 relative. Resume is the port against
itself, bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.core.registry as jreg
import vipers.models.vit as jvit
import vipers.train.driver as jdrv
from vipers.core.checkpoint import restore_checkpoint
from vipers.core.config import TrainConfig as JConfig
from vipers.pruning import apply_masks as japply
from vipers.train.optim import OptimConfig as JOptim
import vipers_torch.core.registry as treg
import vipers_torch.models.vit as tvit
import vipers_torch.train.driver as tdrv
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.config import TrainConfig as TConfig
from vipers_torch.core.metrics import MetricsWriter
from vipers_torch.core.tree import flatten_dict
from vipers_torch.discovery.driver import load_lost_checkpoint
from vipers_torch.train.optim import OptimConfig as TOptim

NAME = "vit_tiny_driver_test"


@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    jreg.list_models()
    treg._ensure_builtins_imported()

    def jbuild(num_classes=1000, image_size=(224, 224)):
        return jvit._build(NAME, jvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)

    def tbuild(num_classes=1000, image_size=(224, 224)):
        return tvit._build(NAME, tvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)

    jreg._BUILTIN_MODELS[NAME] = jbuild
    treg._BUILTIN_MODELS[NAME] = tbuild
    yield
    del jreg._BUILTIN_MODELS[NAME], treg._BUILTIN_MODELS[NAME]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """2 classes x 8 train + 4 val images, 40x40 RGB, class b's red lifted."""
    root = tmp_path_factory.mktemp("tinyds")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("val", 4)):
        for cls in ("class_a", "class_b"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
                if cls == "class_b":
                    arr[..., 0] = np.minimum(arr[..., 0].astype(np.int16) + 80,
                                             255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.jpg")
    return str(root)


def _cfgs(data, out, **kw):
    optim = dict(opt="sgd", lr=0.01, weight_decay=1e-4, epochs=kw.pop("epochs", 1),
                 lr_scheduler="cosineannealinglr")
    base = dict(model=NAME, data_path=data, num_classes=2, train_crop_size=32,
                val_resize_size=40, val_crop_size=32, batch_size=4, workers=2,
                pruning_method="snip", target_sparsity=0.5, seed=0, print_freq=0)
    base.update(kw)
    return (JConfig(optim=JOptim(**optim), output_dir=str(out / "jax"), **base),
            TConfig(optim=TOptim(**optim), output_dir=str(out / "torch"), device="cpu", **base))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _sessions(jcfg, tcfg):
    os.makedirs(jcfg.output_dir, exist_ok=True)
    os.makedirs(tcfg.output_dir, exist_ok=True)
    js = jdrv.build_session(jcfg)
    ts = tdrv.build_session(tcfg, params=_np_tree(js.state.params))
    return js, ts


def _port_flat(named):
    return {p: w.numpy() for p, w in flatten_dict(tck.flax_tree_from_vit_state_dict(named)).items()}


def _assert_params_close(ts, jparams, tol=1e-5):
    got = _port_flat(ts.state.params)
    want = {p: np.asarray(w) for p, w in flatten_dict(_np_tree(jparams)).items()}
    assert got.keys() == want.keys()
    for p, w in want.items():
        err = np.abs(got[p] - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-12), (p, err)


def _assert_masks_equal(ts, jmasks):
    got = {p: m.numpy() for p, m in tck.vit_masks_from_state_dict(ts.state.masks).items()}
    assert got.keys() == set(jmasks)
    for p, m in jmasks.items():
        assert np.array_equal(got[p], np.asarray(m)), p


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_records_match(got_path, want_path):
    got, want = _records(got_path), _records(want_path)
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k == "ts":
                continue
            if k == "loss":
                assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (g, w)
            else:
                assert g[k] == w[k], (k, g, w)


def _stems(d):
    return sorted(n[:-len(".pth")] if n.endswith(".pth") else n for n in os.listdir(d))


@pytest.fixture(scope="module")
def snip_runs(data, tmp_path_factory):
    jcfg, tcfg = _cfgs(data, tmp_path_factory.mktemp("snip"))
    js, ts = _sessions(jcfg, tcfg)
    return js, ts, jdrv.run_snip(js), tdrv.run_snip(ts)


def test_run_snip_matches_jax(snip_runs):
    js, ts, (jsp, jacc), (tsp, tacc) = snip_runs
    _assert_masks_equal(ts, js.state.masks)
    assert tsp == pytest.approx(float(jsp), abs=0) and 50.0 <= tsp < 51.0
    assert tacc == jacc
    _assert_params_close(ts, js.state.params)
    # pruned slots keep their unbaked values (updates are masked)
    assert _stems(ts.cfg.output_dir) == _stems(js.cfg.output_dir) == sorted(
        ["metrics.jsonl", f"{NAME}_epoch_0_snip_0.5", f"{NAME}_checkpoint_snip_0.5"])


def test_snip_metrics_stream_matches_jax(snip_runs):
    js, ts, _, _ = snip_runs
    _assert_records_match(os.path.join(ts.cfg.output_dir, "metrics.jsonl"),
                          os.path.join(js.cfg.output_dir, "metrics.jsonl"))
    assert [r["tag"] for r in _records(os.path.join(ts.cfg.output_dir, "metrics.jsonl"))] == \
        ["prune", "train", "test"]


def test_pth_loads_through_lost_loader(snip_runs):
    """The port's .pth through ``load_lost_checkpoint``: the port's own
    baked weights exactly, its masks; the JAX package's orbax checkpoint of
    the same run within the parameter tolerance."""
    js, ts, _, _ = snip_runs
    path = os.path.join(ts.cfg.output_dir, f"{NAME}_epoch_0_snip_0.5.pth")
    params, stats, masks, _ = load_lost_checkpoint(path, ts.spec)
    assert stats is None
    own = _port_flat(ts.state.params)
    tmasks = {p: m.numpy() for p, m in tck.vit_masks_from_state_dict(ts.state.masks).items()}
    assert masks.keys() == tmasks.keys()
    flat = flatten_dict(params)
    for p, w in own.items():
        want = np.where(tmasks[p], w, 0) if p in tmasks else w
        assert np.array_equal(np.asarray(flat[p]), want), p
    for p, m in tmasks.items():
        assert np.array_equal(np.asarray(masks[p]), m), p
    tree = restore_checkpoint(os.path.join(js.cfg.output_dir, f"{NAME}_epoch_0_snip_0.5"))
    jmasks = {tuple(k.split("/")): np.asarray(v, bool) for k, v in tree["masks"].items()}
    jflat = flatten_dict(_np_tree(japply(tree["params"], jmasks)))
    for p, w in jflat.items():
        assert np.abs(np.asarray(flat[p]) - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-12), p
    # the raw .pth: the reference's pruned form, unbaked
    raw = torch.load(path, map_location="cpu", weights_only=False)
    assert {"model", "optimizer", "epoch", "step", "sparsity"} <= raw.keys()
    assert raw["epoch"] == 0 and raw["step"] == 4 == int(tree["step"])
    assert "conv_proj.weight_orig" in raw["model"] and "conv_proj.weight_mask" in raw["model"]


@pytest.fixture(scope="module")
def magnitude_runs(data, tmp_path_factory):
    jcfg, tcfg = _cfgs(data, tmp_path_factory.mktemp("lrr"), pruning_method="magnitude",
                       pruning_rate=0.5, pruning_threshold=70.0)
    js, ts = _sessions(jcfg, tcfg)
    return js, ts, jdrv.run_magnitude(js), tdrv.run_magnitude(ts)


def test_run_magnitude_matches_jax(magnitude_runs):
    """Two LRR iterations (0% -> 50% -> 75%): performance.txt rows (acc1
    equal, sparsity exact), the final masks and parameters, the metrics
    stream, the file stems."""
    js, ts, (jsp, jrows), (tsp, trows) = magnitude_runs
    assert tsp == float(jsp) == 75.0
    assert trows == [(float(a), float(s)) for a, s in jrows] and len(trows) == 2
    perf = [MetricsWriter.read_performance_txt(os.path.join(s.cfg.output_dir, "performance.txt"))
            for s in (ts, js)]
    assert perf[0] == perf[1] == [(trows[0][0], 0.0), (trows[1][0], 50.0)]
    _assert_masks_equal(ts, js.state.masks)
    _assert_params_close(ts, js.state.params)
    _assert_records_match(os.path.join(ts.cfg.output_dir, "metrics.jsonl"),
                          os.path.join(js.cfg.output_dir, "metrics.jsonl"))
    assert _stems(ts.cfg.output_dir) == _stems(js.cfg.output_dir)
    assert f"{NAME}_epoch_0_pruning_iteration_01" in _stems(ts.cfg.output_dir)
    # the baked weights: pruned slots are exact zeros in the last checkpoint
    sd = tck.load_torch_state_dict(os.path.join(
        ts.cfg.output_dir, f"{NAME}_epoch_0_pruning_iteration_01.pth"))
    raw = torch.load(os.path.join(ts.cfg.output_dir,
                                  f"{NAME}_epoch_0_pruning_iteration_01.pth"),
                     map_location="cpu", weights_only=False)["model"]
    pruned = total = 0
    for k in sd:
        if k.endswith(".__mask__"):
            base = k[:-len(".__mask__")]
            assert (raw[base + "_orig"].numpy()[~sd[k]] == 0).all(), base
            pruned, total = pruned + int((~sd[k]).sum()), total + sd[k].size
    assert pruned / total == 0.5  # the checkpoint holds the masks iteration 01 trained under


@pytest.mark.parametrize("extras", [dict(), dict(random_erase=0.5, mixup_alpha=0.2,
                                                 cutmix_alpha=1.0, model_ema=True,
                                                 model_ema_steps=1, auto_augment="ra")],
                         ids=["plain", "erase-mixup-ema-ra"])
def test_resume_is_bit_equal(data, tmp_path, extras):
    """Two epochs straight against one epoch resumed from the first run's
    epoch-0 checkpoint: weights, masks, optimizer state, step count and
    EMA bit for bit."""
    _, cfg_a = _cfgs(data, tmp_path / "a", epochs=2, **extras)
    _, cfg_b = _cfgs(data, tmp_path / "b", epochs=2, **extras)
    params = tvit._build(NAME, tvit.ViTConfig(8, 2, 2, 64, 128, 2), (32, 32)).init(
        torch.Generator().manual_seed(3))
    sa = tdrv.build_session(cfg_a, params=params)
    tdrv.run_snip(sa)
    sb = tdrv.build_session(cfg_b, params=params)
    start = tdrv.resume_session(
        sb, os.path.join(cfg_a.output_dir, f"{NAME}_epoch_0_snip_0.5.pth"))
    assert start == 1
    tdrv.run_snip(sb, initial_epoch=start)
    for k, p in sa.state.params.items():
        assert torch.equal(p, sb.state.params[k]), k
    assert sa.state.masks.keys() == sb.state.masks.keys()
    assert all(torch.equal(m, sb.state.masks[k]) for k, m in sa.state.masks.items())
    assert sa.state.step == sb.state.step == 8 and sa.state.opt.count == sb.state.opt.count
    oa, ob = sa.state.opt.state_dict()["opt"], sb.state.opt.state_dict()["opt"]
    for i, st in oa["state"].items():
        assert torch.equal(st["momentum_buffer"], ob["state"][i]["momentum_buffer"]), i
    if extras:
        for k, e in sa.state.ema_params.items():
            assert torch.equal(e, sb.state.ema_params[k]), k
    # the last epoch's records are the same apart from ts
    ra = _records(os.path.join(cfg_a.output_dir, "metrics.jsonl"))
    rb = _records(os.path.join(cfg_b.output_dir, "metrics.jsonl"))
    assert [{k: v for k, v in r.items() if k != "ts"} for r in ra[-2 - bool(extras):]] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in rb[-2 - bool(extras):]]


def test_amp_step_takes_the_training_kernel_like_jax(data, tmp_path, monkeypatch):
    """``--amp``: the port's bf16 train step sends every block's attention
    through the training kernel (its plain version here), as the JAX step
    does under VIPERS_FUSED_ATTN_INTERPRET=1 (its kernel in interpret
    mode); the f32 step keeps the einsum in the port, and SNIP's f32
    saliency pass does too."""
    import vipers.ops.attention_train as jat

    monkeypatch.setenv("VIPERS_FUSED_ATTN_INTERPRET", "1")
    jcfg, tcfg = _cfgs(data, tmp_path, amp=True)
    js, ts = _sessions(jcfg, tcfg)
    calls = {"jax": 0, "torch": []}
    jorig, torig = jat.attention_train_packed, tvit.attention_train_packed

    def jspy(*a, **k):
        calls["jax"] += 1
        return jorig(*a, **k)

    def tspy(qkv, **k):
        calls["torch"].append(tuple(qkv.shape))
        return torig(qkv, **k)

    monkeypatch.setattr(jat, "attention_train_packed", jspy)
    monkeypatch.setattr(tvit, "attention_train_packed", tspy)
    images, labels = next(iter(tdrv._train_loader(ts, 0)))
    x = ts.normalize(images)
    ts.train_step(ts.state, (x, labels))
    assert calls["torch"] == [(3, 4, 2, 128, 32)] * 2  # T = 17 seq-padded to 128
    f32 = tdrv.build_session(_cfgs(data, tmp_path / "f32")[1],
                             params=_np_tree(js.state.params))
    jx = jax.numpy.asarray(x.numpy())
    js.train_step(js.state, (jx, jax.numpy.asarray(labels.numpy().astype(np.int32))),
                  jax.random.PRNGKey(0))  # donates the state
    assert calls["jax"] == 2
    f32.train_step(f32.state, (x, labels))
    tdrv.snip_saliencies(f32)
    assert len(calls["torch"]) == 2


def test_resume_from_a_reference_pth_restores_weights_and_masks(snip_runs, tmp_path):
    """A reference-style ``.pth`` (a bare state dict, DDP's ``module.``
    prefix, pruned layers as weight_orig / weight_mask, no optimizer of the
    port's): ``resume_session`` takes its weights unbaked and its masks,
    keeps the fresh optimizer, and continues at epoch 0."""
    _, ts, _, _ = snip_runs
    raw = torch.load(os.path.join(ts.cfg.output_dir, f"{NAME}_epoch_0_snip_0.5.pth"),
                     map_location="cpu", weights_only=False)["model"]
    path = tmp_path / "reference.pth"
    torch.save({f"module.{k}": v for k, v in raw.items()}, path)
    fresh = tdrv.build_session(ts.cfg, params=tck.flax_tree_from_vit_state_dict(
        {k: torch.zeros_like(p) for k, p in ts.state.params.items()}))
    assert tdrv.resume_session(fresh, str(path)) == 0
    for k, p in ts.state.params.items():
        assert torch.equal(fresh.state.params[k], p), k
    assert all(torch.equal(m, ts.state.masks[k]) for k, m in fresh.state.masks.items())
    assert fresh.state.opt.count == 0 and fresh.state.step == 0
