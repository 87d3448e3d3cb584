"""``scripts/jax_checkpoint_to_torch.py``: the JAX package's orbax
checkpoints (``vipers train``'s epoch checkpoints, ``vipers slim``'s
output with its sidecar, ``vipers quantize``'s artifact) into the port's
``.pth``, and the port's ``average_checkpoints`` / ``store_model_weights``.

A tiny ViT (patch 8, 2 blocks, D 64, 2 heads, 2 classes) is registered in
both registries; the JAX train driver writes real SNIP checkpoints of it
on a 2-class 40x40 ImageFolder (B = 4, 4 steps, SGD with momentum or
AdamW). Held: weights, masks and running statistics exactly (the
conversion only moves layouts); logits of the converted model against the
JAX model within 1e-5 of their scale; one resumed train step of the port
(``vipers_torch train --resume`` on the ``.pth``) against the JAX
``resume_session`` and one step, parameters within 1e-5 of each leaf's
scale (as ``tests/test_torch_train_driver.py``); the slim sidecar and the
observers exactly.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.core.registry as jreg
import vipers.models.vit as jvit
import vipers.train.driver as jdrv
from vipers.core.checkpoint import restore_checkpoint, save_checkpoint
from vipers.core.config import TrainConfig as JConfig
from vipers.pruning import apply_masks as japply
from vipers.train.optim import OptimConfig as JOptim
import vipers_torch.core.registry as treg
import vipers_torch.models.vit as tvit
import vipers_torch.train.driver as tdrv
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.config import TrainConfig as TConfig
from vipers_torch.core.tree import flatten_dict
from vipers_torch.discovery.driver import load_lost_checkpoint
from vipers_torch.train.optim import OptimConfig as TOptim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import jax_checkpoint_to_torch as conv  # noqa: E402

NAME = "vit_tiny_convert_test"
CFG = dict(patch_size=8, num_layers=2, num_heads=2, hidden_dim=64, mlp_dim=128)


@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    jreg.list_models()
    treg._ensure_builtins_imported()

    def jbuild(num_classes=1000, image_size=(224, 224)):
        return jvit._build(NAME, jvit.ViTConfig(num_classes=num_classes, **CFG), image_size)

    def tbuild(num_classes=1000, image_size=(224, 224), representation_size=None):
        return tvit._build(NAME, tvit.ViTConfig(num_classes=num_classes, **CFG), image_size)

    jreg._BUILTIN_MODELS[NAME] = jbuild
    treg._BUILTIN_MODELS[NAME] = tbuild
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    del jreg._BUILTIN_MODELS[NAME], treg._BUILTIN_MODELS[NAME]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert_ds")
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


def _cfgs(data, out, opt, epochs=1):
    optim = dict(opt=opt, lr=0.01, momentum=0.9, weight_decay=1e-4, epochs=epochs)
    base = dict(model=NAME, data_path=data, num_classes=2, train_crop_size=32,
                val_resize_size=40, val_crop_size=32, batch_size=4, workers=1,
                pruning_method="snip", target_sparsity=0.5, seed=0, print_freq=0)
    return (JConfig(optim=JOptim(**optim), output_dir=str(out), **base),
            TConfig(optim=TOptim(**optim), output_dir=str(out) + "_torch", device="cpu",
                    **base))


@pytest.fixture(scope="module", params=["sgd", "adamw"])
def jax_run(request, data, tmp_path_factory):
    """A JAX SNIP run of one epoch (4 steps): its epoch-0 orbax checkpoint
    and the port's conversion of it."""
    out = tmp_path_factory.mktemp(f"jax_{request.param}")
    jcfg, tcfg = _cfgs(data, out / "run", request.param)
    os.makedirs(jcfg.output_dir, exist_ok=True)
    jdrv.run(jcfg)
    ckpt = os.path.join(jcfg.output_dir, f"{NAME}_epoch_0_snip_0.5")
    pth = str(out / "converted.pth")
    assert conv.convert(ckpt, pth, tcfg) == "train"
    return request.param, ckpt, pth, jcfg, tcfg


def _logits_pair(spec_args, jtree, pth, x):
    """(JAX logits of ``jtree`` masked, the port's logits of ``pth``)."""
    jspec = jreg.build_model(NAME, **spec_args)
    jparams = japply(jtree["params"], {tuple(k.split("/")): v
                                       for k, v in (jtree.get("masks") or {}).items()})
    want = jspec.module.apply({"params": jparams}, jnp.asarray(x), train=False)[0]
    tspec = treg.build_model(NAME, **spec_args)
    params, stats, masks, _ = load_lost_checkpoint(pth, tspec)
    model = treg.build_module(tspec)
    fam = tck.family(tspec)
    model.load_state_dict(fam.state_dict(params, stats, masks))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), need_attn=False)[0]
    return np.asarray(want), got.numpy()


def test_train_checkpoint_weights_masks_and_logits(jax_run):
    _, ckpt, pth, _, _ = jax_run
    jtree = restore_checkpoint(ckpt)
    tspec = treg.build_model(NAME, num_classes=2, image_size=(32, 32))
    params, _, masks, _ = load_lost_checkpoint(pth, tspec)
    ck = tck.load_train_checkpoint(pth, tspec)
    jmasks = {tuple(k.split("/")): np.asarray(m) for k, m in jtree["masks"].items()}
    for tree, want_tree in ((ck["params"], jtree["params"]),  # unbaked, for resuming
                            (params, japply(jtree["params"], jmasks))):  # baked, for lost
        want = {p: np.asarray(v) for p, v in flatten_dict(want_tree).items()}
        got = {p: np.asarray(v) for p, v in flatten_dict(tree).items()}
        assert got.keys() == want.keys()
        for p in want:
            assert np.array_equal(got[p], want[p]), p
    assert {"/".join(p): np.asarray(m) for p, m in masks.items()}.keys() == jtree["masks"].keys()
    for k, m in jtree["masks"].items():
        assert np.array_equal(np.asarray(masks[tuple(k.split("/"))]), np.asarray(m)), k
    x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    want_l, got_l = _logits_pair(dict(num_classes=2, image_size=(32, 32)), jtree, pth, x)
    np.testing.assert_allclose(got_l, want_l, atol=1e-5 * np.abs(want_l).max(), rtol=0)
    assert (ck["epoch"], ck["step"]) == (int(jtree["epoch"]), int(jtree["step"])) == (0, 4)
    assert ck["sparsity"] == pytest.approx(float(jtree["sparsity"]))


def test_resumed_step_matches_jax_resume_session(jax_run, data, tmp_path):
    """JAX: ``resume_session`` on the orbax checkpoint and one step; the
    port: ``resume_session`` on the converted ``.pth`` and one step on the
    same batch. The optimizer's momentum (SGD) or moments and count
    (AdamW) came across, so the steps agree."""
    opt, ckpt, pth, _, _ = jax_run
    jcfg, tcfg = _cfgs(data, tmp_path / "resume", opt, epochs=2)
    os.makedirs(jcfg.output_dir, exist_ok=True)
    os.makedirs(tcfg.output_dir, exist_ok=True)
    js = jdrv.build_session(jcfg)
    assert jdrv.resume_session(js, ckpt) == 1
    ts = tdrv.build_session(tcfg)
    assert tdrv.resume_session(ts, pth) == 1
    assert ts.state.opt.count == int(js.state.step) == 4
    images, labels = next(iter(tdrv.train_loader(tcfg, ts.train_ds, 1)))
    jstate, _ = js.train_step(js.state, (js.normalize(images), jnp.asarray(labels)), js.rng)
    tstate, _ = ts.train_step(ts.state, (ts.normalize(torch.from_numpy(images)),
                                         torch.from_numpy(labels).long()))
    got = {p: w.numpy() for p, w in flatten_dict(
        tck.flax_tree_from_vit_state_dict(tstate.params)).items()}
    d = CFG["hidden_dim"]
    for p, w in flatten_dict(jax.tree.map(np.asarray, jstate.params)).items():
        g = got[p]
        if p[-2:] == ("qkv", "bias"):
            # the key bias has no gradient in exact arithmetic (softmax is blind to a
            # constant added to every key's score), so both packages' gradients there
            # are rounding noise: SGD moves it by noise, but Adam normalizes the noise
            # to a step of up to lr. Hold the key rows to that and q, v as the rest.
            assert np.abs(g[d:2 * d] - w[d:2 * d]).max() <= 2 * tcfg.optim.lr, p
            g, w = np.concatenate([g[:d], g[2 * d:]]), np.concatenate([w[:d], w[2 * d:]])
        err = np.abs(g - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-12), (p, err)


def _slim(ckpt, out):
    from vipers.pruning.structured import run_slim_cli

    args = types.SimpleNamespace(model=NAME, checkpoint=ckpt, num_classes=2, mlp_keep=0.5,
                                 heads_keep=0.5, conv_keep=None, fc_keep=None,
                                 inner_keep=None, round_to=1, output_dir=str(out))
    assert run_slim_cli(args) == 0
    return os.path.join(str(out), f"{NAME}_slim_m64_h1")


def test_slim_checkpoint_carries_its_sidecar_and_logits(jax_run, tmp_path):
    from vipers.pruning.structured import arch_sidecar as jsidecar
    from vipers_torch.pruning.structured import arch_sidecar as tsidecar

    _, ckpt, _, _, tcfg = jax_run
    slim = _slim(ckpt, tmp_path / "slim")
    arch = jsidecar(slim)
    assert arch == {"mlp_dim": 64, "num_heads": 1, "head_dim": 32}
    pth = str(tmp_path / "slim.pth")
    assert conv.convert(slim, pth, tcfg) == "weights"
    assert tsidecar(pth) == arch
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want, got = _logits_pair(dict(num_classes=2, image_size=(32, 32), arch_overrides=arch),
                             restore_checkpoint(slim), pth, x)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_quantize_artifact_carries_observers_and_batch_stats(tmp_path):
    """A ``vipers quantize``-shaped artifact of resnet18 (params, masks,
    running statistics, observers, epoch): weights, statistics, masks and
    observers exactly, the logits within 1e-5."""
    from vipers.core.registry import init_variables
    from vipers.pruning import magnitude as jmag
    from vipers.pruning import masks as jmasks

    spec = jreg.build_model("resnet18", num_classes=3)
    v = init_variables(spec.module, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                       train=False)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    stats = jax.tree.map(lambda a: (np.array(a, np.float32)
                                    + rng.uniform(0.1, 0.5, a.shape).astype(np.float32)),
                         v["batch_stats"])
    masks = jmag.magnitude_prune(params, jmasks.init_masks(params, ()), 0.5)
    observers = {f"layer1_0/conv{i}:{io}": {"min": np.float32(-rng.uniform()),
                                             "max": np.float32(rng.uniform())}
                 for i in (1, 2) for io in ("in", "out")}
    src = str(tmp_path / "quantized_post_train_model")
    save_checkpoint(src, {"params": params, "batch_stats": stats, "observers": observers,
                          "masks": {"/".join(k): np.asarray(m) for k, m in masks.items()},
                          "epoch": np.int32(2)})
    cfg = TConfig(model="resnet18", num_classes=3, train_crop_size=32, device="cpu")
    pth = str(tmp_path / "q.pth")
    assert conv.convert(src, pth, cfg) == "quantize"
    tspec = treg.build_model("resnet18", num_classes=3)
    tparams, tstats, tmasks, tobs = load_lost_checkpoint(pth, tspec)
    assert tobs.keys() == observers.keys()
    for site, o in observers.items():
        assert float(tobs[site]["min"]) == float(o["min"])
        assert float(tobs[site]["max"]) == float(o["max"])
    for tree, ttree in ((japply(params, masks), tparams), (stats, tstats)):  # lost bakes
        for p, w in flatten_dict(tree).items():
            assert np.array_equal(np.asarray(flatten_dict(ttree)[p]), w), p
    assert tmasks.keys() == masks.keys()
    assert torch.load(pth, weights_only=False)["epoch"] == 2
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = spec.module.apply({"params": japply(params, masks), "batch_stats": stats},
                             jnp.asarray(x), train=False)[0]
    model = treg.build_module(tspec)
    model.load_state_dict(tck.family(tspec).state_dict(tparams, tstats, tmasks))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5 * np.abs(want).max(), rtol=0)


def test_sgd_momentum_of_a_bn_net_comes_across(tmp_path):
    """A resnet18 train tree with optax SGD momentum after two updates:
    the port optimizer's momentum buffers are the optax trace in the
    module's layout, its count the schedule's."""
    from vipers.core.registry import init_variables
    from vipers.pruning import masks as jmasks
    from vipers.train.optim import make_lr_schedule, make_optimizer

    spec = jreg.build_model("resnet18", num_classes=2)
    v = init_variables(spec.module, jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                       train=False)
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    ocfg = JOptim(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4)
    tx = make_optimizer(ocfg, params, make_lr_schedule(ocfg, 1))
    opt_state = tx.init(params)
    rng = np.random.default_rng(4)
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        _, opt_state = tx.update(grads, opt_state, params)
    masks = jmasks.init_masks(params, ())
    src = str(tmp_path / "resnet18_epoch_3_pruning_iteration_00")
    save_checkpoint(src, {"params": params, "batch_stats": v["batch_stats"],
                          "masks": {"/".join(k): np.asarray(m) for k, m in masks.items()},
                          "opt_state": opt_state, "step": np.int32(2), "epoch": np.int32(3),
                          "sparsity": np.float32(0.0)})
    cfg = TConfig(model="resnet18", num_classes=2, train_crop_size=32, device="cpu",
                  optim=TOptim(opt="sgd", lr=0.1, momentum=0.9, weight_decay=1e-4))
    pth = str(tmp_path / "r.pth")
    assert conv.convert(src, pth, cfg) == "train"
    tspec = treg.build_model("resnet18", num_classes=2)
    ck = tck.load_train_checkpoint(pth, tspec)
    assert ck["epoch"] == 3 and ck["step"] == 2 and ck["optimizer"]["count"] == 2
    st = tdrv.create_train_state(tspec, ck["params"], ck["masks"], cfg.optim, 1, device="cpu")
    st.opt.load_state_dict(ck["optimizer"])
    fam = tck.family(tspec)
    trace = fam.state_dict(jax.tree.map(np.asarray, opt_state[1].trace))
    for name, p in st.opt.params.items():
        assert torch.equal(st.opt.opt.state[p]["momentum_buffer"], trace[name]), name


def test_average_and_store_model_weights_on_pth(jax_run, tmp_path):
    """The port's ``average_checkpoints`` of two converted ``.pth`` equals
    the conversion of the JAX package's ``average_checkpoints`` of the two
    orbax checkpoints; ``store_model_weights`` keeps the weights alone
    under a hash-stamped name, stable across writes."""
    from vipers.core.checkpoint import average_checkpoints as javg

    _, ckpt, pth, jcfg, tcfg = jax_run
    rolling = os.path.join(jcfg.output_dir, f"{NAME}_checkpoint_snip_0.5")
    pth2 = str(tmp_path / "rolling.pth")
    conv.convert(rolling, pth2, tcfg)
    # perturb one side so the mean is not either input
    obj = torch.load(pth2, weights_only=False)
    obj["model"] = {k: (v * 1.5 if v.is_floating_point() else v) for k, v in obj["model"].items()}
    torch.save(obj, pth2)
    jtree = restore_checkpoint(rolling)
    jtree["params"] = jax.tree.map(lambda a: np.asarray(a) * np.float32(1.5), jtree["params"])
    scaled = str(tmp_path / "scaled")
    save_checkpoint(scaled, jtree)
    avg_src = str(tmp_path / "jax_avg")
    avg = javg([ckpt, scaled])
    save_checkpoint(avg_src, {k: avg[k] for k in ("params", "masks")})
    want = str(tmp_path / "want.pth")
    conv.convert(avg_src, want, tcfg)
    got = tck.average_checkpoints([pth, pth2])["model"]
    want_sd = torch.load(want, weights_only=False)["model"]
    assert got.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(got[k], v), k
    path = tck.store_model_weights({"model": got, "optimizer": {}}, str(tmp_path / "rel"))
    assert os.path.basename(path).startswith("weights-") and path.endswith(".pth")
    assert tck.store_model_weights({"model": got}, str(tmp_path / "rel")) == path
    assert set(torch.load(path, weights_only=False)) == {"model"}


def test_cli_writes_a_pth_that_lost_and_evaluate_read(jax_run, tmp_path, capsys):
    opt, ckpt, _, _, _ = jax_run
    out = str(tmp_path / "cli.pth")
    flags = [ckpt, out, "--model", NAME, "--num-classes", "2", "--train-crop-size", "32"]
    if opt == "adamw":
        with pytest.raises(SystemExit, match="--opt sgd"):
            conv.main(flags)  # the default optimizer is not the run's
    assert conv.main(flags + ["--opt", opt]) == 0
    assert f"wrote {out} (train checkpoint of {NAME})" in capsys.readouterr().out
    params, _, masks, obs = load_lost_checkpoint(
        out, treg.build_model(NAME, num_classes=2, image_size=(32, 32)))
    assert masks and obs is None
