"""vipers_torch's MobileNetV2 and the ``quantized_`` aliases against the
JAX package on the CPU: the parameter tree, the eval and train forwards
(logits, head map, updated running statistics), the bf16 BatchNorm dtype
flow, the torchvision ``.pth`` both ways, and each family's quantize
exclusions.

Small sizes: ``width_mult`` 0.25, 10 classes, 64x64 images, B=4; the
port's initial parameters (seed 0) carried into both packages, every leaf
perturbed by N(0, 0.05) and the running statistics drawn away from mean 0
/ var 1. Tolerance: f32 atol 1e-5 / rtol 1e-4 (the ResNet tests').

The train forward normalizes by the batch's statistics, down to 2x2 maps
x 4 images in the last stages, where flax's E[x^2] - mean^2 loses digits:
with these weights the JAX package's logits lie 2.1e-4 from an f64 run of
the port, the port's f32 3.7e-5. So the train case starts every
BatchNorm bias at +3, which puts the relu6 inputs inside (0, 6) (the
ResNet tests' remedy), and holds the logits at 1e-5 of their scale, the
head map (the last BatchNorm's output) and the updated running statistics
at 1e-4 of theirs (the ResNet tests' statistics tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipers.core.registry import build_model as jbuild
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict

from torch_explain_fixtures import one_torch_thread as _one_thread

CLASSES = 10
WIDTH = 0.25


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    yield from _one_thread()


@functools.lru_cache(maxsize=None)
def _variables():
    spec = tbuild("mobilenet_v2", num_classes=CLASSES, width_mult=WIDTH)
    rng = np.random.default_rng(1)
    params = {p: (a.numpy() + rng.normal(0, 0.05, a.shape)).astype(np.float32)
              for p, a in flatten_dict(spec.init(torch.Generator().manual_seed(0))).items()}
    stats = {}
    for path, w in params.items():
        if path[-1] == "scale":
            stats[path[:-1] + ("mean",)] = rng.normal(0, 0.2, w.shape).astype(np.float32)
            stats[path[:-1] + ("var",)] = rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
    return unflatten_dict(params), unflatten_dict(stats)


def _models():
    params, stats = _variables()
    spec = tbuild("mobilenet_v2", num_classes=CLASSES, width_mult=WIDTH)
    model = spec.module()
    model.load_state_dict(tck.family(spec).state_dict(params, stats))
    jspec = jbuild("mobilenet_v2", num_classes=CLASSES, width_mult=WIDTH)
    return spec, model, jspec, params, stats


def _images(seed=0, b=4):
    return np.random.default_rng(seed).normal(0, 1, (b, 64, 64, 3)).astype(np.float32)


def test_init_tree_matches_jax_shapes():
    spec = tbuild("mobilenet_v2", num_classes=CLASSES, width_mult=WIDTH)
    jspec = jbuild("mobilenet_v2", num_classes=CLASSES, width_mult=WIDTH)
    want = jax.eval_shape(lambda: jspec.module.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 32, 32, 3))))
    got = spec.init(torch.Generator().manual_seed(0))
    for col, tree in (("params", got), ):
        w = {p: tuple(a.shape) for p, a in flatten_dict(want[col]).items()}
        g = {p: tuple(a.shape) for p, a in flatten_dict(tree).items()}
        assert g == w
    assert set(flatten_dict(want["batch_stats"])) == {
        p[:-1] + (leaf,) for p in flatten_dict(got) if p[-1] == "scale" for leaf in ("mean", "var")}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train):
    spec, model, jspec, params, stats = _models()
    x = _images()
    if train:
        params = unflatten_dict({p: (np.full_like(v, 3.0) if p[-2:] == ("bn", "bias") else v)
                                 for p, v in flatten_dict(params).items()})
        model.load_state_dict(tck.family(spec).state_dict(params, stats))
    model.train(train)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(x))
    variables = {"params": params, "batch_stats": stats}
    if not train:
        jl, jaux = jax.jit(lambda v, xx: jspec.module.apply(v, xx, train=False))(variables, x)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(aux["features"].numpy(), np.asarray(jaux["features"]),
                                   atol=1e-5, rtol=1e-4)
        return
    (jl, jaux), new = jax.jit(lambda v, xx: jspec.module.apply(
        v, xx, train=True, mutable=["batch_stats"]))(variables, x)
    for got, want, tol in ((logits, jl, 1e-5), (aux["features"], jaux["features"], 1e-4)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=tol * np.abs(want).max())
    fam = tck.family(spec)
    got = {fam.flax_path(k, 1): v.numpy() for k, v in aux["batch_stats"].items()}
    want = flatten_dict(jax.tree.map(np.asarray, new["batch_stats"]))
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], atol=1e-4 * np.abs(want[p]).max(),
                                   err_msg=str(p))


def test_bf16_batchnorm_output_dtype_matches_flax():
    """flax's BatchNorm with no ``dtype`` returns the promoted dtype of
    input and scale: bf16 in a bf16 forward, so every convolution of a
    MobileNetV2 runs in bf16 (a ResNet's f32 BatchNorm does not)."""
    from vipers_torch.models.cnn import BatchNorm

    spec, model, jspec, params, stats = _models()
    x = _images()[:1]
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jl, jaux = jax.jit(lambda v, xx: jspec.module.apply(v, xx, train=False))(
        {"params": bf, "batch_stats": stats}, jnp.asarray(x, jnp.bfloat16))
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda mod, a, o: seen.append((a[0].dtype, o.dtype)))
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(x).to(torch.bfloat16))
    assert jl.dtype == jaux["features"].dtype == jnp.bfloat16
    assert logits.dtype == aux["features"].dtype == torch.bfloat16
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen)


def test_pth_round_trip_and_torchvision_keys():
    """``export_mobilenet_v2`` writes torchvision's ``mobilenet_v2`` keys
    (``features.0.0``, ``features.{n}.conv.{k}``, ``features.18``,
    ``classifier.1``, running statistics, ``num_batches_tracked``), baked
    or as ``weight_orig`` / ``weight_mask``; ``import_mobilenet_v2`` reads
    them back exactly."""
    spec, model, _j, params, stats = _models()
    sd = tck.export_mobilenet_v2(params, stats)
    assert set(sd) == set(model.state_dict()) | {
        k[:-len("running_mean")] + "num_batches_tracked" for k in sd if k.endswith("running_mean")}
    for k in ("features.0.0.weight", "features.1.conv.0.0.weight", "features.1.conv.1.weight",
              "features.2.conv.0.0.weight", "features.2.conv.2.weight",
              "features.2.conv.3.running_var", "features.17.conv.3.bias",
              "features.18.0.weight", "features.18.1.weight", "classifier.1.weight"):
        assert k in sd, k
    assert sd["features.18.0.weight"].shape == (1280, 80, 1, 1)
    p2, s2, m2 = tck.import_mobilenet_v2(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = flatten_dict(a), flatten_dict(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fb[k]), fa[k])
    assert m2 == {}
    masks = {p: np.random.default_rng(2).random(w.shape) > 0.5
             for p, w in flatten_dict(params).items() if p[-1] == "kernel"}
    sdm = tck.export_mobilenet_v2(params, stats, masks, bake_masks=False)
    assert "features.0.0.weight_orig" in sdm and "classifier.1.weight_mask" in sdm
    p3, _s3, m3 = tck.import_mobilenet_v2(tck.normalize_torch_state_dict(sdm))
    assert set(m3) == set(masks)
    for k, m in masks.items():
        np.testing.assert_array_equal(m3[k], m)
        np.testing.assert_array_equal(np.asarray(flatten_dict(p3)[k]),
                                      flatten_dict(params)[k] * m)
    # the module's own state dict back to flax paths
    p4, s4 = tck.family(spec).trees(dict(model.state_dict()))
    for k, v in flatten_dict(params).items():
        np.testing.assert_array_equal(flatten_dict(p4)[k].numpy(), v)


def test_quantized_aliases_and_quant_exclude_match_jax():
    for name in ("quantized_mobilenet_v2", "quantized_resnet18", "quantized_resnet50"):
        t, j = tbuild(name, num_classes=CLASSES), jbuild(name, num_classes=CLASSES)
        assert t.extra.get("quantized") is True and j.extra.get("quantized") is True
        assert t.family == j.family and t.name == j.name
    for name in ("vit_s_16", "vit_b_16", "resnet18", "vgg16", "swin_v2_t", "dino_vit_small",
                 "mobilenet_v2", "quantized_resnet50"):
        assert tuple(tbuild(name).quant_exclude) == tuple(jbuild(name).quant_exclude), name


def test_masked_train_step_matches_jax():
    """2 f32 SGD steps (momentum 0.9, wd 1e-4, lr 0.01) on 50% magnitude
    masks, BatchNorm biases at +3 and the classifier scaled by 0.1 (the
    ResNet tests' remedies): loss and accuracies per step, parameters within
    2e-5 and running statistics within 1e-4 of their scale after them,
    against ``vipers.train.steps.make_train_step``; pruned slots
    unchanged."""
    import vipers.train.optim as joptim
    import vipers.train.steps as jsteps
    import vipers_torch.pruning as tprune
    from vipers_torch.train import optim as toptim
    from vipers_torch.train import steps as tsteps

    spec, _model, jspec, params, stats = _models()
    params = unflatten_dict({p: (v + np.float32(3.0) if p[-2:] == ("bn", "bias")
                                 else v * np.float32(0.1) if p[0] == "classifier" else v)
                             for p, v in flatten_dict(params).items()})
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params), amount=0.5).items()}
    rng = np.random.default_rng(3)
    batches = [(_images(seed=s), rng.integers(0, CLASSES, size=(4,)).astype(np.int32))
               for s in (5, 6)]
    jocfg = joptim.OptimConfig(opt="sgd", lr=0.01)
    tx = joptim.make_optimizer(jocfg, params, joptim.make_lr_schedule(jocfg, 1))
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               masks=masks, opt_state=tx.init(params))
    jstep = jsteps.make_train_step(jspec.module.apply, tx, num_classes=CLASSES, donate=False)
    tstate = tsteps.create_train_state(spec, params, {p: np.array(m) for p, m in masks.items()},
                                       toptim.OptimConfig(opt="sgd", lr=0.01), 1, device="cpu",
                                       batch_stats=stats)
    tstep = tsteps.make_train_step(CLASSES)
    before = {k: p.detach().clone() for k, p in tstate.params.items()}
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(tm["acc1"]) == float(jm["acc1"]) and float(tm["acc5"]) == float(jm["acc5"])
    want = tstate.family.state_dict(jstate.params, jstate.batch_stats)
    for k, v in {**tstate.params, **tstate.batch_stats}.items():
        w = want[k].numpy()
        tol = 1e-4 * np.abs(w).max() if k.endswith(("running_mean", "running_var")) else 2e-5
        np.testing.assert_allclose(v.detach().numpy(), w, atol=tol, rtol=0, err_msg=k)
    for k, m in tstate.masks.items():
        assert torch.equal(tstate.params[k].detach()[~m], before[k][~m]), k
