"""vipers_torch's CNN families (ResNet-18/34/50, VGG16) against the JAX
package on the CPU: the forward, the bf16 dtype flow, flax's BatchNorm
statistics, the masked train step and EMA, SNIP and the ``.pth`` both ways.

Small sizes: 10 classes, 48x40 or 64x64 images, B=2-4; the JAX weights
(flax init, running statistics perturbed so they are not the identity)
carried across by ``core.checkpoint.family(spec)``. Tolerances: forward
f32 atol 1e-5 / rtol 1e-4; params after 3 SGD steps atol 2e-5 (the ViT
test's); running statistics after them 1e-4 of their scale and SNIP's
saliencies 1e-5 of theirs (flax's train-mode variance, E[x^2] - mean^2 in
f32, loses the digits of 1 + mean^2 / var, and the gradient cases' model
below raises that ratio; the ViT's SNIP test holds 2e-6).

The gradient of a ReLU network jumps where a pre-activation crosses 0,
and train-mode BatchNorm couples every cell of a channel: one
pre-activation within rounding of 0 that the two packages put on opposite
sides moves a last-stage gradient by ~1/(B*H*W) of itself (16 cells a
channel at 64x64, B=4). An f64 run of the port sides with the port's f32
there, so this is the comparison's conditioning, not a fault: with flax's
initial BatchNorm biases (0) resnet18's gradients differ by percents of a
kernel's scale after one such flip. The gradient cases (train step, SNIP)
therefore start every BatchNorm bias at +3, which puts the pre-activations
three batch deviations above the kink (the rest of the weights as
initialized, the classifier's scaled by 0.1 so the logits stay near their
initial size), and run resnet18 and resnet50 with dilate 4 (an 8x8 map).
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vipers.core.checkpoint as jck
import vipers.pruning as jprune
import vipers.pruning.snip as jsnip
import vipers.train.optim as joptim
import vipers.train.steps as jsteps
from vipers.core.registry import build_model as jbuild
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.models.cnn import BatchNorm
import vipers_torch.pruning as tprune
from vipers_torch.pruning import snip as tsnip
from vipers_torch.train import optim as toptim
from vipers_torch.train import steps as tsteps
from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


CLASSES = 10


@functools.lru_cache(maxsize=None)
def _variables(name):
    """A parameter tree in the JAX layout (the port's flax-default init,
    seed 0, as numpy) and running statistics drawn from seed 1 away from
    mean 0 / var 1, for ``name`` at 10 classes; the JAX spec."""
    spec = tbuild(name, num_classes=CLASSES)
    params = jax.tree.map(lambda a: a.numpy(), spec.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    stats = {}
    for path, w in flatten_dict(params).items():
        if path[-1] == "scale":
            stats[path[:-1] + ("mean",)] = rng.normal(0, 0.2, w.shape).astype(np.float32)
            stats[path[:-1] + ("var",)] = rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
    return jbuild(name, num_classes=CLASSES), params, unflatten_dict(stats)


def _torch_model(name, params, stats, dilate=1, train=False):
    kw = {} if name.endswith("_bottom") else {"num_classes": CLASSES}
    spec = tbuild(name, dilate=dilate, **kw)
    model = spec.module()
    model.load_state_dict(tck.family(spec).state_dict(params, stats))
    return spec, model.train(train)


def _images(b, h, w, seed=0):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name,dilate", [
    ("resnet18", 1), ("resnet18", 2), ("resnet18", 4), ("resnet34", 1),
    ("resnet50", 1), ("resnet50", 2), ("resnet50", 4), ("resnet50_bottom", 2)])
def test_forward_matches_jax(name, dilate):
    """Eval mode, f32: logits (the map for a headless model) and the
    layer4 map in NHWC order, on a 48x40 batch."""
    js, params, stats = _variables(name.replace("_bottom", ""))
    if name.endswith("_bottom"):
        params = {k: v for k, v in params.items() if k != "fc"}
        js = jbuild(name, dilate=dilate)
    else:
        js = jbuild(name, num_classes=CLASSES, dilate=dilate)
    x = _images(2, 48, 40)
    jout, jaux = js.module.apply({"params": params, "batch_stats": stats}, x)
    spec, model = _torch_model(name, params, stats, dilate)
    with torch.no_grad():
        tout, taux = model(torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(taux["features"].numpy(), np.asarray(jaux["features"]),
                               atol=1e-5, rtol=1e-4)
    assert taux["features"].shape[1:3] == (model.feature_extent(48), model.feature_extent(40))


def test_vgg16_forward_matches_jax():
    """VGG16's classifier (CHW flatten) and headless map, f32, eval mode,
    at 224x224 on narrow widths (8 channels a conv, fc 16): the same
    module structure and names as cfg "D"."""
    import vipers.models.vgg as jvgg

    from vipers_torch.models import vgg as tvgg

    jm = jvgg.VGG16(num_classes=CLASSES, cfg=jvgg.VGGConfig(conv_widths=(8,) * 13,
                                                             fc_dims=(16, 16)))
    cfg = tvgg.VGGConfig(CLASSES, conv_widths=(8,) * 13, fc_dims=(16, 16))
    params = jax.tree.map(lambda a: a.numpy(),
                          tvgg.init_vgg_params(cfg, torch.Generator().manual_seed(0)))
    x = _images(1, 224, 224)
    jout, jaux = jm.apply({"params": params}, x)
    model = tvgg.VGG16(cfg).eval()
    model.load_state_dict(tck.FAMILIES["vgg"].state_dict(params))
    with torch.no_grad():
        tout, taux = model(torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(taux["features"].numpy(), np.asarray(jaux["features"]),
                               atol=1e-5, rtol=1e-4)
    # the classifier's dropout (rate 0.5) draws from the forward's generator
    with pytest.raises(ValueError, match="needs a generator"):
        model.train()(torch.from_numpy(x))


class _ConvDtypes(TorchDispatchMode):
    """Counts aten convolutions by their input's dtype."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.convolution:
            k = str(args[0].dtype).replace("torch.", "")
            self.counts[k] = self.counts.get(k, 0) + 1
        return func(*args, **(kwargs or {}))


def test_bf16_dtype_flow_matches_jax_jaxpr():
    """The bf16 train forward: the params cast to bf16, BatchNorm's output
    f32, so flax runs only the stem convolution in bf16 and the other 19
    of resnet18's in f32 on bf16-rounded weights. The port's count of
    convolutions by input dtype equals the JAX jaxpr's, and the logits
    are f32 in both."""
    js, params, stats = _variables("resnet18")
    x = _images(2, 48, 48)
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)

    def fwd(p, xb):
        return js.module.apply({"params": p, "batch_stats": stats}, xb, train=True,
                               mutable=["batch_stats"])[0][0]

    jaxpr = jax.make_jaxpr(fwd)(p16, jnp.asarray(x, jnp.bfloat16))
    want = {}
    for eqn in jaxpr.jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            k = str(eqn.invars[0].aval.dtype)
            want[k] = want.get(k, 0) + 1
    assert want == {"bfloat16": 1, "float32": 19}, want
    spec, model = _torch_model("resnet18", params, stats, train=True)
    tensors = tsteps.forward_params(dict(model.named_parameters()), {}, torch.bfloat16)
    mode = _ConvDtypes()
    with mode:
        _, logits, _ = tsteps.train_loss(model, tensors, (torch.from_numpy(x),
                                                          torch.zeros(2, dtype=torch.long)),
                                         CLASSES, compute_dtype=torch.bfloat16)
    assert mode.counts == want, mode.counts
    assert logits.dtype == torch.float32
    assert jaxpr.out_avals[0].dtype == jnp.float32


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_batch_norm_running_stats_biased_variance(steps):
    """flax's BatchNorm on a (4, 3, 3, 2) input: after ``steps`` train
    forwards the running variance follows the BIASED batch variance (torch's
    BatchNorm2d would take the unbiased one), momentum 0.9; outputs f32."""
    import flax.linen as fnn

    rng = np.random.default_rng(7)
    xs = [rng.normal(1.0, 1.0, size=(4, 3, 3, 2)).astype(np.float32) for _ in range(steps)]
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.float32)
    v = jbn.init(jax.random.PRNGKey(0), xs[0])
    tbn = BatchNorm(2).train()
    tbn.state_name = "bn"
    for x in xs:
        jy, upd = jbn.apply(v, jnp.asarray(x, jnp.bfloat16), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        new = {}
        ty = tbn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2), new)
        with torch.no_grad():
            tbn.running_mean.copy_(new["bn.running_mean"])
            tbn.running_var.copy_(new["bn.running_var"])
        assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
        np.testing.assert_allclose(ty.permute(0, 2, 3, 1).detach().numpy(), np.asarray(jy),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(v["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(v["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    # torch's own update, for contrast, takes the unbiased variance
    xb = torch.from_numpy(xs[-1]).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    unbiased = xb.var(dim=(0, 2, 3), unbiased=True)
    biased = xb.var(dim=(0, 2, 3), unbiased=False)
    assert not torch.allclose(unbiased, biased, rtol=1e-3)


TRAIN_CASES = {
    "resnet18-ema": dict(name="resnet18", dilate=1, ema=(0.9, 1)),
}


def _train_setup(name, dilate):
    """The gradient cases' model (BatchNorm biases at +3 and the classifier
    scaled by 0.1 after the masks were ranked, see the module docstring),
    50% magnitude masks and three 64x64 B=4 batches."""
    js, params, stats = _variables(name)
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params), amount=0.5).items()}
    params = unflatten_dict({p: a + 3.0 if p[-1] == "bias" and p[-2].startswith(
        ("bn", "downsample_bn")) else a * 0.1 if p[0] == "fc" else a
        for p, a in flatten_dict(params).items()})
    js = jbuild(name, num_classes=CLASSES, dilate=dilate)
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
                rng.integers(0, CLASSES, size=(4,)).astype(np.int32)) for _ in range(3)]
    return js, params, stats, masks, batches


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_masked_train_step_matches_jax(case):
    """3 f32 SGD steps (momentum 0.9, wd 1e-4, lr 0.01) on 50% magnitude
    masks: loss and accuracies per step, params, running statistics (and
    the EMA weights and statistics) after, against
    ``vipers.train.steps.make_train_step``; pruned slots unchanged."""
    c = TRAIN_CASES[case]
    js, params, stats, masks, batches = _train_setup(c["name"], c["dilate"])
    ocfg = toptim.OptimConfig(opt="sgd", lr=0.01)
    ema_decay, ema_warmup = c.get("ema", (None, 0))
    jocfg = joptim.OptimConfig(opt="sgd", lr=0.01)
    tx = joptim.make_optimizer(jocfg, params, joptim.make_lr_schedule(jocfg, 1))
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               masks=masks, opt_state=tx.init(params),
                               ema_params=params if ema_decay else None,
                               ema_batch_stats=stats if ema_decay else None)
    jstep = jsteps.make_train_step(js.module.apply, tx, num_classes=CLASSES, ema_decay=ema_decay,
                                   ema_warmup_steps=ema_warmup, donate=False)
    tspec = tbuild(c["name"], num_classes=CLASSES, dilate=c["dilate"])
    tstate = tsteps.create_train_state(tspec, params, {p: np.array(m) for p, m in masks.items()},
                                       ocfg, 1, device="cpu", ema=ema_decay is not None,
                                       batch_stats=stats)
    tstep = tsteps.make_train_step(CLASSES, ema_decay=ema_decay, ema_warmup_steps=ema_warmup)
    before = {k: p.detach().clone() for k, p in tstate.params.items()}
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)), jax.random.PRNGKey(1))
        tstate, tm = tstep(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(tm["acc1"]) == float(jm["acc1"]) and float(tm["acc5"]) == float(jm["acc5"])
    fam = tstate.family
    want = fam.state_dict(jstate.params, jstate.batch_stats)
    for k, v in {**tstate.params, **tstate.batch_stats}.items():
        w = want[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.detach().numpy(), w, atol=1e-4 * np.abs(w).max(),
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(v.detach().numpy(), w, atol=2e-5, rtol=0, err_msg=k)
    for k, m in tstate.masks.items():
        assert torch.equal(tstate.params[k].detach()[~m], before[k][~m]), k
    if ema_decay:
        want = fam.state_dict(jstate.ema_params, jstate.ema_batch_stats)
        for k, v in {**tstate.ema_params, **tstate.ema_batch_stats}.items():
            w = want[k].numpy()
            tol = 1e-4 * np.abs(w).max() if k.endswith(("_mean", "_var")) else 2e-5
            np.testing.assert_allclose(v.numpy(), w, atol=tol, rtol=0, err_msg=k)


def test_eval_step_reads_running_and_ema_statistics():
    """The eval step normalizes with the running statistics, and with
    ``use_ema`` with the EMA weights and statistics, as the JAX eval step
    does (``vipers/train/steps.py`` ``make_eval_step``)."""
    js, params, stats, masks, batches = _train_setup("resnet18", 1)
    ema_stats = jax.tree.map(lambda a: a * 1.5, stats)
    x, y = batches[0]
    tspec = tbuild("resnet18", num_classes=CLASSES)
    tstate = tsteps.create_train_state(tspec, params, {p: np.array(m) for p, m in masks.items()},
                                       toptim.OptimConfig(), 1, device="cpu", ema=True,
                                       batch_stats=stats)
    tstate.ema_batch_stats = {k: v.clone() for k, v in
                              tck.family(tspec).state_dict({}, ema_stats).items()}
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               masks=masks, opt_state=None, ema_params=params,
                               ema_batch_stats=ema_stats)
    for use_ema in (False, True):
        jout = jsteps.make_eval_step(js.module.apply, CLASSES, use_ema=use_ema)(
            jstate, (jnp.asarray(x), jnp.asarray(y)))
        tout = tsteps.make_eval_step(CLASSES, use_ema=use_ema)(
            tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
        assert abs(float(tout["loss_sum"]) - float(jout["loss_sum"])) <= 1e-5 * abs(
            float(jout["loss_sum"])), use_ema
        assert int(tout["top1"]) == int(jout["top1"]) and int(tout["n"]) == int(jout["n"])


def test_optimizer_sees_the_flax_norm_paths():
    """``--norm-weight-decay`` reaches every BatchNorm, ``downsample_bn``
    included (torchvision's ``downsample.1`` would escape the bn* rule)."""
    spec = tbuild("resnet18", num_classes=CLASSES)
    params = spec.init(torch.Generator().manual_seed(0))
    state = tsteps.create_train_state(spec, params, {}, toptim.OptimConfig(norm_weight_decay=0.0),
                                      1, device="cpu")
    rates = {id(p): g["weight_decay"] for g in state.opt.opt.param_groups for p in g["params"]}
    named = state.params
    assert rates[id(named["layer2.0.downsample.1.weight"])] == 0.0
    assert rates[id(named["layer2.0.downsample.1.bias"])] == 0.0
    assert rates[id(named["layer2.0.downsample.0.weight"])] == 1e-4
    assert rates[id(named["fc.weight"])] == 1e-4
    jr = joptim.weight_decay_rates(jax.tree.map(np.asarray, params),
                                   joptim.OptimConfig(norm_weight_decay=0.0))
    fam = tck.family(spec)
    assert {fam.state_key(p): r for p, r in flatten_dict(jr).items()} == {
        k: rates[id(p)] for k, p in named.items()}


@pytest.mark.parametrize("name,dilate", [("resnet18", 1)])
def test_snip_saliencies_match_jax(name, dilate):
    """SNIP's saliencies of the dense model in f32, BatchNorm on the batch's
    statistics, against ``vipers.pruning.snip.snip_saliency`` with the JAX
    driver's loss (train=True, the updated statistics dropped); the
    session's running statistics are left as they were."""
    js, params, stats, _, batches = _train_setup(name, dilate)
    x, y = batches[0]

    def jloss(p, batch):
        out = js.module.apply({"params": p, "batch_stats": stats}, batch[0], train=True,
                              mutable=["batch_stats"])
        return jsteps.cross_entropy(out[0][0], batch[1], CLASSES)

    base = jprune.init_masks(params)
    jsal = jsnip.snip_saliency(jloss, params, (jnp.asarray(x), jnp.asarray(y)), masks=base)
    tspec = tbuild(name, num_classes=CLASSES, dilate=dilate)
    tstats = {k: v for k, v in tck.family(tspec).state_dict({}, stats).items()}
    kept = {k: v.clone() for k, v in tstats.items()}
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    tsal = tsnip.snip_saliency(tsnip.snip_loss(tspec, CLASSES, batch_stats=tstats), tparams,
                               (torch.from_numpy(x), torch.from_numpy(y).long()),
                               masks={p: torch.from_numpy(np.array(m)) for p, m in base.items()})
    assert tsal.keys() == jsal.keys()
    scale = max(float(np.abs(np.asarray(s)).max()) for s in jsal.values())
    for p, s in jsal.items():
        np.testing.assert_allclose(tsal[p].numpy(), np.asarray(s), atol=1e-5 * scale, rtol=0,
                                   err_msg=str(p))
    assert all(torch.equal(tstats[k], kept[k]) for k in kept)


class _TorchvisionBlock(torch.nn.Module):
    """torchvision's BasicBlock / Bottleneck layout with torch's own
    modules (``nn.BatchNorm2d``): the oracle a ``.pth`` must load into."""

    def __init__(self, inplanes, planes, stride, bottleneck, downsample):
        super().__init__()
        nn = torch.nn
        out = planes * (4 if bottleneck else 1)
        if bottleneck:
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
            self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(out)
        else:
            self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
            self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1, self.bn2 = nn.BatchNorm2d(planes), nn.BatchNorm2d(planes)
        self.bottleneck = bottleneck
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                                         nn.BatchNorm2d(out)) if downsample else None)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.bottleneck:
            y = self.bn3(self.conv3(torch.relu(y)))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class _TorchvisionResNet(torch.nn.Module):
    def __init__(self, stage_sizes, bottleneck, num_classes):
        super().__init__()
        nn = torch.nn
        self.conv1, self.bn1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64)
        inplanes = 64
        for s, n in enumerate(stage_sizes):
            planes, blocks = 64 * 2 ** s, []
            for b in range(n):
                stride = 2 if s and not b else 1
                out = planes * (4 if bottleneck else 1)
                blocks.append(_TorchvisionBlock(inplanes, planes, stride, bottleneck,
                                                not b and (stride != 1 or inplanes != out)))
                inplanes = out
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x):
        x = torch.nn.functional.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in range(4):
            x = getattr(self, f"layer{s + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


@pytest.mark.parametrize("name", ["resnet50"])
def test_resnet_pth_both_ways(name):
    """``export_resnet`` writes what a torchvision-layout ResNet loads
    strictly (``num_batches_tracked`` included) and what the JAX
    ``import_resnet`` reads back to the same trees and masks; baked or as
    ``weight_orig`` / ``weight_mask``; the strictly loaded torch model's
    eval forward equals the port's."""
    _, params, stats = _variables(name)
    rng = np.random.default_rng(4)
    masks = {p: rng.random(m.shape) < 0.5 for p, m in tprune.init_masks(params).items()}
    spec = tbuild(name, num_classes=CLASSES)
    sizes = spec.cfg.stage_sizes
    for bake in (True, False):
        sd = tck.export_resnet(params, stats, masks, bake_masks=bake)
        norm = tck.normalize_torch_state_dict({k: torch.from_numpy(np.asarray(v))
                                               for k, v in sd.items()})
        for importer in (lambda s: jck.import_resnet(s, sizes), lambda s: tck.import_resnet(s, sizes)):
            p2, s2, m2 = importer(norm)
            p2, s2 = flatten_dict(p2), flatten_dict(s2)
            for path, w in flatten_dict(params).items():
                want = w * masks[path] if path in masks else w
                np.testing.assert_array_equal(np.asarray(p2[path]), want, err_msg=str(path))
            for path, v in flatten_dict(stats).items():
                np.testing.assert_array_equal(np.asarray(s2[path]), v)
            if bake:
                assert not m2
            else:
                assert {tuple(k) for k in m2} == set(masks)
                assert all(np.array_equal(np.asarray(m2[p]), masks[p]) for p in masks)
    tv = _TorchvisionResNet(sizes, spec.cfg.bottleneck, CLASSES).eval()
    tv.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in tck.export_resnet(params, stats, masks).items()}, strict=True)
    x = _images(2, 48, 40)
    baked = unflatten_dict({p: w * masks[p] if p in masks else w
                            for p, w in flatten_dict(params).items()})
    _, model = _torch_model(name, baked, stats)
    with torch.no_grad():
        np.testing.assert_allclose(tv(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
                                   model(torch.from_numpy(x))[0].numpy(), atol=1e-5, rtol=1e-4)


def test_vgg16_pth_both_ways():
    """``export_vgg16`` (torchvision's keys) -> the JAX ``import_vgg16`` and
    the port's: the same trees and masks, the weights masked (baked, or as
    ``weight_orig`` / ``weight_mask`` resolved on load), the convolutions'
    masks carried and the classifier's not, as in the JAX importer; the
    headless import drops the classifier."""
    from vipers_torch.models import vgg as tvgg

    params = jax.tree.map(lambda a: a.numpy(), tvgg.init_vgg_params(
        tvgg.VGGConfig(CLASSES, conv_widths=(8,) * 13, fc_dims=(16, 16)),
        torch.Generator().manual_seed(0)))
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params), amount=0.5).items()}
    want = flatten_dict(jax.tree.map(np.asarray, jprune.apply_masks(params, masks)))
    keys = {f"features.{i}.{leaf}" for i in tck._VGG_CONV for leaf in ("weight", "bias")} | {
        f"classifier.{i}.{leaf}" for i in (0, 3, 6) for leaf in ("weight", "bias")}
    for bake in (True, False):
        sd = tck.export_vgg16(params, masks, bake_masks=bake)
        assert {k[:-len("_orig")] if k.endswith("_orig") else k for k in sd
                if not k.endswith("_mask")} == keys
        norm = tck.normalize_torch_state_dict({k: torch.from_numpy(np.array(v))
                                               for k, v in sd.items()})
        (jp, jm2), (tp, tm2) = jck.import_vgg16(norm), tck.import_vgg16(norm)
        assert flatten_dict(jp).keys() == flatten_dict(tp).keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_array_equal(np.asarray(flatten_dict(jp)[path]), w)
            np.testing.assert_array_equal(np.asarray(flatten_dict(tp)[path]), w)
        conv_masks = {p for p in masks if p[0].startswith("conv")}
        assert set(tm2) == set(jm2) == (set() if bake else conv_masks)
        assert all(np.array_equal(tm2[p], masks[p]) for p in tm2)
    headless, _ = tck.import_vgg16(norm, headless=True)
    assert set(headless) == {f"conv_{i}" for i in range(13)}


def test_infer_num_classes_reads_fc_and_fc3():
    assert tck.infer_num_classes({"fc": {"kernel": np.zeros((512, 7))}}) == 7
    assert tck.infer_num_classes({"fc3": {"kernel": np.zeros((16, 5))},
                                  "conv_0": {"kernel": np.zeros((3, 3, 3, 8))}}) == 5
    assert tck.infer_num_classes({"conv_0": {"kernel": np.zeros((3, 3, 3, 8))}}) is None


def test_resnet18_cli_train_evaluate_lost(tmp_path):
    """The JAX CLI's default model through the port's entry points on the
    CPU: ``train`` with no ``--model`` (resnet18) runs SNIP and LRR; the LRR
    ``.pth`` with its masks baked loads strictly into a torchvision-layout
    ResNet-18 whose eval forward equals the checkpoint's through the port;
    ``evaluate`` reads the sweep (dilated) and ``lost --arch resnet``
    reads the checkpoint."""
    from PIL import Image

    from vipers_torch.cli.main import main

    rng = np.random.default_rng(2)
    data = tmp_path / "data"
    for split, n in (("train", 8), ("val", 4)):
        for cls in ("a", "b"):
            os.makedirs(data / split / cls)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                    data / split / cls / f"{i}.jpg")
    common = ["--data-path", str(data), "--num-classes", "2", "--batch-size", "4", "--epochs",
              "1", "--train-crop-size", "32", "--val-resize-size", "40", "--val-crop-size", "32",
              "--lr", "0.01", "--print-freq", "0", "--workers", "2", "--device", "cpu"]
    assert main(["train", *common, "--pruning-method", "snip", "--target-sparsity", "0.5",
                 "--output-dir", str(tmp_path / "snip")]) == 0
    assert (tmp_path / "snip" / "resnet18_epoch_0_snip_0.5.pth").exists()
    lrr = tmp_path / "lrr"
    assert main(["train", *common, "--pruning-method", "magnitude", "--pruning-rate", "0.5",
                 "--pruning-threshold", "70", "--output-dir", str(lrr)]) == 0
    pth = lrr / "resnet18_epoch_0_pruning_iteration_01.pth"
    sd = tck.load_torch_state_dict(str(pth))
    baked = {k: torch.from_numpy(v) for k, v in sd.items() if not k.endswith(".__mask__")}
    tv = _TorchvisionResNet((2, 2, 2, 2), False, 2).eval()
    tv.load_state_dict(baked, strict=True)
    spec = tbuild("resnet18", num_classes=2)
    params, stats, masks = tck.import_resnet(sd, spec.cfg.stage_sizes)
    assert masks and all(not np.asarray(m).all() for m in masks.values())
    model = spec.module().eval()
    model.load_state_dict(tck.family(spec).state_dict(params, stats, masks))
    x = _images(2, 32, 32)
    with torch.no_grad():
        np.testing.assert_allclose(tv(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(),
                                   model(torch.from_numpy(x))[0].numpy(), atol=1e-5, rtol=1e-4)
    assert main(["evaluate", *common, "--models-path", str(lrr), "--resnet-dilate", "2",
                 "--output-dir", str(tmp_path / "eval")]) == 0
    rows = (tmp_path / "eval" / "resnet18_dilation_2.txt").read_text().splitlines()
    assert len(rows) == 6 and rows[3].endswith("custom_x_axis 50.0"), rows
    voc = os.path.join(os.path.dirname(__file__), "data", "torch_voc")
    assert main(["lost", "--arch", "resnet", "--model", "resnet18", "--resnet-dilate", "2",
                 "--data-path", voc, "--checkpoint", str(pth), "--batch-size", "1",
                 "--output-dir", str(tmp_path / "lost"), "--device", "cpu"]) == 0
    with open(tmp_path / "lost" / "preds.pkl", "rb") as f:
        assert len(pickle.load(f)) >= 1
