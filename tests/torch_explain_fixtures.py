"""Small models of each family for the explain parity tests (and the CLI
tests' tiny registered ViT, at the end), the same
weights in both packages: the port's initial parameters (seed 0) as numpy,
every leaf perturbed by N(0, 0.02) so that biases, class token and
LayerNorm shifts are not zero, carried into the port's module by
``core.checkpoint.family(spec)`` and into the JAX module as its variables.
A ResNet's running statistics are drawn away from mean 0 / var 1.

  * ViT: 2 blocks, D 64, 2 heads of 32, mlp 128, 10 classes, patch 8;
  * resnet18 at 10 classes;
  * VGG16 narrowed to 8 channels a conv and fc 16 (224 x 224 input);
  * Swin-V2 narrowed (embed 24, heads 3/3/6/6) at 10 classes, 256 x 256
    input (the JAX Swin's gradients are NaN where a stage pads its map);
  * MobileNetV2 at width 0.25, 10 classes, 64 x 64 input, running
    statistics drawn as the ResNet's;
  * the DINO ViT-Tiny cut to 2 blocks (D 192, 3 heads, patch 16, no head:
    the "logits" are the CLS feature), 64 x 96 input (a 4 x 6 grid on its
    14 x 14 pos table, 25 tokens, so block 0 takes the flash route at the
    tests' 16-token threshold).
"""

import contextlib
import functools
import importlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vipers.core.registry as jreg
import vipers_torch.core.registry as treg
import vipers.models.swin as jswin
import vipers.models.vgg as jvgg
import vipers.models.dino_vit as jdino
import vipers.models.vit as jvit
from vipers.pruning import init_masks, magnitude_prune
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.explain import driver as tdriver
from vipers_torch.explain import lrp as tlrp
from vipers_torch.models import dino_vit as tdino
from vipers_torch.models import swin as tswin
from vipers_torch.models import vgg as tvgg
from vipers_torch.models import vit as tvit

jdriver = importlib.import_module("vipers.explain.driver")
jlrp = importlib.import_module("vipers.explain.lrp")
jinterp = importlib.import_module("vipers.models.interpolate")

CLASSES = 10
VIT_CFG = dict(patch_size=8, num_layers=2, num_heads=2, hidden_dim=64, mlp_dim=128,
               num_classes=CLASSES)
SWIN_CFG = dict(embed_dim=24, num_heads=(3, 3, 6, 6), num_classes=CLASSES)
VGG_CFG = dict(conv_widths=(8,) * 13, fc_dims=(16, 16))
MOBILENET_WIDTH = 0.25
DINO_CFG = dict(patch_size=16, embed_dim=192, depth=2, num_heads=3, mlp_ratio=4.0,
                num_classes=0)
INPUT = {"vit": (32, 32), "resnet": (64, 64), "vgg": (224, 224), "swin": (256, 256),
         "mobilenet": (64, 64), "dino": (64, 96)}
# compute_heatmaps' sizes: the ViT's 32 x 48 on its 32 x 32 pos table
SIZE = {"vit": (32, 48), "resnet": (64, 64), "vgg": (224, 224), "swin": (256, 256),
        "mobilenet": (64, 64), "dino": (64, 96)}
# families whose running statistics the fixtures draw
WITH_STATS = ("resnet", "mobilenet")


def one_torch_thread():
    """Run a test module's torch work on one thread, then restore the
    count (the body of a module-scoped fixture): the models here are
    small, and tier-1 runs six workers on the host's cores, where torch's
    spinning intra-op threads only take time from the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(params, seed=0, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a, np.float32)
                                   + rng.normal(0, scale, np.shape(a)).astype(np.float32)),
                        params)


@functools.lru_cache(maxsize=None)
def family_models(fam: str, image_size=(32, 32)):
    """(JAX spec, JAX variables, port spec, port params, port batch stats).
    ``image_size`` is the ViT's pos-table size."""
    if fam == "vit":
        tspec = tvit._build("vit_explain_test", tvit.ViTConfig(**VIT_CFG), image_size)
        jspec = jvit._build("vit_explain_test", jvit.ViTConfig(**VIT_CFG), image_size)
    elif fam == "resnet":
        tspec = tbuild("resnet18", num_classes=CLASSES)
        jspec = jreg.build_model("resnet18", num_classes=CLASSES)
    elif fam == "vgg":
        tspec = tvgg._spec("vgg16", tvgg.VGGConfig(CLASSES, **VGG_CFG), (224, 224))
        jspec = jreg.ModelSpec(name="vgg16", input_size=(224, 224), num_classes=CLASSES,
                               family="vgg",
                               module=jvgg.VGG16(num_classes=CLASSES,
                                                 cfg=jvgg.VGGConfig(**VGG_CFG)))
    elif fam == "swin":
        tspec = tswin.swin_spec("swin_explain_test",
                                tswin.SwinV2Config(**SWIN_CFG, stochastic_depth_prob=0.0),
                                (256, 256))
        jspec = jreg.ModelSpec(name="swin_explain_test", input_size=(256, 256),
                               num_classes=CLASSES, family="swin", patch_size=4,
                               module=jswin.SwinTransformerV2(cfg=jswin.SwinV2Config(
                                   **SWIN_CFG, stochastic_depth_prob=0.0)))
    elif fam == "mobilenet":
        tspec = tbuild("mobilenet_v2", num_classes=CLASSES, width_mult=MOBILENET_WIDTH)
        jspec = jreg.build_model("mobilenet_v2", num_classes=CLASSES,
                                 width_mult=MOBILENET_WIDTH)
    elif fam == "dino":
        tspec = tdino._build("dino_explain_test", tdino.DinoViTConfig(**DINO_CFG))
        jspec = jdino._build("dino_explain_test", jdino.DinoViTConfig(**DINO_CFG))
    else:
        raise ValueError(fam)
    params = _perturbed(jax.tree.map(lambda a: a.numpy(),
                                     tspec.init(torch.Generator().manual_seed(0))))
    stats = None
    variables = {"params": params}
    if fam in WITH_STATS:
        rng = np.random.default_rng(1)
        flat = {}
        for path, w in flatten_dict(params).items():
            if path[-1] == "scale":
                flat[path[:-1] + ("mean",)] = rng.normal(0, 0.2, w.shape).astype(np.float32)
                flat[path[:-1] + ("var",)] = rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
        stats = unflatten_dict(flat)
        variables["batch_stats"] = stats
    return jspec, variables, tspec, params, stats


def port_model(fam: str, image_size=(32, 32)):
    """The port's module of ``family_models(fam)`` in eval mode, frozen."""
    _jspec, _v, tspec, params, stats = family_models(fam, image_size)
    model = tspec.module()
    model.load_state_dict({**dict(model.named_buffers()),
                           **tck.family(tspec).state_dict(params, stats)})
    return tspec, model.eval().requires_grad_(False)


def images(fam: str, n: int = 1, seed: int = 0, size=None):
    """Normalized-looking f32 NHWC inputs at the family's test size (or
    ``size``)."""
    h, w = size or INPUT[fam]
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, h, w, 3)).astype(np.float32)


def jax_apply(fam: str, image_size=(32, 32)):
    """``model_apply(variables, x, train=False, **kw)`` of the JAX model."""
    jspec = family_models(fam, image_size)[0]
    return jspec.module.apply


def scaled_close(got, want, rel=1e-5, rtol=1e-4):
    """|got - want| <= rel * max|want| + rtol * |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1e-30), rtol=rtol)


# ---- checks the explain test files run per family (the bodies of their
# ---- parametrized tests)

def image(fam, seed=0, size=None):
    h, w = size or SIZE[fam]
    return np.random.default_rng(seed).normal(0, 1, (h, w, 3)).astype(np.float32)


def jax_pos(fam, h, w):
    if fam != "vit":
        return {}
    pos = family_models(fam)[1]["params"]["pos_embedding"]
    return {"override_pos_embedding": jinterp.interpolate_pos_embedding(
        jnp.asarray(pos), (h // 8, w // 8), align_corners=True)}


def check_tap(fam, against_jax=True):
    """A nonzero tap moves the tapped activation by itself (ViT: the last
    block's ln_1 output, the aux qkv_input; CNNs and Swin: the final map)
    and (``against_jax``) the logits as the JAX model's do; None leaves the
    forward as it was."""
    jspec, variables, *_ = family_models(fam)
    _tspec, model = port_model(fam)
    x = images(fam)
    key = "qkv_input" if fam in ("vit", "dino") else "features"
    with torch.no_grad():
        base_logits, base = model(torch.from_numpy(x))
        tap = torch.from_numpy(np.random.default_rng(1).normal(
            0, 0.1, tuple(base[key].shape)).astype(np.float32))
        logits, aux = model(torch.from_numpy(x), tap_delta=tap)
        again, _ = model(torch.from_numpy(x), tap_delta=None)
    torch.testing.assert_close(again, base_logits, rtol=0, atol=0)
    if fam != "swin":  # Swin's map is normalized after the tap, not returned raw
        torch.testing.assert_close(aux[key], base[key] + tap, rtol=0, atol=0)
    if not against_jax:
        return
    japply = jax.jit(functools.partial(jspec.module.apply, train=False))
    jlogits, jaux = japply(variables, jnp.asarray(x), tap_delta=jnp.asarray(tap.numpy()))
    scaled_close(logits.numpy(), np.asarray(jlogits))
    scaled_close(aux[key].numpy(), np.asarray(jaux[key]))


def jax_lrp(fam, x, eps):
    """``vipers.explain.lrp.lrp_attribution``'s body (the JAX package's
    interceptor, the argmax target) under ``jax.jit``, eps an argument so
    one compile serves every eps: eager, the JAX package compiles op by
    op, a minute on the Swin."""
    (_v, t), rel = _jax_lrp_fn(fam, x.shape)(jnp.asarray(x), jnp.float32(eps))
    return np.asarray(rel[0]), int(t)


@functools.lru_cache(maxsize=None)
def _jax_lrp_fn(fam, shape):
    import flax.linen as nn

    jspec, variables, *_ = family_models(fam)
    kw = jax_pos(fam, *shape[1:3])

    def score(xx, eps):
        with nn.intercept_methods(jlrp.lrp_interceptor(eps)):
            logits, _aux = jspec.module.apply(variables, xx, train=False, **kw)
        t = jnp.argmax(logits[0])
        return logits[0, t], t

    return jax.jit(jax.value_and_grad(score, has_aux=True))


def port_lrp(fam, x, eps, dtype=torch.float32):
    tspec, model = port_model(fam)
    model = model.to(dtype)
    apply = tdriver._apply_fn(tspec, model, *x.shape[1:3])
    return tlrp.lrp_attribution(apply, model, torch.from_numpy(x).to(dtype), eps=eps)


def check_lrp_matches_jax(fam):
    """At eps = 1e-2, within 2e-3 of the map's scale (measured 1e-6 to
    4.7e-4 over the four families at 1, 3 and 8 torch threads; the ViT on
    the flash route); the modules are left as they were."""
    x = image(fam)[None]
    want, tgt_j = jax_lrp(fam, x, 1e-2)
    got, tgt_t = port_lrp(fam, x, 1e-2)
    assert tgt_t == tgt_j
    scaled_close(got, want, rel=2e-3, rtol=0)
    _s, model = port_model(fam)
    assert not any("forward" in vars(o) or "patch_embed" in vars(o)
                   for o, _a in tlrp.lrp_sites(model))


def check_lrp_default_eps(fam):
    """The default eps is the JAX package's (1e-6). There the rule divides
    by y + 1e-6 sign(y): a pre-activation within f32 rounding of 0 flips a
    stabilizer's sign, and the map is ill conditioned in f32 in both
    packages (each lies ~4e-3 to ~3e-1 of the scale from an f64 run of the
    rule, and the JAX package's own jitted and eager runs of one Swin
    differ by ~18%), so no f32 pair can be held to a tolerance: the map is
    finite, of the input's shape and for the JAX package's target."""
    assert tlrp.LRP_EPS == jlrp.LRP_EPS
    x = image(fam)[None]
    want, tgt_j = jax_lrp(fam, x, tlrp.LRP_EPS)
    got, tgt_t = port_lrp(fam, x, tlrp.LRP_EPS)
    assert tgt_t == tgt_j and got.shape == want.shape == x.shape[1:]
    assert np.isfinite(got).all()


def check_compute_heatmaps(fam):
    jspec, variables, *_ = family_models(fam)
    tspec, model = port_model(fam)
    img = image(fam, seed=3)
    methods = ["gradcam", "guided_gradcam", "attention"]
    want = jdriver.compute_heatmaps(jspec, variables, img, methods)
    got = tdriver.compute_heatmaps(tspec, model, img, methods + ["lrp"])
    assert sorted(got) == sorted(list(want) + ["lrp"])
    assert int(np.argmax(got["prediction"])) == int(np.argmax(want["prediction"]))
    scaled_close(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["gradcam"], want["gradcam"], atol=1e-5, rtol=0)
    for m in ("guided_gradcam", "attention"):
        if m in want:
            scaled_close(got[m], want[m])
    # lrp: held by the two tests above (its default-eps map is ill
    # conditioned: a 1e-8 change of the input's rounding moves it); here
    # compute_heatmaps' CHW layout. MobileNetV2's map at the default eps
    # overflows f32 in both packages (53 layers of epsilon division: an f64
    # run of the rule reaches ~4e38), so it is held at eps 1e-2 only
    assert got["lrp"].shape == (3, *img.shape[:2])
    assert fam == "mobilenet" or np.isfinite(got["lrp"]).all()


# ---- the CLI tests' tiny ViT (patch 16, 2 blocks, D 64, 2 heads of 32,
# ---- mlp 128, 10 classes, pos table at 224) and helpers

CLI_NAME = "vit_tiny_explain_cli"
CLI_CFG = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=64, mlp_dim=128,
               num_classes=10)


def register_cli_vit():
    """Register the CLI tests' tiny ViT in both registries; yields, then
    removes it (the body of a module-scoped fixture)."""
    jreg.list_models()
    treg._ensure_builtins_imported()

    def jbuild(num_classes=10, image_size=(224, 224), **_kw):
        cfg = jvit.ViTConfig(**{**CLI_CFG, "num_classes": num_classes})
        return jvit._build(CLI_NAME, cfg, image_size)

    def tbuild(num_classes=10, image_size=(224, 224), **kw):
        cfg = tvit.ViTConfig(**{**CLI_CFG, "num_classes": num_classes}, **kw)
        return tvit._build(CLI_NAME, cfg, image_size)

    jreg._BUILTIN_MODELS[CLI_NAME] = jbuild
    treg._BUILTIN_MODELS[CLI_NAME] = tbuild
    yield
    del jreg._BUILTIN_MODELS[CLI_NAME], treg._BUILTIN_MODELS[CLI_NAME]


def cli_params(seed=0, num_classes=10, image_size=(224, 224)):
    cfg = tvit.ViTConfig(**{**CLI_CFG, "num_classes": num_classes})
    spec = tvit._build(CLI_NAME, cfg, image_size)
    return _perturbed(jax.tree.map(lambda a: a.numpy(),
                                   spec.init(torch.Generator().manual_seed(seed))), seed)


def write_cli_checkpoints(root, stem, seed=0, num_classes=10, image_size=(224, 224)):
    """The same weights and masks as the port's ``.pth`` (``root/torch``)
    and the JAX package's orbax directory (``root/jax``: the JAX package
    reads a ``.pth`` only at the registry's own depths)."""
    from vipers.core.checkpoint import save_checkpoint

    params = cli_params(seed, num_classes, image_size)
    jspec = jvit._build(CLI_NAME, jvit.ViTConfig(**CLI_CFG), image_size)
    masks = {p: np.asarray(m) for p, m in magnitude_prune(
        params, init_masks(params, exclude=jspec.prune_exclude), 0.5).items()}
    os.makedirs(os.path.join(root, "torch"), exist_ok=True)
    save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False),
                          os.path.join(root, "torch", stem + ".pth"))
    save_checkpoint(os.path.join(root, "jax", stem),
                    {"params": params, "masks": {"/".join(k): v for k, v in masks.items()}})
    return {"torch": os.path.join(root, "torch", stem + ".pth"),
            "jax": os.path.join(root, "jax", stem)}


def run_cli(main, argv):
    """(exit code, stdout) of a CLI's ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def file_tree(root):
    """Every file under ``root``, relative, sorted."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _s, files in os.walk(root) for f in files)


