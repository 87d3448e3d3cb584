"""The ViT family in vipers_torch against the JAX package on the CPU:
``vit_b_16``, ``vit_b_32``, ``vit_l_16``, ``vit_l_32`` and ``vit_h_14`` built
with the JAX configs, ``representation_size`` (pre_logits + tanh) in the
forward and in the reference ``.pth``, the dropout rates, a patch-14
head-dim-80 model through the batched LOST pipeline on the flash route, and
``vipers_torch lost --model vit_b_32 --patch-size 32`` against ``vipers
lost`` on the committed 8-JPEG VOC fixture. f32 throughout; tolerances are
stated where a comparison is not exact.
"""

import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.core.checkpoint as jckpt
import vipers.core.registry as jreg
import vipers.models.vit as jvit
import vipers_torch.core.checkpoint as tckpt
import vipers_torch.core.registry as treg
import vipers_torch.models.vit as tvit
from vipers.pruning import init_masks, magnitude_prune
from vipers_torch.cli.main import build_parser, main
from vipers_torch.core.tree import flatten_dict
from vipers_torch.discovery.driver import LostFeatureExtractor

jdriver = importlib.import_module("vipers.discovery.driver")

FAMILY = ["vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"]
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_voc")
SMALL = dict(patch_size=16, num_layers=2, num_heads=2, hidden_dim=128, mlp_dim=256,
             num_classes=10, representation_size=48)
SMALL_IMAGE = (64, 48)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", FAMILY)
def test_family_builds_with_the_jax_configs(name):
    """The five names build with the JAX registry's configs and metadata,
    and the module's parameters have the JAX tree's paths and shapes (the
    JAX init traced by ``jax.eval_shape``, the port's module on the meta
    device: nothing is drawn at full width)."""
    jspec = jreg.build_model(name)
    tspec = treg.build_model(name)
    fields = ("patch_size", "num_layers", "num_heads", "hidden_dim", "mlp_dim", "num_classes",
              "dropout_rate", "attention_dropout_rate", "representation_size")
    assert ({f: getattr(tspec.cfg, f) for f in fields}
            == {f: getattr(jspec.module.cfg, f) for f in fields})
    assert (tspec.patch_size, tspec.input_size, tuple(tspec.prune_exclude)) == \
        (jspec.patch_size, jspec.input_size, tuple(jspec.prune_exclude))
    shapes = jax.eval_shape(lambda: jspec.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))["params"]
    want = {p: tuple(a.shape) for p, a in flatten_dict(shapes).items()}
    with torch.device("meta"):
        model = tspec.module()
    got = tckpt.flax_tree_from_vit_state_dict(dict(model.named_parameters()))
    assert {p: tuple(a.shape) for p, a in flatten_dict(got).items()} == want


@pytest.fixture(scope="module")
def small():
    """A 2-layer ViT with representation_size 48, from the JAX init."""
    jspec = jvit._build("small", jvit.ViTConfig(**SMALL), SMALL_IMAGE)
    variables = jspec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, *SMALL_IMAGE, 3)),
                                  train=False)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    return jspec, variables, params


def test_forward_with_representation_size_matches_jax(small):
    """pre_logits (Dense to 48) and tanh before the head: logits, the CLS
    feature and the last ln_1 output within 1e-4 of the JAX package's; the
    port's init draws the same tree."""
    jspec, variables, params = small
    tspec = tvit._build("small", tvit.ViTConfig(**SMALL), SMALL_IMAGE)
    model = tspec.module()
    model.load_state_dict(tckpt.vit_state_dict_from_flax(params))
    x = np.random.default_rng(5).normal(size=(2, *SMALL_IMAGE, 3)).astype(np.float32)
    want, jaux = jspec.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got, aux = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    for key in ("cls", "qkv_input"):
        np.testing.assert_allclose(_np(aux[key]), np.asarray(jaux[key]), rtol=1e-4, atol=1e-4)
    drawn = tspec.init(torch.Generator().manual_seed(0))
    assert ({p: tuple(a.shape) for p, a in flatten_dict(drawn).items()}
            == {p: a.shape for p, a in flatten_dict(params).items()})


def test_pth_round_trip_with_pre_logits_is_exact(small):
    """A reference .pth with ``heads.pre_logits``, both ways, bit-exact: the
    JAX exporter's state dict comes in through the port's importer, loads
    into a module built with ``infer_representation_size`` (strictly), goes
    back out through ``flax_tree_from_vit_state_dict`` and the port's
    exporter equal to what came in, and the port's export goes into the JAX
    importer equal to the JAX tree."""
    _, _, params = small
    sd = jckpt.export_vit_torchvision(params)
    assert "heads.pre_logits.weight" in sd
    tree, masks = tckpt.import_vit_torchvision(sd, SMALL["num_layers"])
    assert not masks
    rep = tckpt.infer_representation_size(tree)
    assert rep == SMALL["representation_size"]
    cfg = tvit.ViTConfig(**{**SMALL, "representation_size": rep})
    model = tvit._build("small", cfg, SMALL_IMAGE).module()
    model.load_state_dict(tckpt.vit_state_dict_from_flax(tree))  # strict
    assert torch.equal(model.pre_logits.weight, torch.tensor(sd["heads.pre_logits.weight"]))
    back = tckpt.export_vit_torchvision(
        tckpt.flax_tree_from_vit_state_dict(dict(model.named_parameters())))
    assert sorted(back) == sorted(sd)
    for key, w in sd.items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)
    jtree, _ = jckpt.import_vit_torchvision(back, SMALL["num_layers"])
    want = flatten_dict(params)
    got = flatten_dict(jtree)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), w, err_msg=str(path))


@pytest.mark.parametrize("patch", [14, 16, 32])
def test_infer_vit_image_size_matches_jax(patch):
    """The checkpoint's pos-table size at the family's patch sizes: 224 x
    224 from a square table, None from a table that is not square."""
    for n in (224 // patch, 7):
        pos = {"pos_embedding": np.zeros((1, n * n + 1, 8), np.float32)}
        assert tckpt.infer_vit_image_size(pos, patch) == jckpt.infer_vit_image_size(pos, patch)
    assert tckpt.infer_vit_image_size({"pos_embedding": np.zeros((1, 11, 8))}, patch) is None


@pytest.mark.parametrize("field", ["dropout_rate", "attention_dropout_rate"])
def test_dropout_raises_naming_the_roadmap_item(field):
    """Dropout is ported (ROADMAP A8): a rate above 0 builds the model with
    it, and a train forward then raises without the generator its masks
    are drawn from, rather than run a model without dropout."""
    spec = treg.build_model("vit_b_16", **{field: 0.1})
    assert getattr(spec.cfg, field) == 0.1
    assert getattr(treg.build_model("vit_b_16", **{field: 0.0}).cfg, field) == 0.0
    small = tvit._build("vit_dropout", tvit.ViTConfig(8, 1, 2, 32, 64, 10, **{field: 0.1}),
                        (16, 16))
    with pytest.raises(ValueError, match="needs a generator"):
        small.module().train()(torch.zeros(1, 16, 16, 3), need_attn=False)


HD80 = dict(patch_size=14, num_layers=2, num_heads=2, hidden_dim=160, mlp_dim=320,
            num_classes=10)
HD80_IMAGE = (112, 112)  # an 8 x 8 patch grid at patch 14
HD80_HW = [(112, 112), (100, 70)]  # one bucket, the second image masked


def _images(exact_hw, patch, seed):
    """Tier-1-padded uint8 images, zero beyond the exact pixel extent, each
    with a bright block on darker noise."""
    rng = np.random.default_rng(seed)
    imgs = []
    for h, w in exact_hw:
        im = np.zeros((-(-h // patch) * patch, -(-w // patch) * patch, 3), np.uint8)
        im[:h, :w] = rng.integers(0, 120, (h, w, 3))
        r, c = rng.integers(0, h // 2), rng.integers(0, w // 2)
        im[r:r + h // 3, c:c + w // 3] = rng.integers(180, 256, 3)
        imgs.append(im)
    return imgs


def _jax_features(jex, patch, images, pos, token_mask, valid_hw, pixel_hw):
    """The JAX pipeline's LOST features (``make_batched_pipeline``'s feature
    step, outside its jit): normalize, the masked forward, the scramble of
    each image's compacted tier-1 tokens scattered back onto the grid."""
    x = jdriver._device_normalize(images, pixel_hw)
    _, aux = jex._module_apply(jex.variables, x, train=False, override_pos_embedding=pos,
                               token_mask=token_mask, need_attn=False,
                               seq_pad_multiple=jdriver._seq_pad(x.shape, patch, False))

    def feats_of(q, tmask, vhw):
        perm = jnp.argsort(~tmask, stable=True)
        fc = jvit.scrambled_qkv_gather(q[perm], 1 + vhw[0] * vhw[1], "k")
        valid = tmask[1:]
        return jnp.where(valid[:, None], fc[jnp.cumsum(valid)], 0.0)

    return np.asarray(jax.vmap(feats_of)(aux["qkv_input"], token_mask, valid_hw))


def test_hd80_patch14_pipeline_matches_jax(monkeypatch):
    """vit_h_14's geometry at 2 layers and narrow width (patch 14, 2 heads of
    80) through ``make_batched_pipeline`` on two images of different sizes
    in one bucket, with both packages' flash threshold at 16 tokens so the
    seq-padded flash route runs (T = 65 -> 128): features within 1e-4 of the
    JAX package's (f32) and boxes, seeds and background flags equal."""
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    jspec = jvit._build("hd80", jvit.ViTConfig(**HD80), HD80_IMAGE)
    variables = jspec.module.init(jax.random.PRNGKey(1), jnp.zeros((1, *HD80_IMAGE, 3)),
                                  train=False)
    masks = magnitude_prune(variables["params"],
                            init_masks(variables["params"], exclude=jspec.prune_exclude),
                            amount=0.5)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), variables["params"])
    imgs = _images(HD80_HW, 14, seed=14)
    jex = jdriver.LostFeatureExtractor(jspec, variables, masks, arch="vit", which_features="k")
    jin = jex.prepare_batch(imgs, 14, exact_hw=HD80_HW)
    jbox, jseed, jbg = map(np.asarray, jex.make_batched_pipeline(k_patches=10)(jex.variables, *jin))

    tspec = tvit._build("hd80", tvit.ViTConfig(**HD80), HD80_IMAGE)
    tex = LostFeatureExtractor(tspec, params, {p: np.asarray(m) for p, m in masks.items()},
                               device="cpu")
    tin = tex.prepare_batch(imgs, 14, exact_hw=HD80_HW)
    assert tin[2] is not None and tin[0].shape[1:3] == (112, 112)
    calls = []
    real = tvit.flash_attention
    monkeypatch.setattr(tvit, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tbox, tseed, tbg = (z.numpy() for z in tex.make_batched_pipeline(k_patches=10)(*tin))
    assert len(calls) == HD80["num_layers"]
    feats = tex.batched_features(*tin).numpy()
    want = _jax_features(jex, 14, *jin)
    np.testing.assert_allclose(feats, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tseed, jseed)
    np.testing.assert_array_equal(tbox, jbox)
    np.testing.assert_array_equal(tbg, jbg)


def _two_layer_vit_b_32(monkeypatch):
    """Both registries' ``vit_b_32`` at its real width (D 768, 12 heads of
    64, mlp 3072, patch 32) cut to 2 layers, and the JAX importer told so."""
    def jax_builder(num_classes=1000, image_size=(224, 224), **kw):
        cfg = jvit.ViTConfig(32, 2, 12, 768, 3072, num_classes, **kw)
        return jvit._build("vit_b_32", cfg, image_size)

    def port_builder(num_classes=1000, image_size=(224, 224), **kw):
        cfg = tvit.ViTConfig(32, 2, 12, 768, 3072, num_classes, **kw)
        return tvit._build("vit_b_32", cfg, image_size)

    jreg._ensure_builtins_imported()
    treg._ensure_builtins_imported()
    monkeypatch.setitem(jreg._BUILTIN_MODELS, "vit_b_32", jax_builder)
    monkeypatch.setitem(treg._BUILTIN_MODELS, "vit_b_32", port_builder)
    real_import = jckpt.import_torch_checkpoint
    monkeypatch.setattr(jckpt, "import_torch_checkpoint",
                        lambda path, name, **kw: real_import(path, name, num_layers=2, **kw))


def test_cli_vit_b_32_patch_32_equals_vipers_lost(monkeypatch, tmp_path):
    """``vipers_torch lost --model vit_b_32 --patch-size 32`` and ``vipers
    lost`` on the same pruned .pth (seeded JAX init, residual output kernels
    scaled by 0.2 so the boxes are smaller than the image, a 50% global
    magnitude mask in the weight_orig / weight_mask form) and the 8 fixture
    JPEGs (two buckets at patch 32, 384x512 and 512x384: T = 193, below the
    flash threshold, so attention is the key-masked einsum in both; tail
    batches at --batch-size 4): preds.pkl and the results txt equal."""
    _two_layer_vit_b_32(monkeypatch)
    spec = jreg.build_model("vit_b_32")
    v = spec.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False)
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    for i in range(2):
        layer = params[f"encoder_layer_{i}"]
        layer["attention"]["out"]["kernel"] *= 0.2
        layer["mlp"]["fc2"]["kernel"] *= 0.2
    masks = magnitude_prune(params, init_masks(params, exclude=("qkv",)), amount=0.5)
    pth = str(tmp_path / "vit_b_32.pth")
    tckpt.save_torch_state_dict(tckpt.export_vit_torchvision(
        params, {k: np.asarray(m) for k, m in masks.items()}, bake_masks=False), pth)

    def argv(out):
        return ["lost", "--model", "vit_b_32", "--patch-size", "32", "--data-path", FIXTURE,
                "--checkpoint", pth, "--output-dir", str(tmp_path / out), "--batch-size", "4",
                "--workers", "2", "--device", "cpu"]

    assert jdriver.run_lost(build_parser().parse_args(argv("jax"))) == 0
    assert main(argv("port")) == 0
    preds = {}
    for out in ("jax", "port"):
        with open(tmp_path / out / "preds.pkl", "rb") as f:
            preds[out] = pickle.load(f)
    assert len(preds["port"]) == 8 and preds["port"] == preds["jax"]
    sizes = {}
    for name in preds["port"]:
        with open(os.path.join(FIXTURE, "Annotations", name.replace(".jpg", ".xml"))) as f:
            xml = f.read()
        sizes[name] = [0.0, 0.0, float(xml.split("<width>")[1].split("<")[0]),
                       float(xml.split("<height>")[1].split("<")[0])]
    assert any(box != sizes[name] for name, box in preds["port"].items()), "all whole-image"
    txt = "results_iteration_00.txt"
    assert (tmp_path / "port" / txt).read_text() == (tmp_path / "jax" / txt).read_text()
