"""CNN LOST in vipers_torch (``--arch resnet``, ``--arch vgg16``) against the
JAX package on the CPU: the feature extents and bucket arithmetic, the
batched CNN pipeline and ``vipers_torch lost`` on the committed VOC fixture.

Weights: the port's flax-default init (seed 0) as numpy trees, ResNet
running statistics drawn away from mean 0 / var 1, 50% global magnitude
masks; both packages read the same trees, and the CLI runs read the same
``.pth``. f32 throughout. Tolerances: feature extents, canonical inputs,
bucket keys, boxes and seeds exact; LOST features 1e-4 of their scale.
"""

import argparse
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.discovery.driver as jdriver
from vipers.core.registry import build_model as jbuild
import vipers_torch.pruning as tprune
from vipers_torch.cli.main import main
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.discovery.driver import LostFeatureExtractor
from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


VOC = os.path.join(os.path.dirname(__file__), "data", "torch_voc")
# (registry name, dilate): the three ResNet output strides and VGG's
MODELS = [("resnet18", 1), ("resnet18", 2), ("resnet18", 4), ("vgg16_bottom", 1)]


def _spec_kw(name, dilate):
    return {} if name.startswith("vgg") else {"dilate": dilate}


def _stats(params):
    """Running statistics for every BatchNorm of ``params`` (seed 1, away
    from mean 0 / var 1), or None for a model without BatchNorm."""
    rng = np.random.default_rng(1)
    flat = {}
    for path, w in flatten_dict(params).items():
        if path[-1] == "scale":
            flat[path[:-1] + ("mean",)] = rng.normal(0, 0.2, w.shape).astype(np.float32)
            flat[path[:-1] + ("var",)] = rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
    return unflatten_dict(flat) if flat else None


def _weights(name, dilate=1):
    """(params, batch_stats or None, masks) numpy trees of ``name``."""
    spec = tbuild(name, **_spec_kw(name, dilate))
    params = jax.tree.map(lambda a: a.numpy(), spec.init(torch.Generator().manual_seed(0)))
    masks = {p: m.numpy() for p, m in tprune.magnitude_prune(
        params, tprune.init_masks(params), amount=0.5).items()}
    return params, _stats(params), masks


def _extractors(name, dilate, weights=None, cnn_bucket=4):
    params, stats, masks = weights or _weights(name, dilate)
    arch = "vgg16" if name.startswith("vgg") else "resnet"
    variables = {"params": params, **({"batch_stats": stats} if stats is not None else {})}
    jex = jdriver.LostFeatureExtractor(jbuild(name, **_spec_kw(name, dilate)), variables,
                                       {p: jnp.asarray(m) for p, m in masks.items()}, arch=arch,
                                       cnn_bucket=cnn_bucket)
    tex = LostFeatureExtractor(tbuild(name, **_spec_kw(name, dilate)), params, masks,
                               device="cpu", batch_stats=stats, cnn_bucket=cnn_bucket)
    return jex, tex


# px probed through JAX's eval_shape (~0.3 s a probe here): every residue
# of the smallest output stride (8), both sides of a step boundary
SAMPLED_PX = list(range(33, 41)) + [384, 385]


@pytest.mark.parametrize("name,dilate", MODELS)
def test_feature_extent_matches_jax_eval_shape(name, dilate):
    """The port's arithmetic feature extent (``feature_extent``) equals the
    JAX extractor's ``eval_shape`` of the model at the sampled sizes."""
    spec = tbuild(name, **_spec_kw(name, dilate))
    params = jax.tree.map(lambda a: a.numpy(), spec.init(torch.Generator().manual_seed(0)))
    tex = LostFeatureExtractor(spec, params, device="cpu")
    stats = _stats(params)
    jex = jdriver.LostFeatureExtractor(
        jbuild(name, **_spec_kw(name, dilate)),
        {"params": params, **({"batch_stats": stats} if stats is not None else {})},
        arch="vgg16" if name.startswith("vgg") else "resnet")
    for px in SAMPLED_PX:
        assert tex._cnn_fdim(px) == jex._cnn_fdim(px), px


class _JaxBucketRule:
    """The JAX extractor's bucket methods, on given feature extents."""

    cnn_bucket_key = jdriver.LostFeatureExtractor.cnn_bucket_key
    cnn_scales = jdriver.LostFeatureExtractor.cnn_scales
    _cnn_canon_input = jdriver.LostFeatureExtractor._cnn_canon_input
    _cnn_input_for_fdim = jdriver.LostFeatureExtractor._cnn_input_for_fdim

    def __init__(self, fdim, cnn_bucket):
        self._cnn_fdim, self.cnn_bucket = fdim, cnn_bucket
        self._fdim_cache, self._cnn_stride = {}, None


@pytest.mark.parametrize("cnn_bucket", [4, 3])
@pytest.mark.parametrize("name,dilate", MODELS)
def test_canonical_inputs_and_bucket_keys_match_jax(name, dilate, cnn_bucket):
    """``_cnn_canon_input``, ``cnn_bucket_key`` and ``cnn_scales`` for every
    size 33-640 against the JAX extractor's methods. These run here on the
    port's feature extents (``eval_shape`` of every size their search
    probes would take minutes; the test above holds the extents equal on a
    sample that covers every residue of the output stride), so this holds
    the search and the rounding rule."""
    spec = tbuild(name, **_spec_kw(name, dilate))
    tex = LostFeatureExtractor(spec, spec.init(torch.Generator().manual_seed(0)), device="cpu",
                               cnn_bucket=cnn_bucket)
    jrule = _JaxBucketRule(tex.model.feature_extent, cnn_bucket)
    for px in range(33, 641):
        assert tex.cnn_bucket_key(px, 673 - px) == jrule.cnn_bucket_key(px, 673 - px), px
        f = tex._cnn_fdim(px)
        assert tex._cnn_canon_input(f) == jrule._cnn_canon_input(f), px
        assert tex.cnn_scales(px, px) == jrule.cnn_scales(px, px)


def _u8_batch(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


@pytest.mark.parametrize("name,dilate", [("resnet18", 2)])
def test_batched_cnn_pipeline_matches_jax(name, dilate):
    """``make_batched_cnn_pipeline`` on one mixed bucket of 3 uint8 images
    (their exact pixel dims below the canonical input, so pixel and
    feature masks are live): boxes and seeds equal to JAX's, and the
    masked slab-LayerNorm features within 1e-4 of their scale."""
    jex, tex = _extractors(name, dilate)
    sizes = [(96, 88), (93, 84), (90, 81)]
    imgs = _u8_batch(sizes, 5)
    keys = {tex.cnn_bucket_key(h, w) for h, w in sizes}
    assert len(keys) == 1
    key = keys.pop()
    assert key == jex.cnn_bucket_key(96, 80)
    jin = jex.prepare_cnn_batch(imgs, key, exact_hw=sizes)
    tin = tex.prepare_cnn_batch(imgs, key, exact_hw=sizes)
    assert tin[2] is not None
    np.testing.assert_array_equal(tin[0].numpy(), np.asarray(jin[0]))
    np.testing.assert_array_equal(tin[1].numpy(), np.asarray(jin[1]))
    jbox, jseed, jbg = (np.asarray(a) for a in jex.make_batched_cnn_pipeline(10)(
        jex.variables, *jin))
    tbox, tseed, tbg = (a.numpy() for a in tex.make_batched_cnn_pipeline(10)(*tin))
    np.testing.assert_array_equal(tseed, jseed)
    np.testing.assert_array_equal(tbox, jbox)
    np.testing.assert_array_equal(tbg, jbg)
    # the features the JAX pipeline computes inside
    images = jdriver._device_normalize(jin[0], jin[2])
    feats = np.asarray(jex._raw_cnn_feats(jex.variables, images))
    b, fh, fw, d = feats.shape
    v = np.asarray(jin[1])
    m = ((np.arange(fh)[None, :, None] < v[:, 0, None, None])
         & (np.arange(fw)[None, None, :] < v[:, 1, None, None])).reshape(b, fh * fw, 1)
    want = np.asarray(jdriver.masked_slab_layernorm(
        jnp.asarray(feats.reshape(b, fh * fw, d)), jnp.asarray(m, jnp.float32),
        jnp.asarray((v[:, 0] * v[:, 1] * d).astype(np.float32))[:, None, None]))
    got = tex.cnn_features(*tin).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0)


# three of the fixture's JPEGs in one bucket (500x375, 500x366, 500x333):
# one full batch of 2 and a tail batch
CLI_IMAGES = ("000005", "000019", "000007")


def _voc_subset(root):
    """A VOC07 tree of symlinks to CLI_IMAGES of the committed fixture."""
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub))
    for name in CLI_IMAGES:
        for sub, ext in (("JPEGImages", "jpg"), ("Annotations", "xml")):
            os.symlink(os.path.join(VOC, sub, f"{name}.{ext}"),
                       os.path.join(root, sub, f"{name}.{ext}"))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(CLI_IMAGES) + "\n")
    return str(root)


def _lost_args(arch, model, data, out, pth, extra=()):
    return ["lost", "--arch", arch, "--model", model, "--dataset", "VOC07", "--set", "trainval",
            "--data-path", data, "--checkpoint", pth, "--batch-size", "2", "--workers", "2",
            "--k-patches", "10", "--output-dir", str(out), *extra]


@pytest.mark.parametrize("arch,model,extra", [
    ("resnet", "resnet18", ["--resnet-dilate", "2"]),
    ("vgg16", "vgg16_bottom", []),
])
def test_lost_cli_matches_jax(arch, model, extra, tmp_path):
    """``vipers_torch lost --arch resnet|vgg16`` on three JPEGs of the
    committed VOC fixture (one bucket, a tail batch) from one ``.pth`` (a
    ResNet's running statistics included, the masks as ``weight_orig`` /
    ``weight_mask``): the same ``preds.pkl`` and results txt as ``vipers
    lost``."""
    from vipers.cli.main import main as jmain

    dilate = int(extra[1]) if extra else 1
    params, stats, masks = _weights(model, dilate)
    sd = (tck.export_resnet(params, stats, masks, bake_masks=False) if arch == "resnet"
          else tck.export_vgg16(params, masks, bake_masks=False))
    pth = str(tmp_path / f"{model}.pth")
    tck.save_torch_state_dict(sd, pth)
    data = _voc_subset(tmp_path / "voc")
    assert main([*_lost_args(arch, model, data, tmp_path / "port", pth, extra),
                 "--device", "cpu"]) == 0
    assert jmain(_lost_args(arch, model, data, tmp_path / "jax", pth, extra)) in (0, None)
    got, want = ({k: np.asarray(v).tolist() for k, v in pickle.load(
        open(tmp_path / p / "preds.pkl", "rb")).items()} for p in ("port", "jax"))
    assert got == want and len(got) == len(CLI_IMAGES)
    assert (tmp_path / "port" / "results_iteration_00.txt").read_text() == \
        (tmp_path / "jax" / "results_iteration_00.txt").read_text()


def test_lost_cli_refuses_a_vit_model_under_a_cnn_arch(tmp_path):
    with pytest.raises(SystemExit, match="does not take --model vit_s_16"):
        main(["lost", "--arch", "resnet", "--model", "vit_s_16", "--data-path", VOC,
              "--device", "cpu", "--output-dir", str(tmp_path)])


def test_cnn_lost_parser_accepts_the_cnn_flags():
    from vipers_torch.cli.main import build_parser

    args = build_parser().parse_args(["lost", "--arch", "resnet", "--model", "resnet50",
                                      "--resnet-dilate", "4", "--cnn-bucket", "2"])
    assert isinstance(args, argparse.Namespace)
    assert (args.arch, args.resnet_dilate, args.cnn_bucket) == ("resnet", 4, 2)
