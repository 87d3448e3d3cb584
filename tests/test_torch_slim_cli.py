"""``python -m vipers_torch.cli.main slim --device``-free host slimming and
the entry points that take its output, against ``vipers.cli.main`` on the
CPU.

The CLI tests' tiny ViT (``tests/torch_explain_fixtures.py``: patch 16, 2
blocks, D 64, 2 heads of 32, mlp 128, 10 classes) is registered in both
registries for this module's lifetime, and narrowed VGG16 and Swin-V2
(``vgg16_slim_cli_test``, ``swin_slim_cli_test``) in the port's. Weights:
the port's initial parameters (seed 0) with N(0, 0.02) on every leaf;
the ViT's residual output kernels (attention ``out``, ``fc2``) scaled by
0.2 so LOST's boxes are smaller than the image (as in
``tests/test_torch_lost_cli.py``); masks that make half the MLP neurons
and one head of each block inert (their downstream rows zero), on top of
a 50% global magnitude mask, so ``--mlp-keep 0.5 --heads-keep 0.5`` is an
exact slim. The port reads and writes ``.pth``; the JAX package the same
weights as an orbax directory.

What is held: the files ``slim`` writes for the four families (the
``.pth`` loads strictly into the module rebuilt from the sidecar); ``lost
--checkpoint <slim>`` gives the masked dense checkpoint's boxes box for
box, and ``vipers lost`` on the JAX package's slim of the same weights the
same boxes; ``evaluate`` over dense and slim checkpoints, flat and under
``{model}/``; a slim of a slim merges the sidecars; a DINO tree is
refused; each package reads the other's sidecar. ``train --resume`` and
``explain-eval`` of a slim checkpoint are held in
``tests/test_torch_train_cli.py`` and ``tests/test_torch_explain_cli.py``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import vipers.pruning.structured as js
import vipers_torch.core.registry as treg
import vipers_torch.pruning.structured as ts
from tests import torch_explain_fixtures as fx
from vipers.cli.main import main as jmain
from vipers.pruning import init_masks, magnitude_prune
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict, unflatten_dict
from vipers_torch.models import swin as tswin
from vipers_torch.models import vgg as tvgg

VGG_NAME, SWIN_NAME = "vgg16_slim_cli_test", "swin_slim_cli_test"
VIT_SLIM = ["--mlp-keep", "0.5", "--heads-keep", "0.5", "--round-to", "1"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def tiny_models():
    treg._ensure_builtins_imported()
    treg._BUILTIN_MODELS[VGG_NAME] = lambda num_classes=5, input_size=(224, 224): tvgg._spec(
        VGG_NAME, tvgg.VGGConfig(num_classes, conv_widths=(8,) * 13, fc_dims=(16, 16)),
        input_size)
    treg._BUILTIN_MODELS[SWIN_NAME] = lambda num_classes=10, input_size=(64, 64): \
        tswin.swin_spec(SWIN_NAME, tswin.SwinV2Config(embed_dim=24, depths=(2, 2, 2, 2),
                                                      num_heads=(3, 3, 6, 6),
                                                      num_classes=num_classes), input_size)
    yield from fx.register_cli_vit()
    del treg._BUILTIN_MODELS[VGG_NAME], treg._BUILTIN_MODELS[SWIN_NAME]


def _np_tree(tree):
    return unflatten_dict({p: np.asarray(a, np.float32) for p, a in flatten_dict(tree).items()})


def vit_weights(num_classes=10, image_size=(224, 224)):
    """The tiny ViT's perturbed seed-0 params (residual outputs x 0.2) and
    its masks: 50% global magnitude, then half of each block's fc2 rows and
    head 1's out rows zero."""
    params = fx.cli_params(0, num_classes, image_size)
    flat = flatten_dict(params)
    for path in flat:
        if path[-1] == "kernel" and path[-2] in ("out", "fc2"):
            flat[path] = flat[path] * np.float32(0.2)
    params = unflatten_dict(flat)
    masks = {p: np.asarray(m) for p, m in magnitude_prune(
        params, init_masks(params, exclude=("qkv",)), 0.5).items()}
    r = np.random.default_rng(3)
    for i in range(2):
        layer = f"encoder_layer_{i}"
        fc2 = (layer, "mlp", "fc2", "kernel")
        masks[fc2] = masks[fc2].copy()
        masks[fc2][np.sort(r.choice(128, 64, replace=False))] = False
        out = (layer, "attention", "out", "kernel")
        masks[out] = masks[out].copy()
        masks[out][32:64] = False
    return params, masks


def write_vit(root, stem, num_classes=10, image_size=(224, 224)):
    """The tiny ViT's masked weights as the port's ``.pth`` and the JAX
    package's orbax directory: {"torch": path, "jax": path}."""
    from vipers.core.checkpoint import save_checkpoint

    params, masks = vit_weights(num_classes, image_size)
    os.makedirs(root / "torch", exist_ok=True)
    pth = str(root / "torch" / f"{stem}.pth")
    tck.save_torch_state_dict(tck.export_vit_torchvision(params, masks, bake_masks=False), pth)
    orbax = str(root / "jax" / stem)
    save_checkpoint(orbax, {"params": params,
                            "masks": {"/".join(k): v for k, v in masks.items()}})
    return {"torch": pth, "jax": orbax}


def slim(pkg, ckpt, out, model=fx.CLI_NAME, extra=VIT_SLIM, classes="10"):
    """(exit code, stdout) of ``slim`` in the package ``pkg``."""
    main = tmain if pkg == "torch" else jmain
    return fx.run_cli(main, ["slim", "--model", model, "--checkpoint", ckpt,
                             "--num-classes", classes, *extra, "--output-dir", str(out)])


def _cnn_pth(root, name, spec):
    params = fx._perturbed(_np_tree(spec.init(torch.Generator().manual_seed(0))))
    sd = tck.family(spec).export_pth(params, None, {}, True)
    path = str(root / f"{name}.pth")
    tck.save_torch_state_dict(sd, path)
    return path


@pytest.mark.parametrize("model,extra,tag,want", [
    (fx.CLI_NAME, VIT_SLIM, "m64_h1", {"mlp_dim": 64, "num_heads": 1, "head_dim": 32}),
    ("resnet18", ["--inner-keep", "0.5", "--round-to", "1"], "i50", None),
    (VGG_NAME, ["--conv-keep", "0.5", "--fc-keep", "0.5", "--round-to", "1"], "c50_f50",
     {"conv_widths": [4] * 13, "fc_dims": [8, 8]}),
    (SWIN_NAME, ["--mlp-keep", "0.5", "--round-to", "1"], "m50", None)])
def test_slim_writes_pth_and_sidecar(tmp_path, model, extra, tag, want):
    """``slim`` writes ``{model}_slim_{tag}.pth`` (masked layers as
    ``weight_orig`` / ``weight_mask``) and its ``.slim.json``, and the
    ``.pth`` loads strictly into the module rebuilt from the sidecar."""
    if model == fx.CLI_NAME:
        src = write_vit(tmp_path, "dense")["torch"]
    else:
        src = _cnn_pth(tmp_path, "dense", tbuild(model, num_classes=10))
    rc, out = slim("torch", src, tmp_path / "slim", model, extra)
    assert rc == 0 and f"slimmed {model}: " in out, out
    path = tmp_path / "slim" / f"{model}_slim_{tag}.pth"
    assert out.strip().endswith(f"wrote {path}")
    side = json.loads((tmp_path / "slim" / f"{model}_slim_{tag}.pth.slim.json").read_text())
    assert side["model"] == model
    arch = side["arch_overrides"]
    if want is not None:
        assert arch == want
    if model == "resnet18":
        assert arch["inner_widths"] == {f"layer{s}_{b}": 32 * 2 ** (s - 1)
                                        for s in range(1, 5) for b in range(2)}
    if model == SWIN_NAME:
        assert arch["mlp_dims"]["stage0_block0"] == 48 and len(arch["mlp_dims"]) == 8
    assert ts.arch_sidecar(str(path)) == arch
    sd = torch.load(path, weights_only=False)
    assert any(k.endswith("_mask") for k in sd) == (model == fx.CLI_NAME)
    spec = tbuild(model, num_classes=10, arch_overrides=arch)
    params, stats, masks = tck.family(spec).import_pth(tck.load_torch_state_dict(str(path)),
                                                       spec)
    module = spec.module()
    module.load_state_dict({**dict(module.named_buffers()),
                            **tck.family(spec).state_dict(params, stats, masks)})


def test_nothing_to_slim_and_other_families_exit_1(tmp_path):
    ck = write_vit(tmp_path, "dense")
    rc, out = slim("torch", ck["torch"], tmp_path / "o", extra=[])
    assert rc == 1 and out.startswith("nothing to slim")
    rc_j, out_j = slim("jax", ck["jax"], tmp_path / "j", extra=[])
    assert rc_j == 1 and out.strip() in out_j
    assert not (tmp_path / "o").exists()


def test_dino_tree_is_refused(tmp_path):
    """A DINO tree has no ``encoder_layer_*``: ``slim_vit`` raises the JAX
    package's error, and ``slim --model dino_vit_tiny`` exits 1 naming the
    families it takes."""
    spec = tbuild("dino_vit_tiny")
    params = _np_tree(spec.init(torch.Generator().manual_seed(0)))
    for pkg in (ts, js):
        with pytest.raises(ValueError, match="no encoder_layer_\\* params.*DINO backbones"):
            pkg.slim_vit({"params": params}, {}, spec.cfg, mlp_keep=0.5)
    path = str(tmp_path / "dino.pth")
    tck.save_torch_state_dict(tck.export_dino_vit(params), path)
    rc, out = slim("torch", path, tmp_path / "o", model="dino_vit_tiny", classes="0")
    assert rc == 1 and "family 'dino_vit'" in out


def test_reslim_merges_the_sidecars(tmp_path):
    """slim -> slim again: the second pass builds at the first's widths and
    its sidecar holds both passes' overrides, in both packages."""
    ck = write_vit(tmp_path, "dense")
    got = {}
    for pkg in ("torch", "jax"):
        rc, _ = slim(pkg, ck[pkg], tmp_path / pkg / "a", extra=["--mlp-keep", "0.5",
                                                             "--round-to", "1"])
        assert rc == 0
        first = os.path.join(tmp_path / pkg / "a", f"{fx.CLI_NAME}_slim_m64_h2")
        first += ".pth" if pkg == "torch" else ""
        rc, _ = slim(pkg, first, tmp_path / pkg / "b", extra=["--heads-keep", "0.5",
                                                           "--round-to", "1"])
        assert rc == 0
        second = os.path.join(tmp_path / pkg / "b", f"{fx.CLI_NAME}_slim_m64_h1")
        second += ".pth" if pkg == "torch" else ""
        got[pkg] = (ts if pkg == "torch" else js).arch_sidecar(second)
    assert got["torch"] == got["jax"] == {"mlp_dim": 64, "num_heads": 1, "head_dim": 32}


def test_each_package_reads_the_others_sidecar(tmp_path):
    arch = {"inner_widths": {"layer1_0": [32, 48]}, "mlp_dim": 461}
    ts.write_sidecar(str(tmp_path / "t.pth"), "resnet50", arch)
    js.write_sidecar(str(tmp_path / "j.pth"), "resnet50", arch)
    assert (tmp_path / "t.pth.slim.json").read_bytes() == (tmp_path / "j.pth.slim.json").read_bytes()
    assert js.arch_sidecar(str(tmp_path / "t.pth")) == ts.arch_sidecar(str(tmp_path / "j.pth"))
    assert ts.arch_sidecar(str(tmp_path / "t.pth")) == arch
    (tmp_path / "d").mkdir()
    js.write_sidecar(str(tmp_path / "d" / "ck"), "m", arch)
    os.makedirs(tmp_path / "d" / "ck2")
    os.replace(tmp_path / "d" / "ck.slim.json", tmp_path / "d" / "ck2" / "slim.json")
    assert ts.arch_sidecar(str(tmp_path / "d" / "ck2") + "/") == arch


# ------------------------------------------------------------------- lost

def _voc(root):
    """Two 96 x 128 JPEGs (one bucket) with a dark striped block on a
    bright ground, VOC07 layout."""
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(root / sub, exist_ok=True)
    r = np.random.default_rng(0)
    names = []
    for i in range(2):
        h, w = 96, 128
        arr = r.integers(200, 240, (h, w, 3)).astype(np.float64)
        yy, xx = np.mgrid[0:40, 0:48]
        arr[16:56, 24 + 16 * i:72 + 16 * i] = np.where((((xx + yy) // 6) % 2)[..., None] == 1,
                                                       30.0, 5.0)
        name = f"im{i:03d}"
        names.append(name)
        Image.fromarray(arr.astype(np.uint8)).save(root / "JPEGImages" / f"{name}.jpg")
        (root / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width>"
            f"<height>{h}</height><depth>3</depth></size><object><name>thing</name>"
            "<truncated>0</truncated><difficult>0</difficult><bndbox><xmin>25</xmin>"
            "<ymin>17</ymin><xmax>72</xmax><ymax>56</ymax></bndbox></object></annotation>")
    (root / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(names))
    return str(root)


def test_lost_on_an_exact_slim_gives_the_dense_boxes(tmp_path, monkeypatch):
    """``lost --checkpoint <slim>.pth``: the sidecar rebuilds the model at
    its widths (``slim architecture: ...``), and on an exact slim the
    boxes equal the masked dense checkpoint's, box for box; ``vipers
    lost`` on the JAX package's slim of the same weights gives the same
    boxes."""
    monkeypatch.setenv("VIPERS_JAX_CACHE", "0")
    data = _voc(tmp_path / "voc")
    ck = write_vit(tmp_path, "dense")
    slim_ck = {}
    for pkg in ("torch", "jax"):
        rc, _ = slim(pkg, ck[pkg], tmp_path / "slim" / pkg)
        assert rc == 0
        slim_ck[pkg] = os.path.join(tmp_path / "slim" / pkg, f"{fx.CLI_NAME}_slim_m64_h1")
    slim_ck["torch"] += ".pth"

    def lost(main, ckpt, out, extra=()):
        rc, text = fx.run_cli(main, ["lost", "--model", fx.CLI_NAME, "--data-path", data,
                                     "--checkpoint", ckpt, "--output-dir", str(out),
                                     "--batch-size", "2", *extra])
        assert rc == 0
        with open(out / "preds.pkl", "rb") as f:
            return pickle.load(f), text

    dense, _ = lost(tmain, ck["torch"], tmp_path / "dense", ["--device", "cpu"])
    got, text = lost(tmain, slim_ck["torch"], tmp_path / "got", ["--device", "cpu"])
    want, _ = lost(jmain, slim_ck["jax"], tmp_path / "want")
    assert "slim architecture: {'mlp_dim': 64, 'num_heads': 1, 'head_dim': 32}" in text
    assert sorted(got) == sorted(dense) == sorted(want) and len(got) == 2
    for k in got:
        np.testing.assert_array_equal(got[k], dense[k])
        np.testing.assert_array_equal(got[k], want[k])
    for x0, y0, x1, y1 in got.values():  # boxes smaller than the 128 x 96 image
        assert (x1 - x0) * (y1 - y0) < 128 * 96


# --------------------------------------------------------------- evaluate

def _imagefolder(root):
    rng = np.random.default_rng(1)
    for cls in ("class_a", "class_b"):
        d = root / "val" / cls
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                d / f"img_{i}.jpg")
    return str(root)


def test_evaluate_mixes_dense_and_slim_checkpoints(tmp_path):
    """A sweep with a dense checkpoint (flat) and exact slims of it, flat
    and under ``{model}/``: each evaluated at its own widths, the slims'
    rows equal to the dense one's (accuracy, and the loss within 1e-5);
    the sidecars are not taken as checkpoints."""
    data = _imagefolder(tmp_path / "data")
    sweep = tmp_path / "sweep"
    ck = write_vit(tmp_path, f"{fx.CLI_NAME}_epoch_0_pruning_iteration_00", 2, (32, 32))
    sweep.mkdir()
    os.replace(ck["torch"], sweep / f"{fx.CLI_NAME}_epoch_0_pruning_iteration_00.pth")
    dense = str(sweep / f"{fx.CLI_NAME}_epoch_0_pruning_iteration_00.pth")
    assert slim("torch", dense, sweep, classes="2")[0] == 0
    sub = sweep / fx.CLI_NAME
    assert slim("torch", dense, sub, extra=["--mlp-keep", "0.5", "--round-to", "1"],
                classes="2")[0] == 0
    rc, out = fx.run_cli(tmain, [
        "evaluate", "--model", fx.CLI_NAME, "--data-path", data, "--num-classes", "2",
        "--batch-size", "3", "--train-crop-size", "32", "--val-resize-size", "40",
        "--val-crop-size", "32", "--workers", "1", "--models-path", str(sweep),
        "--output-dir", str(tmp_path / "eval"), "--device", "cpu"])
    assert rc == 0
    rows = [ln.split()[1] for ln in out.splitlines() if ln.startswith("acc1 ")]
    assert len(rows) == 3 and len(set(rows)) == 1, out
    names = [ln.split(":")[0] for ln in out.splitlines() if ": sparsity" in ln]
    assert [os.path.basename(n) for n in names] == [
        f"{fx.CLI_NAME}_epoch_0_pruning_iteration_00.pth", f"{fx.CLI_NAME}_slim_m64_h2.pth",
        f"{fx.CLI_NAME}_slim_m64_h1.pth"]
    lines = (tmp_path / "eval" / f"{fx.CLI_NAME}_dilation_1.txt").read_text().splitlines()
    losses = [float(ln.split()[1]) for ln in lines if ln.startswith("test/loss")]
    assert len(losses) == 3 and max(losses) - min(losses) <= 1e-5 * abs(losses[0])


def test_bench_slim_tool_runs_on_the_cpu(capsys):
    """``vipers_torch.tools.bench_slim`` at one block and one image on the
    CPU: the JAX tool's JSON keys, the slim widths of ``slim --mlp-keep
    0.5 --heads-keep 0.5`` (mlp 768, 4 heads) and positive rates."""
    from vipers_torch.tools import bench_slim

    out = bench_slim.main(["--device", "cpu", "--layers", "1", "--batch", "1",
                           "--n-batches", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["overrides"] == {"mlp_dim": 768, "num_heads": 4, "head_dim": 64}
    assert out["param_reduction_pct"] > 0
    for dt in ("bf16", "f32"):
        assert out[dt]["dense_masked"] > 0 and out[dt]["slim"] > 0


@pytest.mark.parametrize("fam,model,arch,extra", [
    ("resnet18", "resnet18", "resnet", ["--inner-keep", "0.75"]),
    ("swin", SWIN_NAME, "swin", ["--mlp-keep", "0.5"])])
def test_lost_takes_a_slim_cnn_and_swin(tmp_path, fam, model, arch, extra):
    """The sidecar holds on the CNN pipeline and on the per-image path
    (Swin): an exact slim of ``tests/test_torch_structured.py``'s masked
    trees gives the masked dense checkpoint's boxes."""
    from tests.test_torch_structured import case

    spec, variables, masks, _d, _kw, _x = case(fam)
    dense = str(tmp_path / "dense.pth")
    tck.save_torch_state_dict(tck.family(spec).export_pth(
        variables["params"], variables.get("batch_stats"), masks, False), dense)
    classes = str(tck.infer_num_classes(variables["params"]))
    rc, _ = slim("torch", dense, tmp_path, model, [*extra, "--round-to", "1"], classes)
    assert rc == 0
    (pth,) = [p for p in os.listdir(tmp_path) if "_slim_" in p and p.endswith(".pth")]
    data = _voc(tmp_path / "voc")
    preds = {}
    for name, ck in (("dense", dense), ("slim", str(tmp_path / pth))):
        rc, text = fx.run_cli(tmain, ["lost", "--arch", arch, "--model", model, "--data-path",
                                      data, "--checkpoint", ck, "--output-dir",
                                      str(tmp_path / name), "--batch-size", "2", "--device",
                                      "cpu"])
        assert rc == 0 and ("slim architecture" in text) == (name == "slim")
        with open(tmp_path / name / "preds.pkl", "rb") as f:
            preds[name] = pickle.load(f)
    assert sorted(preds["slim"]) == sorted(preds["dense"]) and len(preds["slim"]) == 2
    for k in preds["dense"]:
        np.testing.assert_array_equal(preds["slim"][k], preds["dense"][k])
