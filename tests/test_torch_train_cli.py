"""``python -m vipers_torch.cli.main train|evaluate --device cpu`` against
``vipers.cli.main train|evaluate`` on the CPU, on one ImageFolder.

A tiny ViT (patch 8, 2 blocks, D 64, 2 heads, 2 classes) is registered in
both registries for this module's lifetime; the port's registry entry
draws the JAX driver's initial parameters (``PRNGKey(seed)``, split, flax init), so
both CLIs train the same weights. f32, B = 4, one epoch of 4 steps. Both
CLIs must print the same rows (sparsity, the epoch-end Acc@1, the sweep's
``acc1 ... sparsity ...``) and write the same file names (``.pth`` files
beside the JAX package's orbax directories); the sweep txt the same
accuracies and sparsities, its losses within 1e-5 relative. Also: the
default device raises without a card, and flags that select what the port
lacks exit naming their ROADMAP item.
"""

import contextlib
import dataclasses
import functools
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.core.registry as jreg
import vipers.models.vit as jvit
import vipers_torch.core.registry as treg
import vipers_torch.models.vit as tvit
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain

NAME = "vit_tiny_cli_test"
SEED = 0


@functools.lru_cache(maxsize=None)
def _jax_initial_params(image_size, num_classes):
    """The parameters ``vipers.train.driver.build_session`` starts from."""
    spec = jvit._build(NAME, jvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(SEED))
    variables = jreg.init_variables(spec.module, {"params": init_rng, "dropout": init_rng},
                                    jnp.zeros((1, *image_size, 3), jnp.float32), train=False)
    return jax.tree.map(lambda a: np.array(a, np.float32), variables["params"])


@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    jreg.list_models()
    treg._ensure_builtins_imported()

    def jbuild(num_classes=1000, image_size=(224, 224)):
        return jvit._build(NAME, jvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)

    def tbuild(num_classes=1000, image_size=(224, 224)):
        spec = tvit._build(NAME, tvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)
        return dataclasses.replace(
            spec, init=lambda gen: _jax_initial_params(tuple(image_size), num_classes))

    jreg._BUILTIN_MODELS[NAME] = jbuild
    treg._BUILTIN_MODELS[NAME] = tbuild
    yield
    del jreg._BUILTIN_MODELS[NAME], treg._BUILTIN_MODELS[NAME]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("clids")
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 4)):
        for cls in ("class_a", "class_b"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
                if cls == "class_b":
                    arr[..., 1] = np.minimum(arr[..., 1].astype(np.int16) + 80,
                                             255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"img_{i}.jpg")
    return str(root)


def _common(data):
    return ["--model", NAME, "--data-path", data, "--num-classes", "2", "--batch-size", "4",
            "--epochs", "1", "--train-crop-size", "32", "--val-resize-size", "40",
            "--val-crop-size", "32", "--lr", "0.01", "--workers", "2", "--print-freq", "0",
            "--seed", str(SEED)]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


ROW = re.compile(r"^(Sparsity after SNIP|Pruning iteration|Test: Acc@1|acc1 )")


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPERS_JAX_CACHE", "0")  # no persistent compile cache from the JAX CLI
        for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
            snip = _run(main, ["train", *_common(data), "--pruning-method", "snip",
                               "--target-sparsity", "0.5",
                               "--output-dir", str(out / pkg / "snip"), *extra])
            lrr = _run(main, ["train", *_common(data), "--pruning-method", "magnitude",
                              "--pruning-rate", "0.5", "--pruning-threshold", "70",
                              "--output-dir", str(out / pkg / "lrr"), *extra])
            ev = _run(main, ["evaluate", *_common(data), "--models-path", str(out / pkg / "lrr"),
                             "--output-dir", str(out / pkg / "eval"), *extra])
            res[pkg] = dict(snip=snip, lrr=lrr, eval=ev, out=out / pkg)
    return res


def _stems(d):
    return sorted(n[:-len(".pth")] if n.endswith(".pth") else n for n in os.listdir(d))


@pytest.mark.parametrize("run", ["snip", "lrr", "eval"])
def test_cli_prints_the_jax_rows(runs, run):
    got = [ln for ln in runs["torch"][run] if ROW.match(ln)]
    want = [ln for ln in runs["jax"][run] if ROW.match(ln)]
    assert got == want and len(got) >= 2, (got, want)


def test_cli_writes_the_jax_file_names(runs):
    for run in ("snip", "lrr", "eval"):
        t, j = runs["torch"]["out"] / run, runs["jax"]["out"] / run
        assert _stems(t) == _stems(j), run
        if run != "eval":
            assert all(n.endswith(".pth") for n in os.listdir(t) if "_epoch_" in n
                       or "_checkpoint_" in n)
            assert all(os.path.isdir(j / n) for n in os.listdir(j) if "_epoch_" in n)
    assert f"{NAME}_epoch_0_pruning_iteration_01" in _stems(runs["torch"]["out"] / "lrr")
    for name in ("performance.txt", f"{NAME}_dilation_1.txt"):
        lines = [(runs[p]["out"] / "eval" / name).read_text().splitlines() for p in ("torch", "jax")]
        assert len(lines[0]) == len(lines[1]) >= 3
        for g, w in zip(*lines):
            gs, ws = g.replace("\t", " ").split(), w.replace("\t", " ").split()
            if gs[0].endswith("loss"):
                assert abs(float(gs[1]) - float(ws[1])) <= 1e-5 * abs(float(ws[1]))
                gs, ws = gs[2:], ws[2:]
            assert gs == ws, (g, w)
    assert (runs["torch"]["out"] / "lrr" / "performance.txt").read_text() == \
        (runs["jax"]["out"] / "lrr" / "performance.txt").read_text()


def test_train_and_evaluate_default_device_raise_without_a_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    for cmd in ("train", "evaluate"):
        out = tmp_path / cmd
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmain([cmd, *_common(data), "--output-dir", str(out)])
        assert not out.exists()


@pytest.mark.parametrize("argv,item", [
    (["--model", "mobilenet_v2", "--data-parallel"], "DP"),  # mobilenet passes it too
    (["--model", "resnet50", "--data-parallel"], "DP"),  # the CNNs pass the model check
    (["--model", "swin_v2_t", "--data-parallel"], "DP"),  # and Swin
    (["--model", "dino_vit_small"], "A2"),
    (["--model", "quantized_resnet18", "--debug-nans"], "A11"),  # so do the aliases
    (["--model", "resnet18", "--resnet-dilate", "2", "--debug-nans"], "A11"),
    (["--model", NAME, "--pipeline-parallel", "2"], "JAX"),
    (["--model", NAME, "--pp-remat"], "JAX"),
    (["--model", NAME, "--pp-data", "2"], "JAX"),
    (["--model", NAME, "--pp-microbatch", "2"], "JAX"),
    (["--model", NAME, "--data-parallel"], "DP"),
    (["--model", NAME, "--model-parallel", "2"], "JAX"),
    (["--model", NAME, "--profile-dir", "trace"], "A11"),
    (["--model", NAME, "--debug-nans"], "A11"),
])
@pytest.mark.parametrize("cmd", ["train", "evaluate"])
def test_unported_flags_exit_naming_their_item(cmd, argv, item, tmp_path):
    """DINO training (A2) exits naming its item. ``--profile-dir`` and
    ``--debug-nans`` (A11), ``--data-parallel`` (DP) and tensor and
    pipeline parallelism (JAX: A10 is ported) pass the check (their runs:
    ``tests/test_torch_profiling.py``, ``tests/test_torch_multiprocess.py``,
    ``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_pipeline_parallel.py``); ``train`` then meets the JAX
    driver's layout checks, which one process fails for ``--model-parallel
    2`` and ``--pipeline-parallel 2``, while ``evaluate`` ignores the flags,
    as the JAX sweep does, and so does ``train`` the ``--pp-*`` flags
    without ``--pipeline-parallel``."""
    argv = [cmd, *argv, "--output-dir", str(tmp_path / "out"), "--device", "cpu"]
    if item in ("A11", "DP", "JAX"):
        from vipers_torch.cli.main import build_parser
        from vipers_torch.core.config import config_from_args, refuse_unported

        cfg = config_from_args(build_parser().parse_args(argv))
        assert refuse_unported(cfg, cmd) is None
        if item != "JAX" or cmd != "train":
            return
        from vipers_torch.train.driver import model_spec, parallel_layout

        spec = model_spec(cfg, cfg.train_crop_size)
        want = {"--pipeline-parallel": "--pipeline-parallel 2 needs 2 devices, have 1",
                "--model-parallel": "1 devices not divisible by model_parallel=2"}.get(argv[3])
        if want:
            with pytest.raises(SystemExit, match=want):
                parallel_layout(cfg, spec)
        else:
            assert parallel_layout(cfg, spec) is None
        return
    with pytest.raises(SystemExit, match=rf"not ported yet \(ROADMAP {item}\)"):
        tmain(argv)


@pytest.mark.parametrize("model", ["vgg16", "vgg16_bottom"])
def test_vgg_training_exits_naming_a8(model, tmp_path):
    """VGG trains with dropout in the JAX package, and now in the port
    (ROADMAP A8 is done): nothing refuses it."""
    from vipers_torch.core.config import TrainConfig, refuse_unported

    assert refuse_unported(TrainConfig(model=model, device="cpu")) is None


def test_resnet_dilate_applies_to_resnets_only():
    """``--resnet-dilate`` builds a dilated ResNet and is ignored for a
    ViT, as the JAX driver ignores it there."""
    from vipers_torch.core.config import TrainConfig, refuse_unported
    from vipers_torch.train.driver import model_spec

    for model, want in (("resnet50", (False, True, True)), (NAME, None)):
        cfg = TrainConfig(model=model, num_classes=2, resnet_dilate=4, device="cpu")
        refuse_unported(cfg)
        spec = model_spec(cfg, 32)
        got = getattr(spec.cfg, "replace_stride_with_dilation", None)
        assert got == want and spec.num_classes == 2


def test_slimmed_resume_exits_naming_a4(data, tmp_path):
    """Structured slimming (ROADMAP A4) is ported, so ``train --resume`` of
    a slimmed checkpoint no longer exits: a masked dense ``.pth`` of the
    tiny ViT, slimmed by ``vipers_torch slim`` (mlp 64, 1 head of 32),
    fine-tunes one LRR iteration at the sidecar's widths; every checkpoint
    the session writes carries the sidecar and holds the slim widths, and
    ``evaluate`` of that output takes them."""
    from vipers.pruning import init_masks, magnitude_prune
    from vipers_torch.core.checkpoint import (export_vit_torchvision, load_train_checkpoint,
                                              save_torch_state_dict)
    from vipers_torch.pruning.structured import arch_sidecar
    from vipers_torch.train.driver import model_spec
    from vipers_torch.core.config import TrainConfig

    params = _jax_initial_params((32, 32), 2)
    masks = {p: np.asarray(m) for p, m in magnitude_prune(
        params, init_masks(params, exclude=("qkv",)), 0.5).items()}
    dense = str(tmp_path / "dense.pth")
    save_torch_state_dict(export_vit_torchvision(params, masks, bake_masks=False), dense)
    _run(tmain, ["slim", "--model", NAME, "--checkpoint", dense, "--num-classes", "2",
                 "--mlp-keep", "0.5", "--heads-keep", "0.5", "--round-to", "1",
                 "--output-dir", str(tmp_path)])
    slim = str(tmp_path / f"{NAME}_slim_m64_h1.pth")
    arch = {"mlp_dim": 64, "num_heads": 1, "head_dim": 32}
    assert arch_sidecar(slim) == arch
    out = tmp_path / "out"
    lines = _run(tmain, ["train", *_common(data), "--resume", slim, "--pruning-method",
                         "magnitude", "--pruning-rate", "0.5", "--pruning-threshold", "60",
                         "--device", "cpu", "--output-dir", str(out)])
    assert f"slim architecture: {arch}" in lines
    assert any(ln.startswith("Test: Acc@1") for ln in lines)
    written = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
    assert written == [f"{NAME}_checkpoint_pruning_iteration_00.pth",
                       f"{NAME}_epoch_0_pruning_iteration_00.pth"]
    spec = model_spec(TrainConfig(model=NAME, num_classes=2), 32, arch)
    for name in written:
        assert arch_sidecar(str(out / name)) == arch
        ck = load_train_checkpoint(str(out / name), spec)
        layer = ck["params"]["encoder_layer_1"]
        assert layer["attention"]["qkv"]["kernel"].shape == (64, 96)
        assert layer["mlp"]["fc1"]["kernel"].shape == (64, 64)
    ev = _run(tmain, ["evaluate", *_common(data), "--models-path", str(out),
                      "--output-dir", str(tmp_path / "eval"), "--device", "cpu"])
    assert sum(ln.startswith("acc1 ") for ln in ev) == 1


def test_evaluate_voc_branch_matches_jax(tmp_path):
    """``evaluate --eval-dataset voc`` on the committed 8-image VOC fixture:
    a 20-class tiny ViT (the JAX initial weights, a 50% magnitude mask) as
    the JAX package's orbax checkpoint and as the port's ``.pth``; both
    CLIs print the same rows and write the same ``voc/`` lines."""
    import torch as _torch

    from vipers.core.checkpoint import save_checkpoint
    from vipers.pruning import init_masks, magnitude_prune
    from vipers_torch.core.checkpoint import export_vit_torchvision

    voc = os.path.join(os.path.dirname(__file__), "data", "torch_voc")
    params = _jax_initial_params((32, 32), 20)
    spec = jvit._build(NAME, jvit.ViTConfig(8, 2, 2, 64, 128, 20), (32, 32))
    masks = {p: np.asarray(m) for p, m in magnitude_prune(
        params, init_masks(params, exclude=spec.prune_exclude), 0.5).items()}
    stem = f"{NAME}_epoch_0_pruning_iteration_00"
    save_checkpoint(str(tmp_path / "jax" / stem),
                    {"params": params, "masks": {"/".join(k): v for k, v in masks.items()}})
    os.makedirs(tmp_path / "torch")
    _torch.save({"model": {k: _torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                           export_vit_torchvision(params, masks, bake_masks=False).items()}},
                tmp_path / "torch" / f"{stem}.pth")
    common = ["evaluate", "--model", NAME, "--num-classes", "20", "--eval-dataset", "voc",
              "--data-path", voc, "--batch-size", "4", "--train-crop-size", "32",
              "--val-resize-size", "40", "--val-crop-size", "32", "--workers", "2"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPERS_JAX_CACHE", "0")
        for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
            lines = _run(main, [*common, "--models-path", str(tmp_path / pkg),
                                "--output-dir", str(tmp_path / f"{pkg}_eval"), *extra])
            out[pkg] = [ln for ln in lines if ROW.match(ln)]
    assert out["torch"] == out["jax"] and len(out["torch"]) == 2, out
    assert "sparsity 50.00" in out["torch"][-1]
    txt = [(tmp_path / f"{p}_eval" / f"{NAME}_dilation_1.txt").read_text().split()
           for p in ("torch", "jax")]
    assert txt[0][0] == txt[1][0] == "voc/acc1" and len(txt[0]) == len(txt[1]) == 12
    for i, (g, w) in enumerate(zip(*txt)):
        if i == 9:  # the loss
            assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))
        else:
            assert g == w, (i, g, w)


def test_evaluate_amp_runs_in_f32_as_jax(data, tmp_path):
    """``evaluate --amp`` evaluates in f32 in both packages (the JAX sweep
    builds its eval step at the default f32 whatever ``--amp`` says): on
    the same two ``.pth`` files of a resnet18 sweep (seed-0 weights, dense,
    then a 50% magnitude mask), both CLIs print the same rows and write the
    same accuracies and sparsities, the losses within 1e-5 relative (a bf16
    eval misses that)."""
    from vipers_torch.core.checkpoint import export_resnet, save_torch_state_dict
    from vipers_torch.core.registry import build_model
    from vipers_torch.pruning import init_masks, magnitude_prune

    params = build_model("resnet18", num_classes=2).init(torch.Generator().manual_seed(0))
    masks = magnitude_prune(params, init_masks(params), amount=0.5)
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for it, m in enumerate((None, masks)):
        save_torch_state_dict(export_resnet(params, masks=m, bake_masks=False),
                              sweep / f"resnet18_epoch_0_pruning_iteration_{it:02d}.pth")
    common = ["evaluate", *_common(data)[2:], "--model", "resnet18", "--amp",
              "--models-path", str(sweep)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPERS_JAX_CACHE", "0")
        for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
            lines = _run(main, [*common, "--output-dir", str(tmp_path / pkg), *extra])
            out[pkg] = [ln for ln in lines if ROW.match(ln)]
    assert out["torch"] == out["jax"] and len(out["torch"]) == 4, out
    assert "sparsity 50.00" in out["torch"][-1]
    for name in ("performance.txt", "resnet18_dilation_1.txt"):
        lines = [(tmp_path / p / name).read_text().split() for p in ("torch", "jax")]
        assert len(lines[0]) == len(lines[1]) >= 6
        for i, (g, w) in enumerate(zip(*lines)):
            if name != "performance.txt" and i % 4 == 1 and "loss" in lines[1][i - 1]:
                assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)), (i, g, w)
            else:
                assert g == w, (name, i, g, w)
