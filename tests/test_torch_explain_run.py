"""``python -m vipers_torch.cli.main explain --device cpu`` against
``vipers.cli.main explain`` on the CPU, with the CLI tests' tiny ViT and
checkpoints (``tests/torch_explain_fixtures.py``; the flash route at 16
tokens in both packages): GradCAM, Guided-GradCAM, IG and the attention
map (the port also LRP, whose default-eps map is ill conditioned in f32
and held in ``test_torch_explain_models.py``) over a 3-class val
ImageFolder (one class explained), the same file tree (maps and
figures), GradCAM, Guided-GradCAM and attention ``.npy`` maps within 1e-5
of their scale plus 1e-4 relative (IG's noise differs: shapes and finite
values); the sweep mode's per-iteration directories and maps; and
``--untrained`` within the port (the two init RNGs differ).
"""

import os

import numpy as np
import pytest

from PIL import Image

from tests import torch_explain_fixtures as fx
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    yield from fx.register_cli_vit()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    monkeypatch.setenv("VIPERS_JAX_CACHE", "0")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return fx.write_cli_checkpoints(str(tmp_path_factory.mktemp("ckpt")), fx.CLI_NAME)


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(1)
    for cls in ("a_cls", "b_cls", "c_cls"):
        d = root / "val" / cls
        d.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (240, 260, 3), dtype=np.uint8)).save(
                d / f"img_{i}.jpg")
    return str(root)


# ------------------------------------------------------------ explain

@pytest.fixture(scope="module")
def explain_runs(ckpt, imagenet, tmp_path_factory):
    out = tmp_path_factory.mktemp("ex")
    methods = ["gradcam", "guided_gradcam", "ig", "attention"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPERS_FLASH_MIN_T", "16")
        mp.setenv("VIPERS_JAX_CACHE", "0")
        # the JAX package's LRP runs eager, op by op (a minute under a busy
        # test run), and its map is not compared: the port alone runs it
        for pkg, main, extra in (("jax", jmain, []),
                                 ("torch", tmain, ["lrp", "--device", "cpu"])):
            rc, text = fx.run_cli(main, ["explain", "--model", fx.CLI_NAME,
                                         "--checkpoint", ckpt[pkg], "--data-path", imagenet,
                                         "--num-classes-sample", "1", "--output-dir",
                                         str(out / pkg), "--methods", *methods, *extra])
            assert rc == 0 and "explained 1 classes" in text
    return out


def test_explain_writes_the_jax_file_tree(explain_runs):
    tree = fx.file_tree(explain_runs / "jax")
    lrp = ["lrp/a_cls/heatmap_img_0.jpg", "lrp/a_cls/img_0.jpg_nparray.npy"]
    assert fx.file_tree(explain_runs / "torch") == sorted(tree + lrp)
    assert "attention/a_cls/attention_heatmap_img_0.jpg.png" in tree
    assert "ig/a_cls/img_0.jpg_nparray.npy" in tree and len(tree) == 10


@pytest.mark.parametrize("method", ["gradcam", "guided_gradcam", "attention", "ig"])
def test_explain_maps_match_jax(explain_runs, method):
    for cls in ("a_cls",):
        rel = os.path.join(method, cls, "img_0.jpg_nparray.npy")
        got = np.load(explain_runs / "torch" / rel)
        want = np.load(explain_runs / "jax" / rel)
        assert got.shape == want.shape == ((224, 224) if method in ("gradcam", "attention")
                                           else (3, 224, 224))
        if method == "ig":
            assert np.isfinite(got).all()  # another noise draw
        else:
            fx.scaled_close(got, want)


def test_explain_sweep_mode_and_untrained(imagenet, tmp_path):
    """``--pruning-iteration -1 --models-path``: every sweep checkpoint into
    its iteration's directory, in both packages; ``--untrained --seed 3``
    (port only: the init RNGs differ) into ``untrained_model_seed_3``."""
    for it in (0, 2):
        fx.write_cli_checkpoints(str(tmp_path / "sweep" / fx.CLI_NAME),
                                 f"{fx.CLI_NAME}_epoch_0_pruning_iteration_{it:02d}", seed=it)
    for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        # the sweep root holds {model}/ with one package's checkpoints
        root = tmp_path / f"root_{pkg}"
        (root / fx.CLI_NAME).mkdir(parents=True)
        for f in os.listdir(tmp_path / "sweep" / fx.CLI_NAME / pkg):
            os.symlink(tmp_path / "sweep" / fx.CLI_NAME / pkg / f, root / fx.CLI_NAME / f)
        rc, text = fx.run_cli(main, ["explain", "--model", fx.CLI_NAME, "--data-path", imagenet,
                                     "--methods", "gradcam", "--num-classes-sample", "1",
                                     "--pruning-iteration", "-1", "--models-path", str(root),
                                     "--output-dir", str(tmp_path / pkg), *extra])
        assert rc == 0 and text.count("Model filename:") == 2
    tree = fx.file_tree(tmp_path / "jax")
    assert fx.file_tree(tmp_path / "torch") == tree
    assert {t.split("/")[0] for t in tree} == {"pruning_iteration_00", "pruning_iteration_02"}
    for t in tree:
        if t.endswith(".npy"):
            fx.scaled_close(np.load(tmp_path / "torch" / t), np.load(tmp_path / "jax" / t))
    rc, text = fx.run_cli(tmain, ["explain", "--model", fx.CLI_NAME, "--data-path", imagenet,
                                  "--untrained", "--seed", "3", "--methods", "gradcam",
                                  "--num-classes-sample", "1", "--output-dir",
                                  str(tmp_path / "u"), "--device", "cpu"])
    assert rc == 0 and "with seed: 3" in text
    assert fx.file_tree(tmp_path / "u") == [
        "untrained_model_seed_3/gradcam/a_cls/blended_heatmap_img_0.jpg",
        "untrained_model_seed_3/gradcam/a_cls/heatmap_img_0.jpg",
        "untrained_model_seed_3/gradcam/a_cls/img_0.jpg_nparray.npy"]


