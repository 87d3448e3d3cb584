"""``python -m vipers_torch.cli.main explain-eval | explain-eval-batch
--device cpu`` against ``vipers.cli.main`` on the CPU, and the explain
subcommands' parsers and refusals.

The CLI tests' tiny ViT (``tests/torch_explain_fixtures.py``: patch 16, 2
blocks, D 64, 2 heads of 32, 10 classes, pos table at 224) is registered
in both registries for this module's lifetime; both CLIs load the same
weights (perturbed seed-0 weights with a 50% magnitude mask): the port a
``.pth`` written by its exporter, the JAX package an orbax directory. Both
packages' flash threshold is 16 tokens, so the ViT's first block takes
the flash route.

What is held:
  * ``explain-eval`` on a small VOC root (two JPEGs padded to 64 x 96,
    masks drawn from boxes): the same files, GradCAM's and the attention
    map's RMA/RRA within 1e-6, IG's structure (its SmoothGrad noise is
    drawn differently, the one documented difference); on the same
    heatmaps (``compute_heatmaps`` replaced by one stub in both) the files
    byte for byte;
  * ``explain-eval-batch``: its four files byte for byte;
  * ``explain-eval`` of a structurally slimmed checkpoint against the
    JAX package's on its slim of the same weights;
  * the models once refused (the DINO ViTs, MobileNetV2) explained, the
    default device raising without a card, the parsers' flags and
    defaults.
"""


import numpy as np
import pytest
import torch
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
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClass").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(60, 90), (58, 84), (70, 50)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"00000{i}.jpg")
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4: 3 * h // 4, w // 5: w // 2] = 15
        Image.fromarray(mask).save(root / "SegmentationClass" / f"00000{i}.png")
    return str(root)


def _numbers(path):
    return [float(line.split(":")[-1]) if ":" in line else line
            for line in open(path).read().splitlines()]


# ------------------------------------------------------------ explain-eval

@pytest.fixture(scope="module")
def eval_runs(ckpt, voc, tmp_path_factory):
    out = tmp_path_factory.mktemp("ee")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIPERS_FLASH_MIN_T", "16")
        mp.setenv("VIPERS_JAX_CACHE", "0")
        for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
            rc, _ = fx.run_cli(main, ["explain-eval", "--model", fx.CLI_NAME,
                                      "--checkpoint", ckpt[pkg], "--voc-root", voc,
                                      "--num-images", "2", "--iteration", "3",
                                      "--output-dir", str(out / pkg), *extra])
            assert rc == 0
    return out


def test_explain_eval_writes_the_jax_files(eval_runs):
    names = [f"{m}_{fx.CLI_NAME}_pruning_iteration_03.txt"
             for m in ("gradCAM", "ig", "attention")]
    assert fx.file_tree(eval_runs / "torch") == fx.file_tree(eval_runs / "jax") == sorted(names)
    for name in names:
        got, want = (_numbers(eval_runs / p / name) for p in ("torch", "jax"))
        assert len(got) == len(want) == 3 and got[2] == want[2] == "On a total of 2 images."
        if name.startswith("ig_"):
            assert all(0.0 <= v <= 1.0 for v in got[:2])  # another noise draw
        else:
            np.testing.assert_allclose(got[:2], want[:2], atol=1e-6, rtol=0)


def _stub_heatmaps(spec, model_or_variables, img, methods, **_kw):
    """Deterministic maps of an image's shape: the same for both packages."""
    h, w = img.shape[:2]
    rng = np.random.default_rng(h * 1000 + w)
    out = {"prediction": rng.normal(0, 1, 10)}
    for m in methods:
        out[m] = (rng.random((3, h, w)) if m == "ig" else rng.random((h, w))).astype(np.float32)
    return out


def test_explain_eval_files_byte_equal_on_the_same_heatmaps(ckpt, voc, tmp_path, monkeypatch):
    import importlib

    monkeypatch.setattr(importlib.import_module("vipers.explain.driver"), "compute_heatmaps",
                        _stub_heatmaps)
    monkeypatch.setattr(importlib.import_module("vipers_torch.explain.driver"),
                        "compute_heatmaps", _stub_heatmaps)
    for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        rc, _ = fx.run_cli(main, ["explain-eval", "--model", fx.CLI_NAME,
                                  "--checkpoint", ckpt[pkg], "--voc-root", voc,
                                  "--pooling", "l2-norm", "--output-dir", str(tmp_path / pkg),
                                  *extra])
        assert rc == 0
    files = fx.file_tree(tmp_path / "jax")
    assert fx.file_tree(tmp_path / "torch") == files and len(files) == 3
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ------------------------------------------------------------ explain-eval-batch

@pytest.mark.parametrize("metric", ["rank", "mass"])
def test_explain_eval_batch_files_byte_equal(tmp_path, metric):
    rng = np.random.default_rng(2)
    hm_dir, gt_dir = tmp_path / "hm", tmp_path / "gt"
    hm_dir.mkdir()
    gt_dir.mkdir()
    for i in range(4):
        np.save(hm_dir / f"{i}.npy", rng.normal(0, 1, (3, 20, 24)).astype(np.float32))
        np.save(gt_dir / f"{i}.npy", (rng.random((18, 22)) > 0.5).astype(np.float64))
    np.save(hm_dir / "not_an_index.npy", np.zeros(3))
    for pkg, main in (("jax", jmain), ("torch", tmain)):
        rc, _ = fx.run_cli(main, ["explain-eval-batch", "--heatmap-dir", str(hm_dir),
                                  "--ground-truth-dir", str(gt_dir), "--metric", metric,
                                  "--output-name", "run", "--num-images", "3",
                                  "--output-dir", str(tmp_path / pkg)])
        assert rc == 0
    files = fx.file_tree(tmp_path / "jax")
    assert files == ["run_FIXED.txt", "run_ORDERED.txt", "run_datapoint", "run_statistic"]
    assert fx.file_tree(tmp_path / "torch") == files
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("argv,item", [
    (["explain", "--model", "dino_vit_small"], "A2"),
    (["explain-eval", "--model", "dino_vit_base"], "A2"),
    (["explain", "--model", "mobilenet_v2"], "A8"),
])
def test_unported_models_exit_naming_their_item(argv, item, tmp_path):
    """The DINO ViTs (once refused under A2) and MobileNetV2 (A8) are
    explained now: each loads at its registry size, seed-0 weights, and
    its GradCAM map comes back finite at the image's size (the parity:
    ``tests/test_torch_explain_families.py``)."""
    from vipers_torch.explain.driver import _load_model, compute_heatmaps

    spec, model = _load_model(argv[2], device="cpu")
    assert spec.family == {"A2": "dino_vit", "A8": "mobilenet"}[item]
    img = np.random.default_rng(0).normal(0, 1, (32, 48, 3)).astype(np.float32)
    cam = compute_heatmaps(spec, model, img, ["gradcam"])["gradcam"]
    assert cam.shape == (32, 48) and np.isfinite(cam).all()


def test_slimmed_checkpoint_exits_naming_a4(ckpt, voc, tmp_path):
    """Structured slimming (ROADMAP A4) is ported, so a slimmed checkpoint
    no longer exits: each package slims the same weights (``slim
    --mlp-keep 0.5 --heads-keep 0.5 --round-to 1``: mlp 64, 1 head of 32),
    ``explain-eval`` builds the model at the sidecar's widths and writes
    the JAX package's files, GradCAM's and the attention map's numbers
    within 1e-6."""
    from vipers_torch.explain.driver import _load_model

    for pkg, main in (("jax", jmain), ("torch", tmain)):
        rc, _ = fx.run_cli(main, ["slim", "--model", fx.CLI_NAME, "--checkpoint", ckpt[pkg],
                                  "--num-classes", "10", "--mlp-keep", "0.5", "--heads-keep",
                                  "0.5", "--round-to", "1", "--output-dir",
                                  str(tmp_path / "slim" / pkg)])
        assert rc == 0
    slim = {pkg: str(tmp_path / "slim" / pkg / f"{fx.CLI_NAME}_slim_m64_h1")
            for pkg in ("jax", "torch")}
    slim["torch"] += ".pth"
    spec, model = _load_model(fx.CLI_NAME, slim["torch"], device="cpu")
    assert (spec.cfg.num_heads, spec.cfg.head_dim, spec.cfg.mlp_dim) == (1, 32, 64)
    assert model.layers[0].attention.qkv.weight.shape == (96, 64)
    for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        rc, _ = fx.run_cli(main, ["explain-eval", "--model", fx.CLI_NAME,
                                  "--checkpoint", slim[pkg], "--voc-root", voc,
                                  "--num-images", "1", "--output-dir", str(tmp_path / pkg),
                                  *extra])
        assert rc == 0
    names = [f"{m}_{fx.CLI_NAME}_pruning_iteration_00.txt" for m in ("gradCAM", "attention")]
    for name in names:
        got, want = (_numbers(tmp_path / p / name) for p in ("torch", "jax"))
        assert len(got) == 3 and got[2] == want[2] == "On a total of 1 images."
        np.testing.assert_allclose(got[:2], want[:2], atol=1e-6, rtol=0)


def test_default_device_raises_without_a_card(voc, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["explain-eval", "--model", fx.CLI_NAME, "--voc-root", voc,
               "--output-dir", str(tmp_path)])


def test_parsers_take_the_jax_flags_and_defaults():
    from vipers_torch.cli.main import build_parser

    p = build_parser()
    a = p.parse_args(["explain"])
    assert (a.model, a.data_path, a.methods, a.num_classes_sample, a.output_dir, a.seed,
            a.pruning_iteration, a.device) == (
        "resnet50", "/data/imagenet", ["gradcam", "guided_gradcam", "ig", "attention"], 200,
        "./explanations", 0, None, "cuda")
    a = p.parse_args(["explain-eval"])
    assert (a.model, a.voc_root, a.num_images, a.pooling, a.iteration, a.output_dir) == (
        "vit_b_32", "/data/VOC2012", 101, "sum,abs", 0, "./explanations_eval")
    a = p.parse_args(["mvh"])
    assert (a.pruning_step, a.checkpoint, a.stimuli_root, a.max_batches, a.model) == (
        0, "", None, 0, "resnet18")

