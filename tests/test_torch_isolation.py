"""The port stands alone: vipers_torch and chip_smoke.py import neither jax
(nor flax/optax) nor anything of the JAX package, and an entry point asked
for the default device on a host without a card raises instead of falling
back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vipers")


def _port_files():
    files = sorted((REPO / "vipers_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_no_jax_or_vipers_imports_in_the_port():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(str(f.relative_to(REPO)), r) for f in files
           for r in _imported_roots(f) if r in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in (REPO / "vipers_torch").rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\nprint('LOADED', bad)\nassert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.core.device import resolve_device
    from vipers_torch.discovery.driver import LostFeatureExtractor
    from vipers_torch.models.vit import ViTConfig, _build

    spec = _build("tiny", ViTConfig(16, 1, 2, 128, 256, 0), (32, 32))
    params = spec.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LostFeatureExtractor(spec, params)
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state

    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(spec, params, None, OptimConfig(), steps_per_epoch=1)
    assert create_train_state(spec, params, None, OptimConfig(), 1,
                              device="cpu").model.head is None
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from vipers_torch.cli.main import main

    data = str(REPO / "tests" / "data" / "torch_voc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["lost", "--data-path", data, "--output-dir", "unused"])


# the port's files the ViT family's slice touches: the registry and config,
# the .pth carry-over, the CLI, the LOST driver, the flash and fused-MLP
# wrappers, the training wrapper's refusal, the profiler and chip_smoke.py
FAMILY_SLICE = ("vipers_torch/models/vit.py", "vipers_torch/core/checkpoint.py",
                "vipers_torch/cli/main.py", "vipers_torch/discovery/driver.py",
                "vipers_torch/ops/flash_attention.py", "vipers_torch/ops/fused_mlp.py",
                "vipers_torch/ops/attention_train.py", "vipers_torch/tools/profile_lost.py",
                "chip_smoke.py")


@pytest.mark.parametrize("rel", FAMILY_SLICE)
def test_family_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


@pytest.mark.parametrize("model,patch", [("vit_b_16", "16"), ("vit_b_32", "32"),
                                         ("vit_h_14", "14")])
def test_family_cli_default_device_raises_without_a_card(model, patch):
    """``vipers_torch lost --model <family member>`` without ``--device``
    runs on the card or raises: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.cli.main import main

    data = str(REPO / "tests" / "data" / "torch_voc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["lost", "--model", model, "--patch-size", patch, "--data-path", data,
              "--output-dir", "unused"])


# the modules the train and evaluate entry points brought in
TRAIN_SLICE = ("vipers_torch/core/config.py", "vipers_torch/core/metrics.py",
               "vipers_torch/core/checkpoint.py", "vipers_torch/data/sampler.py",
               "vipers_torch/data/imagefolder.py", "vipers_torch/data/preprocess.py",
               "vipers_torch/data/autoaugment.py", "vipers_torch/data/native.py",
               "vipers_torch/data/mixup.py", "vipers_torch/train/loop.py",
               "vipers_torch/train/optim.py", "vipers_torch/train/driver.py",
               "vipers_torch/train/evaluate_models.py", "vipers_torch/cli/main.py")


@pytest.mark.parametrize("rel", TRAIN_SLICE)
def test_train_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


@pytest.mark.parametrize("cmd", ["train", "evaluate", "export"])
def test_train_cli_default_device_raises_without_a_card(cmd, tmp_path):
    """``vipers_torch train|evaluate|export --model vit_b_16`` without
    ``--device`` runs on the card or raises before it reads data or writes
    a file."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.cli.main import main

    out = tmp_path / "out"
    data = [] if cmd == "export" else ["--data-path", str(tmp_path / "none")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([cmd, "--model", "vit_b_16", *data, "--output-dir", str(out)])
    assert not out.exists()


# the serving export's modules: the exporter, its A/B tool, the ops package
# that registers the custom ops, and the while_loop flood fill
EXPORT_SLICE = ("vipers_torch/core/export.py", "vipers_torch/tools/bench_export.py",
                "vipers_torch/ops/__init__.py", "vipers_torch/discovery/components.py")


@pytest.mark.parametrize("rel", EXPORT_SLICE)
def test_export_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


# the modules structured slimming brought in
SLIM_SLICE = ("vipers_torch/pruning/structured.py", "vipers_torch/tools/bench_slim.py")


@pytest.mark.parametrize("rel", SLIM_SLICE)
def test_slim_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


def test_slim_cli_default_device_raises_without_a_card(tmp_path):
    """``vipers_torch lost --checkpoint <slim>.pth`` without ``--device``
    runs on the card or raises: the sidecar changes the widths, not the
    device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.cli.main import main

    data = str(REPO / "tests" / "data" / "torch_voc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["lost", "--data-path", data, "--checkpoint", str(tmp_path / "m_slim.pth"),
              "--output-dir", str(tmp_path / "unused")])


# the modules quantization brought in
QUANT_SLICE = ("vipers_torch/train/quantize.py", "vipers_torch/models/mobilenet.py",
               "vipers_torch/tools/bench_int8.py")


@pytest.mark.parametrize("rel", QUANT_SLICE)
def test_quant_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


@pytest.mark.parametrize("argv", [
    ["quantize", "--model", "quantized_mobilenet_v2", "--resume", "m.pth"],
    ["lost", "--dtype", "int8"]], ids=["quantize", "lost-int8"])
def test_quant_cli_default_device_raises_without_a_card(argv, tmp_path):
    """``vipers_torch quantize`` and ``lost --dtype int8`` without
    ``--device`` run on the card or raise before they write a file."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.cli.main import main

    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([*argv, "--data-path", str(REPO / "tests" / "data" / "torch_voc"),
              "--output-dir", str(out)])
    assert not out.exists()


# the modules the debugging surface and the plots brought in
VIZ_SLICE = ("vipers_torch/viz/__init__.py", "vipers_torch/viz/draw.py",
             "vipers_torch/viz/plots.py", "vipers_torch/viz/heatmap_report.py",
             "vipers_torch/core/profiling.py", "vipers_torch/core/flops.py")


@pytest.mark.parametrize("rel", VIZ_SLICE)
def test_viz_slice_files_import_no_jax(rel):
    path = REPO / rel
    assert path in _port_files()
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, (rel, bad)


@pytest.mark.parametrize("argv", [
    ["lost", "--arch", "mobilenet", "--model", "mobilenet_v2"],
    ["lost", "--model", "vit_s_16", "--visualize", "pred"]], ids=["mobilenet", "visualize"])
def test_mobilenet_and_visualize_default_device_raises_without_a_card(argv, tmp_path):
    """``lost --model mobilenet_v2`` and ``lost --visualize`` without
    ``--device`` run on the card or raise before they write a file."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    from vipers_torch.cli.main import main

    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([*argv, "--data-path", str(REPO / "tests" / "data" / "torch_voc"),
              "--output-dir", str(out)])
    assert not out.exists()


def test_plot_is_host_work_and_touches_no_device(tmp_path, monkeypatch):
    """``plot`` takes no ``--device`` and never asks torch for one: it draws
    with every CUDA query poisoned."""
    from vipers_torch.cli.main import main

    def poisoned(*_a, **_k):
        raise AssertionError("plot touched a device")

    for name in ("is_available", "device_count", "init", "current_device"):
        monkeypatch.setattr(torch.cuda, name, poisoned)
    (tmp_path / "results_iteration_00.txt").write_text("0,41.5\n")
    (tmp_path / "results_iteration_01.txt").write_text("1,40.0\n")
    assert main(["plot", "--results-dir", str(tmp_path), "--performance-txt", "",
                 "--out", str(tmp_path / "lost.png")]) == 0
    assert (tmp_path / "lost.png").stat().st_size > 0
