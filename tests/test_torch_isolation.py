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
