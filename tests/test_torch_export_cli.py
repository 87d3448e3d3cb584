"""``python -m vipers_torch.cli.main export`` (``vipers_torch/core/export.py``
``run_export``) on the CPU, against the JAX CLI's flags and contract: the
slim sidecar round trip with ``--verify`` (as ``tests/test_export.py``'s
``test_export_cli_slim_sidecar``), the ``meta.json`` keys, the refusals
(``--platforms`` other than the export device, an orbax checkpoint
naming ROADMAP A7, ``--pipeline lost`` on swin and mobilenet), the card
by default, and a written artifact loaded and run in a fresh process
that imports nothing of the port but ``vipers_torch.ops``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_explain_fixtures as fx
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import export as texport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(scope="module")
def cli_vit():
    yield from fx.register_cli_vit()


def _export(argv):
    return fx.run_cli(tmain, ["export", *argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def lost_art(cli_vit, tmp_path_factory):
    """(artifact dir, CLI stdout) of ``export --pipeline lost --verify`` of
    the tiny CLI ViT (random weights, seed 0) at 64x96, B=2, f32."""
    art = str(tmp_path_factory.mktemp("export") / "lost")
    rc, out = _export(["--model", fx.CLI_NAME, "--pipeline", "lost", "--batch-size", "2",
                       "--image-size", "64", "96", "--dtype", "f32", "--k-patches", "10",
                       "--platforms", "cpu", "--output-dir", art, "--verify"])
    assert rc == 0, out
    return art, out


def test_cli_slim_sidecar_round_trip(cli_vit, tmp_path):
    """``slim`` -> ``export --verify``: the sidecar rebuilds the slim module,
    the reloaded artifact equals the slim model's direct forward, and
    ``meta.json`` has the JAX keys with ``torch_version`` for
    ``jax_version``."""
    pth = fx.write_cli_checkpoints(tmp_path, "src")["torch"]
    rc, out = fx.run_cli(tmain, ["slim", "--model", fx.CLI_NAME, "--checkpoint", pth,
                                 "--num-classes", "10", "--mlp-keep", "0.5", "--heads-keep",
                                 "0.5", "--round-to", "1", "--output-dir", str(tmp_path)])
    assert rc == 0, out
    slim = str(tmp_path / f"{fx.CLI_NAME}_slim_m64_h1.pth")
    art = str(tmp_path / "art")
    rc, out = _export(["--model", fx.CLI_NAME, "--checkpoint", slim, "--batch-size", "1",
                       "--dtype", "f32", "--output-dir", art, "--verify"])
    assert rc == 0 and "slim architecture: " in out and "verify: artifact output" in out, out
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    want = {"model", "family", "input_shape", "input_dtype", "output_shape", "output_dtype",
            "compute_dtype", "num_classes", "sparsity_pct", "platforms", "calibrated_sites"}
    assert want <= set(meta) and "torch_version" in meta and "jax_version" not in meta
    assert meta["input_shape"] == [1, 224, 224, 3] and meta["output_shape"] == [1, 10]
    assert meta["compute_dtype"] == "float32" and meta["sparsity_pct"] > 40
    fn, _ = texport.load_artifact(art)
    assert tuple(fn(np.zeros((1, 224, 224, 3), np.float32)).shape) == (1, 10)


def test_cli_lost_meta_keys(lost_art):
    """``--pipeline lost --verify`` writes the JAX LOST meta keys."""
    art, out = lost_art
    assert "verify: artifact output" in out, out
    with open(os.path.join(art, "meta.json")) as f:
        meta = json.load(f)
    want = {"model", "family", "pipeline", "which_features", "k_patches", "input_shape",
            "input_dtype", "outputs", "compute_dtype", "platforms"}
    assert want <= set(meta) and meta["input_shape"] == [2, 64, 96, 3]
    assert meta["platforms"] == ["cpu"] and meta["which_features"] == "k"


@pytest.mark.parametrize("argv,match", [
    (["--platforms", "tpu"], "one device's program"),
    (["--platforms", "cpu", "cuda"], "one device's program"),
    (["--pipeline", "lost", "--model", "swin_v2_t"], "swin LOST runs via"),
    (["--pipeline", "lost", "--model", "mobilenet_v2"], "not supported"),
], ids=["tpu", "two-platforms", "swin", "mobilenet"])
def test_cli_refusals(cli_vit, argv, match, tmp_path):
    if "--model" not in argv:
        argv = ["--model", fx.CLI_NAME, *argv]
    with pytest.raises(SystemExit, match=match):
        _export([*argv, "--output-dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def test_cli_refuses_an_orbax_directory_naming_a7(cli_vit, tmp_path):
    orbax = fx.write_cli_checkpoints(tmp_path, "src")["jax"]
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        _export(["--model", fx.CLI_NAME, "--checkpoint", orbax,
                 "--output-dir", str(tmp_path / "x")])


def test_cli_runs_on_the_card_by_default(cli_vit, tmp_path):
    """Without ``--device`` the export runs on the card, or raises on a
    host without one: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain(["export", "--model", fx.CLI_NAME, "--output-dir", str(tmp_path / "x")])


def test_load_artifact_needs_only_the_ops(lost_art, tmp_path):
    """A fresh process loads and runs an artifact with ``load_artifact``:
    no model, driver or checkpoint module of the port is imported."""
    out = lost_art[0]
    np.save(tmp_path / "x.npy", np.random.default_rng(5).normal(
        size=(2, 64, 96, 3)).astype(np.float32))
    code = ("import sys, numpy as np, torch\n"
            "from vipers_torch.core.export import load_artifact\n"
            f"fn, meta = load_artifact({out!r})\n"
            f"boxes, seed, bg = fn(np.load({str(tmp_path / 'x.npy')!r}))\n"
            "assert boxes.shape == (2, 4) and seed.dtype == torch.int32\n"
            "mods = sorted(m for m in sys.modules if m.startswith('vipers'))\n"
            "print(mods)\n"
            "assert not any(m.startswith(('vipers_torch.models', 'vipers_torch.discovery',\n"
            "    'vipers_torch.train', 'vipers_torch.pruning')) or m.split('.')[0] == 'vipers'\n"
            "    for m in mods), mods\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
