"""vipers_torch's debugging surface against the JAX package's on the CPU:
``core.profiling`` (``enable_nan_check`` / ``--debug-nans``, ``device_trace``
/ ``--profile-dir``, ``StepTimer``) and ``core.flops``.

Held: a NaN weight raises ``FloatingPointError`` in both packages under the
sanitizer and in the port's ``train --debug-nans``; a NaN that only a
backward produces raises it too; with the sanitizer off nothing is
registered and the NaN passes silently, as in JAX; ``train --profile-dir``
writes one Chrome trace (SNIP's run, LRR's first pruning iteration only);
the FLOP formulas equal the JAX package's, the peak is the card's.
"""

import dataclasses
import glob
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_explain_fixtures as fx
import vipers.core.flops as jflops
import vipers.core.profiling as jprof
import vipers_torch.core.registry as treg
import vipers_torch.models.vit as tvit
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import flops as tflops
from vipers_torch.core import profiling as tprof

NAME = "vit_tiny_profiling_test"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(autouse=True)
def _sanitizer_off():
    yield
    tprof.enable_nan_check(False)
    jprof.enable_nan_check(False)


def test_nan_weight_raises_in_both_packages():
    w = np.ones((4, 3), np.float32)
    w[1, 2] = np.nan
    x = np.ones((2, 4), np.float32)
    dense = nn.Dense(3)
    variables = {"params": {"kernel": jnp.asarray(w), "bias": jnp.zeros(3)}}
    jprof.enable_nan_check(True)
    with pytest.raises(FloatingPointError):
        jax.jit(dense.apply)(variables, jnp.asarray(x)).block_until_ready()
    jprof.enable_nan_check(False)
    assert np.isnan(np.asarray(jax.jit(dense.apply)(variables, jnp.asarray(x)))).any()

    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    tprof.enable_nan_check(True)
    with pytest.raises(FloatingPointError, match="Linear"):
        lin(torch.from_numpy(x))
    tprof.enable_nan_check(False)
    assert tprof._NAN_HOOK is None and not torch.is_anomaly_enabled()
    assert torch.isnan(lin(torch.from_numpy(x))).any()


def test_nan_in_a_backward_raises():
    """A finite forward whose backward makes a NaN (sqrt of a negative
    behind a ``where``): anomaly mode's error, as ``FloatingPointError``."""
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    tprof.enable_nan_check(True)
    y = torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x)).sum()
    assert torch.isfinite(y)
    with pytest.raises(FloatingPointError, match="nan"), tprof.nan_errors():
        y.backward()


@pytest.fixture(scope="module")
def tiny_vit():
    """A tiny ViT (patch 8, 2 blocks, D 64, 2 classes) in the port's
    registry; ``nan=True`` puts a NaN into its first fc1 weight."""
    treg._ensure_builtins_imported()

    def build(num_classes=1000, image_size=(224, 224), nan=False):
        spec = tvit._build(NAME, tvit.ViTConfig(8, 2, 2, 64, 128, num_classes), image_size)
        if not nan:
            return spec

        def init(gen):
            params = spec.init(gen)
            params["encoder_layer_0"]["mlp"]["fc1"]["kernel"][0, 0] = float("nan")
            return params

        return dataclasses.replace(spec, init=init)

    treg._BUILTIN_MODELS[NAME] = build
    treg._BUILTIN_MODELS[NAME + "_nan"] = lambda **kw: build(nan=True, **kw)
    yield
    del treg._BUILTIN_MODELS[NAME], treg._BUILTIN_MODELS[NAME + "_nan"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(1)
    for split, n in (("train", 4), ("val", 2)):
        for cls in ("a", "b"):
            (root / split / cls).mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                    root / split / cls / f"{i}.jpg")
    return str(root)


def _train(data, out, model, *extra):
    return tmain(["train", "--model", model, "--data-path", data, "--num-classes", "2",
                  "--batch-size", "4", "--epochs", "1", "--train-crop-size", "32",
                  "--val-resize-size", "40", "--val-crop-size", "32", "--lr", "0.01",
                  "--workers", "1", "--print-freq", "0", "--output-dir", str(out),
                  "--device", "cpu", *extra])


def test_train_debug_nans_raises_on_a_nan_weight(tiny_vit, data, tmp_path):
    """``train --debug-nans`` fails fast at the first module whose output
    holds a NaN, and leaves the sanitizer off behind it."""
    with pytest.raises(FloatingPointError):
        _train(data, tmp_path / "nan", NAME + "_nan", "--pruning-method", "magnitude",
               "--pruning-rate", "0.5", "--pruning-threshold", "40", "--debug-nans")
    assert tprof._NAN_HOOK is None and not torch.is_anomaly_enabled()


@pytest.mark.parametrize("method", [
    ["--pruning-method", "snip", "--target-sparsity", "0.5"],
    ["--pruning-method", "magnitude", "--pruning-rate", "0.5", "--pruning-threshold", "70"]],
    ids=["snip", "lrr"])
def test_train_profile_dir_writes_one_trace(method, tiny_vit, data, tmp_path, capsys):
    """``train --profile-dir`` traces SNIP's training run, or LRR's first
    pruning iteration only (two iterations run here): one Chrome trace with
    the train step's operators, its path printed."""
    assert _train(data, tmp_path / "out", NAME, *method, "--profile-dir",
                  str(tmp_path / "trace")) is not None
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    assert f"trace written to {traces[0]}" in capsys.readouterr().out
    events = json.load(open(traces[0]))["traceEvents"]
    assert any("linear" in str(e.get("name", "")).lower() for e in events)


def test_step_timer_counts_the_host_without_a_card():
    timer = tprof.StepTimer()
    assert timer.n_chips == (torch.cuda.device_count() or 1)
    timer.step(8)
    assert timer.images_per_sec_per_chip > 0
    assert tprof.StepTimer(4).n_chips == 4


@pytest.mark.parametrize("cfg", [(384, 12, 24 * 32, 16), (768, 12, 196, 16),
                                 (1280, 32, 28 * 36, 14), (192, 12, 4 * 6, 16, 4, 64)])
def test_flops_equal_jax(cfg):
    for fn in ("vit_forward_flops_per_image", "vit_train_flops_per_image"):
        got = getattr(tflops, fn)(*cfg)
        assert got == getattr(jflops, fn)(*cfg) and got > 0


def test_peak_is_the_cards():
    assert tflops.H100_SXM_BF16_DENSE_PEAK == 989e12
    assert not any("V5E" in name for name in dir(tflops))
