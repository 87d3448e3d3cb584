"""vipers_torch's model-vs-human benchmarks against the JAX package's on
the CPU: each of the 12 parametric distortions bit for bit for a seeded
``np.random.Generator`` at its levels, the tables (levels, orders, CSV
rows), the 1000 -> 16 category matrix, ``eval_mvh`` with the identity-level
shortcut and ``write_mvh_csv`` on the same trivial classifier, and
``python -m vipers_torch.cli.main mvh --device cpu`` against ``vipers mvh``
on the same weights (the CLI tests' tiny ViT at 1000 classes and 32 x 32,
a 50% magnitude mask; the port reads a ``.pth``, the JAX package an orbax
directory), with a stimulus set: the two CSVs byte for byte.
"""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.data.distortions as jdist
from tests import torch_explain_fixtures as fx
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain
from vipers_torch.data import distortions as tdist
from vipers_torch.train import mvh as tmvh

jmvh = importlib.import_module("vipers.train.mvh")

CASES = [(name, level) for name, levels in jdist.DISTORTION_LEVELS.items()
         for level in (levels if not name.startswith("eidolon") else levels[:3] + levels[-1:])]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.mark.parametrize("name,level", CASES, ids=[f"{n}-{lv}" for n, lv in CASES])
def test_distortion_bit_equal(name, level):
    img = np.random.default_rng(0).random((32, 40, 3)).astype(np.float32)
    got = tdist.PARAMETRIC_DISTORTIONS[name](img, np.random.default_rng(7), level=level)
    want = jdist.PARAMETRIC_DISTORTIONS[name](img, np.random.default_rng(7), level=level)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tables_equal():
    assert tdist.DISTORTION_LEVELS == jdist.DISTORTION_LEVELS
    assert list(tdist.PARAMETRIC_DISTORTIONS) == list(jdist.PARAMETRIC_DISTORTIONS)
    assert tdist.STIMULUS_DATASETS == jdist.STIMULUS_DATASETS
    assert tmvh.MVH_ORDER == jmvh.MVH_ORDER
    assert tmvh.REFERENCE_CSV_ROWS == jmvh.REFERENCE_CSV_ROWS
    assert tmvh.SIXTEEN_CATEGORIES == jmvh.SIXTEEN_CATEGORIES


def test_category_matrix_equal(tmp_path):
    np.testing.assert_array_equal(tmvh.imagenet_to_16_matrix(), jmvh.imagenet_to_16_matrix())
    (tmp_path / "category_map.json").write_text(json.dumps({"cat": [1, 2], "dog": [7]}))
    got = tmvh.imagenet_to_16_matrix(str(tmp_path))
    np.testing.assert_array_equal(got, jmvh.imagenet_to_16_matrix(str(tmp_path)))
    assert got.sum() == 3


def test_eval_mvh_and_csv_equal_jax(tmp_path):
    """The same brightness classifier as each package's eval step, on the
    same batches: every level's accuracy and the CSV equal."""
    def jstep(state, batch):
        images, labels = batch
        pred = (jnp.mean(images, axis=(1, 2, 3)) > 0).astype(jnp.int32)
        return {"top1": jnp.sum(pred == labels), "n": jnp.asarray(labels.shape[0])}

    def tstep(state, batch):
        images, labels = batch
        pred = (images.mean(dim=(1, 2, 3)) > 0).long()
        return {"top1": (pred == labels).sum(), "n": torch.tensor(labels.shape[0])}

    rng = np.random.default_rng(0)
    images = (rng.random((6, 24, 24, 3)) * 255).astype(np.uint8)
    labels = (images.mean(axis=(1, 2, 3)) > 127).astype(np.int32)
    batches = [(images[:4], labels[:4]), (images[4:], labels[4:])]
    levels = {k: (v if not k.startswith("eidolon") else v[:2])
              for k, v in jdist.DISTORTION_LEVELS.items()}
    want = jmvh.eval_mvh(jstep, None, batches, levels=levels)
    got = tmvh.eval_mvh(tstep, None, batches, levels=levels, device="cpu")
    assert list(got) == list(want) == tmvh.MVH_ORDER
    for k in want:
        if isinstance(want[k], list):
            assert got[k] == want[k], k
        else:
            assert np.isnan(got[k]) and np.isnan(want[k])
    assert tmvh.LAST_RUN["images"] > 0 and tmvh.LAST_RUN["distort_s"] > 0
    pt = tmvh.write_mvh_csv(got, "resnet18", 3, str(tmp_path / "t"))
    pj = jmvh.write_mvh_csv(want, "resnet18", 3, str(tmp_path / "j"))
    assert os.path.basename(pt) == os.path.basename(pj) == "resnet18_pruning_step_3.csv"
    assert open(pt).read() == open(pj).read()


# ------------------------------------------------------------ the CLIs

@pytest.fixture(scope="module", autouse=True)
def tiny_vit():
    yield from fx.register_cli_vit()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvhds")
    rng = np.random.default_rng(1)
    for split, n in (("train", 2), ("val", 2)):
        for cls in ("class_a", "class_b"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (40, 44, 3), dtype=np.uint8)).save(
                    d / f"img_{i}.jpg")
    stim = root / "stimuli" / "edge"
    for cat in ("cat", "dog", "not_a_category"):
        (stim / cat).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                stim / cat / f"s{i}.png")
    return root


def test_mvh_cli_csv_equals_jax(data, tmp_path, monkeypatch):
    monkeypatch.setenv("VIPERS_JAX_CACHE", "0")
    ckpt = fx.write_cli_checkpoints(str(tmp_path / "ckpt"), fx.CLI_NAME, num_classes=1000,
                                    image_size=(32, 32))
    common = ["mvh", "--model", fx.CLI_NAME, "--data-path", str(data), "--num-classes", "1000",
              "--batch-size", "2", "--train-crop-size", "32", "--val-resize-size", "36",
              "--val-crop-size", "32", "--workers", "2", "--pruning-step", "4",
              "--max-batches", "1", "--stimuli-root", str(data / "stimuli")]
    for pkg, main, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        rc, text = fx.run_cli(main, [*common, "--checkpoint", ckpt[pkg],
                                     "--output-dir", str(tmp_path / pkg), *extra])
        assert rc == 0 and "wrote" in text
    name = f"{fx.CLI_NAME}_pruning_step_4.csv"
    got = (tmp_path / "torch" / name).read_text()
    want = (tmp_path / "jax" / name).read_text()
    assert got == want
    rows = got.splitlines()
    assert len(rows) == 20 and rows[1].startswith(f"{fx.CLI_NAME},edge,accuracy (top-1),")
    assert rows[1].split(",")[-1] != "nan" and rows[2].split(",")[-1] == "nan"
