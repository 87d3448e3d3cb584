"""``vipers_torch lost --arch dino`` and ``--dinoseg`` against ``vipers
lost`` on the CPU, from one ``.pth`` each, on a synthetic VOC07 tree (a
bright block an image, as ``tests/test_lost.py`` builds it): the same
``preds.pkl`` and results txt; and what is still refused
(``tests/test_torch_cluster.py`` holds ``cluster``).

Full-depth models at the registry's widths (``dino_vit_tiny``:
facebookresearch/dino keys written by ``export_dino_vit``; ``vit_s_16``:
torchvision keys), the port's seed-0 initial weights plus N(0, 0.02) on
every leaf, f32, images of 96-128 x 128 (T <= 65: the einsum route).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tests import torch_explain_fixtures as fx
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _voc(root, n):
    """``n`` images of 96-128 x 128 with a bright block each, their XML and
    the trainval list."""
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.default_rng(0)
    names = []
    for i in range(n):
        h, w = 96 + 16 * (i % 3), 128
        arr = rng.integers(0, 60, size=(h, w, 3), dtype=np.uint8)
        y0, x0 = 16 + 8 * (i % 3), 32 + 4 * (i % 4)
        arr[y0:y0 + 40, x0:x0 + 48] = 120 + 30 * (i % 5)
        name = f"im{i:03d}"
        names.append(name)
        Image.fromarray(arr).save(os.path.join(root, "JPEGImages", f"{name}.jpg"))
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(f"""<annotation><filename>{name}.jpg</filename>
<size><width>{w}</width><height>{h}</height><depth>3</depth></size>
<object><name>thing</name><truncated>0</truncated><difficult>0</difficult>
<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x0 + 48}</xmax><ymax>{y0 + 40}</ymax></bndbox>
</object></annotation>""")
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(names))
    return str(root)


def _perturbed(spec, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a.numpy() + rng.normal(0, 0.02, a.shape).astype(np.float32),
                        spec.init(torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    dino, vit = str(root / "dino.pth"), str(root / "vit.pth")
    tck.save_torch_state_dict(tck.export_dino_vit(_perturbed(tbuild("dino_vit_tiny"), 1)), dino)
    tck.save_torch_state_dict(tck.export_vit_torchvision(_perturbed(
        tbuild("vit_s_16", num_classes=10), 2)), vit)
    return {"dino": dino, "vit": vit}


def _preds(path):
    with open(path, "rb") as f:
        return {k: np.asarray(v).tolist() for k, v in pickle.load(f).items()}


@pytest.mark.parametrize("case", ["dino", "dinoseg-dino", "dinoseg-vit",
                                  "dinoseg-reference-bugs"])
def test_lost_cli_matches_jax(case, weights, tmp_path):
    if case == "dinoseg-vit":
        argv = ["--arch", "vit", "--model", "vit_s_16", "--checkpoint", weights["vit"],
                "--dinoseg"]
    else:
        argv = ["--arch", "dino", "--model", "dino_vit_tiny", "--checkpoint", weights["dino"],
                "--dinoseg-head", "2"]
        argv += {"dino": [], "dinoseg-dino": ["--dinoseg"],
                 "dinoseg-reference-bugs": ["--dinoseg", "--dinoseg-reference-bugs"]}[case]
    data = _voc(tmp_path / "voc", 3)
    common = [*argv, "--dataset", "VOC07", "--set", "trainval", "--data-path", data,
              "--workers", "2", "--k-patches", "10", "--batch-size", "2"]
    assert tmain(["lost", *common, "--output-dir", str(tmp_path / "port"),
                  "--device", "cpu"]) == 0
    assert jmain(["lost", *common, "--output-dir", str(tmp_path / "jax")]) in (0, None)
    got, want = _preds(tmp_path / "port" / "preds.pkl"), _preds(tmp_path / "jax" / "preds.pkl")
    assert got == want and len(got) >= 2
    assert (tmp_path / "port" / "results_iteration_00.txt").read_text() == \
        (tmp_path / "jax" / "results_iteration_00.txt").read_text()


@pytest.mark.parametrize("argv,match", [
    (["train", "--model", "dino_vit_small"], r"DINO training\) is not ported yet \(ROADMAP A2\)"),
    (["evaluate", "--model", "dino_vit_tiny"], r"DINO training\) is not ported yet \(ROADMAP A2\)"),
    (["lost", "--arch", "swin", "--model", "swin_v2_t", "--dinoseg"], "--arch vit or dino"),
    (["lost", "--arch", "resnet", "--model", "resnet18", "--dinoseg"], "--arch vit or dino"),
    (["lost", "--arch", "dino", "--model", "vit_s_16"], "does not take --model vit_s_16"),
    (["lost", "--arch", "vit", "--model", "dino_vit_small"], "does not take"),
])
def test_refusals(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        tmain([*argv, "--output-dir", str(tmp_path / "out"), "--data-path", _voc(
            tmp_path / "voc", 1), "--device", "cpu"])
    assert not (tmp_path / "out").exists()
