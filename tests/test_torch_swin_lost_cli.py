"""``vipers_torch lost`` one image at a time against ``vipers lost`` on the
CPU: ``--arch swin`` (the first window and ``--swin-all-windows``) and
``--arch resnet --exact-shapes``, on three JPEGs of the committed VOC
fixture from one ``.pth``: the same ``preds.pkl`` and results txt.

The Swin runs read a random torchvision-layout ``swin_v2_t`` state dict
(``tests/torch_swin_oracle``: biases not zero, see
``tests/test_torch_swin_lost.py``), the ResNet run
``tests/test_torch_cnn_lost.py``'s ResNet-18 weights (dilate 2). f32.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from tests import torch_swin_oracle as oracle
from tests.test_torch_cnn_lost import VOC, _weights
from vipers_torch.cli.main import main
from vipers_torch.core import checkpoint as tck

K = 10


def _swin_sd():
    return oracle.random_torchvision_swin_sd(seed=0, num_classes=10)


# two of the fixture's JPEGs share a padded shape (500x375 -> 512x384)
# and one has its own (500x366 -> 512x368)
CLI_IMAGES = ("000005", "000016", "000019")


def _voc_subset(root):
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub))
    for name in CLI_IMAGES:
        for sub, ext in (("JPEGImages", "jpg"), ("Annotations", "xml")):
            os.symlink(os.path.join(VOC, sub, f"{name}.{ext}"),
                       os.path.join(root, sub, f"{name}.{ext}"))
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(CLI_IMAGES) + "\n")
    return str(root)


@pytest.mark.parametrize("case", ["swin", "swin-all-windows", "resnet-exact-shapes"])
def test_lost_cli_matches_jax(case, tmp_path):
    """``vipers_torch lost`` one image at a time on three JPEGs of the
    committed VOC fixture, from one ``.pth``: the same ``preds.pkl`` and
    results txt as ``vipers lost``."""
    from vipers.cli.main import main as jmain

    pth = str(tmp_path / "model.pth")
    if case.startswith("swin"):
        torch.save({"model": _swin_sd()}, pth)
        argv = ["--arch", "swin", "--model", "swin_v2_t"]
        if case == "swin-all-windows":
            argv.append("--swin-all-windows")
    else:
        params, stats, masks = _weights("resnet18", 2)
        tck.save_torch_state_dict(tck.export_resnet(params, stats, masks, bake_masks=False), pth)
        argv = ["--arch", "resnet", "--model", "resnet18", "--resnet-dilate", "2",
                "--exact-shapes"]
    data = _voc_subset(tmp_path / "voc")
    common = [*argv, "--dataset", "VOC07", "--set", "trainval", "--data-path", data,
              "--checkpoint", pth, "--workers", "2", "--k-patches", str(K)]
    assert main(["lost", *common, "--output-dir", str(tmp_path / "port"), "--device",
                 "cpu"]) == 0
    assert jmain(["lost", *common, "--output-dir", str(tmp_path / "jax")]) in (0, None)
    got, want = ({k: np.asarray(v).tolist() for k, v in pickle.load(
        open(tmp_path / p / "preds.pkl", "rb")).items()} for p in ("port", "jax"))
    assert got == want and len(got) == len(CLI_IMAGES)
    assert (tmp_path / "port" / "results_iteration_00.txt").read_text() == \
        (tmp_path / "jax" / "results_iteration_00.txt").read_text()
