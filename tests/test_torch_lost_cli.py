"""``vipers_torch lost`` and ``vipers_torch corloc`` against ``vipers lost`` and
``vipers corloc`` on the CPU, on one reference ``.pth`` and one VOC tree.

The ``.pth`` is written here from a seeded JAX ``vit_s_16`` with a 50% global
magnitude mask, its pruned layers in the reference's ``weight_orig`` /
``weight_mask`` form. At random init the 12 blocks pull every token towards
one direction, every affinity is positive and LOST returns the whole image;
the output kernels of the residual branches (attention ``out``, ``fc2``) are
scaled by 0.2 first, so the patch embedding keeps a dark object apart from
its bright ground and the boxes are smaller than the image.

The tree holds 7 small JPEGs in two buckets (4 in 128x192, 3 in 192x128), so
with ``--batch-size 4`` the second batch is a tail padded by repeating its
last image. f32: ``preds.pkl`` must equal the JAX package's, a box differing
only where the two seeds tie at the top score; the results txt must be the
same file.
"""

import argparse
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from vipers_torch.cli.main import build_parser, main
from tests import torch_explain_fixtures as fx


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


SIZES = [(192, 128), (160, 100), (150, 96), (170, 110), (100, 160), (96, 150), (110, 170)]
N_IMAGES = len(SIZES)


def _write_voc(root, rng):
    from PIL import Image

    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = []
    for i, (w, h) in enumerate(SIZES):
        ground = rng.integers(200, 240, 3).astype(np.float64)
        arr = np.broadcast_to(ground, (h, w, 3)) + rng.normal(0, 2, (h, w, 3))
        bw, bh = int(rng.integers(w // 4, w // 2)), int(rng.integers(h // 4, h // 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        yy, xx = np.mgrid[0:bh, 0:bw]
        stripes = ((xx + yy) // 6) % 2
        c0, c1 = rng.integers(0, 40, (2, 3))
        arr[y0:y0 + bh, x0:x0 + bw] = (np.where(stripes[..., None] == 1, c1, c0)
                                       + rng.normal(0, 12, (bh, bw, 3)))
        name = f"{i + 1:06d}"
        names.append(name)
        Image.fromarray(np.clip(np.rint(arr), 0, 255).astype(np.uint8)).save(
            os.path.join(root, "JPEGImages", f"{name}.jpg"), quality=90)
        with open(os.path.join(root, "Annotations", f"{name}.xml"), "w") as f:
            f.write(f"<annotation><filename>{name}.jpg</filename><size><width>{w}</width>"
                    f"<height>{h}</height><depth>3</depth></size><object><name>thing</name>"
                    f"<truncated>0</truncated><difficult>0</difficult><bndbox>"
                    f"<xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x0 + bw}</xmax>"
                    f"<ymax>{y0 + bh}</ymax></bndbox></object></annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def _write_pth(path):
    import jax
    import jax.numpy as jnp

    from vipers.core.registry import build_model, init_variables
    from vipers.pruning import magnitude as jmag
    from vipers.pruning import masks as jmasks
    from vipers_torch.core.checkpoint import export_vit_torchvision, save_torch_state_dict

    spec = build_model("vit_s_16")
    v = init_variables(spec.module, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                       train=False)
    params = jax.tree.map(lambda a: np.array(a, np.float32), v["params"])
    for i in range(12):
        layer = params[f"encoder_layer_{i}"]
        layer["attention"]["out"]["kernel"] *= 0.2
        layer["mlp"]["fc2"]["kernel"] *= 0.2
    masks = jmag.magnitude_prune(params, jmasks.init_masks(params, ("qkv",)), 0.5)
    sd = export_vit_torchvision(params, {k: np.asarray(m) for k, m in masks.items()},
                                bake_masks=False)
    assert any(k.endswith("weight_orig") for k in sd) and any(k.endswith("weight_mask") for k in sd)
    save_torch_state_dict(sd, path)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_lost_cli")
    data = str(root / "VOC2007")
    names = _write_voc(data, np.random.default_rng(11))
    pth = str(root / "model.pth")
    _write_pth(pth)
    sweep = root / "models" / "vit_s_16"
    sweep.mkdir(parents=True)
    shutil.copy(pth, sweep / "vit_s_16_epoch_299_pruning_iteration_03.pth")
    return {"root": root, "data": data, "pth": pth, "names": names,
            "models": str(root / "models")}


def _lost_argv(voc, out, *extra):
    return ["lost", "--data-path", voc["data"], "--output-dir", str(out), "--batch-size", "4",
            "--workers", "2", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(voc):
    """One ``vipers lost`` run (JAX, f32) and the port's runs on the CPU."""
    from vipers.discovery.driver import run_lost as jax_run_lost

    root = voc["root"]
    jargs = build_parser().parse_args(_lost_argv(voc, root / "jax", "--checkpoint", voc["pth"]))
    assert jax_run_lost(jargs) == 0
    out = {"jax": root / "jax"}
    for name, extra in (("port", ["--checkpoint", voc["pth"]]),
                        ("no_eval", ["--checkpoint", voc["pth"], "--no-evaluation"]),
                        ("no_preds", ["--checkpoint", voc["pth"], "--save-predictions", "false"]),
                        ("sweep", ["--models-dir", voc["models"], "--pruning-iteration", "3"]),
                        ("image", ["--checkpoint", voc["pth"], "--image-path",
                                   os.path.join(voc["data"], "JPEGImages", "000002.jpg")])):
        assert main(_lost_argv(voc, root / name, *extra)) == 0
        out[name] = root / name
    return out


def _preds(d):
    with open(os.path.join(d, "preds.pkl"), "rb") as f:
        return pickle.load(f)


def _seeds_and_scores(voc, im_name):
    """Both packages' seed for one image (its own batch) and the port's
    LOST scores: the tie rule's evidence when two boxes differ."""
    import jax

    from vipers.core.checkpoint import import_torch_checkpoint, to_jax
    from vipers.core.registry import build_model as jbuild
    from vipers.discovery import driver as jdriver
    from vipers_torch.core.registry import build_model
    from vipers_torch.data import native
    from vipers_torch.discovery.driver import LostFeatureExtractor, load_lost_checkpoint
    from vipers_torch.discovery.lost import lost_core

    img, hw = native.decode_pad(os.path.join(voc["data"], "JPEGImages", im_name), 16)
    spec = build_model("vit_s_16")
    params, _, masks, _ = load_lost_checkpoint(voc["pth"], spec)
    tex = LostFeatureExtractor(spec, params, masks, device="cpu")
    tin = tex.prepare_batch([img], 16, exact_hw=[hw])
    tseed = int(tex.make_batched_pipeline()(*tin)[1][0])
    scores = lost_core(tex.batched_features(*tin), tin[3], (tin[0].shape[1] // 16,
                                                            tin[0].shape[2] // 16))["scores"][0]
    jspec = jbuild("vit_s_16")
    jp, _, jm = import_torch_checkpoint(voc["pth"], "vit_s_16")
    jex = jdriver.LostFeatureExtractor(jspec, {"params": to_jax(jp)},
                                       {k: jax.numpy.asarray(v) for k, v in jm.items()})
    jin = jex.prepare_batch([img], 16, exact_hw=[hw])
    jseed = int(np.asarray(jex.make_batched_pipeline()(jex.variables, *jin)[1])[0])
    return tseed, jseed, scores


def test_preds_and_results_equal_vipers_lost(voc, runs):
    tpreds, jpreds = _preds(runs["port"]), _preds(runs["jax"])
    assert sorted(tpreds) == sorted(jpreds) == [f"{n}.jpg" for n in voc["names"]]
    for name in voc["names"]:
        im = f"{name}.jpg"
        if tpreds[im] != jpreds[im]:  # only a tie at the top score may part them
            tseed, jseed, scores = _seeds_and_scores(voc, im)
            assert tseed != jseed, (im, tpreds[im], jpreds[im])
            assert scores[tseed] == scores[jseed] == scores.max(), im
    whole = {f"{n}.jpg": [0.0, 0.0, float(w), float(h)] for n, (w, h) in zip(voc["names"], SIZES)}
    assert any(tpreds[k] != whole[k] for k in tpreds), "every box is the whole image"
    txt = "results_iteration_00.txt"
    with open(runs["port"] / txt) as a, open(runs["jax"] / txt) as b:
        assert a.read() == b.read()


def test_cli_options(voc, runs):
    """--no-evaluation writes preds.pkl and no results txt, --save-predictions
    false the reverse, the sweep template finds the iteration's checkpoint
    and stamps its txt, --image-path writes neither; the boxes are those of
    the main run."""
    main_preds = _preds(runs["port"])
    assert _preds(runs["no_eval"]) == main_preds
    assert not list(runs["no_eval"].glob("results_iteration_*.txt"))
    assert not (runs["no_preds"] / "preds.pkl").exists()
    assert (runs["no_preds"] / "results_iteration_00.txt").read_text() == \
        (runs["port"] / "results_iteration_00.txt").read_text()
    assert _preds(runs["sweep"]) == main_preds
    assert (runs["sweep"] / "results_iteration_03.txt").read_text() == \
        (runs["port"] / "results_iteration_00.txt").read_text()
    assert os.path.isdir(runs["image"]) and not os.listdir(runs["image"])


def _corloc_line(capsys, fn):
    capsys.readouterr()
    fn()
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("corloc:")]


@pytest.mark.parametrize("no_hard", [False, True], ids=["all", "no-hard"])
def test_corloc_rescoring_equals_vipers_corloc(voc, runs, tmp_path, capsys, no_hard):
    """``vipers_torch corloc`` against ``vipers corloc`` on the port's
    preds.pkl and on a detectron json (integer image ids, two boxes for one
    image, none for another); on the pkl it also reproduces the CorLoc of
    the run's results txt."""
    from vipers.data.detection import DiscoveryDataset as JDataset
    from vipers.discovery.corloc import evaluate_predictions as jeval
    import json

    preds = _preds(runs["port"])
    dets = [{"image_id": int(k[:-4]), "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
             "score": 0.5} for k, b in preds.items() if k != "000003.jpg"]
    dets.append({"image_id": 1, "bbox": [0, 0, 40, 30], "score": 0.9})
    det_path = str(tmp_path / "dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    jds = JDataset("VOC07", "trainval", voc["data"], no_hard=no_hard)
    for path in (str(runs["port"] / "preds.pkl"), det_path):
        argv = ["corloc", "--preds", path, "--data-path", voc["data"]] + (
            ["--no-hard"] if no_hard else [])
        got = _corloc_line(capsys, lambda: main(argv))
        want = _corloc_line(capsys, lambda: jeval(path, jds))
        assert got == want and len(got) == 1
    txt = (runs["port"] / "results_iteration_00.txt").read_text()
    pct = _corloc_line(capsys, lambda: main(["corloc", "--preds", str(runs["port"] / "preds.pkl"),
                                            "--data-path", voc["data"]]))[0].split()[1]
    assert txt == f"corloc,{float(pct):.1f},,\n"


def test_seed_in_background_collected_or_strict(voc, monkeypatch, tmp_path, capsys):
    """A seed-in-background image does not discard the run: by default it is
    skipped and reported (the first image of each of the 2 batches here);
    ``--strict`` raises, as the reference does."""
    from vipers_torch.discovery import driver as tdriver

    orig = tdriver.LostFeatureExtractor.make_batched_pipeline

    def poisoned(self, k_patches=100):
        pipe = orig(self, k_patches=k_patches)

        def wrapped(*inputs):
            box, seed, bg = pipe(*inputs)
            return box, seed, bg | (torch.arange(bg.shape[0]) == 0)

        return wrapped

    monkeypatch.setattr(tdriver.LostFeatureExtractor, "make_batched_pipeline", poisoned)
    assert main(_lost_argv(voc, tmp_path / "collect", "--checkpoint", voc["pth"])) == 0
    assert "seed in background component for 2 image(s)" in capsys.readouterr().out
    assert len(_preds(tmp_path / "collect")) == N_IMAGES - 2
    assert tdriver.LAST_RUN["failed"] == ["000001.jpg", "000005.jpg"]
    assert (tmp_path / "collect" / "results_iteration_00.txt").exists()
    with pytest.raises(ValueError, match="background component"):
        main(_lost_argv(voc, tmp_path / "strict", "--checkpoint", voc["pth"], "--strict"))


# the per-image paths run (--arch swin, --swin-all-windows, --exact-shapes,
# --cnn-bucket 1, --dinoseg, --visualize); sequence parallelism (SP: A10's
# last half) meets the JAX driver's checks, data parallelism (DP) passes
@pytest.mark.parametrize("flags,item", [
    (["--arch", "resnet", "--exact-shapes", "--visualize", "pred"], "A11"),
    (["--arch", "swin", "--model", "swin_v2_t", "--visualize", "pred"], "A11"),
    (["--model", "mobilenet_v2"], "A5"),
    (["--dtype", "int8", "--data-parallel"], "DP"),
    (["--visualize", "pred"], "A11"), (["--data-parallel"], "DP"),
    (["--sequence-parallel", "--data-parallel"], "SP"),
    (["--arch", "resnet", "--model", "resnet50", "--resnet-dilate", "2", "--cnn-bucket", "1",
      "--data-parallel"], "DP"),
    (["--arch", "swin", "--model", "swin_v2_t", "--dtype", "int8", "--visualize", "pred"],
     "A11"),
    (["--arch", "swin", "--model", "swin_v2_t", "--swin-all-windows", "--sequence-parallel"],
     "SP")])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path):
    """``--model mobilenet_v2`` (A5), ``--visualize`` (A11),
    ``--data-parallel`` (DP) and ``--sequence-parallel`` (SP) are ported: no
    refusal is left for them (their runs: ``tests/test_torch_mobilenet_lost.py``,
    ``tests/test_torch_viz.py``, ``tests/test_torch_multiprocess.py``,
    ``tests/test_torch_sequence_parallel.py``); sequence parallelism meets
    the JAX driver's checks: not with ``--data-parallel``, and only where
    there is a token axis (vit, dino)."""
    argv = ["lost", "--data-path", str(tmp_path), "--device", "cpu", *flags]
    if item == "SP":
        with pytest.raises(SystemExit, match="mutually exclusive|no token dimension to shard"):
            main(argv)
        return
    from vipers_torch.cli.main import _refuse_unported, build_parser

    assert _refuse_unported(build_parser().parse_args(argv)) is None


def test_orbax_directory_checkpoint_is_refused(voc, tmp_path):
    ckpt = tmp_path / "vit_s_16_checkpoint"
    ckpt.mkdir()
    with pytest.raises(ValueError, match="export_vit_torchvision"):
        main(_lost_argv(voc, tmp_path / "out", "--checkpoint", str(ckpt)))


@pytest.mark.parametrize("as_uint8", [True, False], ids=["uint8", "host-normalize"])
def test_prefetch_matches_jax(voc, as_uint8):
    """The decode feed in dataset order, bit for bit: the uint8 slabs
    (libjpeg) or the host-normalized float32 images (PIL), the exact sizes
    and the GT boxes."""
    from vipers.data.detection import DiscoveryDataset as JDataset
    from vipers.discovery.driver import _prefetch_decoded as jprefetch
    from vipers_torch.data.detection import DiscoveryDataset
    from vipers_torch.discovery.driver import _prefetch_decoded

    got = list(_prefetch_decoded(DiscoveryDataset("VOC07", "trainval", voc["data"]), 16, False,
                                 workers=3, as_uint8=as_uint8))
    want = list(jprefetch(JDataset("VOC07", "trainval", voc["data"]), 16, False,
                          workers=3, as_uint8=as_uint8))
    assert len(got) == len(want) == N_IMAGES
    for g, w in zip(got, want):
        assert g[1] == w[1] and g[3] == w[3]
        assert g[2].dtype == w[2].dtype and np.array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[4], w[4])


def test_namespace_matches_vipers_cli():
    """The port's ``lost`` flags are those of ``vipers lost`` plus
    ``--device``, with the same defaults."""
    import vipers.cli.main as jcli
    import inspect
    import re

    src = inspect.getsource(jcli.main)
    block = src[src.index('lost = sub.add_parser("lost"'):src.index('corloc = sub.add_parser')]
    jflags = set(re.findall(r'lost\.add_argument\("(--[a-z0-9-]+)"', block))
    ns = vars(build_parser().parse_args(["lost"]))
    port = {"--" + k.replace("_", "-") for k in ns} - {"--cmd"}
    assert port == jflags | {"--device"}
    want = argparse.Namespace(model="vit_s_16", arch="vit", dataset="VOC07", set="trainval",
                              batch_size=8, workers=8, k_patches=100, dtype="f32",
                              save_predictions=True, iteration=0, patch_size=16,
                              which_features="k", device="cuda")
    assert all(ns[k] == v for k, v in vars(want).items())
