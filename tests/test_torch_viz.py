"""vipers_torch's LOST drawings and plots against the JAX package's on the
CPU: ``viz.draw`` (``save_lost_visualization`` for ``pred``, ``fms`` and
``seed_expansion``, and the torchvision-utils tail), ``lost --visualize``
through the CLI, and ``plot --kind lost|mass_rank|mvh|mvh-compare|heatmaps``
(``viz.plots``, ``viz.heatmap_report``) from the same text artifacts.

Held: every PNG written by both packages decodes to equal pixels; the
drawing tail's arrays are equal; the plots' parsed series are equal; a
``--visualize`` run writes one drawing an image, each pixel-equal to the
JAX drawer's on the same box, affinity and seed, and its boxes equal the
batched run's.
"""

import glob
import os
import pickle

import numpy as np
import pytest
from PIL import Image

import test_torch_cnn_lost as cnnt
import torch_explain_fixtures as fx
import vipers.viz.draw as jdraw
import vipers.viz.heatmap_report as jreport
import vipers.viz.plots as jplots
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import checkpoint as tck
from vipers_torch.viz import draw as tdraw
from vipers_torch.viz import heatmap_report as treport
from vipers_torch.viz import plots as tplots


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def _same_pngs(got_dir, want_dir, n_min=1):
    got = sorted(os.path.relpath(p, got_dir) for p in glob.glob(f"{got_dir}/**/*.*",
                                                               recursive=True))
    want = sorted(os.path.relpath(p, want_dir) for p in glob.glob(f"{want_dir}/**/*.*",
                                                                 recursive=True))
    assert got == want and len(got) >= n_min, (got, want)
    for rel in got:
        if rel.endswith((".png", ".gif")):
            np.testing.assert_array_equal(_pixels(os.path.join(got_dir, rel)),
                                          _pixels(os.path.join(want_dir, rel)), err_msg=rel)


@pytest.fixture(scope="module")
def drawn_inputs(tmp_path_factory):
    """An RGB JPEG (75 x 100), a 5 x 7 grid at 15 x 14 px cells, its
    affinity, scores, seed, a predicted and two GT boxes."""
    root = tmp_path_factory.mktemp("img")
    rng = np.random.default_rng(0)
    path = str(root / "im.jpg")
    Image.fromarray(rng.integers(0, 255, (75, 100, 3), dtype=np.uint8)).save(path)
    t = 35
    feats = rng.normal(0, 1, (t, 8))
    A = feats @ feats.T
    scores = (A > 0).sum(1).astype(np.float32)
    return dict(image_path=path, pred=np.array([14.0, 15.0, 70.0, 60.0]),
                gt=np.array([[10, 10, 60, 50], [30, 20, 90, 70]]), A=A, scores=scores,
                seed=int(np.argmin(scores)), dims=(5, 7), scales=[15.0, 14.0])


@pytest.mark.parametrize("kind", ["pred", "fms", "seed_expansion"])
def test_save_lost_visualization_pixels_equal_jax(kind, drawn_inputs, tmp_path):
    d = drawn_inputs
    for mod, out in ((tdraw, tmp_path / "torch"), (jdraw, tmp_path / "jax")):
        mod.save_lost_visualization(kind, d["image_path"], d["pred"], d["gt"], d["A"],
                                    d["scores"], d["seed"], d["dims"], d["scales"], str(out),
                                    "im.jpg")
    _same_pngs(tmp_path / "torch", tmp_path / "jax", n_min=2 if kind == "fms" else 1)


def test_drawing_tail_equals_jax():
    rng = np.random.default_rng(1)
    image = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    masks = rng.random((3, 20, 30)) > 0.6
    np.testing.assert_array_equal(tdraw.draw_segmentation_masks(image, masks, 0.6),
                                  jdraw.draw_segmentation_masks(image, masks, 0.6))
    np.testing.assert_array_equal(
        tdraw.draw_segmentation_masks(image, masks[0], colors=(1, 2, 3)),
        jdraw.draw_segmentation_masks(image, masks[0], colors=(1, 2, 3)))
    kp = rng.uniform(0, 20, (2, 4, 2))
    np.testing.assert_array_equal(tdraw.draw_keypoints(image, kp, [(0, 1), (2, 3)]),
                                  jdraw.draw_keypoints(image, kp, [(0, 1), (2, 3)]))
    flow = rng.normal(0, 3, (2, 2, 9, 11)).astype(np.float32)
    np.testing.assert_array_equal(tdraw.flow_to_image(flow), jdraw.flow_to_image(flow))
    np.testing.assert_array_equal(tdraw.flow_to_image(flow[0]), jdraw.flow_to_image(flow[0]))


def _lost(tmp_path, tag, arch, model, pth, extra=()):
    data = str(tmp_path / "voc")
    if not os.path.exists(data):
        cnnt._voc_subset(tmp_path / "voc")
    argv = ["lost", "--arch", arch, "--model", model, "--data-path", data,
            "--output-dir", str(tmp_path / tag), "--batch-size", "2", "--workers", "2",
            "--k-patches", "10", "--device", "cpu", *extra]
    if pth:
        argv += ["--checkpoint", pth]
    assert tmain(argv) == 0
    return {k: np.asarray(v).tolist()
            for k, v in pickle.load(open(tmp_path / tag / "preds.pkl", "rb")).items()}


@pytest.mark.parametrize("kind", ["pred", "seed_expansion"])
def test_lost_visualize_mobilenet_matches_the_jax_drawer(kind, tmp_path):
    """``lost --arch mobilenet --visualize`` runs every image one at a time
    (``extract`` on its bucket at B = 1, then ``lost``): one drawing an
    image, pixel-equal to the JAX drawer's on the port's box, affinity and
    seed for that image; the boxes equal the batched run's."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.data.detection import DiscoveryDataset
    from vipers_torch.discovery.driver import LostFeatureExtractor, _prefetch_decoded
    from vipers_torch.discovery.lost import lost

    import test_torch_mobilenet_lost as mbt

    params, stats, masks = mbt._weights(width=1.0)
    pth = str(tmp_path / "mb.pth")
    tck.save_torch_state_dict(tck.export_mobilenet_v2(params, stats, masks, bake_masks=False),
                              pth)
    batched = _lost(tmp_path, "batched", "mobilenet", "mobilenet_v2", pth)
    drawn = _lost(tmp_path, "drawn", "mobilenet", "mobilenet_v2", pth, ["--visualize", kind])
    assert drawn == batched and len(drawn) == 3
    spec = build_model("mobilenet_v2", num_classes=10)
    ex = LostFeatureExtractor(spec, params, masks, device="cpu", batch_stats=stats)
    ds = DiscoveryDataset("VOC07", "trainval", str(tmp_path / "voc"))
    for path, name, img, size, gt in _prefetch_decoded(ds, 16, False, workers=1):
        feats, dims, valid, scales, _ = ex.extract(img, 16)
        pred, A, scores, seed = lost(feats, dims, scales, size, k_patches=10,
                                     valid_dims=valid)
        jdraw.save_lost_visualization(kind, path, pred, gt, A, scores, seed, dims, scales,
                                      str(tmp_path / "jax"), name)
    got = sorted(f for f in os.listdir(tmp_path / "drawn") if f.endswith(".png"))
    assert got == sorted(os.listdir(tmp_path / "jax")) and len(got) == 3
    for f in got:
        np.testing.assert_array_equal(_pixels(tmp_path / "drawn" / f),
                                      _pixels(tmp_path / "jax" / f), err_msg=f)


def test_lost_visualize_vit_keeps_the_batched_boxes(tmp_path):
    """``lost --visualize fms`` on the default ViT-S/16 (seed-0 weights):
    the per-image route writes each image's degree and seed-affinity maps
    and the batched pipeline's boxes."""
    batched = _lost(tmp_path, "batched", "vit", "vit_s_16", "")
    drawn = _lost(tmp_path, "drawn", "vit", "vit_s_16", "", ["--visualize", "fms"])
    assert drawn == batched
    assert sorted(os.listdir(tmp_path / "drawn")) == sorted(
        [f"{n}.jpg_{m}.png" for n in cnnt.CLI_IMAGES for m in ("degree", "seed_affinity")]
        + ["preds.pkl", "results_iteration_00.txt"])


# ------------------------------------------------------------ plot

MVH_ROWS = ("colour", "rotation", "silhouette")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The text artifacts the pipelines write, three pruning iterations."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(2)
    with open(root / "performance.txt", "w") as f:
        f.write("acc1\tsparsity\n")
        for it in range(3):
            f.write(f"{70 - 3 * it:.2f}\t{100 * (1 - 0.8 ** it):.2f}\n")
    for it in range(3):
        (root / f"results_iteration_{it:02d}.txt").write_text(
            f"{it},{rng.uniform(30, 60):.4f}\n")
        for method in ("gradCAM", "ig", "attention"):
            (root / f"{method}_resnet50_pruning_iteration_{it:02d}.txt").write_text(
                f"Average Mass: {rng.random()}\nAverage Rank: {rng.random()}\n"
                "On a total of 4 images.\n")
        for model in ("resnet50", "resnet18"):
            (root / f"{model}_pruning_step_{it}.csv").write_text(
                "subj,model,test,value\n" + "".join(
                    f"{model},{b},accuracy (top-1),{rng.random():.4f}\n" for b in MVH_ROWS))
        for cls in ("cat", "dog"):
            d = root / f"pruning_iteration_{it:02d}" / "gradcam" / cls
            d.mkdir(parents=True)
            Image.fromarray(rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)).save(
                d / "heatmap_x.png")
    return root


KINDS = {
    "lost": [],
    "mass_rank": ["--model", "resnet50"],
    "mvh": ["--model", "resnet50"],
    "mvh-compare": ["--models", "resnet18", "resnet50", "--benchmarks", "colour", "rotation",
                    "--max-prune", "4"],
    "heatmaps": ["--method", "gradcam", "--gif"],
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_plot_pixels_equal_jax(kind, results, tmp_path):
    """Both CLIs' ``plot --kind`` on the same files: the same files, pixel
    for pixel."""
    for pkg, main in (("torch", tmain), ("jax", jmain)):
        os.makedirs(tmp_path / pkg)
        rc = main(["plot", "--kind", kind, "--results-dir", str(results),
                   "--performance-txt", str(results / "performance.txt"),
                   "--out", str(tmp_path / pkg / "plot.png"), *KINDS[kind]])
        assert rc in (0, None)
    _same_pngs(tmp_path / "torch", tmp_path / "jax", n_min=4 if kind == "heatmaps" else 1)


def test_plot_series_equal_jax(results):
    r = str(results)
    assert tplots.read_results_iterations(r) == jplots.read_results_iterations(r)
    for m in ("gradCAM", "ig", "attention"):
        assert tplots.read_mass_rank(r, m, "resnet50") == jplots.read_mass_rank(r, m, "resnet50")
    for step in range(3):
        path = str(results / f"resnet50_pruning_step_{step}.csv")
        assert tplots.read_mvh_csv(path) == jplots.read_mvh_csv(path)
        assert sorted(tplots.read_mvh_csv(path)) == sorted(MVH_ROWS)
    assert treport.list_classes(r, "gradcam") == jreport.list_classes(r, "gradcam") == [
        "cat", "dog"]
    assert (treport.collect_iteration_images(r, "gradcam", "cat")
            == jreport.collect_iteration_images(r, "gradcam", "cat"))


def test_plot_parser_takes_the_jax_flags_and_defaults():
    from vipers.cli.main import main as _unused  # noqa: F401  (the JAX parser is built in main)
    from vipers_torch.cli.main import build_parser

    a = build_parser().parse_args(["plot"])
    assert (a.kind, a.model, a.models, a.benchmarks, a.max_prune, a.results_dir,
            a.performance_txt, a.out, a.method, a.cls, a.gif) == (
        "lost", "resnet50", None, None, 26, "./outputs", "performance.txt", "plot.png",
        "gradcam", "", False)
    assert not hasattr(a, "device")
