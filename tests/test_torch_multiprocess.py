"""vipers_torch's ``train``, ``evaluate``, ``quantize --mode ptq`` and
``lost`` CLIs under a torchrun-style launch of 2 gloo ranks on the CPU
against one process at the global batch.

One module fixture runs ``tests/torch_dp_child.py`` once as one process
(per-process batch 16) and once as 2 ranks (8 each): resnet18 SNIP at 32
px for 2 epochs of 1 step with RandomErasing and mixup/cutmix, a tiny ViT
(dropout 0.1) through one LRR round with SGD momentum, ``evaluate`` of the
one-process resnet sweep over a 9-image val split (a sentinel row on the
second rank), PTQ of its last checkpoint and ``lost`` of its ViT
checkpoint over 7 VOC-style JPEGs (4 and 3 a rank). Tolerances are those
of the JAX package's multi-process test (``tests/test_multiprocess.py``):
masks, integer counts, printed accuracies and ``preds.pkl`` exact;
parameters after 1 step rtol 1e-4 / atol 2e-5, after 2 steps rtol 5e-2 /
atol 3e-3 (the ranks' sums round in another order than one process's);
losses and observers as parameters after 1 step.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_dp_child.py")
WORLD = 2
GLOBAL_BATCH = 16
ONE_STEP = dict(rtol=1e-4, atol=2e-5)
TWO_STEPS = dict(rtol=5e-2, atol=3e-3)


def _write_data(root):
    rng = np.random.default_rng(7)
    for split, counts in (("train", (8, 8)), ("val", (5, 4))):
        for cls, n in zip(("class_a", "class_b"), counts):
            d = os.path.join(root, split, cls)
            os.makedirs(d)
            for i in range(n):
                arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
                if cls == "class_b":
                    arr[..., 0] = np.minimum(arr[..., 0].astype(np.int16) + 80,
                                             255).astype(np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"img_{i}.jpg"))


def _write_voc(root):
    """7 JPEGs of a striped box on a flat ground, with VOC annotations."""
    rng = np.random.default_rng(11)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub))
    names = []
    for i, (w, h) in enumerate([(192, 128), (160, 100), (150, 96), (170, 110), (100, 160),
                                (96, 150), (110, 170)]):
        arr = np.broadcast_to(rng.integers(200, 240, 3).astype(np.float64), (h, w, 3)) \
            + rng.normal(0, 2, (h, w, 3))
        bw, bh = int(rng.integers(w // 4, w // 2)), int(rng.integers(h // 4, h // 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        yy, xx = np.mgrid[0:bh, 0:bw]
        c0, c1 = rng.integers(0, 40, (2, 3))
        arr[y0:y0 + bh, x0:x0 + bw] = np.where((((xx + yy) // 6) % 2)[..., None] == 1, c1, c0)
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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stages(out):
    """{stage: [printed line, ...]} from a child's STAGE lines."""
    got = {}
    for line in out.splitlines():
        if line.startswith("STAGE "):
            stage, text = line[len("STAGE "):].split(" ", 1)
            got.setdefault(stage, []).append(text)
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dp")
    data, voc = str(root / "data"), str(root / "voc")
    _write_data(data)
    _write_voc(voc)
    single, multi = str(root / "single"), str(root / "multi")
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID"):
        env.pop(k, None)
    p = subprocess.run([sys.executable, CHILD, data, voc, single, str(GLOBAL_BATCH), single],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "DONE rank 0 world 1" in p.stdout
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, CHILD, data, voc, multi, str(GLOBAL_BATCH // WORLD), single],
        cwd=REPO, env=dict(env, RANK=str(r), WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    outs = []
    for r, proc in enumerate(procs):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"rank {r}:\n{err[-4000:]}"
        assert f"DONE rank {r} world {WORLD}" in out
        outs.append(out)
    return {"single": single, "multi": multi, "single_out": _stages(p.stdout),
            "rank_outs": [_stages(o) for o in outs]}


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _assert_state_dicts(a, b, tol, what):
    assert a.keys() == b.keys()
    for k in a:
        if k.endswith("_mask") or k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], b[k]), f"{what} {k}"
        else:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), err_msg=f"{what} {k}", **tol)


@pytest.mark.parametrize("stage", ["train_resnet", "train_vit", "evaluate", "quantize"])
def test_every_rank_prints_the_one_process_accuracies(runs, stage):
    want = runs["single_out"][stage]
    assert want
    for got in runs["rank_outs"]:
        assert got[stage] == want


@pytest.mark.parametrize("epoch", [0, 1], ids=["one-step", "two-steps"])
def test_snip_resnet_checkpoints_match_one_process(runs, epoch):
    """SNIP masks exact (the first global batch on rank 0), parameters and
    BatchNorm statistics within the step's tolerance."""
    name = f"resnet/resnet18_epoch_{epoch}_snip_0.5.pth"
    a, b = _load(os.path.join(runs["single"], name)), _load(os.path.join(runs["multi"], name))
    assert any(k.endswith("weight_mask") for k in a["model"])
    _assert_state_dicts(a["model"], b["model"], ONE_STEP if epoch == 0 else TWO_STEPS, name)
    assert (a["epoch"], a["step"], a["sparsity"]) == (b["epoch"], b["step"], b["sparsity"])
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == epoch + 1


def test_lrr_vit_checkpoint_and_masks_match_one_process(runs):
    name = "vit/vit_dp_tiny_epoch_0_pruning_iteration_00.pth"
    a, b = _load(os.path.join(runs["single"], name)), _load(os.path.join(runs["multi"], name))
    _assert_state_dicts(a["model"], b["model"], ONE_STEP, name)
    for run in ("single", "multi"):
        with open(os.path.join(runs[run], "vit", "performance.txt")) as f:
            rows = f.read().splitlines()
        assert rows[0] == "acc1\tsparsity" and len(rows) == 2
    # the prune records: LRR's global-magnitude masks give the same sparsity
    recs = [[json.loads(line) for line in open(os.path.join(runs[r], "vit", "metrics.jsonl"))]
            for r in ("single", "multi")]
    assert [r["tag"] for r in recs[0]] == [r["tag"] for r in recs[1]]
    assert recs[0][-1]["sparsity"] == recs[1][-1]["sparsity"] == 50.0


@pytest.mark.parametrize("sub", ["resnet", "vit"])
def test_metrics_streams_match_one_process(runs, sub):
    """Rank 0 alone writes ``metrics.jsonl``: the one-process records, the
    accuracies exact and the losses within 1e-4."""
    recs = [[json.loads(line) for line in open(os.path.join(runs[r], sub, "metrics.jsonl"))]
            for r in ("single", "multi")]
    assert len(recs[0]) == len(recs[1])
    for a, b in zip(*recs):
        assert {k: v for k, v in a.items() if k not in ("ts", "loss")} == \
            {k: v for k, v in b.items() if k not in ("ts", "loss")}
        if "loss" in a:
            np.testing.assert_allclose(b["loss"], a["loss"], **ONE_STEP)


def test_evaluate_sweep_rows_match_one_process(runs):
    rows = {}
    for r in ("single", "multi"):
        with open(os.path.join(runs[r], "eval", "resnet18_dilation_1.txt")) as f:
            rows[r] = [line.split() for line in f.read().splitlines()]
    assert len(rows["single"]) == len(rows["multi"]) == 6
    for a, b in zip(rows["single"], rows["multi"]):
        assert a[0] == b[0] and a[2:] == b[2:]
        if a[0].endswith("loss"):
            np.testing.assert_allclose(float(b[1]), float(a[1]), **ONE_STEP)
        else:  # accuracies are integer counts over 9 images
            assert a[1] == b[1]
    with open(os.path.join(runs["single"], "eval", "performance.txt")) as f, \
            open(os.path.join(runs["multi"], "eval", "performance.txt")) as g:
        assert f.read() == g.read()


def test_ptq_observers_and_weights_match_one_process(runs):
    name = "quant/quantized_post_train_model.pth"
    a, b = _load(os.path.join(runs["single"], name)), _load(os.path.join(runs["multi"], name))
    assert a["observers"].keys() == b["observers"].keys() and len(a["observers"]) > 20
    for site, obs in a["observers"].items():
        for m in ("min", "max"):
            np.testing.assert_allclose(float(b["observers"][site][m]), float(obs[m]),
                                       err_msg=site, **ONE_STEP)
    _assert_state_dicts(a["model"], b["model"], dict(rtol=0, atol=0), name)


def test_lost_preds_and_results_match_one_process(runs):
    preds = [pickle.load(open(os.path.join(runs[r], "lost", "preds.pkl"), "rb"))
             for r in ("single", "multi")]
    assert len(preds[0]) == 7 and preds[0] == preds[1]
    txt = [open(os.path.join(runs[r], "lost", "results_iteration_00.txt")).read()
           for r in ("single", "multi")]
    assert txt[0] == txt[1]
    # rank 0 alone prints the merged corloc
    assert runs["rank_outs"][0]["lost"] == runs["single_out"]["lost"]
    assert "lost" not in runs["rank_outs"][1]
