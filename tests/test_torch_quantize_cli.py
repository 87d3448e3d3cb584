"""``python -m vipers_torch.cli.main quantize`` and ``lost --dtype int8``
on the CPU, with the files they write checked: PTQ and QAT on
``quantized_mobilenet_v2`` (full width, 2 classes, 32x32 crops of a tiny
ImageFolder, B=4), PTQ on the CLI tests' tiny ViT (``tests/
torch_explain_fixtures.py``, pos table at 224) and ``lost --dtype int8``
from its ``.pth`` (static qparams from the checkpoint's observers) against
``vipers lost --dtype int8`` on the same weights and observers, and
``slim`` carrying the observers across.

The numbers inside are held to the JAX package in the other
``tests/test_torch_quantize*.py`` files; here the CLI's lines, files and
the consistency of what it writes: the observer keys are the model's
sites, the PTQ weights the QDQ of the masked ones, and in QAT the
observers and BatchNorm statistics stay as epoch 0 left them once their
freeze epoch has passed.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import torch_explain_fixtures as fx
from test_torch_slim_cli import _voc, vit_weights
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import main as tmain
from vipers_torch.core import checkpoint as tck
from vipers_torch.core.registry import build_model as tbuild
from vipers_torch.core.tree import flatten_dict
from vipers_torch.discovery.driver import load_lost_checkpoint
from vipers_torch.pruning import init_masks, magnitude_prune
from vipers_torch.train import quantize as tq

MB = "quantized_mobilenet_v2"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@pytest.fixture(scope="module", autouse=True)
def _cli_vit():
    yield from fx.register_cli_vit()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("qds")
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 4)):
        for cls in ("class_a", "class_b"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8)
                if cls == "class_b":
                    arr[..., 1] = np.minimum(arr[..., 1].astype(np.int16) + 80, 255)
                Image.fromarray(arr.astype(np.uint8)).save(d / f"img_{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def mobilenet_pth(tmp_path_factory):
    """A 50%-magnitude-pruned quantized_mobilenet_v2 at 2 classes as the
    port's ``.pth`` (masked layers as weight_orig / weight_mask)."""
    spec = tbuild(MB, num_classes=2)
    params = {p: a.numpy() for p, a in flatten_dict(
        spec.init(torch.Generator().manual_seed(0))).items()}
    from vipers_torch.core.tree import unflatten_dict

    params = unflatten_dict(params)
    masks = {p: m.numpy() for p, m in magnitude_prune(params, init_masks(params), 0.5).items()}
    path = str(tmp_path_factory.mktemp("mbck") / "mb.pth")
    tck.save_torch_state_dict(tck.export_mobilenet_v2(params, None, masks, bake_masks=False),
                              path)
    return path, spec, masks


def _quantize(data, resume, out, *extra, model=MB, crop="32", resize="40"):
    return fx.run_cli(tmain, [
        "quantize", "--model", model, "--data-path", data, "--num-classes", "2",
        "--batch-size", "4", "--train-crop-size", crop, "--val-resize-size", resize,
        "--val-crop-size", crop, "--workers", "2", "--lr", "0.001", "--device", "cpu",
        "--resume", resume, "--output-dir", str(out), *extra])


def _sites(spec, crop=32):
    model = spec.module()
    return tq.observer_sites(model, tck.family(spec), torch.zeros((1, crop, crop, 3)),
                             exclude=spec.quant_exclude, need_attn=False)


@pytest.mark.parametrize("flag", [["--mode", "ptq"], ["--post-training-quantize"]],
                         ids=["mode-ptq", "alias"])
def test_quantize_ptq_writes_the_jax_lines_and_file(data, mobilenet_pth, tmp_path, flag):
    ck, spec, masks = mobilenet_pth
    rc, text = _quantize(data, ck, tmp_path, *flag, "--calibration-batches", "2")
    assert rc == 0
    sites = _sites(spec)
    assert len(sites) == 53
    lines = text.splitlines()
    assert f"{len(sites)} quantizable activation sites" in lines
    qdq = [ln for ln in lines if ln.startswith("PTQ QDQ:  acc1 ")]
    int8 = [ln for ln in lines if ln.startswith("PTQ int8: acc1 ")]
    assert len(qdq) == 1 and len(int8) == 1
    assert int8[0].endswith("(Dense/Conv layers executed in int8)")
    assert sum(ln.startswith("Test: Acc@1") for ln in lines) == 2
    # the session's (empty) metrics stream, as the JAX session opens it
    assert fx.file_tree(tmp_path) == ["metrics.jsonl", "quantized_post_train_model.pth"]
    params, stats, got_masks, observers = load_lost_checkpoint(
        str(tmp_path / "quantized_post_train_model.pth"), spec)
    assert list(observers) == list(tq.init_observers(sites))
    for o in observers.values():
        assert o["min"].dtype == torch.float32 and float(o["min"]) <= float(o["max"])
    assert set(got_masks) == set(masks)
    for p, m in masks.items():
        np.testing.assert_array_equal(got_masks[p], m)
    assert stats is not None
    # the weights are the QDQ of the masked ones, so re-quantizing is exact
    fam = tck.family(spec)
    sd = fam.state_dict(params)
    q, scales = tq.quantize_params_int8(sd, fam)
    again = tq.dequantize_params(sd, fam, q, scales)
    for k, site in tq.weight_sites(sd, fam).items():
        np.testing.assert_allclose(again[k].numpy(), sd[k].numpy(), rtol=2e-7, atol=0)


def test_quantize_qat_freezes_observers_and_batchnorm_on_schedule(data, mobilenet_pth,
                                                                   tmp_path):
    ck, spec, _masks = mobilenet_pth
    sched = ["--mode", "qat", "--num-observer-update-epochs", "1",
             "--num-batch-norm-update-epochs", "1", "--print-freq", "2"]
    rc, text = _quantize(data, ck, tmp_path / "two", *sched, "--epochs", "2")
    assert rc == 0
    lines = text.splitlines()
    want_order = ["QAT epoch 0 [0] loss ", "QAT epoch 0 [2] loss ", "Test:QAT Acc@1 ",
                  "Test:INT8 Acc@1 ", "Disabling observer for subseq epochs, epoch = 1",
                  "Freezing BN for subseq epochs, epoch = 1", "QAT epoch 1 [0] loss ",
                  "Test:QAT Acc@1 ", "Test:INT8 Acc@1 "]
    it = iter(lines)
    for w in want_order:
        assert any(ln.startswith(w) for ln in it), w
    assert fx.file_tree(tmp_path / "two") == ["metrics.jsonl", "qat_checkpoint.pth"]
    rc, _ = _quantize(data, ck, tmp_path / "one", *sched, "--epochs", "1")
    assert rc == 0
    one = torch.load(tmp_path / "one" / "qat_checkpoint.pth", weights_only=False)
    two = torch.load(tmp_path / "two" / "qat_checkpoint.pth", weights_only=False)
    assert (one["epoch"], two["epoch"]) == (0, 1)
    assert list(two["observers"]) == list(tq.init_observers(_sites(spec)))
    for k, o in two["observers"].items():  # frozen from epoch 1 on
        assert torch.equal(o["min"], one["observers"][k]["min"]), k
        assert torch.equal(o["max"], one["observers"][k]["max"]), k
    moved = 0
    for k, v in two["model"].items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, one["model"][k]), k  # BatchNorm frozen from epoch 1
        elif k.endswith("weight_orig"):
            moved += not torch.equal(v, one["model"][k])
    assert moved  # while the weights kept training


def test_quantize_requires_resume_and_one_device(data, tmp_path):
    with pytest.raises(SystemExit, match="requires --resume"):
        fx.run_cli(tmain, ["quantize", "--model", MB, "--data-path", data, "--num-classes", "2",
                           "--device", "cpu", "--output-dir", str(tmp_path)])
    # data parallelism is ported (tests/test_torch_multiprocess.py); tensor parallelism has
    # no spec for a CNN (and is not ported for a ViT's QAT: tests/test_torch_tensor_parallel.py)
    with pytest.raises(SystemExit, match="no tensor-parallel spec"):
        fx.run_cli(tmain, ["quantize", "--model", MB, "--data-path", data, "--device", "cpu",
                           "--model-parallel", "2", "--resume", "x.pth",
                           "--output-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def vit_ptq(data, tmp_path_factory):
    """``quantize --mode ptq`` of the tiny ViT's masked weights at 224."""
    root = tmp_path_factory.mktemp("vitq")
    params, masks = vit_weights(num_classes=2)
    ck = str(root / "vit.pth")
    tck.save_torch_state_dict(tck.export_vit_torchvision(params, masks, bake_masks=False), ck)
    rc, text = _quantize(data, ck, root / "q", "--mode", "ptq", "--calibration-batches", "1",
                         model=fx.CLI_NAME, crop="224", resize="224")
    assert rc == 0
    spec = tbuild(fx.CLI_NAME, num_classes=2)
    assert "6 quantizable activation sites" in text.splitlines()
    return str(root / "q" / "quantized_post_train_model.pth"), spec


def test_lost_int8_reads_the_observers_as_jax_does(vit_ptq, tmp_path, monkeypatch):
    """``lost --dtype int8 --checkpoint <ptq .pth>``: the static qparams of
    the checkpoint's observers; ``vipers lost --dtype int8`` on an orbax
    directory of the same weights, masks and observers gives the same
    boxes."""
    from vipers.core.checkpoint import save_checkpoint

    monkeypatch.setenv("VIPERS_JAX_CACHE", "0")
    pth, spec = vit_ptq
    voc = _voc(tmp_path / "voc")
    params, _stats, masks, observers = load_lost_checkpoint(pth, spec)
    assert observers and all(k.rsplit(":", 1)[0] in
                             {"conv_proj", "head"} | {f"encoder_layer_{i}/mlp/fc{j}"
                                                       for i in range(2) for j in (1, 2)}
                             for k in observers)
    orbax = str(tmp_path / "jax_ck")
    save_checkpoint(orbax, {"params": params,
                            "masks": {"/".join(k): np.asarray(v) for k, v in masks.items()},
                            "observers": {k: {"min": o["min"].numpy(), "max": o["max"].numpy()}
                                          for k, o in observers.items()}})
    preds = {}
    for pkg, main, ckpt, extra in (("torch", tmain, pth, ["--device", "cpu"]),
                                   ("jax", jmain, orbax, [])):
        out = tmp_path / pkg
        rc, _ = fx.run_cli(main, ["lost", "--model", fx.CLI_NAME, "--data-path", voc,
                                  "--checkpoint", ckpt, "--dtype", "int8", "--batch-size", "2",
                                  "--output-dir", str(out), *extra])
        assert rc == 0
        assert sorted(os.listdir(out)) == ["preds.pkl", "results_iteration_00.txt"]
        with open(out / "preds.pkl", "rb") as f:
            preds[pkg] = pickle.load(f)
    assert sorted(preds["torch"]) == sorted(preds["jax"]) and len(preds["torch"]) == 2
    for k in preds["jax"]:
        np.testing.assert_array_equal(preds["torch"][k], preds["jax"][k])


def test_slim_carries_the_observers_unchanged(vit_ptq, tmp_path):
    pth, spec = vit_ptq
    _p, _s, _m, observers = load_lost_checkpoint(pth, spec)
    rc, _ = fx.run_cli(tmain, ["slim", "--model", fx.CLI_NAME, "--checkpoint", pth,
                               "--num-classes", "2", "--mlp-keep", "0.5", "--heads-keep", "0.5",
                               "--round-to", "1", "--output-dir", str(tmp_path)])
    assert rc == 0
    out = str(tmp_path / f"{fx.CLI_NAME}_slim_m64_h1.pth")
    assert os.path.exists(out + ".slim.json")
    slim_spec = tbuild(fx.CLI_NAME, num_classes=2,
                       arch_overrides={"mlp_dim": 64, "num_heads": 1, "head_dim": 32})
    _p, _s, masks, slim_obs = load_lost_checkpoint(out, slim_spec)
    assert masks and list(slim_obs) == list(observers)
    for k, o in observers.items():
        assert torch.equal(slim_obs[k]["min"], o["min"]) and \
            torch.equal(slim_obs[k]["max"], o["max"]), k


def test_bench_int8_tool_runs_on_the_cpu(capsys):
    """``vipers_torch.tools.bench_int8`` at one block and one image on the
    CPU: a row a model with positive rates, the JSON line last."""
    import json

    from vipers_torch.tools import bench_int8

    out = bench_int8.main(["--device", "cpu", "--layers", "1", "--batch", "1",
                           "--n-batches", "1"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert sorted(out) == ["vit_b_16", "vit_s_16"]
    for row in out.values():
        assert row["bf16"] > 0 and row["int8"] > 0
        assert row["int8_over_bf16"] == round(row["int8"] / row["bf16"], 3)


def test_lost_int8_on_the_fixture_jpegs(tmp_path):
    """``lost --dtype int8`` on the committed VOC fixture (8 JPEGs at their
    VOC sizes, several buckets), the tiny ViT at random weights: dynamic
    qparams; preds.pkl holds every image not reported as a seed in the
    background, and the results txt is written."""
    voc = os.path.join(os.path.dirname(__file__), "data", "torch_voc")
    rc, text = fx.run_cli(tmain, ["lost", "--model", fx.CLI_NAME, "--dtype", "int8",
                                  "--data-path", voc, "--batch-size", "4", "--device", "cpu",
                                  "--output-dir", str(tmp_path)])
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["preds.pkl", "results_iteration_00.txt"]
    with open(tmp_path / "preds.pkl", "rb") as f:
        preds = pickle.load(f)
    n_failed = next((int(ln.split(" for ")[1].split()[0]) for ln in text.splitlines()
                     if ln.startswith("WARNING: seed in background")), 0)
    assert len(preds) + n_failed == 8 and preds


def test_train_evaluate_then_quantize_mobilenet_v2(data, tmp_path):
    """``mobilenet_v2`` through ``train`` (one LRR round) and ``evaluate``,
    then ``quantize --mode ptq --resume`` of the train checkpoint: the
    masks the train run wrote come through into the quantized .pth."""
    common = ["--model", "mobilenet_v2", "--data-path", data, "--num-classes", "2",
              "--batch-size", "4", "--train-crop-size", "32", "--val-resize-size", "40",
              "--val-crop-size", "32", "--workers", "2", "--device", "cpu"]
    rc, text = fx.run_cli(tmain, ["train", *common, "--epochs", "1", "--lr", "0.01",
                                  "--print-freq", "0", "--pruning-method", "magnitude",
                                  "--pruning-rate", "0.5", "--pruning-threshold", "40",
                                  "--output-dir", str(tmp_path / "train")])
    assert rc == 0
    ck = tmp_path / "train" / "mobilenet_v2_epoch_0_pruning_iteration_00.pth"
    assert ck.exists() and "Pruning iteration: 0 (sparsity 0.00%)" in text
    rc, text = fx.run_cli(tmain, ["evaluate", *common, "--models-path", str(tmp_path / "train"),
                                  "--output-dir", str(tmp_path / "eval")])
    assert rc == 0 and any(ln.startswith("acc1 ") for ln in text.splitlines())
    rc, text = fx.run_cli(tmain, ["quantize", *common, "--mode", "ptq", "--calibration-batches",
                                  "1", "--resume", str(ck), "--output-dir", str(tmp_path / "q")])
    assert rc == 0 and "53 quantizable activation sites" in text.splitlines()
    spec = tbuild("mobilenet_v2", num_classes=2)
    _p, _s, masks, observers = load_lost_checkpoint(str(tmp_path / "q" /
                                                        "quantized_post_train_model.pth"), spec)
    _p, _s, train_masks, none = load_lost_checkpoint(str(ck), spec)
    assert none is None and len(observers) == 106
    assert set(masks) == set(train_masks)
    for p, m in train_masks.items():
        np.testing.assert_array_equal(masks[p], m)
