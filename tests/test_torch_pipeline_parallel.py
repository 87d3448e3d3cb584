"""Pipeline parallelism (``vipers_torch.parallel.pp``, ``train
--pipeline-parallel``) as gloo ranks on the CPU against the JAX package's
``vipers/parallel/pp.py`` (the cases of ``tests/test_pipeline.py``) and
against one process.

Module fixtures start ``tests/torch_mp_child.py pp`` once as 2 ranks (one
pipeline of 2 stages) and once as 4 (``--pp-data 2``: 2 pipelines of 2
stages): a tiny ViT (patch 4, 4 blocks, D 32, 2 heads, mlp 64, 5 classes,
16x16 inputs, a 50% magnitude mask). The forward is held against
``pp_vit_apply`` (3e-5 / 1e-4), two SGD steps with and without remat
against ``make_pp_train_step`` (5e-5 / 1e-4), the eval step against
``make_pp_eval_step`` (1e-5), the default microbatch on a batch of 5.
``pp_cli`` runs the train CLI (SNIP for one epoch, one LRR round) with
``--pp-microbatch 2 --pp-remat`` (2 ranks) and ``--pp-data 2`` (4 ranks)
against one process: masks exact, parameters and momentum within the
JAX multi-process test's tolerances (``tests/test_torch_multiprocess.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests import torch_mp_child as mp
from tests.test_torch_multiprocess import _write_data

CFG = dict(patch_size=4, num_layers=4, num_heads=2, hidden_dim=32, mlp_dim=64, num_classes=5)
TWO_STEPS = dict(rtol=5e-2, atol=3e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny():
    from vipers.models.vit import ViTConfig, VisionTransformer

    cfg = ViTConfig(**CFG)
    module = VisionTransformer(cfg=cfg, image_size=(16, 16))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(4, 16, 16, 3)), jnp.float32)
    variables = module.init(jax.random.PRNGKey(0), x, train=False)
    return cfg, module, variables


def _pipe_mesh(n, data=1):
    devs = np.asarray(jax.devices()[:n * data])
    return Mesh(devs.reshape(data, n), ("data", "pipe")) if data > 1 else Mesh(devs, ("pipe",))


def _flat_torch(sd):
    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_model
    from vipers_torch.core.tree import flatten_dict

    return flatten_dict(family(build_model("vit_s_16")).trees(sd)[0])


def _run(tmp_path_factory, world):
    import optax

    from vipers.parallel.pp import make_pp_eval_step, make_pp_train_step, pp_vit_apply
    from vipers.pruning import init_masks, magnitude_prune
    from vipers.train.steps import TrainState

    cfg, module, variables = _tiny()
    params = variables["params"]
    masks = magnitude_prune(params, init_masks(params, exclude=("qkv",)), 0.5)
    data = world // 2
    rng = np.random.default_rng(5)
    n = 4 * data
    x = rng.normal(size=(n, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 5, n)
    x5 = rng.normal(size=(5 * data, 16, 16, 3)).astype(np.float32)
    fwd_mbs, train_mb = ([1, 2], 2) if data == 1 else ([2, 4], 4)
    out = tmp_path_factory.mktemp(f"pp{world}")
    torch.save({"cfg": CFG, "image_size": (16, 16), "params": jax.tree.map(np.asarray, params),
                "masks": {k: np.asarray(m) for k, m in masks.items()}, "x": x, "y": y,
                "x5": x5, "forward_microbatches": fwd_mbs, "train_microbatch": train_mb},
               os.path.join(out, "inputs.pt"))
    mp.launch("pp", out, world)

    mesh = _pipe_mesh(2, data)
    data_axis = "data" if data > 1 else None
    ref = {f"forward_{mb}": pp_vit_apply(params, jnp.asarray(x), cfg=cfg, mesh=mesh,
                                         microbatch=mb, data_axis=data_axis)
           for mb in fwd_mbs}
    ref["forward_default_5"] = pp_vit_apply(params, jnp.asarray(x5), cfg=cfg, mesh=mesh,
                                            data_axis=data_axis)
    ref["dense_5"] = module.apply(variables, jnp.asarray(x5), train=False)[0]
    tx = optax.sgd(0.05, momentum=0.9)
    state0 = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=None,
                        masks=masks, opt_state=tx.init(params))
    labels = jnp.asarray(y, jnp.int32)
    if data == 1:
        ref["eval"] = make_pp_eval_step(cfg, num_classes=5, mesh=mesh)(
            state0, (jnp.asarray(x), labels))
    for remat in (False, True):
        step = make_pp_train_step(cfg, tx, num_classes=5, mesh=mesh, microbatch=train_mb,
                                  donate=False, remat=remat, data_axis=data_axis)
        st = state0
        for _ in range(2):
            st, metrics = step(st, (jnp.asarray(x), labels), jax.random.PRNGKey(2))
        ref[f"params_remat_{remat}"] = jax.tree.map(np.asarray, st.params)
        ref[f"metrics_remat_{remat}"] = jax.tree.map(float, metrics)
    return {"ranks": [mp.load(out, "pp", r) for r in range(world)],
            "ref": jax.tree.map(np.asarray, ref), "data": data}


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return _run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return _run(tmp_path_factory, 4)


def _rows(res, r, ref):
    """Rank r's rows of a global-batch reference (its data rank's)."""
    n = ref.shape[0] // res["data"]
    d = r // 2
    return ref[d * n:(d + 1) * n]


@pytest.mark.parametrize("microbatch", [1, 2])
def test_pp_forward_matches_pp_vit_apply(pp2, microbatch):
    want = pp2["ref"][f"forward_{microbatch}"]
    for r in pp2["ranks"]:  # the logits on every stage
        np.testing.assert_allclose(r[f"forward_{microbatch}"].numpy(), want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_pp_train_step_matches_make_pp_train_step(pp2, remat):
    got = _flat_torch(pp2["ranks"][0][f"params_remat_{remat}"])
    from vipers_torch.core.tree import flatten_dict

    want = flatten_dict(pp2["ref"][f"params_remat_{remat}"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=5e-5, rtol=1e-4, err_msg=str(k))
    metrics = pp2["ranks"][1][f"metrics_remat_{remat}"]
    ref = pp2["ref"][f"metrics_remat_{remat}"]
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"], atol=1e-5, rtol=1e-5)
    assert float(metrics["acc1"]) == float(ref["acc1"])


def test_pp_eval_step_matches_make_pp_eval_step(pp2):
    for r in pp2["ranks"]:
        for k in ("loss_sum", "top1", "top5", "n"):
            np.testing.assert_allclose(float(r["eval"][k]), float(pp2["ref"]["eval"][k]),
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_pp_dp_combined_and_remat_match_jax(pp4, remat):
    """DP x PP over a (data 2, pipe 2) grid of 4 ranks: each data rank
    pipelines its half of the batch; the stage gradients average over the
    data group."""
    from vipers_torch.core.tree import flatten_dict

    want = flatten_dict(pp4["ref"][f"params_remat_{remat}"])
    for r in pp4["ranks"]:
        got = _flat_torch(r[f"params_remat_{remat}"])
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=5e-5, rtol=1e-4, err_msg=str(k))
    for mb in (2, 4):
        for i, r in enumerate(pp4["ranks"]):
            np.testing.assert_allclose(r[f"forward_{mb}"].numpy(),
                                       _rows(pp4, i, pp4["ref"][f"forward_{mb}"]),
                                       atol=3e-5, rtol=1e-4)


def test_pp_default_microbatch_handles_any_batch(pp2):
    """Batch 5 over 2 stages: the default microbatch (1, JAX's rule)."""
    from vipers_torch.parallel.pp import default_microbatch

    for r in pp2["ranks"]:
        got = r["forward_default_5"].numpy()
        np.testing.assert_allclose(got, pp2["ref"]["forward_default_5"], atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(got, pp2["ref"]["dense_5"], atol=3e-5, rtol=1e-4)
    for n, s, dd in [(5, 2, 1), (8, 2, 1), (12, 4, 2), (6, 4, 2), (7, 3, 1)]:
        mb = max(dd, (n // s) // dd * dd)
        while n % mb or mb % dd:
            mb -= dd
        assert default_microbatch(n, s, dd) == mb


def test_pp_rejects_indivisible_layout():
    from vipers_torch.core.registry import build_model
    from vipers_torch.parallel.pp import PipelineParallel, check_microbatch

    spec = build_model("vit_s_16")
    with pytest.raises(ValueError, match="pipeline stages"):
        PipelineParallel(spec, None, 0, 5)
    with pytest.raises(ValueError, match="microbatch"):
        check_microbatch(4, 3)
    with pytest.raises(ValueError, match="data-parallel degree"):
        check_microbatch(8, 2, 4)


def _cli(tmp_path_factory, world):
    root = str(tmp_path_factory.mktemp(f"pp_cli{world}"))
    _write_data(os.path.join(root, "data"))
    torch.save({"root": root, "data": os.path.join(root, "data"), "world": world,
                "global_batch": 8, "microbatch": 2}, os.path.join(root, "inputs.pt"))
    mp.launch("pp_cli", root, world)
    return root, [mp.load(root, "pp_cli", r) for r in range(world)]


@pytest.fixture(scope="module")
def cli2(tmp_path_factory):
    return _cli(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def cli4(tmp_path_factory):
    return _cli(tmp_path_factory, 4)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


@pytest.mark.parametrize("world", [2, 4], ids=["microbatch_remat", "pp_data"])
@pytest.mark.parametrize("single,multi,stem", [
    ("single", "pp", "epoch_0_snip_0.5"),
    ("single_lrr", "pp_lrr", "epoch_0_pruning_iteration_00")], ids=["snip", "lrr"])
def test_cli_checkpoints_match_one_process(request, world, single, multi, stem):
    root, ranks = request.getfixturevalue(f"cli{world}")
    name = f"{mp.CLI_NAME}_{stem}.pth"
    a, b = _load(os.path.join(root, single, name)), _load(os.path.join(root, multi, name))
    assert a["model"].keys() == b["model"].keys() and a["step"] == b["step"] == 2
    for k, v in a["model"].items():
        assert v.shape == b["model"][k].shape, k
        if k.endswith("_mask"):
            assert torch.equal(v, b["model"][k]), k
        else:
            np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), err_msg=k, **TWO_STEPS)
    sa, sb = a["optimizer"]["opt"]["state"], b["optimizer"]["opt"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        np.testing.assert_allclose(sb[i]["momentum_buffer"].numpy(),
                                   sa[i]["momentum_buffer"].numpy(), **TWO_STEPS)
    for r in ranks:  # every stage prints the one process's accuracies
        assert r["multi"] == ranks[0]["single"]


# ------------------------------------------------------------- refusals

@pytest.fixture
def tiny(tmp_path):
    _write_data(str(tmp_path / "data"))
    return ["--data-path", str(tmp_path / "data"), "--num-classes", "2", "--device", "cpu",
            "--train-crop-size", "32", "--val-resize-size", "40", "--val-crop-size", "32",
            "--output-dir", str(tmp_path / "out")]


@pytest.mark.parametrize("argv,match", [
    (["--model", "resnet18", "--pipeline-parallel", "2"], "stages the ViT encoder"),
    (["--model", "vit_s_16", "--pipeline-parallel", "2", "--model-ema"],
     "does not support --model-ema"),
    (["--model", "vit_s_16", "--pipeline-parallel", "5"], "do not divide into 5 pipeline"),
    (["--model", "vit_s_16", "--pipeline-parallel", "2", "--data-parallel"], "cannot combine"),
    (["--model", "vit_s_16", "--pipeline-parallel", "2", "--model-parallel", "2"],
     "cannot combine"),
    (["--model", "vit_s_16", "--pipeline-parallel", "2", "--pp-data", "2"],
     "--pipeline-parallel 2 --pp-data 2 needs 4 devices, have 1"),
], ids=["cnn", "ema", "layers", "data_parallel", "model_parallel", "devices"])
def test_train_refuses_what_jax_refuses(tiny, argv, match):
    from vipers_torch.cli.main import main

    with pytest.raises(SystemExit, match=match):
        main(["train", *tiny, *argv])


def test_dropout_is_refused():
    import dataclasses
    import types

    from vipers_torch.core.registry import build_model
    from vipers_torch.parallel.pp import check_pipeline

    spec = build_model("vit_s_16")
    spec = spec.rebuild(dataclasses.replace(spec.cfg, dropout_rate=0.1))
    cfg = types.SimpleNamespace(pipeline_parallel=2, model="vit_s_16", model_ema=False,
                                data_parallel=False, model_parallel=1, pp_data=0)
    with pytest.raises(SystemExit, match="requires dropout 0"):
        check_pipeline(spec, cfg, 2)
