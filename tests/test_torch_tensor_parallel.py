"""Tensor parallelism (``vipers_torch.parallel.tp``, ``train --model-parallel``)
as 2 gloo ranks on the CPU against the JAX package and against one process.

One module fixture starts ``tests/torch_mp_child.py tp`` once: a tiny ViT
(patch 4, 2 blocks, D 32, 2 heads, mlp 64, 5 classes, 8x8 inputs, a 50%
magnitude mask) split over the 2 ranks (one head and 32 MLP columns
each). Its forward is held against the JAX ViT under
``vit_param_sharding`` over ``make_mesh(model_parallel=2)`` (the JAX
test's 2e-5 / 1e-4), two clipped SGD steps against the JAX train step on
that mesh (the JAX pipeline test's 5e-5 / 1e-4), and the dropout draws
(0.1 everywhere) against one process's exactly up to f32 rounding. A
second fixture runs the train CLI (``tp_cli``): SNIP for one epoch, the
checkpoint resumed for a second, a one-process checkpoint resumed under
tensor parallelism and the tensor-parallel one resumed by one process,
one LRR round, against one process: masks exact, the checkpoint's keys
and shapes those of one process, parameters and momentum within the JAX
multi-process test's tolerances (rtol 5e-2 / atol 3e-3 after two or more
steps, ``tests/test_torch_multiprocess.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests import torch_mp_child as mp
from tests.test_torch_multiprocess import _write_data

CFG = dict(patch_size=4, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64, num_classes=5)
CLIP = 0.5
TWO_STEPS = dict(rtol=5e-2, atol=3e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_vit():
    from vipers.models.vit import ViTConfig, VisionTransformer

    module = VisionTransformer(cfg=ViTConfig(**CFG), image_size=(8, 8))
    x = np.random.default_rng(2).normal(size=(8, 8, 8, 3)).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    return module, variables, x


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The 2 ranks' results and the JAX package's on the same inputs."""
    import optax

    from vipers.parallel.mesh import make_mesh, shard_batch, vit_param_sharding
    from vipers.pruning import init_masks, magnitude_prune
    from vipers.train.steps import TrainState, make_train_step

    module, variables, x = _jax_vit()
    params = variables["params"]
    masks = magnitude_prune(params, init_masks(params, exclude=("qkv",)), 0.5)
    y = np.random.default_rng(3).integers(0, 5, 8)
    out = tmp_path_factory.mktemp("tp")
    np_tree = jax.tree.map(np.asarray, params)
    torch.save({"cfg": CFG, "image_size": (8, 8), "params": np_tree,
                "masks": {k: np.asarray(m) for k, m in masks.items()}, "x": x, "y": y,
                "clip": CLIP}, os.path.join(out, "inputs.pt"))
    mp.launch("tp", out, 2)

    mesh = make_mesh(model_parallel=2)
    specs = vit_param_sharding(mesh, params)
    sharded = jax.device_put(params, specs)
    xs = jax.device_put(jnp.asarray(x), shard_batch(mesh))
    ys = jax.device_put(jnp.asarray(y, jnp.int32), shard_batch(mesh))
    with mesh:
        logits, _ = jax.jit(lambda p, xx: module.apply({"params": p}, xx, train=False))(
            sharded, xs)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.sgd(0.05, momentum=0.9))
    repl = NamedSharding(mesh, P())
    state = TrainState(step=jnp.zeros((), jnp.int32), params=sharded, batch_stats=None,
                       masks=masks, opt_state=jax.device_put(tx.init(params), repl))
    step = make_train_step(module.apply, tx, num_classes=5, donate=False)
    with mesh:
        for _ in range(2):
            state, metrics = step(state, (xs, ys), jax.random.PRNGKey(1))
    return {"ranks": [mp.load(out, "tp", r) for r in range(2)], "logits": np.asarray(logits),
            "params": jax.tree.map(np.asarray, state.params), "loss": float(metrics["loss"])}


@pytest.mark.parametrize("rank", [0, 1])
def test_forward_matches_jax_vit_param_sharding(tp, rank):
    np.testing.assert_allclose(tp["ranks"][rank]["forward"].numpy(), tp["logits"],
                               atol=2e-5, rtol=1e-4)


def test_shards_split_per_head_and_round_trip(tp):
    """qkv keeps its (s, h, e) rows for the rank's head, fc1 its 32 output
    rows, out and fc2 their input columns; biases of out and fc2 whole."""
    shapes = tp["ranks"][0]["part_shapes"]
    assert shapes["layers.0.attention.qkv.weight"] == (3 * 16, 32)
    assert shapes["layers.0.attention.qkv.bias"] == (3 * 16,)
    assert shapes["layers.0.attention.out.weight"] == (32, 16)
    assert shapes["layers.0.attention.out.bias"] == (32,)
    assert shapes["layers.0.mlp.fc1.weight"] == (32, 32)
    assert shapes["layers.0.mlp.fc2.weight"] == (32, 32)
    assert shapes["layers.0.mlp.fc2.bias"] == (32,)
    assert tp["ranks"][0]["round_trip"] and tp["ranks"][1]["round_trip"]


def test_shard_vit_params_is_the_per_head_cut():
    from vipers_torch.parallel.tp import gather_vit_params, shard_vit_params

    qkv = torch.arange(3 * 4 * 2 * 3, dtype=torch.float32).reshape(3 * 4 * 2, 3)
    parts = [shard_vit_params({"layers.0.attention.qkv.weight": qkv}, j, 2, 4)
             for j in range(2)]
    heads = qkv.reshape(3, 4, 2, 3)
    for j, part in enumerate(parts):
        want = heads[:, 2 * j:2 * j + 2].reshape(-1, 3)
        assert torch.equal(part["layers.0.attention.qkv.weight"], want)
    assert torch.equal(gather_vit_params(parts, 4)["layers.0.attention.qkv.weight"], qkv)


def test_two_clipped_sgd_steps_match_jax_model_parallel_step(tp):
    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_model
    from vipers_torch.core.tree import flatten_dict

    fam = family(build_model("vit_s_16"))
    got = flatten_dict(fam.trees(tp["ranks"][0]["params"])[0])
    want = flatten_dict(tp["params"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=5e-5, rtol=1e-4, err_msg=str(k))
    np.testing.assert_allclose(float(tp["ranks"][1]["loss"]), tp["loss"], rtol=1e-5)
    for k, v in tp["ranks"][0]["params"].items():
        assert torch.equal(v, tp["ranks"][1]["params"][k]), k  # every rank gathers the same


def test_dropout_draws_are_the_one_process_draws(tp):
    """Dropout 0.1 on the residual stream, the probabilities (the rank's
    head of the full draw) and after the GELU (its MLP columns)."""
    one = tp["ranks"][0]["dropout_one"].detach()
    for r in range(2):
        torch.testing.assert_close(tp["ranks"][r]["dropout"], one, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_cli"))
    _write_data(os.path.join(root, "data"))
    torch.save({"root": root, "data": os.path.join(root, "data"), "batch": 8, "world": 2},
               os.path.join(root, "inputs.pt"))
    mp.launch("tp_cli", root, 2)
    return root, [mp.load(root, "tp_cli", r) for r in range(2)]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _assert_checkpoints(a, b, tol):
    a, b = _load(a), _load(b)
    assert a["model"].keys() == b["model"].keys()
    assert (a["epoch"], a["step"], a["sparsity"]) == (b["epoch"], b["step"], b["sparsity"])
    for k, v in a["model"].items():
        assert v.shape == b["model"][k].shape, k
        if k.endswith("_mask"):
            assert torch.equal(v, b["model"][k]), k
        else:
            np.testing.assert_allclose(b["model"][k].numpy(), v.numpy(), err_msg=k, **tol)
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"] and oa["opt"]["param_groups"] == ob["opt"]["param_groups"]
    assert oa["opt"]["state"].keys() == ob["opt"]["state"].keys()
    for i, st in oa["opt"]["state"].items():
        np.testing.assert_allclose(ob["opt"]["state"][i]["momentum_buffer"].numpy(),
                                   st["momentum_buffer"].numpy(), **tol)


@pytest.mark.parametrize("single,multi,stem", [
    ("single", "tp", "epoch_0_snip_0.5"),
    ("single_resumed", "tp_resumed", "epoch_1_snip_0.5"),
    ("single_resumed", "tp_then_single", "epoch_1_snip_0.5"),
    ("single_lrr", "tp_lrr", "epoch_0_pruning_iteration_00"),
], ids=["snip", "one_process_checkpoint_resumed_under_tp", "tp_checkpoint_resumed_alone",
        "lrr"])
def test_checkpoints_match_one_process(cli, single, multi, stem):
    root, _ = cli
    name = f"{mp.CLI_NAME}_{stem}.pth"
    _assert_checkpoints(os.path.join(root, single, name), os.path.join(root, multi, name),
                        TWO_STEPS)


def test_cli_prints_the_mesh_line_and_one_process_accuracies(cli):
    _, ranks = cli
    single = ranks[0]["single"]
    for r in ranks:
        for run, lines in r["multi"].items():
            assert lines[0] == "train mesh: data=1 x model=2 over 2 devices, 2 processes"
            assert lines[1:] == single[run], (run, lines)
    assert ranks[0]["after"]["resume_tp"] == single["resume"]


# ------------------------------------------------------------- refusals

@pytest.fixture
def tiny(tmp_path):
    _write_data(str(tmp_path / "data"))
    return ["--data-path", str(tmp_path / "data"), "--num-classes", "2", "--device", "cpu",
            "--train-crop-size", "32", "--val-resize-size", "40", "--val-crop-size", "32",
            "--output-dir", str(tmp_path / "out")]


@pytest.mark.parametrize("argv,match", [
    (["--model", "resnet18", "--model-parallel", "2"], "no tensor-parallel spec"),
    (["--model", "vit_s_16", "--model-parallel", "2"],
     "1 devices not divisible by model_parallel=2"),
], ids=["cnn", "one_process"])
def test_train_refuses_what_jax_refuses(tiny, argv, match):
    from vipers_torch.cli.main import main

    with pytest.raises(SystemExit, match=match):
        main(["train", *tiny, *argv])


@pytest.mark.parametrize("over", [dict(num_heads=3), dict(mlp_dim=461)],
                         ids=["heads", "slim_mlp_461"])
def test_uneven_split_is_refused(over):
    """A slim checkpoint's F = 461 (or 3 heads) does not split over 2."""
    import dataclasses

    from vipers_torch.core.registry import build_model
    from vipers_torch.parallel.tp import check_tensor_parallel

    spec = build_model("vit_s_16")
    spec = spec.rebuild(dataclasses.replace(spec.cfg, **over))
    with pytest.raises(SystemExit, match="must both divide by 2"):
        check_tensor_parallel(spec, 2, 2, "vit_s_16")


@pytest.mark.parametrize("model,match", [("vit_s_16", r"not ported yet \(ROADMAP A10\)"),
                                         ("resnet18", "no tensor-parallel spec")])
def test_quantize_model_parallel_is_refused(tiny, model, match):
    from vipers_torch.cli.main import main

    with pytest.raises(SystemExit, match=match):
        main(["quantize", *tiny, "--model", model, "--model-parallel", "2",
              "--resume", "x.pth"])
