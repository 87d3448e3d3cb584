"""Sequence parallelism (``vipers_torch.parallel.sp``, ``lost
--sequence-parallel``) as 2 gloo ranks on the CPU against the JAX
package's ``vipers/parallel/sp.py`` and against one process.

One module fixture starts ``tests/torch_mp_child.py sp`` once: a tiny ViT
(patch 4, 2 blocks, D 32, 2 heads, 5 classes) on a 32x32 image (65 tokens,
33 a rank after the pad), its logits and last-block attention held
against the JAX forward under ``sequence_parallel`` on the 8-device mesh
(the JAX test's 2e-5 / 1e-4); the LOST extractors of ``vit_s_16`` (at
32x32, f32 and int8) and ``dino_vit_tiny`` on a ragged 48x32 image and a
batch of three, against the plain extractor in this process (features
2e-5 / 1e-4; the batched boxes, seeds and background flags equal; int8
equal, since each site's dynamic range spans every rank's tokens).
``sp_cli`` runs ``lost --sequence-parallel`` (a pruned ``vit_s_16`` in
f32, ``dino_vit_tiny`` in bf16) against one process: ``preds.pkl`` and the
results txt equal.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mp_child as mp

CFG = dict(patch_size=4, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64, num_classes=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    from vipers.core.registry import build_model
    from vipers.models.vit import ViTConfig, VisionTransformer
    from vipers.parallel.sp import make_seq_mesh, sequence_parallel

    module = VisionTransformer(cfg=ViTConfig(**CFG), image_size=(32, 32))
    x = np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    mesh = make_seq_mesh(axis="seq")

    def fwd(v, xx):
        with sequence_parallel(mesh, "seq"):
            return module.apply(v, xx, train=False)

    logits, aux = jax.jit(fwd)(variables, jnp.asarray(x))
    vit = build_model("vit_s_16", num_classes=10, image_size=(32, 32))
    vit_vars = vit.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    dino = build_model("dino_vit_tiny")
    dino_vars = dino.module.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.default_rng(11)
    inp = {"cfg": CFG, "image_size": (32, 32), "params": _np(variables["params"]), "x": x,
           "vit_params": _np(vit_vars["params"]), "dino_params": _np(dino_vars["params"]),
           "ragged": rng.normal(size=(48, 32, 3)).astype(np.float32),
           "imgs": [rng.normal(size=(32, 32, 3)).astype(np.float32) for _ in range(3)]}
    out = tmp_path_factory.mktemp("sp")
    torch.save(inp, os.path.join(out, "inputs.pt"))
    mp.launch("sp", out, 2)
    return {"ranks": [mp.load(out, "sp", r) for r in range(2)], "inp": inp,
            "logits": np.asarray(logits), "attn": np.asarray(aux["attn"])}


@pytest.mark.parametrize("rank", [0, 1])
def test_sp_forward_and_attn_match_jax_sequence_parallel(sp, rank):
    r = sp["ranks"][rank]
    np.testing.assert_allclose(r["forward"].numpy(), sp["logits"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(r["attn"].numpy(), sp["attn"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["vit", "dino", "int8"])
def test_sp_lost_extractor_equals_plain(sp, name):
    from vipers_torch.core.registry import build_model

    inp = sp["inp"]
    spec = (build_model("dino_vit_tiny") if name == "dino"
            else build_model("vit_s_16", num_classes=10, image_size=(32, 32)))
    kw = {"compute_dtype": "int8"} if name == "int8" else {}
    plain = mp.sp_extract(spec, inp["dino_params" if name == "dino" else "vit_params"],
                          inp["imgs"], inp["ragged"], **kw)
    for r in sp["ranks"]:
        got = r[name]
        assert got["dims"] == plain["dims"]
        if name == "int8":  # the one process's int8 codes
            assert torch.equal(got["feats"], plain["feats"])
        else:
            np.testing.assert_allclose(got["feats"].numpy(), plain["feats"].numpy(),
                                       atol=2e-5, rtol=1e-4)
        for a, b in zip(got["batched"], plain["batched"]):
            assert torch.equal(a, b)


def test_sp_one_rank_warns_and_runs_with_the_kernels(tmp_path):
    """World 1: the JAX warning, and the plain run (preds equal)."""
    from tests.test_torch_lost_cli import _write_voc
    from vipers_torch.cli.main import main

    voc = str(tmp_path / "voc")
    _write_voc(voc, np.random.default_rng(4))
    argv = ["lost", "--model", "dino_vit_tiny", "--arch", "dino", "--data-path", voc,
            "--device", "cpu", "--batch-size", "4", "--workers", "1"]
    with pytest.warns(UserWarning, match="--sequence-parallel ignored: only 1 device"):
        assert main([*argv, "--sequence-parallel", "--output-dir", str(tmp_path / "a")]) == 0
    assert main([*argv, "--output-dir", str(tmp_path / "b")]) == 0
    preds = [pickle.load(open(tmp_path / d / "preds.pkl", "rb")) for d in ("a", "b")]
    assert preds[0] == preds[1]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    from tests.test_torch_lost_cli import _write_pth, _write_voc

    root = str(tmp_path_factory.mktemp("sp_cli"))
    voc = os.path.join(root, "VOC2007")
    _write_voc(voc, np.random.default_rng(11))
    pth = os.path.join(root, "model.pth")
    _write_pth(pth)
    torch.save({"root": root, "voc": voc, "checkpoint": pth}, os.path.join(root, "inputs.pt"))
    mp.launch("sp_cli", root, 2)
    return root, [mp.load(root, "sp_cli", r) for r in range(2)]


@pytest.mark.parametrize("model", ["vit", "dino"], ids=["vit_s_16_f32", "dino_vit_tiny_bf16"])
def test_cli_boxes_and_results_match_one_process(cli, model):
    root, ranks = cli
    preds = [pickle.load(open(os.path.join(root, d, "preds.pkl"), "rb"))
             for d in (f"single_{model}", f"sp_{model}")]
    assert preds[0] == preds[1] and len(preds[0]) == 7
    txt = [open(os.path.join(root, d, "results_iteration_00.txt")).read()
           for d in (f"single_{model}", f"sp_{model}")]
    assert txt[0] == txt[1]
    if model == "vit":  # the pruned ViT finds boxes smaller than the images
        assert any(b[2] - b[0] < 100 for b in preds[0].values())
    for r in ranks:
        assert r["multi"][model] == ["LOST sequence-parallel over 2 devices (token axis)"]
