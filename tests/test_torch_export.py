"""The port's serving export (``vipers_torch/core/export.py``, ``vipers_torch
export``) against the JAX package's (``vipers/core/export.py``), on the CPU.

The same numpy weights go into both packages: a tiny ViT (the JAX export
tests' config, every leaf perturbed off zero, 50% random masks). Held: the kernels as ``torch.library`` custom ops
(``opcheck``; their nodes in an exported ViT), the ``while_loop`` flood
fill against ``vipers.discovery.components``, the reloaded classify
artifact against ``make_serving_forward`` in f32, bf16 and int8 (masks
baked, ``sparsity_pct`` as the JAX package counts it), the reloaded LOST
artifacts against ``make_lost_serving_forward`` and
``make_cnn_lost_serving_forward`` (boxes, seeds and background flags
equal), an artifact for cuda refusing a host without a card. The CLI is held in
``tests/test_torch_export_cli.py``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.core.export as jexport
import vipers.discovery.components as jcomp
import vipers.models.vit as jvit
import vipers.pruning as jprune
from tests import torch_explain_fixtures as fx
from vipers_torch.core import export as texport
from vipers_torch.discovery.components import flood_fill_from_seed
from vipers_torch.models import vit as tvit
from vipers_torch.ops import flash_attention as tfa

IMG = (32, 32)
CFG = dict(patch_size=4, num_layers=2, num_heads=4, hidden_dim=32, mlp_dim=64,
           num_classes=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


@functools.lru_cache(maxsize=None)
def _tiny():
    """(JAX spec, JAX variables, JAX masks, port spec, params, masks): the
    JAX export tests' tiny ViT, the port's init (seed 0) as numpy with every
    leaf perturbed off zero, and 50% random masks on the prunable kernels."""
    jspec = jvit._build("vit_export_tiny", jvit.ViTConfig(**CFG), IMG)
    tspec = tvit._build("vit_export_tiny", tvit.ViTConfig(**CFG), IMG)
    params = fx._perturbed(jax.tree.map(lambda a: a.numpy(),
                                        tspec.init(torch.Generator().manual_seed(0))))
    rng = np.random.default_rng(0)
    masks = {k: rng.random(np.shape(v)) > 0.5
             for k, v in jprune.init_masks(params, exclude=jspec.prune_exclude).items()}
    return (jspec, {"params": params}, {k: jnp.asarray(m) for k, m in masks.items()},
            tspec, params, masks)


def _images(n, seed, hw=IMG):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *hw, 3)).astype(np.float32) * 0.2
    x[:, hw[0] // 4: 3 * hw[0] // 4, hw[1] // 4: 3 * hw[1] // 4] += 2.0
    return x


def _roundtrip(tmp_path, program, meta, name="art"):
    out = str(tmp_path / name)
    texport.save_artifact(out, program, meta)
    return texport.load_artifact(out)


# ------------------------------------------------------------------ the ops

def test_custom_ops_pass_opcheck_on_the_cpu():
    """The three kernels' ops (and the flash backward's) pass
    ``torch.library.opcheck``: schema, fake implementation against the
    CPU one, autograd registration and AOT dispatch (inputs that require
    grad)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 40, 16, generator=g) for _ in range(3))
    valid = torch.rand(2, 40, generator=g) < 0.7
    valid[:, 0] = True
    ops = torch.ops.vipers_torch
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, 0.25)
    qkv = torch.randn(2, 40, 3 * 128, generator=g)
    x = torch.randn(128, 64, generator=g).bfloat16()
    w = (torch.randn(96, 64, generator=g) / 8).bfloat16()
    b = torch.randn(96, generator=g)
    cases = [
        (ops.flash_attention_fwd.default, (q.clone().requires_grad_(), k.clone().requires_grad_(),
                                           v.clone().requires_grad_(), valid, 0.25)),
        (ops.flash_attention_bwd.default, (q, k, v, valid, out, lse, torch.randn_like(q), 0.25)),
        (ops.flash_attention_packed.default, (qkv.clone().requires_grad_(), valid, 4, 0.25)),
        (ops.fused_ln_dense_gelu.default, (x.clone().requires_grad_(), w.clone().requires_grad_(),
                                           b.clone().requires_grad_(), 1e-6)),
    ]
    for op, args in cases:
        res = torch.library.opcheck(op, args)
        assert set(res.values()) == {"SUCCESS"}, (op, res)


def test_exported_vit_graph_calls_the_kernel_ops(monkeypatch, tmp_path):
    """A bf16 tiny ViT LOST program on the flash route (T = 65 -> 128 with
    ``VIPERS_FLASH_MIN_T=16``; 2 x 128 rows for the fused MLP) exports with
    one ``vipers_torch.flash_attention_fwd`` and one
    ``vipers_torch.fused_ln_dense_gelu`` node a block, and its reload
    equals the eager program."""
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    *_, tspec, params, masks = _tiny()
    prog, meta = texport.export_lost_pipeline(tspec, params, batch_size=2, image_size=IMG,
                                              masks=masks, dtype=torch.bfloat16, k_patches=20,
                                              device="cpu")
    targets = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    layers = CFG["num_layers"]
    assert targets.count(torch.ops.vipers_torch.flash_attention_fwd.default) == layers
    assert targets.count(torch.ops.vipers_torch.fused_ln_dense_gelu.default) == layers
    assert meta["custom_ops"] == ["vipers_torch::flash_attention_fwd",
                                  "vipers_torch::fused_ln_dense_gelu"]
    fn, _ = _roundtrip(tmp_path, prog, meta)
    x = _images(2, 3)
    eager = texport.make_lost_serving_forward(tspec, params, batch_size=2, image_size=IMG,
                                              masks=masks, dtype=torch.bfloat16, k_patches=20,
                                              device="cpu")
    with torch.no_grad():
        want = eager(torch.from_numpy(x))
    for got, w in zip(fn(x), want):
        assert torch.equal(got, w)


# ----------------------------------------------------------- the flood fill

def _snake(h, w):
    """A one-cell-wide serpentine over an (h, w) grid: its far end is
    h * w / 2 steps from the near one."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, -1 if r % 4 == 1 else 0] = True
    return m


def test_while_loop_fill_matches_jax():
    """The ``while_loop`` fill against ``vipers.discovery.components`` on
    seeded random grids (seeds on the foreground and on the background)
    and on a snake whose fill takes ~100 steps (12 bodies of 8)."""
    rng = np.random.default_rng(7)
    grids = [rng.random((12, 16)) > p for p in (0.3, 0.45, 0.6, 0.8)]
    seeds = [tuple(int(c) for c in np.argwhere(g)[0]) if g.any() else (0, 0) for g in grids]
    bg = np.argwhere(~grids[1])[0]
    grids.append(grids[1])
    seeds.append((int(bg[0]), int(bg[1])))  # a seed on the background: all False
    grids.append(_snake(12, 16))
    seeds.append((0, 0))
    mask = np.stack(grids)
    seed = np.asarray(seeds)
    got = flood_fill_from_seed(torch.from_numpy(mask), torch.from_numpy(seed)).numpy()
    want = np.stack([np.asarray(jcomp.flood_fill_from_seed(jnp.asarray(m), jnp.asarray(s)))
                     for m, s in zip(mask, seed)])
    np.testing.assert_array_equal(got, want)
    assert not got[4].any() and got[5].sum() == _snake(12, 16).sum() > 8 * 8


# --------------------------------------------------------- classify parity

@functools.lru_cache(maxsize=None)
def _jax_logits(dtype: str):
    jspec, jvars, jmasks, *_ = _tiny()
    fwd = jexport.make_serving_forward(jspec, jvars, masks=jmasks,
                                       dtype=jnp.bfloat16 if dtype == "bf16" else None,
                                       int8=dtype == "int8")
    # bf16 op by op, so that each op rounds to bf16 as the port's do (a
    # jitted XLA program may keep bf16 intermediates in f32)
    return np.asarray((fwd if dtype == "bf16" else jax.jit(fwd))(jnp.asarray(_images(2, 1))))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_classify_artifact_matches_jax(dtype, tmp_path):
    """The reloaded classify artifact against the JAX package's
    ``make_serving_forward`` on the same weights and masks: f32 within
    1e-4 of the logits' scale, bf16 within 2e-2 of it, int8 within the JAX
    CLI's 0.3 (dynamic qparams); the masks are baked and counted as the
    JAX package counts them."""
    jspec, jvars, jmasks, tspec, params, masks = _tiny()
    prog, meta = texport.export_serving(
        tspec, params, batch_size=2, masks=masks,
        dtype=torch.bfloat16 if dtype == "bf16" else None, int8=dtype == "int8", device="cpu")
    fn, meta2 = _roundtrip(tmp_path, prog, meta)
    got = fn(_images(2, 1)).numpy()
    want = _jax_logits(dtype)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 10)
    scale = float(np.abs(want).max())
    tol = {"f32": 1e-4 * scale, "bf16": 2e-2 * scale, "int8": 0.3}[dtype]
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    assert meta2 == meta
    assert meta["sparsity_pct"] == pytest.approx(
        float(jprune.compute_sparsity_global(jvars["params"], jmasks)), abs=1e-9)
    assert meta["compute_dtype"] == {"f32": "float32", "bf16": "bfloat16",
                                     "int8": "int8+bf16"}[dtype]
    assert meta["output_shape"] == [2, 10] and meta["num_classes"] == 10
    assert meta["platforms"] == ["cpu"]


# ------------------------------------------------------------- LOST parity

def test_lost_artifact_matches_jax(tmp_path):
    """The reloaded ViT LOST artifact (f32) against the JAX package's
    ``make_lost_serving_forward``: boxes, seeds and background flags equal."""
    jspec, jvars, jmasks, tspec, params, masks = _tiny()
    x = _images(2, 5)
    jfn = jexport.make_lost_serving_forward(jspec, jvars, batch_size=2, image_size=IMG,
                                            masks=jmasks, k_patches=20)
    want = [np.asarray(o) for o in jfn(jnp.asarray(x))]
    prog, meta = texport.export_lost_pipeline(tspec, params, batch_size=2, image_size=IMG,
                                              masks=masks, k_patches=20, device="cpu")
    fn, _ = _roundtrip(tmp_path, prog, meta)
    got = [o.numpy() for o in fn(x)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert meta["pipeline"] == "lost" and meta["k_patches"] == 20
    assert (got[0][:, 2] > got[0][:, 0]).all() and (got[0][:, 2] <= IMG[1]).all()


# ---------------------------------------------------------------- loading

def test_cuda_artifact_refuses_a_host_without_a_card(tmp_path):
    """``meta.json`` naming cuda makes ``load_artifact`` raise on a host
    with no card, before it reads the program."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    os.makedirs(tmp_path / "art")
    with open(tmp_path / "art" / "meta.json", "w") as f:
        json.dump({"platforms": ["cuda"]}, f)
    with pytest.raises(RuntimeError, match="exported for cuda"):
        texport.load_artifact(str(tmp_path / "art"))
