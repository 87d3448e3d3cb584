"""vipers_torch's data-parallel pieces (``vipers_torch.parallel.mesh``,
``data.sampler``, ``data.imagefolder``, the global-batch BatchNorm and the
random draws) against the JAX package on the CPU.

- ``shard_indices_for_host`` (every mode) and the RA sampler over ranks
  equal ``vipers.data.sampler``'s streams exactly; the loaders' generators
  keyed on the global stream position give the JAX loader's batches bit
  for bit, and the ranks' batches concatenated are the one-process batch.
- ``all_gather_object`` at one process is the JAX ``allgather_host_objects``.
- Two gloo ranks on the CPU (one launch for the module): the BatchNorm's
  output, running statistics and gradients against flax's ``BatchNorm``
  on the concatenated batch (1e-5); mixup/cutmix given the JAX draws
  against ``vipers.data.mixup`` on the global batch (mixup 1e-6, cutmix
  exact); RandomErasing, dropout and stochastic-depth masks against the
  port's one-process draws at the global batch (exact); one f64 QAT step
  (observers, global BatchNorm, gradients) against the one-process step
  at the global batch (1e-10); the gradient average, the min/max reduce
  and the object gather.
- The model-parallel flags meet the JAX package's own checks (A10 is
  ported; the layouts' runs are in ``tests/test_torch_tensor_parallel.py``,
  ``tests/test_torch_pipeline_parallel.py`` and
  ``tests/test_torch_sequence_parallel.py``).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import vipers.data.imagefolder as jif
import vipers.data.mixup as jmix
import vipers.data.preprocess as jpre
import vipers.data.sampler as jsamp
import vipers_torch.data.imagefolder as tif
import vipers_torch.data.preprocess as tpre
import vipers_torch.data.sampler as tsamp
from vipers_torch.models import stochastic
from vipers_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N_LOCAL = 4  # rows a rank


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------- samplers

MODES = [dict(shuffle=s, drop_last=d, batch_size=b, pad_with_sentinel=p)
         for s in (False, True) for d in (False, True) for b in (0, 3)
         for p in (False, True)]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k[:4]}{int(v)}"
                                                               for k, v in m.items()))
def test_shard_indices_for_host_matches_jax(mode):
    for n in (1, 5, 16, 37, 300):
        for world in (1, 2, 3, 4):
            for rank in range(world):
                for epoch in (0, 2):
                    got = tsamp.shard_indices_for_host(n, world, rank, epoch, seed=9, **mode)
                    want = jsamp.shard_indices_for_host(n, world, rank, epoch, seed=9, **mode)
                    assert got == want, (n, world, rank, epoch)


def test_batch_interleaved_shards_reassemble_the_global_batch():
    n, world, b = 37, 3, 4
    single = tsamp.shard_indices_for_host(n, 1, 0, 1, seed=2)
    shards = [tsamp.shard_indices_for_host(n, world, r, 1, seed=2, batch_size=b,
                                           drop_last=True) for r in range(world)]
    g = b * world
    for step in range(n // g):
        glob = sum((s[step * b:(step + 1) * b] for s in shards), [])
        assert glob == single[step * g:(step + 1) * g]


@pytest.mark.parametrize("n", [10, 300, 1000])
def test_ra_sampler_over_ranks_matches_jax(n):
    for world in (1, 2, 4):
        for rank in range(world):
            got = tsamp.ra_sampler_indices(n, 3, seed=4, repetitions=3, num_replicas=world,
                                           rank=rank)
            assert got == jsamp.ra_sampler_indices(n, world, rank, 3, seed=4, repetitions=3)


# ------------------------------------------------------------------ loaders

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_folder")
    rng = np.random.default_rng(3)
    for cls in ("a", "b"):
        (root / cls).mkdir()
        for i in range(7):
            arr = rng.integers(0, 255, size=(36 + 2 * i, 44, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / cls / f"{i}.jpg")
    return str(root)


def _decode(path, rng):
    return tpre.train_decode(path, rng, crop_size=24)


def _jdecode(path, rng):
    return jpre.train_decode(path, rng, crop_size=24)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_global_positions_match_jax_and_the_global_batch(folder, world):
    """Each rank's decoded batches equal the JAX loader's (same rank and
    world) bit for bit, and the ranks' b-th batches concatenated are the
    one-process b-th batch at the global batch size."""
    b = 2
    tds, jds = tif.ImageFolder(folder), jif.ImageFolder(folder)
    per_rank = []
    for rank in range(world):
        idx = tsamp.shard_indices_for_host(len(tds), world, rank, 1, seed=5, batch_size=b,
                                           drop_last=True) if world > 1 else \
            tsamp.epoch_indices(len(tds), 1, seed=5)
        got = list(tif.ImageFolderLoader(tds, idx, b, _decode, num_workers=2, drop_last=True,
                                         seed=6, rank=rank, world=world))
        want = list(jif.ImageFolderLoader(jds, idx, b, _jdecode, num_workers=2,
                                          drop_last=True, seed=6, rank=rank, world=world))
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
        per_rank.append(got)
    single = list(tif.ImageFolderLoader(tds, tsamp.epoch_indices(len(tds), 1, seed=5),
                                        b * world, _decode, num_workers=2, drop_last=True,
                                        seed=6))
    for step, (si, sl) in enumerate(single):
        assert np.array_equal(si, np.concatenate([r[step][0] for r in per_rank]))
        assert np.array_equal(sl, np.concatenate([r[step][1] for r in per_rank]))


def test_loader_sentinel_rows_match_jax(folder):
    tds, jds = tif.ImageFolder(folder), jif.ImageFolder(folder)
    idx = tsamp.shard_indices_for_host(len(tds), 4, 3, 0, shuffle=False, pad_with_sentinel=True)
    assert idx[-1] == -1

    def dec(path, rng):
        return tpre.eval_decode(path, 30, 24)

    got = list(tif.ImageFolderLoader(tds, idx, 3, dec, num_workers=1))
    want = list(jif.ImageFolderLoader(jds, idx, 3, lambda p, r: jpre.eval_decode(p, 30, 24),
                                      num_workers=1))
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gl, wl)
    assert got[-1][1][-1] == -1 and not got[-1][0][-1].any()


def test_all_gather_object_at_one_process_matches_jax():
    from vipers.parallel.mesh import allgather_host_objects

    obj = {"hits": 3, "preds": {"a.jpg": [1, 2, 3, 4]}, "failed": ["b.jpg"]}
    assert mesh.all_gather_object(obj) == allgather_host_objects(obj) == [obj]
    assert mesh.world() == 1 and mesh.rank() == 0 and mesh.is_main()
    assert mesh.broadcast_object(obj) is obj


# ---------------------------------------------- the model-parallel flags

@pytest.mark.parametrize("argv", [["--model-parallel", "2"], ["--pipeline-parallel", "2"],
                                  ["--pp-microbatch", "2"], ["--pp-data", "2"],
                                  ["--pp-remat"]], ids=lambda a: a[0])
@pytest.mark.parametrize("cmd", ["train", "evaluate", "quantize"])
def test_parallelism_flags_take_the_jax_checks(cmd, argv, tmp_path):
    """A10 is ported: each flag meets the JAX package's own check. On the
    default resnet18 ``train`` refuses ``--model-parallel`` (no
    tensor-parallel spec) and ``--pipeline-parallel`` (it stages a ViT),
    ``quantize`` refuses ``--model-parallel``; ``evaluate`` ignores every
    one of them, as the JAX sweep does, and ``train`` and ``quantize`` the
    ``--pp-*`` flags without ``--pipeline-parallel``: those runs stop
    where the run without the flag stops, at the missing data. (The
    layouts' runs: ``tests/test_torch_tensor_parallel.py``,
    ``tests/test_torch_pipeline_parallel.py``.)"""
    from vipers_torch.cli.main import main

    want = {("train", "--model-parallel"): "no tensor-parallel spec",
            ("train", "--pipeline-parallel"): "stages the ViT encoder",
            ("quantize", "--model-parallel"): "no tensor-parallel spec"}.get((cmd, argv[0]))
    argv = [cmd, "--device", "cpu", "--data-path", str(tmp_path / "none"),
            "--output-dir", str(tmp_path / "out"), *argv]
    if want:
        with pytest.raises(SystemExit, match=want):
            main(argv)
    else:
        with pytest.raises(FileNotFoundError, match="none"):
            main(argv)


def test_lost_sequence_parallel_takes_the_jax_checks():
    from vipers_torch.cli.main import main

    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["lost", "--device", "cpu", "--sequence-parallel", "--data-parallel"])


def test_distributed_env_precedence(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
              "SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.distributed_env() is None
    assert not mesh.maybe_initialize_distributed("cpu")
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_NTASKS_PER_NODE", "4(x2)")
    monkeypatch.setenv("SLURM_STEP_NODELIST", "gpu[07-08],gpu11")
    assert mesh.distributed_env() == {"rank": 3, "world": 8, "local_rank": 1,
                                      "local_world": 4, "addr": "gpu07", "port": 29500}
    # torchrun's variables come first
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "10.0.0.1"),
                 ("MASTER_PORT", "1234"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    assert mesh.distributed_env() == {"rank": 1, "world": 2, "local_rank": 1,
                                      "local_world": 2, "addr": "10.0.0.1", "port": 1234}
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not mesh.maybe_initialize_distributed("cpu")


# ------------------------------------------------------ two gloo ranks

_PROG = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
from vipers_torch.data.mixup import apply_mixup_cutmix
from vipers_torch.data.preprocess import make_device_normalize
from vipers_torch.models import stochastic
from vipers_torch.models.cnn import BatchNorm
from vipers_torch.parallel import mesh
from tests.test_torch_parallel import qat_step

assert mesh.maybe_initialize_distributed("cpu")
r, p = mesh.rank(), mesh.world()
inp = dict(np.load(sys.argv[1], allow_pickle=True))
n = inp["bn_x"].shape[0] // p
rows = slice(r * n, (r + 1) * n)
out = {}

bn = BatchNorm(inp["bn_x"].shape[1])
with torch.no_grad():
    bn.weight.copy_(torch.from_numpy(inp["bn_w"]))
    bn.bias.copy_(torch.from_numpy(inp["bn_b"]))
    bn.running_mean.copy_(torch.from_numpy(inp["bn_rm"]))
    bn.running_var.copy_(torch.from_numpy(inp["bn_rv"]))
bn.train()
x = torch.from_numpy(inp["bn_x"][rows]).requires_grad_(True)
stats = {}
y = bn(x, stats)
gx, gw, gb = torch.autograd.grad((y * torch.from_numpy(inp["bn_c"][rows])).sum(),
                                 [x, bn.weight, bn.bias])
out.update(bn_y=y.detach().numpy(), bn_gx=gx.numpy(), bn_gw=gw.numpy(), bn_gb=gb.numpy(),
           bn_rm=stats[".running_mean"].numpy(), bn_rv=stats[".running_var"].numpy())

images = torch.from_numpy(inp["mix_x"][rows])
labels = torch.from_numpy(inp["mix_y"][rows])
for name in ("mixup", "cutmix"):
    use_mixup, lam, box = inp[name + "_draws"].tolist()
    mi, ml = apply_mixup_cutmix(images, labels, 5, use_mixup, lam, box)
    out[name + "_x"], out[name + "_y"] = mi.numpy(), ml.numpy()

norm = make_device_normalize(random_erase_prob=0.5)
out["erase"] = norm(torch.from_numpy(inp["u8"][rows]),
                    generator=torch.Generator().manual_seed(3)).numpy()
z = torch.from_numpy(inp["drop_x"][rows])
out["dropout"] = stochastic.dropout(z, 0.3, True, torch.Generator().manual_seed(4)).numpy()
out["drop_path"] = stochastic.drop_path(z, 0.5, True, torch.Generator().manual_seed(5)).numpy()

q = qat_step(torch.from_numpy(inp["qat_x"][rows]), torch.from_numpy(inp["qat_y"][rows]))
out.update({"qat_" + k: v for k, v in q.items()})

g, (m,) = mesh.average_gradients({"w": torch.full((3,), float(r + 1))}, (torch.tensor(2.0 * r),))
out["avg"], out["avg_extra"] = g["w"].numpy(), m.numpy()
mn, mx = mesh.reduce_min_max(torch.tensor(-1.0 - r), torch.tensor(5.0 * r))
out["minmax"] = np.array([float(mn), float(mx)])
out["gather"] = np.array(mesh.all_gather_object({"r": r, "n": [r] * (r + 1)}), dtype=object)
out["bcast"] = np.array(mesh.broadcast_object({"from": r}), dtype=object)
mesh.barrier()
np.savez(sys.argv[2] + f"_{r}.npz", **out)
print("OK", r, p)
"""


def qat_step(x, y):
    """One QAT step of resnet18 (3 classes, seed-0 weights, BatchNorm
    biases at +3) in f64 from observers calibrated on the same batch:
    {params, stats, observers} as numpy. In a data-parallel run the batch
    is this rank's share and the observers, BatchNorm statistics and
    gradients are the global batch's. f64: in f32 an ulp moves an
    activation across a uint8 bin and the flips cascade (ROADMAP C); +3:
    fake-quant puts many activations on one grid value, so at bias 0 some
    BatchNorm outputs sit within rounding of the ReLU's kink, where the
    ranks' and one process's sums (equal to the last bits) pick different
    sides and a gradient moves by its own size (the CPU parity tests'
    start)."""
    from vipers_torch.core.registry import build_model
    from vipers_torch.core.tree import flatten_dict, unflatten_dict
    from vipers_torch.pruning import init_masks
    from vipers_torch.train import quantize as tq
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, forward_params

    spec = build_model("resnet18", num_classes=3)
    params = unflatten_dict({p: (v + 3.0 if p[-1] == "bias" and "bn" in p[-2] else v)
                             for p, v in flatten_dict(
                                 spec.init(torch.Generator().manual_seed(0))).items()})
    st = create_train_state(spec, params, init_masks(params, exclude=spec.prune_exclude),
                            OptimConfig(lr=0.01), 1, device="cpu")
    st.model.double()
    x = x.double()
    tensors = forward_params(st.params, st.masks)
    sites = tq.observer_sites(st.model, st.family, x[:1], exclude=spec.quant_exclude,
                              tensors=tensors, need_attn=False)
    zero = torch.zeros((), dtype=torch.float64)
    obs = {k: tq.ObserverState(zero, zero, o.initialized)
           for k, o in tq.init_observers(sites).items()}
    obs = tq.ptq_calibrate(st.model, st.family, obs, [(x, None)], exclude=spec.quant_exclude,
                           tensors=tensors)
    st, obs, _ = tq.make_qat_train_step(3, exclude=spec.quant_exclude)(st, obs, (x, y.long()))
    return {"params": np.concatenate([p.detach().reshape(-1).numpy()
                                      for p in st.params.values()]),
            "stats": np.concatenate([b.reshape(-1).numpy() for b in st.batch_stats.values()]),
            "observers": np.array([[float(o.min_val), float(o.max_val)] for o in obs.values()])}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mix_draws(key, h, w, mixup_alpha, cutmix_alpha):
    """(use mixup, lam, box) as ``vipers.data.mixup.mixup_cutmix_batch``
    draws them from ``key``."""
    k_choice, k_lam, k_box = jax.random.split(key, 3)
    use_mixup = mixup_alpha > 0
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_mixup = bool(jax.random.bernoulli(k_choice))
    lam = jmix._beta(k_lam, mixup_alpha if use_mixup else cutmix_alpha)
    if use_mixup:
        return True, float(lam), None
    kx, ky = jax.random.split(k_box)
    r_x, r_y = int(jax.random.randint(kx, (), 0, w)), int(jax.random.randint(ky, (), 0, h))
    r = 0.5 * jnp.sqrt(1.0 - lam)
    rw, rh = int((r * w).astype(jnp.int32)), int((r * h).astype(jnp.int32))
    box = tuple(int(np.clip(v, 0, m)) for v, m in ((r_x - rw, w), (r_y - rh, h),
                                                    (r_x + rw, w), (r_y + rh, h)))
    return False, float(lam), box


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs (global batches) and each rank's outputs of one 2-rank
    gloo launch."""
    root = tmp_path_factory.mktemp("dp_ranks")
    rng = np.random.default_rng(0)
    n = N_LOCAL * WORLD
    inp = {
        "bn_x": rng.normal(0.5, 2.0, (n, 3, 5, 6)).astype(np.float32),
        "bn_c": rng.normal(size=(n, 3, 5, 6)).astype(np.float32),
        "bn_w": rng.normal(1.0, 0.2, 3).astype(np.float32),
        "bn_b": rng.normal(0.0, 0.2, 3).astype(np.float32),
        "bn_rm": rng.normal(size=3).astype(np.float32),
        "bn_rv": rng.uniform(0.5, 2.0, 3).astype(np.float32),
        "mix_x": rng.normal(size=(n, 9, 11, 3)).astype(np.float32),
        "mix_y": rng.integers(0, 5, n).astype(np.int64),
        "u8": rng.integers(0, 256, (n, 12, 10, 3)).astype(np.uint8),
        "drop_x": rng.normal(size=(n, 6, 4)).astype(np.float32),
        "qat_x": rng.normal(size=(n, 16, 16, 3)).astype(np.float32),
        "qat_y": rng.integers(0, 3, n).astype(np.int64),
    }
    key = jax.random.PRNGKey(0)
    draws = {}
    while len(draws) < 2:  # one batch each of mixup and cutmix
        key, sub = jax.random.split(key)
        d = _jax_mix_draws(sub, 9, 11, 0.8, 1.0)
        name = "mixup" if d[0] else "cutmix"
        if name not in draws:
            draws[name] = (sub, d)
            inp[name + "_draws"] = np.array(d, dtype=object)
    np.savez(root / "inp.npz", **inp)
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(WORLD), PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _PROG, str(root / "inp.npz"),
                               str(root / "out")], cwd=REPO, env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
        assert f"| distributed init (rank {r}): {WORLD} processes, gloo on cpu" in out, out
    outs = [dict(np.load(root / f"out_{r}.npz", allow_pickle=True)) for r in range(WORLD)]
    return inp, draws, outs


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


def test_global_batchnorm_matches_flax_on_the_concatenated_batch(ranks):
    import flax.linen as nn

    inp, _, outs = ranks
    x = jnp.asarray(inp["bn_x"].transpose(0, 2, 3, 1))
    c = jnp.asarray(inp["bn_c"].transpose(0, 2, 3, 1))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(inp["bn_w"]), "bias": jnp.asarray(inp["bn_b"])},
                 "batch_stats": {"mean": jnp.asarray(inp["bn_rm"]),
                                 "var": jnp.asarray(inp["bn_rv"])}}

    def loss(params, x):
        y, upd = bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])
        return jnp.sum(y * c), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], x)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_cat(outs, "bn_y"), np.asarray(y).transpose(0, 3, 1, 2), **tol)
    np.testing.assert_allclose(_cat(outs, "bn_gx"), np.asarray(gx).transpose(0, 3, 1, 2), **tol)
    # each rank's parameter gradient holds its own loss terms: their sum is the global one
    np.testing.assert_allclose(sum(o["bn_gw"] for o in outs), np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(sum(o["bn_gb"] for o in outs), np.asarray(gp["bias"]), **tol)
    for o in outs:
        np.testing.assert_allclose(o["bn_rm"], np.asarray(stats["mean"]), **tol)
        np.testing.assert_allclose(o["bn_rv"], np.asarray(stats["var"]), **tol)


@pytest.mark.parametrize("name", ["mixup", "cutmix"])
def test_mixup_cutmix_over_ranks_matches_jax_on_the_global_batch(ranks, name):
    inp, draws, outs = ranks
    key, _ = draws[name]
    wi, wl = jmix.mixup_cutmix_batch(key, jnp.asarray(inp["mix_x"]),
                                     jnp.asarray(inp["mix_y"]), 5, 0.8, 1.0)
    atol = 1e-6 if name == "mixup" else 0
    np.testing.assert_allclose(_cat(outs, name + "_x"), np.asarray(wi), atol=atol, rtol=0)
    np.testing.assert_allclose(_cat(outs, name + "_y"), np.asarray(wl), atol=atol, rtol=0)


def test_random_erasing_over_ranks_is_the_global_batch_draw(ranks):
    inp, _, outs = ranks
    norm = tpre.make_device_normalize(random_erase_prob=0.5)
    want = norm(torch.from_numpy(inp["u8"]), generator=torch.Generator().manual_seed(3))
    got = _cat(outs, "erase")
    assert np.array_equal(got, want.numpy())
    assert (got == 0).all(axis=-1).any()  # some rectangle was erased


@pytest.mark.parametrize("kind", ["dropout", "drop_path"])
def test_dropout_masks_over_ranks_are_the_global_batch_draw(ranks, kind):
    inp, _, outs = ranks
    z = torch.from_numpy(inp["drop_x"])
    want = (stochastic.dropout(z, 0.3, True, torch.Generator().manual_seed(4))
            if kind == "dropout" else
            stochastic.drop_path(z, 0.5, True, torch.Generator().manual_seed(5)))
    assert np.array_equal(_cat(outs, kind), want.numpy())


@pytest.mark.parametrize("what", ["params", "stats", "observers"])
def test_qat_step_over_ranks_is_the_global_batch_step(ranks, what):
    """One f64 QAT step on 2 ranks (observers reduced over the ranks,
    global BatchNorm, averaged gradients) against one process on the
    global batch: within 1e-10 of each array's scale (sums in another
    order)."""
    inp, _, outs = ranks
    want = qat_step(torch.from_numpy(inp["qat_x"]), torch.from_numpy(inp["qat_y"]))[what]
    for o in outs:
        np.testing.assert_allclose(o["qat_" + what], want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())


def test_collectives_over_ranks(ranks):
    _, _, outs = ranks
    for o in outs:
        np.testing.assert_array_equal(o["avg"], np.full(3, 1.5, np.float32))
        assert float(o["avg_extra"]) == 1.0
        np.testing.assert_array_equal(o["minmax"], [-2.0, 5.0])
        assert list(o["gather"]) == [{"r": 0, "n": [0]}, {"r": 1, "n": [1, 1]}]
        assert o["bcast"].item() == {"from": 0}
