"""One rank of the model-parallel tests (``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_pipeline_parallel.py``,
``tests/test_torch_sequence_parallel.py``): a torchrun-style rank on the
CPU (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
environment) that joins a gloo group, runs the task named on its command
line and saves what it computed::

    python tests/torch_mp_child.py TASK OUT

``OUT/inputs.pt`` holds the task's inputs (the JAX package's parameters
and the batches, as numpy, written by the test); rank r writes
``OUT/TASK_r.pt``. Rank 0 also runs the one-process references of the
CLI tasks alone (``parallel.mesh.solo``) while the others wait. ``launch``
starts the ranks from a test and waits for them.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(task, out, world, timeout=600):
    """Run ``task`` as ``world`` ranks; returns each rank's stdout."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("SLURM_PROCID", "SLURM_NTASKS", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(out)], cwd=REPO,
        env=dict(env, RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            o, e = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{task} rank {r}:\n{e[-6000:]}"
            assert f"DONE {task} rank {r}" in o, o[-2000:]
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def load(out, task, rank=0):
    return torch.load(os.path.join(out, f"{task}_{rank}.pt"), weights_only=False)


def _spec(inp, name, **over):
    import dataclasses

    import vipers_torch.models.vit as tvit

    cfg = dataclasses.replace(tvit.ViTConfig(**inp["cfg"]), **over)
    return tvit._build(name, cfg, tuple(inp["image_size"]))


def _register(name, cfg_kw):
    """``name`` in the port's registry: the tiny ViT of ``cfg_kw``."""
    import vipers_torch.core.registry as treg
    import vipers_torch.models.vit as tvit

    treg._ensure_builtins_imported()

    def build(num_classes=1000, image_size=(224, 224), **kw):
        cfg = tvit.ViTConfig(**{**cfg_kw, "num_classes": num_classes, **kw})
        return tvit._build(name, cfg, image_size)

    treg._BUILTIN_MODELS[name] = build


def cli(argv):
    """The port's CLI in this process; (rc, stdout)."""
    from vipers_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _tensor_parallel_layout(spec):
    from vipers_torch.parallel import mesh
    from vipers_torch.parallel.tp import TensorParallel

    mesh.make_grid(mesh.world(), "model")
    return TensorParallel(spec, mesh.inner_group(), mesh.inner_rank(), mesh.world())


def task_tp(out, inp):
    """The tensor-parallel forward, two SGD steps (clipped), the dropout
    draws and the train CLI (with the one-process runs on rank 0)."""
    from vipers_torch.core.checkpoint import family
    from vipers_torch.core.registry import build_module
    from vipers_torch.models.stochastic import dropout_generator
    from vipers_torch.parallel import mesh
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state, make_train_step

    res = {}
    spec = _spec(inp, "vit_tp_tiny")
    fam = family(spec)
    lay = _tensor_parallel_layout(spec)
    full = fam.state_dict(inp["params"])
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]).long()
    model = lay.wire(build_module(lay.rank_spec))
    model.load_state_dict(lay.part(full))
    with torch.no_grad():
        res["forward"] = model.eval()(x)[0]
    res["part_shapes"] = {k: tuple(v.shape) for k, v in lay.part(full).items()}
    res["round_trip"] = all(torch.equal(v, lay.full(lay.part(full))[k]) for k, v in full.items())

    masks = fam.masks_from_state_dict(lay.part(fam.masks_to_state_dict(inp["masks"])))
    ocfg = OptimConfig(lr=0.05, momentum=0.9, weight_decay=0.0, clip_grad_norm=inp["clip"])
    state = create_train_state(lay.rank_spec, fam.trees(lay.part(full))[0], masks, ocfg, 1,
                               device="cpu")
    lay.wire(state.model)
    state.opt.sq_norm = lay.sq_norm
    step = make_train_step(5)
    for _ in range(2):
        state, metrics = step(state, (x, y))
    res["params"] = lay.full({k: v.detach() for k, v in state.params.items()})
    res["momentum"] = lay.full({k: s["momentum_buffer"]
                                for k, s in state.opt.named_state().items()})
    res["loss"] = metrics["loss"]

    # dropout 0.1 on the residual stream, the probabilities and the MLP
    dspec = _spec(inp, "vit_tp_tiny", dropout_rate=0.1, attention_dropout_rate=0.1)
    dlay = _tensor_parallel_layout(dspec)
    dmodel = dlay.wire(build_module(dlay.rank_spec))
    dmodel.load_state_dict(dlay.part(full))
    res["dropout"] = dmodel.train()(x, generator=dropout_generator(3, 1, "cpu"))[0].detach()
    if mesh.rank() == 0:
        with mesh.solo():
            whole = build_module(dspec)
            whole.load_state_dict(full)
            res["dropout_one"] = whole.train()(x, generator=dropout_generator(3, 1, "cpu"))[0]
    mesh.make_grid(1)
    return res


def _pipeline_state(inp, spec, stages, microbatch=0, remat=False, ocfg=None):
    """(layout, this stage's train state) from the inputs' parameters and
    masks over a (data, pipe) grid of ``stages`` stages."""
    from vipers_torch.core.checkpoint import family
    from vipers_torch.parallel import mesh
    from vipers_torch.parallel.pp import PipelineParallel
    from vipers_torch.train.optim import OptimConfig
    from vipers_torch.train.steps import create_train_state

    mesh.make_grid(stages, "pipe")
    lay = PipelineParallel(spec, mesh.inner_group(), mesh.inner_rank(), stages, microbatch,
                           remat)
    fam = family(spec)
    full = fam.state_dict(inp["params"])
    masks = fam.masks_from_state_dict(lay.part(fam.masks_to_state_dict(inp["masks"])))
    ocfg = ocfg or OptimConfig(lr=0.05, momentum=0.9, weight_decay=0.0)
    state = create_train_state(lay.rank_spec, fam.trees(lay.part(full))[0], masks, ocfg, 1,
                               device="cpu")
    state.opt.sq_norm = lay.sq_norm
    return lay, state


def _rows(t):
    """This data rank's rows of a global batch."""
    from vipers_torch.parallel import mesh

    n = t.shape[0] // mesh.data_world()
    return t[mesh.data_rank() * n:(mesh.data_rank() + 1) * n]


def task_pp(out, inp):
    """GPipe over the world's ranks (2: one pipeline; 4: --pp-data 2): the
    forward (given and default microbatch), two SGD steps with and without
    remat, the eval step."""
    from vipers_torch.parallel import mesh
    from vipers_torch.parallel.pp import make_pp_eval_step, make_pp_train_step, pp_vit_apply

    res = {}
    stages = 2
    spec = _spec(inp, "vit_pp_tiny")
    x, y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"]).long()
    for mb in inp["forward_microbatches"]:
        lay, state = _pipeline_state(inp, spec, stages, microbatch=mb)
        res[f"forward_{mb}"] = pp_vit_apply(lay, state.model, _rows(x))
    lay, state = _pipeline_state(inp, spec, stages)
    x5 = torch.from_numpy(inp["x5"])
    res["forward_default_5"] = pp_vit_apply(lay, state.model, _rows(x5))
    res["eval"] = make_pp_eval_step(lay, 5)(state, (_rows(x), _rows(y)))
    for remat in (False, True):
        lay, state = _pipeline_state(inp, spec, stages, microbatch=inp["train_microbatch"],
                                     remat=remat)
        step = make_pp_train_step(lay, 5)
        for _ in range(2):
            state, metrics = step(state, (_rows(x), _rows(y)))
        res[f"params_remat_{remat}"] = lay.full({k: v.detach() for k, v in state.params.items()})
        res[f"metrics_remat_{remat}"] = metrics
    mesh.make_grid(1)
    return res


def sp_extract(spec, params, imgs, ragged, **kw):
    """A LOST extractor's per-image features of ``ragged`` and its batched
    pipeline's outputs on ``imgs`` (``kw``: the extractor's, such as
    ``sequence_parallel``)."""
    from vipers_torch.discovery.driver import LostFeatureExtractor

    ex = LostFeatureExtractor(spec, params, device="cpu", which_features="k", **kw)
    feats, dims, valid, _scales, _attn = ex.extract(ragged, 16)
    batched = ex.make_batched_pipeline(k_patches=3)(*ex.prepare_batch(imgs, 16))
    return {"feats": feats, "dims": (dims, valid), "batched": batched}


def task_sp(out, inp):
    """Sequence parallelism over the world's ranks: the tiny ViT's forward
    and attention, the LOST extractors (ViT, DINO, ViT int8) on ragged
    shapes."""
    from vipers_torch.core.registry import build_model, build_module
    from vipers_torch.core.checkpoint import family
    from vipers_torch.parallel.sp import sequence_parallel

    res = {}
    spec = _spec(inp, "vit_sp_tiny")
    model = build_module(spec)
    model.load_state_dict(family(spec).state_dict(inp["params"]))
    with torch.no_grad(), sequence_parallel():
        logits, aux = model.eval()(torch.from_numpy(inp["x"]))
    res["forward"], res["attn"], res["qkv_input"] = logits, aux["attn"], aux["qkv_input"]
    vit = build_model("vit_s_16", num_classes=10, image_size=(32, 32))
    dino = build_model("dino_vit_tiny")
    for name, sp_spec, params, kw in (("vit", vit, inp["vit_params"], {}),
                                      ("dino", dino, inp["dino_params"], {}),
                                      ("int8", vit, inp["vit_params"], {"compute_dtype": "int8"})):
        res[name] = sp_extract(sp_spec, params, inp["imgs"], inp["ragged"],
                               sequence_parallel=True, **kw)
    return res


# the CLI tasks' tiny ViT: patch 8, 2 blocks (4 under pipelining), D 64, 2
# heads, mlp 128, no dropout
CLI_NAME = "vit_mp_tiny"
CLI_CFG = dict(patch_size=8, num_layers=2, num_heads=2, hidden_dim=64, mlp_dim=128)


def _train_argv(inp, out, *extra):
    return ["train", "--model", CLI_NAME, "--data-path", inp["data"], "--num-classes", "2",
            "--batch-size", str(inp["batch"]), "--train-crop-size", "32",
            "--val-resize-size", "40", "--val-crop-size", "32", "--workers", "1", "--seed", "0",
            "--device", "cpu", "--print-freq", "0", "--lr", "0.01", "--output-dir", out,
            *extra]


def _cli_runs(inp, runs):
    """Each (name, argv) of ``runs`` through the CLI; {name: printed lines}."""
    lines = {}
    for name, argv in runs:
        rc, text = cli(argv)
        assert rc == 0, (name, rc)
        lines[name] = [ln for ln in text.splitlines()
                       if ln.startswith(("Test:", "train mesh", "Sparsity", "LOST seq"))]
    return lines


def _cli_task(inp, single, multi):
    """Rank 0 runs ``single(root)`` alone while the others wait; then every
    rank runs ``multi(root)``. Returns {"single": lines, "multi": lines}."""
    from vipers_torch.parallel import mesh

    root = inp["root"]
    res = {}
    if mesh.rank() == 0:
        with mesh.solo():
            res["single"] = _cli_runs(inp, single(root))
    mesh.barrier()
    res["multi"] = _cli_runs(inp, multi(root))
    mesh.barrier()
    if mesh.rank() == 0 and inp.get("after"):
        with mesh.solo():
            res["after"] = _cli_runs(inp, inp["after"])
    mesh.barrier()
    return res


def task_tp_cli(out, inp):
    """``train --model-parallel W``: SNIP for one epoch, its checkpoint
    resumed for a second, a one-process checkpoint resumed under tensor
    parallelism, one LRR round; the one-process runs on rank 0 first, then
    the tensor-parallel checkpoint resumed by one process."""
    _register(CLI_NAME, CLI_CFG)
    mp = ["--model-parallel", str(inp["world"])]
    snip = ["--pruning-method", "snip", "--target-sparsity", "0.5"]
    lrr = ["--pruning-method", "magnitude", "--pruning-rate", "0.5", "--pruning-threshold",
           "40", "--epochs", "1"]
    ck = f"{CLI_NAME}_epoch_0_snip_0.5.pth"

    def j(*p):
        return os.path.join(inp["root"], *p)

    def single(root):
        return [("snip", _train_argv(inp, j("single"), *snip, "--epochs", "1")),
                ("resume", _train_argv(inp, j("single_resumed"), *snip, "--epochs", "2",
                                       "--resume", j("single", ck))),
                ("lrr", _train_argv(inp, j("single_lrr"), *lrr))]

    def multi(root):
        return [("snip", _train_argv(inp, j("tp"), *snip, "--epochs", "1", *mp)),
                ("resume", _train_argv(inp, j("tp_resumed"), *snip, "--epochs", "2",
                                       "--resume", j("single", ck), *mp)),
                ("lrr", _train_argv(inp, j("tp_lrr"), *lrr, *mp))]

    inp["after"] = [("resume_tp", _train_argv(inp, j("tp_then_single"), *snip, "--epochs", "2",
                                              "--resume", j("tp", ck)))]
    return _cli_task(inp, single, multi)


def task_pp_cli(out, inp):
    """``train --pipeline-parallel 2`` (``--pp-microbatch 2 --pp-remat``; at 4
    ranks ``--pp-data 2``): SNIP for one epoch and one LRR round, against
    one process."""
    _register(CLI_NAME, {**CLI_CFG, "num_layers": 4})
    pp = ["--pipeline-parallel", "2", "--pp-microbatch", str(inp["microbatch"])]
    pp += ["--pp-remat"] if inp["world"] == 2 else ["--pp-data", "2"]
    snip = ["--pruning-method", "snip", "--target-sparsity", "0.5", "--epochs", "1"]
    lrr = ["--pruning-method", "magnitude", "--pruning-rate", "0.5", "--pruning-threshold",
           "40", "--epochs", "1"]

    def j(*p):
        return os.path.join(inp["root"], *p)

    inp["batch"] = inp["global_batch"]
    single_runs = [("snip", _train_argv(inp, j("single"), *snip)),
                   ("lrr", _train_argv(inp, j("single_lrr"), *lrr))]
    inp_multi = dict(inp, batch=inp["global_batch"] // (inp["world"] // 2))
    multi_runs = [("snip", _train_argv(inp_multi, j("pp"), *snip, *pp)),
                  ("lrr", _train_argv(inp_multi, j("pp_lrr"), *lrr, *pp))]
    return _cli_task(inp, lambda root: single_runs, lambda root: multi_runs)


def task_sp_cli(out, inp):
    """``lost --sequence-parallel`` on a VOC tree: a ``vit_s_16`` checkpoint
    in f32 and ``dino_vit_tiny`` in bf16, against one process."""
    def lost(out_dir, *extra):
        return ["lost", "--data-path", inp["voc"], "--device", "cpu", "--workers", "1",
                "--batch-size", "4", "--output-dir", os.path.join(inp["root"], out_dir), *extra]

    vit = ["--checkpoint", inp["checkpoint"]]
    dino = ["--arch", "dino", "--model", "dino_vit_tiny", "--dtype", "bf16"]

    def single(root):
        return [("vit", lost("single_vit", *vit)), ("dino", lost("single_dino", *dino))]

    def multi(root):
        return [("vit", lost("sp_vit", *vit, "--sequence-parallel")),
                ("dino", lost("sp_dino", *dino, "--sequence-parallel"))]

    return _cli_task(inp, single, multi)


TASKS = {"tp": task_tp, "pp": task_pp, "sp": task_sp, "tp_cli": task_tp_cli,
         "pp_cli": task_pp_cli, "sp_cli": task_sp_cli}


def main():
    task, out = sys.argv[1:3]
    from vipers_torch.parallel import mesh

    mesh.maybe_initialize_distributed("cpu")
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    res = TASKS[task](out, inp)
    torch.save(res, os.path.join(out, f"{task}_{mesh.rank()}.pt"))
    mesh.barrier()
    print(f"DONE {task} rank {mesh.rank()}", flush=True)


if __name__ == "__main__":
    main()
