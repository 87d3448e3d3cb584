"""Convert a checkpoint of the JAX package (an orbax directory) into the
``.pth`` that ``vipers_torch`` reads.

The card's machine has no JAX, so this runs where the JAX package does,
and writes through the port's own exporters::

    python scripts/jax_checkpoint_to_torch.py CKPT_DIR OUT.pth --model resnet50 \
        --num-classes 1000 [the train flags of the JAX run: --opt, --momentum, ...]

Three kinds of checkpoint, told apart by their keys:

- ``vipers train``'s epoch and rolling checkpoints (``opt_state``): a
  ``save_train_checkpoint`` ``.pth`` (weights unbaked with their masks,
  running statistics, the optimizer's momentum or moments, its step count,
  epoch, step, sparsity, EMA), so ``vipers_torch train --resume OUT.pth``
  continues the JAX run. Give the JAX run's optimizer flags (``--opt``,
  ``--momentum``, ``--weight-decay``, ... and ``--train-crop-size`` for a
  ViT or Swin): the optax state is rebuilt on them (``restore_like`` on
  ``make_optimizer``'s ``init``) and becomes the port optimizer's state.
- ``vipers quantize``'s artifacts (``observers``): ``{"model", "observers"
  [, "epoch"]}``, as ``vipers_torch quantize`` writes them.
- Anything else with ``params`` (``vipers slim``'s output, a weights-only
  tree): ``{"model"}``, masked layers as ``weight_orig`` / ``weight_mask``.

A slimmed checkpoint's ``.slim.json`` sidecar is carried to ``OUT.pth``'s.
The result is read by ``vipers_torch lost``, ``evaluate``, ``explain``,
``slim``, ``quantize --resume`` and ``train --resume``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _masks(tree):
    """{flax path tuple: bool array} from an orbax tree's "a/b/kernel" keys."""
    return {tuple(k.split("/")): np.asarray(v, bool) for k, v in (tree.get("masks") or {}).items()}


def _optax_leaves(state, out):
    """{"trace" | "mu" | "nu" | "count" | "schedule_count": ...} of an optax
    chain state, walked through its NamedTuples and tuples."""
    import optax

    if isinstance(state, optax.TraceState):
        out["trace"] = state.trace
    elif isinstance(state, optax.ScaleByAdamState):
        out.update(mu=state.mu, nu=state.nu, count=state.count)
    elif isinstance(state, optax.ScaleByRmsState):
        out["nu"] = state.nu
    elif isinstance(state, optax.ScaleByScheduleState):
        out["schedule_count"] = state.count
    elif isinstance(state, (tuple, list)):
        for s in state:
            _optax_leaves(s, out)
    return out


def _optimizer_state(st, fam, tree, ocfg, params):
    """Fill the port optimizer of ``st`` from the orbax ``opt_state``:
    SGD's momentum buffer is optax's trace, AdamW's moments its mu and nu
    with the step count, RMSprop's square average its nu."""
    import torch

    from vipers.core.checkpoint import restore_like
    from vipers.train.optim import OptimConfig as JOptim, make_lr_schedule, make_optimizer

    jcfg = JOptim(**dataclasses.asdict(ocfg))
    tx = make_optimizer(jcfg, params, make_lr_schedule(jcfg, 1))
    try:
        restored = restore_like(tx.init(params), tree["opt_state"])
    except (TypeError, KeyError, IndexError) as e:
        raise SystemExit(f"the checkpoint's optimizer state is not that of --opt {ocfg.opt} "
                         f"(--momentum {ocfg.momentum}): pass the JAX run's optimizer flags "
                         f"({type(e).__name__}: {e})") from None
    leaves = _optax_leaves(restored, {})

    def by_name(t):
        return {k: v.float() for k, v in fam.state_dict(t).items()}

    opt = st.opt.opt
    named = st.opt.params
    opt_name = ocfg.opt.lower()
    trace = by_name(leaves["trace"]) if "trace" in leaves else {}
    mu = by_name(leaves["mu"]) if "mu" in leaves else {}
    nu = by_name(leaves["nu"]) if "nu" in leaves else {}
    count = int(np.asarray(leaves.get("count", leaves.get("schedule_count", 0))))
    for name, p in named.items():
        if opt_name.startswith("sgd"):
            opt.state[p] = {"momentum_buffer": trace[name].clone() if ocfg.momentum else None}
        elif opt_name == "adamw":
            opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name].clone(),
                            "exp_avg_sq": nu[name].clone()}
        elif opt_name == "rmsprop":
            state = {"step": torch.tensor(float(count)), "square_avg": nu[name].clone()}
            if ocfg.momentum:
                state["momentum_buffer"] = trace[name].clone()
            opt.state[p] = state
    st.opt.count = int(np.asarray(leaves.get("schedule_count", tree.get("step", 0))))


def convert(src: str, dst: str, cfg) -> str:
    """Write ``dst`` from the orbax checkpoint ``src`` (``cfg``: the port's
    ``TrainConfig`` of the run, for the model and optimizer). Returns the
    kind: "train", "quantize" or "weights"."""
    import torch

    from vipers.core.checkpoint import restore_checkpoint
    from vipers.pruning.structured import arch_sidecar as jax_sidecar
    from vipers_torch.core.checkpoint import (contiguous_tensor, family,
                                              save_train_checkpoint)
    from vipers_torch.pruning.structured import write_sidecar
    from vipers_torch.train.driver import model_spec
    from vipers_torch.train.steps import create_train_state

    tree = restore_checkpoint(src)
    arch = jax_sidecar(src)
    spec = model_spec(cfg, cfg.train_crop_size, arch)
    fam = family(spec)
    params, stats, masks = tree["params"], tree.get("batch_stats"), _masks(tree)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    if tree.get("opt_state") is not None:
        kind = "train"
        st = create_train_state(spec, params, masks, cfg.optim, 1, device="cpu",
                                ema=tree.get("ema_params") is not None, batch_stats=stats)
        _optimizer_state(st, fam, tree, cfg.optim, params)
        st.step = int(np.asarray(tree.get("step", 0)))
        if tree.get("ema_params") is not None:
            ema = fam.state_dict(tree["ema_params"], tree.get("ema_batch_stats"))
            with torch.no_grad():
                for k, v in ema.items():
                    (st.ema_params if k in st.ema_params else st.ema_batch_stats)[k].copy_(v)
        save_train_checkpoint(dst, st, int(np.asarray(tree.get("epoch", -1))),
                              float(np.asarray(tree.get("sparsity", 0.0))))
    else:
        sd = fam.export_pth(params, stats, masks or None, False)
        obj = {"model": {k: contiguous_tensor(v) for k, v in sd.items()}}
        kind = "weights"
        if tree.get("observers") is not None:
            kind = "quantize"
            obj["observers"] = {
                site: {m: torch.tensor(float(np.asarray(o[m])), dtype=torch.float32)
                       for m in ("min", "max")}
                for site, o in tree["observers"].items()}
            if tree.get("epoch") is not None:
                obj["epoch"] = int(np.asarray(tree["epoch"]))
        torch.save(obj, dst + ".tmp")
        os.replace(dst + ".tmp", dst)
    if arch:
        write_sidecar(dst, cfg.model, arch)
    return kind


def main(argv=None) -> int:
    from vipers_torch.core.config import add_train_args, config_from_args

    p = argparse.ArgumentParser("jax_checkpoint_to_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="the JAX package's orbax checkpoint directory")
    p.add_argument("dst", help="the .pth to write")
    add_train_args(p)
    args = p.parse_args(argv)
    args.device = "cpu"
    kind = convert(args.src, args.dst, config_from_args(args))
    print(f"wrote {args.dst} ({kind} checkpoint of {args.model})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
