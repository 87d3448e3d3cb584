"""The process grid, one process a card (port of ``vipers/parallel/mesh.py``).

The JAX package runs one program over a device mesh: its batch is sharded
over the mesh's data axis, XLA inserts the gradient all-reduce, and the
BatchNorm statistics reduce over the global batch by construction. The
torch idiom is one process a card under ``torch.distributed``; what the
mesh gave for free is explicit here:

- ``maybe_initialize_distributed``: the rendezvous, from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` or else
  SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS``; nothing at world size 1.
  NCCL on ``cuda:LOCAL_RANK``; gloo on the CPU, and when more ranks than
  cards share a host (NCCL refuses two ranks on one card).
- ``average_gradients``: the gradient of the global-batch mean (each rank's
  mean-loss gradient, all-reduced in one flat bucket and divided by the
  world size: DDP's arithmetic; the train steps take their gradients with
  ``torch.autograd.grad`` on masked, cast copies of the parameters, which
  ``DistributedDataParallel``'s hooks on ``.grad`` never see).
- ``all_reduce_sum``: a differentiable sum over ranks (its backward sums
  the cotangents), for the global-batch BatchNorm
  (``models.cnn.BatchNorm``).
- ``draw_rand`` and ``roll_batch``: random draws and the mixup/cutmix roll
  as the global batch would have them, each rank keeping its own rows.
- ``all_gather_object``: host objects from every rank (LOST's hits,
  counts, preds and failures); ``broadcast_object`` and ``solo``: work one
  rank does alone on a gathered batch and hands to the others (SNIP's
  masks from the first global batch).
- ``barrier`` and ``is_main``: rank 0 writes the artifacts, the others
  wait. Every rank holds the same parameters (each takes the averaged
  update), so no gather is needed before a write (the JAX package's
  ``host_replicated_tree``).

- ``make_grid``: the W ranks factored into a (data, inner) grid, the inner
  index fastest (rank = d * k + j), as ``make_mesh`` lays out JAX devices
  (``reshape(n // k, k)``). The inner axis is the model axis of
  ``--model-parallel k`` (``parallel.tp``) or the pipe axis of
  ``--pipeline-parallel S --pp-data D`` (``parallel.pp``). Each rank
  belongs to one data group (the ranks of its inner index) and one inner
  group (the ranks of its data index). Without a grid the data group is
  every rank and the inner group this rank alone. Every helper above that
  speaks of "the ranks" of a batch (the gradient average, the global-batch
  BatchNorm, the random draws, the roll, the eval sums) works over the
  data group: the ranks of one inner group hold the same batch.

Every rank must call the collectives here in the same order. The process
group's timeout (``TIMEOUT_S``) bounds every collective, the first one
included: the ranks' per-rank sweeps (LOST, eval) drift apart, and a late
rank must not fail the run at its last gather. gloo takes CUDA tensors
as NCCL does (``chip_smoke.py`` phase 21 probes its collectives on the
card).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 3600


def _first_host(nodelist: str) -> str:
    """The first host of a SLURM node list (``node[03-05,09],gpu1`` ->
    ``node03``)."""
    m = re.match(r"([^,\[]+)(\[([^\]]+)\])?", nodelist.strip())
    if not m:
        return "127.0.0.1"
    base, ranges = m.group(1), m.group(3)
    if not ranges:
        return base
    return base + ranges.split(",")[0].split("-")[0]


def distributed_env() -> Optional[dict]:
    """{rank, world, local_rank, local_world, addr, port} from the
    environment, or None: torchrun's variables first (``RANK`` and
    ``MASTER_ADDR`` set), then SLURM's (``SLURM_PROCID`` with more than
    one task; the master is ``MASTER_ADDR`` or the step's first node)."""
    env = os.environ
    if "MASTER_ADDR" in env and "RANK" in env:
        rank = int(env["RANK"])
        world = int(env.get("WORLD_SIZE", "1"))
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        addr = env["MASTER_ADDR"]
    elif "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        rank = int(env["SLURM_PROCID"])
        world = int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", rank))
        per_node = env.get("SLURM_NTASKS_PER_NODE", "")
        local_world = int(per_node.split("(")[0]) if per_node[:1].isdigit() else world
        addr = env.get("MASTER_ADDR") or _first_host(
            env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST") or "127.0.0.1")
    else:
        return None
    return {"rank": rank, "world": world, "local_rank": local, "local_world": local_world,
            "addr": addr, "port": int(env.get("MASTER_PORT", "29500"))}


def maybe_initialize_distributed(device="cuda") -> bool:
    """Join the process group the environment describes; True when one is
    (or already was) initialized. No environment, or a world of one: False,
    and nothing is initialized. ``device`` is the run's ``--device``: on
    ``cuda`` the rank takes ``cuda:LOCAL_RANK`` (modulo the cards present)
    and NCCL, or gloo when the host has fewer cards than local ranks; on
    ``cpu`` gloo. A joining rank prints its rank, the world, the backend
    and its device."""
    if dist.is_available() and dist.is_initialized():
        return True
    e = distributed_env()
    if e is None or e["world"] <= 1:  # one process: nothing to join, nothing printed
        return False
    dev = torch.device(device or "cuda")
    backend = "gloo"
    where = "cpu"
    if dev.type == "cuda":
        from vipers_torch.core.device import resolve_device

        resolve_device(dev)
        n = torch.cuda.device_count()
        index = e["local_rank"] % n
        torch.cuda.set_device(index)
        where = f"cuda:{index}"
        backend = "nccl" if n >= e["local_world"] else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{e['addr']}:{e['port']}",
                            world_size=e["world"], rank=e["rank"],
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    print(f"| distributed init (rank {e['rank']}): {e['world']} processes, "
          f"{backend} on {where}", flush=True)
    return True


_SOLO = [False]
# the (data, inner) grid of make_grid: {"inner", "data_group", "inner_group"}
_GRID: dict = {}


def active() -> bool:
    """Whether a process group is initialized (of any size) and this
    process is not inside ``solo()``."""
    return not _SOLO[0] and dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def solo():
    """Work this rank does alone (on a batch it gathered): inside the
    scope every helper here acts as in a one-process run."""
    prev = _SOLO[0]
    _SOLO[0] = True
    try:
        yield
    finally:
        _SOLO[0] = prev


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def make_grid(inner: int, axis: str = "model"):
    """Factor the ranks into the (data, ``axis``) grid with ``inner`` ranks
    a row (rank = d * inner + j) and make its groups; every rank calls it,
    in the same order. ``inner`` 1 clears the grid. The caller checks that
    ``inner`` divides the world."""
    _GRID.clear()
    if inner <= 1 or not active():
        return
    w = world()
    if w % inner:
        raise ValueError(f"{w} devices not divisible by {axis}={inner}")
    data_groups = [dist.new_group([d * inner + j for d in range(w // inner)])
                   for j in range(inner)]
    inner_groups = [dist.new_group([d * inner + j for j in range(inner)])
                    for d in range(w // inner)]
    r = rank()
    _GRID.update(inner=inner, data_group=data_groups[r % inner],
                 inner_group=inner_groups[r // inner])


def inner_world() -> int:
    """The inner axis' size (k model ranks, S stages); 1 without a grid."""
    return _GRID["inner"] if active() and _GRID else 1


def inner_rank() -> int:
    """This rank's index j on the inner axis (its model shard, its stage)."""
    return rank() % inner_world()


def inner_group():
    return _GRID.get("inner_group") if active() else None


def data_world() -> int:
    """The data axis' size: the ranks that hold distinct batches."""
    return world() // inner_world()


def data_rank() -> int:
    return rank() // inner_world()


def data_group():
    """The group of the ranks that share this rank's inner index (None: the
    whole world, or no process group)."""
    return _GRID.get("data_group") if active() else None


def is_main() -> bool:
    """Rank 0, or a run without a process group: the rank that writes."""
    return rank() == 0


def barrier():
    if active():
        dist.barrier()


def group_size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (None: every rank;
    identity without a process group)."""
    if active() and group_size(group) > 1:
        dist.all_reduce(t, op, group=group)
    return t


def all_gather_tensor(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """``t`` from every rank of ``group`` (None: every rank), in rank order
    (equal shapes)."""
    if not active() or group_size(group) == 1:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (host objects; tensors should be
    on the CPU)."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_object(obj, group=None) -> list:
    """[obj of the group's first rank, ..., of its last] (pickled host
    objects; ``group`` None: every rank); [obj] without a process group.
    Every rank of the group must call it."""
    if not active() or group_size(group) == 1:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(), group=data_group())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), group=data_group())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group, differentiable: the backward
    sums the cotangents over the ranks too, so each rank's gradient holds
    every rank's loss terms that flow through this sum (the global-batch
    BatchNorm's). Identity without a process group."""
    return _AllReduceSum.apply(x) if active() and data_world() > 1 else x


def average_gradients(grads: Dict[str, torch.Tensor], extras=(), group="data") -> tuple:
    """(grads, extras) averaged over ``group`` (by default the data group):
    one flat all-reduce a dtype of every gradient and of the ``extras``
    scalars (the step's metrics), divided by the group's size. Each rank's
    gradient is that of its mean loss over equal per-rank batches, so the
    average is the gradient of the global-batch mean. Unchanged without a
    process group."""
    if group == "data":
        group = data_group()
    n = group_size(group)
    if not active() or n == 1:
        return grads, tuple(extras)
    items = list(grads.items())
    tensors = [g for _, g in items] + [torch.as_tensor(e) for e in extras]
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_(flat, group=group)
        flat = flat / n
        off = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = flat[off: off + k].view_as(tensors[i])
            off += k
    return ({name: out[i] for i, (name, _) in enumerate(items)},
            tuple(out[len(items):]))


def reduce_min_max(mn: torch.Tensor, mx: torch.Tensor, group="data"):
    """(global min, global max) of per-rank scalars over ``group`` (by
    default the data group: an observer's batch range over the global
    batch; the sequence-parallel group: a range over the token shards)."""
    if group == "data":
        group = data_group()
    if not active() or group_size(group) == 1:
        return mn, mx
    packed = all_reduce_(torch.stack([-mn.float(), mx.float()]), dist.ReduceOp.MAX,
                         group=group)
    return -packed[0], packed[1]


def draw_rand(shape, generator: Optional[torch.Generator], device,
              shard: Optional[tuple] = None) -> torch.Tensor:
    """``torch.rand(shape)`` drawn as the global batch would draw it:
    ``shape[0]`` is this rank's share of the batch; with P data ranks the
    draw is (P * shape[0], ...) and the rank keeps rows [r * n, (r + 1) *
    n). ``shard`` (dim, j, k): ``shape[dim]`` is shard j of k of the full
    tensor's (a tensor-parallel rank's heads or MLP columns): the full
    width is drawn and the rank keeps its slice. One rank draws ``shape``
    itself."""
    p = data_world()
    full_shape = [shape[0] * p, *shape[1:]]
    if shard is not None:
        full_shape[shard[0]] *= shard[2]
    if tuple(full_shape) == tuple(shape):
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand(full_shape, generator=generator, device=device)
    if p > 1:
        full = full[global_rows(shape[0])]
    if shard is not None:
        dim, j, _k = shard
        full = full.narrow(dim, j * shape[dim], shape[dim])
    return full


def global_rows(n: int) -> slice:
    """This rank's rows of a global batch of P * ``n`` rows (P data ranks)."""
    r = data_rank()
    return slice(r * n, (r + 1) * n)


def roll_batch(t: torch.Tensor) -> torch.Tensor:
    """``torch.roll(global batch, 1, dims=0)``, this rank's rows: each
    rank's first row is the previous data rank's last (rank 0 takes the
    last rank's)."""
    p = data_world()
    if p <= 1:
        return torch.roll(t, 1, dims=0)
    last = all_gather_tensor(t[-1:], group=data_group())
    return torch.cat([last[(data_rank() - 1) % p], t[:-1]])
