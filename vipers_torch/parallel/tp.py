"""Tensor (Megatron) parallelism for the ViT across processes (port of
``vipers/parallel/mesh.py``'s ``vit_param_sharding``).

k ranks of a model group hold one ViT between them. The JAX package
shards its parameters with PartitionSpecs and XLA inserts the
collectives; here each rank holds its shard in a module of its own and
the block makes the two collectives itself (``models.vit``):

- qkv, the column split: JAX ``P(None, "model")`` on the kernel and
  ``P("model")`` on the bias. The port splits per head: the weight keeps
  its rows (s, h, e) for the rank's H / k heads, the bias the same, so a
  rank's attention is whole heads (JAX cuts the 3 * inner axis
  contiguously, a layout XLA resolves; the function is the same);
- fc1, the column split: JAX ``P(None, "model")`` / ``P("model")``; the
  rank keeps its F / k output rows and bias;
- attention ``out`` and fc2, the row split: JAX ``P("model", None)``; the
  rank keeps the input columns of its heads and of its F / k; their biases
  stay whole (JAX ``P()``) and are added once, after the all-reduce
  (``row_linear``);
- everything else is replicated (JAX ``P()``).

``_CopyToModel`` (identity forward, all-reduce of the cotangent backward)
sits after each LayerNorm and ``_ReduceFromModel`` (all-reduce forward,
identity backward) after each row-split matmul, so the replicated
parameters' gradients come out whole and equal on every model rank.
Pruning masks, optimizer momentum and EMA weights split as their
parameters do (``shard_vit_params`` / ``gather_vit_params`` on any dict
keyed by the module's state-dict names, in the ``.pth`` layout).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from vipers_torch.parallel import mesh

# state-dict key suffix -> (kind, dim): "heads" splits per head (qkv rows in
# (s, h, e) order, out columns in (h, e) order), "cols" a plain F / k cut
_RULES = (("attention.qkv.weight", "qkv", 0), ("attention.qkv.bias", "qkv", 0),
          ("attention.out.weight", "heads", 1),
          ("mlp.fc1.weight", "cols", 0), ("mlp.fc1.bias", "cols", 0),
          ("mlp.fc2.weight", "cols", 1))


def _rule(key: str):
    for suffix, kind, dim in _RULES:
        if key.endswith(suffix):
            return kind, dim
    return None


def is_sharded(key: str) -> bool:
    """Whether the state-dict entry ``key`` is split over the model ranks."""
    return _rule(key) is not None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_(g.clone(), group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return mesh.all_reduce_(x.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, tp):
    """``x`` into the rank's column-split matmuls: identity, the cotangent
    summed over the model group. Identity without ``tp``."""
    return x if tp is None else _CopyToModel.apply(x, tp[0])


def reduce_from_model(x, tp):
    """The sum of the model ranks' partial products (identity backward)."""
    return x if tp is None else _ReduceFromModel.apply(x, tp[0])


def row_linear(x, linear: torch.nn.Linear, tp):
    """``linear(x)`` for a row-split ``linear``: the partial product summed
    over the model group, then the whole bias, once."""
    if tp is None:
        return linear(x)
    return reduce_from_model(F.linear(x, linear.weight), tp) + linear.bias


def shard_of(tp, dim: int):
    """``draw_rand``'s ``shard`` for a tensor split along ``dim``."""
    return None if tp is None else (dim, tp[1], tp[2])


def shard_tensor(key: str, t: torch.Tensor, j: int, k: int, num_heads: int) -> torch.Tensor:
    """Model rank j's part of the full ``t`` (state-dict entry ``key``)."""
    rule = _rule(key)
    if rule is None or k == 1:
        return t
    kind, dim = rule
    if kind == "cols":
        n = t.shape[dim] // k
        return t.narrow(dim, j * n, n).contiguous()
    hk = num_heads // k
    if kind == "qkv":
        return t.reshape(3, num_heads, -1).narrow(1, j * hk, hk).reshape(
            -1, *t.shape[1:]).contiguous()
    return t.reshape(t.shape[0], num_heads, -1).narrow(1, j * hk, hk).reshape(
        t.shape[0], -1).contiguous()


def gather_tensor(key: str, parts: List[torch.Tensor], num_heads: int) -> torch.Tensor:
    """The full entry ``key`` from the model ranks' parts, in rank order."""
    rule = _rule(key)
    if rule is None or len(parts) == 1:
        return parts[0]
    kind, dim = rule
    if kind == "cols":
        return torch.cat(parts, dim=dim)
    hk = num_heads // len(parts)
    if kind == "qkv":
        return torch.cat([p.reshape(3, hk, -1) for p in parts], dim=1).reshape(
            -1, *parts[0].shape[1:])
    rows = parts[0].shape[0]
    return torch.cat([p.reshape(rows, hk, -1) for p in parts], dim=1).reshape(rows, -1)


def shard_vit_params(sd: Dict[str, torch.Tensor], j: int, k: int,
                     num_heads: int) -> Dict[str, torch.Tensor]:
    """Model rank j of k's part of a ViT state dict (parameters, masks,
    momentum or EMA weights keyed by the module's names)."""
    return {key: shard_tensor(key, t, j, k, num_heads) for key, t in sd.items()}


def gather_vit_params(shards: List[Dict[str, torch.Tensor]],
                      num_heads: int) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_vit_params``: the full state dict from the k
    ranks' parts, in rank order."""
    return {key: gather_tensor(key, [s[key] for s in shards], num_heads) for key in shards[0]}


def check_tensor_parallel(spec, k: int, world: int, model: str):
    """SystemExit for what JAX's mesh refuses: a non-ViT family (no
    tensor-parallel spec), a world not divisible by k, heads or MLP width
    not divisible by k (``device_put`` of an uneven split)."""
    if spec.family != "vit":
        raise SystemExit("--model-parallel shards ViT attention/MLP features; "
                         f"model {model!r} (family {spec.family!r}) has no "
                         "tensor-parallel spec")
    if world % k:
        raise SystemExit(f"{world} devices not divisible by model_parallel={k}")
    cfg = spec.cfg
    if cfg.num_heads % k or cfg.mlp_dim % k:
        raise SystemExit(f"--model-parallel {k}: {model}'s {cfg.num_heads} heads and "
                         f"mlp_dim {cfg.mlp_dim} must both divide by {k} (an uneven "
                         "split is refused, as JAX's device_put refuses it)")


def shard_spec(spec, k: int):
    """``spec`` at one model rank's widths: H / k heads of the same width,
    F / k MLP columns (the slim rectangular blocks)."""
    cfg = spec.cfg
    hd = cfg.head_dim or cfg.hidden_dim // cfg.num_heads
    return spec.rebuild(dataclasses.replace(cfg, num_heads=cfg.num_heads // k,
                                            mlp_dim=cfg.mlp_dim // k, head_dim=hd))


def make_tensor_parallel(model: torch.nn.Module, group, j: int, k: int) -> torch.nn.Module:
    """Wire ``model``'s (a shard spec's) blocks to the model group."""
    tp = (group, j, k)
    for block in model.layers:
        block.attention.tp = tp
        block.mlp.tp = tp
    return model


def gather_state(sd: Dict[str, torch.Tensor], num_heads: int,
                 group=None) -> Dict[str, torch.Tensor]:
    """The full state dict on every model rank from each rank's part
    (``sd`` on the rank's device; collective over ``group``)."""
    out = {}
    for key, t in sd.items():
        out[key] = (gather_tensor(key, mesh.all_gather_tensor(t, group=group), num_heads)
                    if is_sharded(key) else t)
    return out


def split_sq_norm(grads: Dict[str, torch.Tensor], split: Callable, group) -> torch.Tensor:
    """The squared global norm of a model whose gradients are spread over
    ``group``: the squares of the entries ``split(key)`` names summed over
    the group, the others (equal on every rank) counted once."""
    def sq(keys):
        return sum((torch.sum(grads[k_].float() ** 2) for k_ in keys),
                   torch.zeros((), device=next(iter(grads.values())).device))

    part = sq([k_ for k_ in grads if split(k_)]).reshape(1)
    part = mesh.all_reduce_(part, group=group)[0]
    return part + sq([k_ for k_ in grads if not split(k_)])


class TensorParallel:
    """Model rank j of k's view of a ViT (``spec``, the whole model's):
    ``rank_spec`` builds its module, ``wire`` connects the module's blocks
    to the model group, ``part`` cuts a whole state dict (parameters,
    masks, momentum) to the rank's, ``full`` assembles the whole one from
    every rank's part (a collective over the group), ``sq_norm`` is the
    gradient clip's global norm."""

    axis = "model"

    def __init__(self, spec, group, j: int, k: int):
        self.spec, self.group, self.j, self.k = spec, group, j, k
        self.num_heads = spec.cfg.num_heads
        self.rank_spec = shard_spec(spec, k)

    def wire(self, model):
        return make_tensor_parallel(model, self.group, self.j, self.k)

    def part(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return shard_vit_params(sd, self.j, self.k, self.num_heads)

    def full(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gather_state(sd, self.num_heads, self.group)

    def sq_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        return split_sq_norm(grads, is_sharded, self.group)
