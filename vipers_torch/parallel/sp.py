"""Sequence (token) parallelism for whole-image transformer inference
(port of ``vipers/parallel/sp.py``).

For batch-1 native-resolution LOST, where data parallelism has nothing to
split, the token axis of every activation is sharded over the ranks
instead. The JAX package annotates token shardings and lets XLA place the
collectives; here the model does them itself while a ``sequence_parallel``
context is active (``sequence_axis()`` is the context, None outside it):

- ``shard_tokens``: the sequence padded to a multiple of the group's size
  W (pad tokens masked invalid through the token mask) and this rank's
  T / W tokens kept, rank r the tokens [r T / W, (r + 1) T / W): the CLS
  token goes to rank 0;
- each block runs LayerNorm, qkv, the out projection and the MLP on its
  own tokens; attention gathers k and v from every rank
  (``gather_tokens``) and runs the rank's queries against all keys, the
  padded sequence's mask on the keys;
- the last block's ln_1 output, its attention (``need_attn``, DINO's
  ``--dinoseg``) and the final tokens are gathered whole, so the LOST core
  and the head see what the one-process forward gives.

As in the JAX package, the flash and fused-MLP kernels and the automatic
token pad are off under sequence parallelism (``models.vit``,
``models.dino_vit``): the einsum attention runs on the gathered keys. int8
serving takes each site's dynamic range over every rank's tokens
(``SequenceAxis.reduce_min_max``), so the int8 codes are the one
process's. Every rank must run the same forwards in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from vipers_torch.parallel import mesh

_ACTIVE: list = []  # stack of SequenceAxis


class SequenceAxis:
    """The sequence-parallel group and the current forward's token layout:
    ``full_mask`` (N, W * ``local_t``) bool or None, ``local_mask`` this
    rank's (N, ``local_t``) rows of it (None when no token is masked)."""

    def __init__(self, group=None):
        self.group = group
        self.size = mesh.group_size(group)
        self.rank = dist.get_rank(group) if mesh.active() else 0
        self.local_t = None
        self.full_mask = self.local_mask = None

    def shard(self, x, token_mask: Optional[torch.Tensor] = None):
        """(N, T, D) tokens -> (this rank's (N, T / W, D) tokens, the padded
        (N, W * ceil(T / W)) key mask or None)."""
        n, t, _ = x.shape
        lt = -(-t // self.size)
        pad = lt * self.size - t
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            if token_mask is None:
                token_mask = torch.ones((n, t), dtype=torch.bool, device=x.device)
            token_mask = torch.nn.functional.pad(token_mask, (0, pad), value=False)
        self.local_t, self.full_mask = lt, token_mask
        self.local_mask = (None if token_mask is None
                           else token_mask[:, self.rank * lt:(self.rank + 1) * lt])
        return x[:, self.rank * lt:(self.rank + 1) * lt], token_mask

    def gather(self, x: Optional[torch.Tensor], dim: int = 1, length: Optional[int] = None):
        """Every rank's shards of ``x`` concatenated along ``dim`` (cut to
        ``length`` there); None stays None."""
        if x is None:
            return None
        full = torch.cat(mesh.all_gather_tensor(x, group=self.group), dim=dim)
        return full if length is None else full.narrow(dim, 0, length)

    def reduce_min_max(self, mn, mx):
        """(min, max) of the ranks' scalars: an activation's range over
        every token."""
        return mesh.reduce_min_max(mn, mx, group=self.group)


@contextlib.contextmanager
def sequence_parallel(group=None):
    """Shard the token axis of every ViT and DINO forward inside the
    context over ``group`` (None: every rank)."""
    _ACTIVE.append(SequenceAxis(group))
    try:
        yield _ACTIVE[-1]
    finally:
        _ACTIVE.pop()


def sequence_axis() -> Optional[SequenceAxis]:
    """The active ``SequenceAxis`` or None: the models consult it to gate
    the kernels off and to take the sharded path."""
    return _ACTIVE[-1] if _ACTIVE else None


def shard_tokens(x, token_mask=None):
    """(this rank's tokens of ``x``, the padded key mask) under the active
    context; (``x``, ``token_mask``) when sequence parallelism is off."""
    seq = sequence_axis()
    return (x, token_mask) if seq is None else seq.shard(x, token_mask)


def gather_tokens(x, seq: SequenceAxis, dim: int = 1):
    """``x``'s token shards from every rank, whole along ``dim``."""
    return seq.gather(x, dim)
