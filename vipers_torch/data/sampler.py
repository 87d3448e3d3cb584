"""Index streams for the train and val loaders (the port's own copy of
``vipers/data/sampler.py``): torch ``DistributedSampler`` semantics and the
repeated-augmentation sampler (DeiT's RASampler), drawn with numpy's
generator so the streams equal the JAX package's for the same seed.

One process takes the whole stream (``epoch_indices``). A data-parallel
run of P processes (``parallel.mesh``) takes rank r's share
(``shard_indices_for_host``): batch-interleaved blocks for training, so
the P batches the ranks take at one step are, in rank order, the batch one
process takes at P times the batch size; strided samples for evaluation,
the tail padded with -1 sentinel rows that the eval step leaves out.
"""

from __future__ import annotations

import math

import numpy as np


def epoch_indices(n: int, epoch: int, seed: int = 0, shuffle: bool = True):
    """Epoch ``epoch``'s order of ``n`` samples: a permutation drawn from
    ``seed + epoch``, or ``range(n)``. At one replica ``DistributedSampler``
    pads and strides nothing, and ``drop_last`` cuts nothing."""
    if shuffle:
        return np.random.default_rng(seed + epoch).permutation(n).tolist()
    return list(range(n))


def ra_sampler_indices(n: int, epoch: int, seed: int = 0, shuffle: bool = True,
                       repetitions: int = 3, num_replicas: int = 1, rank: int = 0):
    """Each sample ``repetitions`` times in a row, the stream padded to a
    multiple of ``num_replicas``, strided by ``rank`` and cut to
    floor(n / 256) * 256 / num_replicas samples (the whole share when that
    is zero). RA keeps per-sample striding across ranks, so it makes no
    claim that P ranks draw what one process draws."""
    num_samples = int(math.ceil(n * float(repetitions) / num_replicas))
    total = num_samples * num_replicas
    indices = [i for i in epoch_indices(n, epoch, seed, shuffle) for _ in range(repetitions)]
    indices += indices[: total - len(indices)]
    indices = indices[rank:total:num_replicas]
    # under 256 images the /256 cut would select nothing
    return indices[: int(math.floor(n // 256 * 256 / num_replicas)) or num_samples]


def shard_indices_for_host(n: int, num_replicas: int, rank: int, epoch: int, seed: int = 0,
                           shuffle: bool = True, drop_last: bool = False,
                           batch_size: int = 0, pad_with_sentinel: bool = False):
    """Rank ``rank``'s share of epoch ``epoch``'s stream of ``n`` samples
    over ``num_replicas`` ranks (``DistributedSampler``: padded by repeating
    the front to a multiple of the world unless ``drop_last``, then strided
    by rank).

    ``batch_size`` (more than one replica): batch-interleaved blocks
    instead, rank r's b-th batch is ``perm[b*G + r*B : b*G + (r+1)*B]``
    with G = B * num_replicas, so the ranks' b-th batches, concatenated in
    rank order, are the b-th batch of one process at batch size G.
    ``pad_with_sentinel``: the strided tail is padded with -1 (a zero image
    labelled -1 in the loader, left out of every eval sum) instead of
    repeated samples."""
    indices = epoch_indices(n, epoch, seed, shuffle)
    if batch_size and num_replicas > 1:
        g = batch_size * num_replicas
        total = (n // g) * g if drop_last else -(-n // g) * g
        total = total or g  # a tiny dataset keeps one (padded) global batch
        while len(indices) < total:
            indices += indices[: total - len(indices)]
        arr = np.asarray(indices[:total]).reshape(-1, num_replicas, batch_size)
        return arr[:, rank, :].reshape(-1).tolist()
    if drop_last:
        total = n // num_replicas * num_replicas
        indices = indices[:total]
    else:
        total = int(math.ceil(n / num_replicas)) * num_replicas
        pad = [-1] * (total - n) if pad_with_sentinel else indices[: total - n]
        indices = indices + pad
    return indices[rank:total:num_replicas]
