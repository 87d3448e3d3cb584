"""Index streams for the train and val loaders (the port's own copy of
``vipers/data/sampler.py`` at one replica): torch ``DistributedSampler``
semantics and the repeated-augmentation sampler (DeiT's RASampler), drawn
with numpy's generator so the streams equal the JAX package's for the same
seed. The port trains on one device; the multi-replica streams come with
multi-process runs (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np


def epoch_indices(n: int, epoch: int, seed: int = 0, shuffle: bool = True):
    """Epoch ``epoch``'s order of ``n`` samples: a permutation drawn from
    ``seed + epoch``, or ``range(n)``. At one replica ``DistributedSampler``
    pads and strides nothing, and ``drop_last`` cuts nothing."""
    if shuffle:
        return np.random.default_rng(seed + epoch).permutation(n).tolist()
    return list(range(n))


def ra_sampler_indices(n: int, epoch: int, seed: int = 0, shuffle: bool = True,
                       repetitions: int = 3):
    """Each sample ``repetitions`` times in a row, the stream cut to
    floor(n / 256) * 256 samples (the whole stream when that is zero)."""
    indices = [i for i in epoch_indices(n, epoch, seed, shuffle) for _ in range(repetitions)]
    # under 256 images the /256 cut would select nothing
    return indices[: n // 256 * 256 or len(indices)]
