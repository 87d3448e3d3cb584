"""Random layers in training: stochastic depth (``drop_path``) and dropout
(``dropout``).

The JAX package draws a layer's random bits from the ``dropout`` rng
stream that the train step folds with the step count. Here a train forward
takes an explicit ``torch.Generator`` on the model's device
(``dropout_generator``): the train step seeds one from (run seed, step),
so a resumed run draws the same masks as the run it continues, and SNIP
seeds one from the run seed alone. An eval forward, or a layer at rate 0,
draws nothing. The bits differ from JAX's; the keep rate and the ``1 /
keep`` scaling are the same, so the two packages agree by distribution
and exactly at rate 0. In a data-parallel run a mask is drawn for the
global batch and each rank keeps its own rows (``parallel.mesh.draw_rand``),
so P ranks draw what one process draws at P times the batch; a
tensor-parallel rank keeps its heads' or MLP columns' slice as well.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vipers_torch.parallel import mesh as parallel


def dropout_generator(seed: int, step: Optional[int], device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``step``), or from
    ``seed`` alone when ``step`` is None."""
    entropy = [int(seed)] if step is None else [int(seed), int(step)]
    sub = int(np.random.SeedSequence(entropy).generate_state(1)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(sub)


def has_random_layers(model: torch.nn.Module) -> bool:
    """Whether ``model`` has a random layer at a rate above 0 (its
    ``random_rates()``): only then does a train forward need a generator."""
    return hasattr(model, "random_rates") and max(model.random_rates(), default=0.0) > 0


def drop_path(y, rate: float, training: bool, generator: Optional[torch.Generator]):
    """Stochastic depth: each sample's branch ``y`` (N, ...) kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask of
    shape (N, 1, ..., 1) drawn from ``generator``. Identity in eval mode or
    at rate 0; a train forward at a rate above 0 needs a generator."""
    if not training or rate == 0.0:
        return y
    if generator is None:
        raise ValueError("stochastic depth in train mode needs a generator "
                         "(models.stochastic.dropout_generator)")
    keep = 1.0 - rate
    shape = (y.shape[0],) + (1,) * (y.dim() - 1)
    mask = parallel.draw_rand(shape, generator, y.device) < keep
    return y * mask.to(y.dtype) / keep


def dropout(x, rate: float, training: bool, generator: Optional[torch.Generator],
            shard: Optional[tuple] = None):
    """flax ``nn.Dropout``: each element of ``x`` kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask drawn from
    ``generator``. Identity in eval mode or at rate 0; a train forward at
    a rate above 0 needs a generator. ``shard`` (dim, j, k): ``x`` is a
    tensor-parallel rank's slice j of k along ``dim`` and keeps that slice
    of the full tensor's mask (``parallel.mesh.draw_rand``)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator "
                         "(models.stochastic.dropout_generator)")
    keep = 1.0 - rate
    mask = parallel.draw_rand(x.shape, generator, x.device, shard) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
