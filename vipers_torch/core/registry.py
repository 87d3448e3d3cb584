"""Model registry (port of ``vipers/core/registry.py``).

Builders return a :class:`ModelSpec`: the model's configuration plus the
metadata the framework needs (which parameter paths are prunable, patch
size). ``spec.module()`` constructs the ``nn.Module``;
``spec.init(generator)`` draws a parameter tree in the JAX package's keys
and layouts, which pruning ranks and ``core.checkpoint`` loads into the
module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

_BUILTIN_MODELS: Dict[str, Callable[..., "ModelSpec"]] = {}


@dataclasses.dataclass
class ModelSpec:
    """A model configuration plus its metadata.

    ``prune_exclude``: substrings; a parameter path containing one is never
    pruned even if it is a conv/dense kernel (``("qkv",)`` on ViTs: the
    reference never prunes the attention in-projection)."""

    name: str
    cfg: Any
    module: Callable[[], torch.nn.Module]
    init: Callable[[torch.Generator], dict]
    input_size: tuple = (224, 224)
    prune_exclude: Sequence[str] = ()
    patch_size: Optional[int] = None


def register_model(name: Optional[str] = None):
    """Decorator registering a builder: ``fn(**kwargs) -> ModelSpec``."""

    def wrapper(fn):
        key = name if name is not None else fn.__name__
        if key in _BUILTIN_MODELS:
            raise ValueError(f"model {key!r} already registered")
        _BUILTIN_MODELS[key] = fn
        return fn

    return wrapper


def build_model(name: str, **kwargs) -> ModelSpec:
    _ensure_builtins_imported()
    try:
        builder = _BUILTIN_MODELS[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}. Available: "
                         f"{sorted(_BUILTIN_MODELS)}") from None
    return builder(**kwargs)


def _ensure_builtins_imported():
    from vipers_torch.models import vit  # noqa: F401  (registers builders)
