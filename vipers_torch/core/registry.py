"""Model registry (port of ``vipers/core/registry.py``).

Builders return a :class:`ModelSpec`: the model's configuration plus the
metadata the framework needs (which parameter paths are prunable, patch
size). ``spec.module()`` constructs the ``nn.Module`` (``build_module``
without the random init, for a module a state dict is loaded into next);
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
    reference never prunes the attention in-projection).
    ``quantize_exclude``: the same for weight quantization and activation
    observation, None for ``prune_exclude`` (read through
    ``quant_exclude``; the ViTs add ``attention/out``: the JAX ViT applies
    both attention projections by einsum, so no int8 site sees them, as
    torch ao leaves ``MultiheadAttention``'s projections float).
    ``family`` ("vit", "resnet", "vgg", "swin", "dino_vit", "mobilenet")
    picks the weight converters of
    ``core.checkpoint``; ``num_classes`` is the head's width, 0 for a
    headless model; ``extra`` holds what a family's callers read (a Swin's
    last-stage ``num_heads``); ``rebuild(cfg)`` is the same model's spec
    at another configuration (``build_model``'s ``arch_overrides``)."""

    name: str
    cfg: Any
    module: Callable[[], torch.nn.Module]
    init: Callable[[torch.Generator], dict]
    input_size: tuple = (224, 224)
    prune_exclude: Sequence[str] = ()
    quantize_exclude: Optional[Sequence[str]] = None
    patch_size: Optional[int] = None
    family: str = ""
    num_classes: int = 1000
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rebuild: Optional[Callable[[Any], "ModelSpec"]] = None

    @property
    def quant_exclude(self) -> Sequence[str]:
        """Parameter-path substrings left out of weight quantization and
        activation observation: ``quantize_exclude``, else
        ``prune_exclude``."""
        if self.quantize_exclude is not None:
            return self.quantize_exclude
        return self.prune_exclude


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
    """Construct a registered model. ``arch_overrides`` (optional dict)
    rebuilds it with replaced config fields (``{"num_heads": 4,
    "head_dim": 64, "mlp_dim": 768}``, ``{"inner_widths": {...}}``): how a
    structurally slimmed checkpoint (``pruning.structured``, its
    ``.slim.json`` sidecar) gets a module whose parameter shapes match.
    JSON lists come back as tuples; ``spec.extra`` follows the new config;
    a field the config lacks raises ``TypeError``, a model without a
    config ``ValueError``."""
    _ensure_builtins_imported()
    arch = kwargs.pop("arch_overrides", None)
    try:
        make_spec = _BUILTIN_MODELS[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}. Available: "
                         f"{sorted(_BUILTIN_MODELS)}") from None
    spec = make_spec(**kwargs)
    if arch:
        if spec.rebuild is None or not dataclasses.is_dataclass(spec.cfg):
            raise ValueError(f"model {name!r} does not support arch_overrides "
                             "(no config dataclass to rebuild)")
        arch = {k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()}
        spec = spec.rebuild(dataclasses.replace(spec.cfg, **arch))
    return spec


# the torch.nn.init functions a module's constructor draws its parameters
# with (nn.Linear, nn.Conv2d: kaiming_uniform_ and uniform_)
_INITIALIZERS = ("uniform_", "normal_", "trunc_normal_", "kaiming_uniform_",
                 "kaiming_normal_", "xavier_uniform_", "xavier_normal_")


def _unchanged(tensor, *_args, **_kwargs):
    return tensor


def build_module(spec: ModelSpec) -> torch.nn.Module:
    """``spec.module()`` with its parameters' random initialization skipped
    (their memory left as ``torch.empty`` leaves it), for a caller that
    loads every parameter next with a strict ``load_state_dict``: the
    default init that such a load overwrites costs seconds of host time on
    the larger models. Buffers are built as usual. The ``torch.nn.init``
    functions are swapped for the call, so build on one thread at a time."""
    saved = {name: getattr(torch.nn.init, name) for name in _INITIALIZERS}
    for name in saved:
        setattr(torch.nn.init, name, _unchanged)
    try:
        return spec.module()
    finally:
        for name, fn in saved.items():
            setattr(torch.nn.init, name, fn)


def _ensure_builtins_imported():
    from vipers_torch.models import (dino_vit, mobilenet, resnet, swin, vgg,  # noqa: F401
                                     vit)  # (registers builders)
