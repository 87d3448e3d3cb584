"""VGG-16 (port of ``vipers/models/vgg.py``): the classifier and the
reference's headless variant, which drops the classifier and the final
max-pool so the map keeps stride 16.

torchvision's state-dict names (``features.{0,2,5,...,28}``,
``classifier.{0,3,6}``) and flax's dtype rule (``models.cnn``): in bf16
every layer runs in bf16. Input is NHWC; the forward returns ``(logits,
{"features": NHWC map})``, the map in place of the logits when headless.
The classifier flattens the map in CHW order, as torch does, with no
adaptive pooling (the map is 7x7 at 224x224).

The classifier's two dropouts run at the JAX model's rate of 0.5 in train
mode, their masks drawn from the forward's ``generator``
(``models.stochastic``); in eval mode they are the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.models.activations import ReLU
from vipers_torch.models.cnn import Conv2d, Linear
from vipers_torch.models.stochastic import dropout
from vipers_torch.models.vit import _lecun_normal

# torchvision cfg "D": 13 conv widths; max-pools after these conv indices
_CFG_D_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_POOL_AFTER = (1, 3, 6, 9, 12)


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    num_classes: int = 1000
    headless: bool = False
    dropout_rate: float = 0.5
    conv_widths: Tuple[int, ...] = _CFG_D_WIDTHS
    fc_dims: Tuple[int, int] = (4096, 4096)


def feature_layers(cfg: VGGConfig):
    """``features``' layers in torchvision's order: ("conv", in, out),
    ("relu",), ("pool",)."""
    layers, cin = [], 3
    for i, width in enumerate(cfg.conv_widths):
        layers += [("conv", cin, width), ("relu",)]
        cin = width
        if i in _POOL_AFTER and not (cfg.headless and i == len(cfg.conv_widths) - 1):
            layers.append(("pool",))
    return layers


class VGG16(nn.Module):
    def __init__(self, cfg: VGGConfig):
        super().__init__()
        self.cfg = cfg
        mods = {"conv": lambda cin, cout: Conv2d(cin, cout, 3, padding=1), "relu": ReLU,
                "pool": lambda: nn.MaxPool2d(2, 2)}
        self.features = nn.Sequential(*(mods[k](*a) for k, *a in feature_layers(cfg)))
        self.classifier = None
        if not cfg.headless:
            d0, d1 = cfg.fc_dims
            flat = cfg.conv_widths[-1] * 7 * 7
            # torchvision's Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear;
            # ``forward`` runs the dropouts in the identities' slots
            self.classifier = nn.Sequential(Linear(flat, d0), ReLU(), nn.Identity(),
                                            Linear(d0, d1), ReLU(), nn.Identity(),
                                            Linear(d1, cfg.num_classes))

    def feature_extent(self, px: int) -> int:
        """Cells of the feature map along an input axis of ``px`` pixels."""
        for kind, *_ in feature_layers(self.cfg):
            if kind == "pool":
                px //= 2
        return px

    def random_rates(self):
        """The classifier's dropout rate (none when headless)."""
        return () if self.classifier is None else (self.cfg.dropout_rate,)

    def forward(self, x, need_attn: bool = True, tap_delta=None,
                generator: Optional[torch.Generator] = None):  # need_attn: no-op for CNNs
        """``tap_delta``: the explain tap, (N, H', W', C) added to the
        conv stack's output. ``generator``: the classifier's dropout masks
        in train mode."""
        x = self.features(x.permute(0, 3, 1, 2))
        features = x.permute(0, 2, 3, 1)
        if tap_delta is not None:
            features = features + tap_delta
            x = features.permute(0, 3, 1, 2)
        if self.classifier is None:
            return features, {"features": features}
        x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(self.classifier):
            x = layer(x)
            if i in (2, 5):
                x = dropout(x, self.cfg.dropout_rate, self.training, generator)
        return x, {"features": features}


def init_vgg_params(cfg: VGGConfig, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys (``conv_i``, ``fc1-3``)
    and layouts, flax's default initializers, drawn from ``gen``."""
    params, cin = {}, 3
    for i, width in enumerate(cfg.conv_widths):
        params[f"conv_{i}"] = {"kernel": _lecun_normal((3, 3, cin, width), 9 * cin, gen),
                               "bias": torch.zeros(width)}
        cin = width
    if not cfg.headless:
        dims = (cin * 7 * 7, *cfg.fc_dims, cfg.num_classes)
        for j in range(3):
            params[f"fc{j + 1}"] = {"kernel": _lecun_normal(dims[j:j + 2], dims[j], gen),
                                    "bias": torch.zeros(dims[j + 1])}
    return params


def _spec(name, cfg: VGGConfig, input_size):
    return ModelSpec(name=name, cfg=cfg, module=lambda: VGG16(cfg),
                     init=lambda gen: init_vgg_params(cfg, gen), input_size=tuple(input_size),
                     family="vgg", num_classes=0 if cfg.headless else cfg.num_classes,
                     rebuild=lambda c: _spec(name, c, input_size))


@register_model("vgg16")
def vgg16(num_classes=1000, headless=False, input_size=(224, 224)):
    return _spec("vgg16", VGGConfig(num_classes, headless), input_size)


@register_model("vgg16_bottom")
def vgg16_bottom(input_size=(224, 224)):
    """Headless VGG16, the final max-pool removed (the reference's
    ``vgg16Bottom``)."""
    return _spec("vgg16_bottom", VGGConfig(headless=True), input_size)
