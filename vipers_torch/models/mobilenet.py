"""MobileNetV2 (port of ``vipers/models/mobilenet.py``), the quantization
path's own family, and the ``quantized_`` registry aliases.

The JAX package registers the family for ``train.quantize``: the
reference's quantization entry point takes torchvision's quantizable
models (``quantized_mobilenet_v2``, ``quantized_resnet18``,
``quantized_resnet50``), and ``register_quantized_aliases`` resolves each
alias to the same spec with ``extra["quantized"]``. Any registered model
quantizes.

The modules carry torchvision's ``mobilenet_v2`` state-dict names
(``features.0.0`` the stem convolution, ``features.{n}.conv.{k}`` the
inverted residuals, ``features.18`` the head convolution,
``classifier.1``), so the state dict is the torchvision ``.pth``;
``core.checkpoint`` maps the JAX package's flax paths (``stem/conv``,
``block{b}_{i}/{expand,depthwise,project}/{conv,bn}``, ``head_conv``,
``classifier``) to them. BatchNorm is flax's (``models.cnn``) at the JAX
module's epsilon 1e-3 and momentum 0.9 (torchvision's epsilon is 1e-5),
its output in the promoted dtype of input and scale as flax's
``nn.BatchNorm`` with no ``dtype`` gives it. There is no dropout before
the classifier (torchvision has one; the JAX module does not).

Input is NHWC, like the JAX package; the forward returns ``(logits,
{"features": head map NHWC[, "batch_stats"]})`` as the ResNet does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vipers_torch.core.registry import ModelSpec, build_model, register_model
from vipers_torch.models.cnn import BatchNorm, Conv2d, Linear, conv_extent, name_batch_norms
from vipers_torch.models.vit import _lecun_normal

BN_EPS, BN_MOMENTUM = 1e-3, 0.9

# torchvision's mobilenet_v2 inverted-residual config: (t, c, n, s)
V2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _make_divisible(v, divisor=8, min_value=None):
    """torchvision's channel-rounding rule."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _act(x, act: Optional[str]):
    if act == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if act == "hardswish":
        return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
    return x


class ConvBNAct(nn.Module):
    """Convolution (``0``), BatchNorm (``1``) and relu6, hardswish or no
    activation: torchvision's ``Conv2dNormActivation`` keys."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: Optional[str] = "relu6"):
        super().__init__()
        self.act = act
        self.add_module("0", Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2,
                                    groups=groups, bias=False))
        self.add_module("1", BatchNorm(cout, BN_MOMENTUM, BN_EPS, promote_output=True))

    def forward(self, x, stats=None):
        return _act(self._modules["1"](self._modules["0"](x), stats), self.act)


class InvertedResidual(nn.Module):
    """``conv``: [expand ConvBNAct (t != 1)], depthwise ConvBNAct, project
    convolution, its BatchNorm, as torchvision numbers them; ``use_se``
    adds the squeeze-excitation of the JAX module (``se_reduce``,
    ``se_expand``, hardsigmoid)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int,
                 use_se: bool = False, act: str = "relu6"):
        super().__init__()
        hidden = _make_divisible(in_ch * expand_ratio)
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(in_ch, hidden, kernel=1, act=act))
        layers += [ConvBNAct(hidden, hidden, stride=stride, groups=hidden, act=act),
                   Conv2d(hidden, out_ch, 1, bias=False),
                   BatchNorm(out_ch, BN_MOMENTUM, BN_EPS, promote_output=True)]
        self.conv = nn.ModuleList(layers)
        self.use_se = use_se
        if use_se:
            squeeze = _make_divisible(hidden // 4)
            self.se_reduce = Conv2d(hidden, squeeze, 1)
            self.se_expand = Conv2d(squeeze, hidden, 1)

    def forward(self, x, stats=None):
        y = x
        *convs, project, bn = self.conv
        for i, layer in enumerate(convs):
            y = layer(y, stats)
            if self.use_se and i == len(convs) - 1:  # after the depthwise
                se = torch.relu(self.se_reduce(y.mean(dim=(2, 3), keepdim=True)))
                y = y * (torch.clamp(self.se_expand(se) + 3.0, 0.0, 6.0) / 6.0)
        y = bn(project(y), stats)
        return x + y if self.use_res else y


@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    num_classes: int = 1000
    width_mult: float = 1.0

    def blocks(self):
        """(in, out, stride, expand ratio) of each inverted residual, in
        order, and the stem's and head's widths."""
        stem = _make_divisible(32 * self.width_mult)
        out, in_ch = [], stem
        for t, c, n, s in V2_CFG:
            out_ch = _make_divisible(c * self.width_mult)
            for i in range(n):
                out.append((in_ch, out_ch, s if i == 0 else 1, t))
                in_ch = out_ch
        return stem, out, _make_divisible(1280 * max(1.0, self.width_mult))


class MobileNetV2(nn.Module):
    def __init__(self, cfg: MobileNetConfig):
        super().__init__()
        self.cfg = cfg
        stem, blocks, last = cfg.blocks()
        feats = [ConvBNAct(3, stem, stride=2)]
        feats += [InvertedResidual(*b) for b in blocks]
        feats.append(ConvBNAct(blocks[-1][1], last, kernel=1))
        self.features = nn.ModuleList(feats)
        self.classifier = nn.ModuleList([nn.Identity(), Linear(last, cfg.num_classes)])
        name_batch_norms(self)

    def feature_extent(self, px: int) -> int:
        """Cells of the head convolution's map along an input axis of
        ``px`` pixels: the stem (k3 s2 p1), then each inverted residual's
        depthwise (k3 p1 at its stride); the 1x1 convolutions keep it."""
        n = conv_extent(px, 3, 2, 1)
        for _in, _out, stride, _t in self.cfg.blocks()[1]:
            n = conv_extent(n, 3, stride, 1)
        return n

    def forward(self, x, need_attn: bool = True, tap_delta=None):  # need_attn: no-op for CNNs
        """``tap_delta``: the explain tap, (N, H', W', C) added to the head
        convolution's map before pooling."""
        stats = {} if self.training else None
        x = x.permute(0, 3, 1, 2)
        for layer in self.features:
            x = layer(x, stats)
        features = x.permute(0, 2, 3, 1)
        if tap_delta is not None:
            features = features + tap_delta
        aux = {"features": features}
        if stats is not None:
            aux["batch_stats"] = stats
        return self.classifier[1](features.mean(dim=(1, 2))), aux


def init_mobilenet_params(cfg: MobileNetConfig, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys and layouts (conv HWIO,
    depthwise (3, 3, 1, C), dense (in, out)) and flax's default
    initializers (lecun_normal kernels over the kernel's fan-in, biases 0,
    BatchNorm scale 1 and bias 0), drawn from ``gen``. The running
    statistics start at mean 0 and var 1: the module's buffers."""
    def cba(cin, cout, k=3, groups=1):
        cin_g = cin // groups
        return {"conv": {"kernel": _lecun_normal((k, k, cin_g, cout), k * k * cin_g, gen)},
                "bn": {"scale": torch.ones(cout), "bias": torch.zeros(cout)}}

    stem, blocks, last = cfg.blocks()
    params = {"stem": cba(3, stem)}
    n_of = [n for _t, _c, n, _s in V2_CFG]
    k = 0
    for bi, n in enumerate(n_of):
        for i in range(n):
            in_ch, out_ch, _stride, t = blocks[k]
            k += 1
            hidden = _make_divisible(in_ch * t)
            blk = {}
            if t != 1:
                blk["expand"] = cba(in_ch, hidden, 1)
            blk["depthwise"] = cba(hidden, hidden, 3, hidden)
            blk["project"] = cba(hidden, out_ch, 1)
            params[f"block{bi}_{i}"] = blk
    params["head_conv"] = cba(blocks[-1][1], last, 1)
    params["classifier"] = {"kernel": _lecun_normal((last, cfg.num_classes), last, gen),
                            "bias": torch.zeros(cfg.num_classes)}
    return params


@register_model("mobilenet_v2")
def mobilenet_v2(num_classes=1000, width_mult=1.0, input_size=(224, 224)):
    cfg = MobileNetConfig(num_classes, width_mult)
    return ModelSpec(
        name="mobilenet_v2", cfg=cfg, module=lambda: MobileNetV2(cfg),
        init=lambda gen: init_mobilenet_params(cfg, gen),
        input_size=tuple(input_size), prune_exclude=(), family="mobilenet",
        num_classes=num_classes, extra={"width_mult": width_mult})


def register_quantized_aliases():
    """``quantized_<name>``: the same architecture, ``extra["quantized"]``
    set; the quantize driver applies the quantization."""
    for base in ("mobilenet_v2", "resnet18", "resnet50"):
        def make(b):
            def builder(**kw):
                spec = build_model(b, **kw)
                spec.extra = dict(spec.extra, quantized=True)
                return spec

            return builder

        register_model(f"quantized_{base}")(make(base))


register_quantized_aliases()
