"""ResNet-18/34/50 (port of ``vipers/models/resnet.py``): torchvision's
block and stage structure and state-dict names, flax's dtype rule and
BatchNorm (``models.cnn``), ``replace_stride_with_dilation`` for LOST on
CNN features and the headless variant that returns the layer4 map.

Input is NHWC, like the JAX package. The forward returns ``(logits,
aux)``: ``aux["features"]`` is the pre-pool layer4 map in NHWC order
(flattened to (B, H'W', C) its rows come out in the JAX order), and a
train forward adds ``aux["batch_stats"]``, the updated running statistics
{state-dict key: f32 tensor}, which nothing writes back here. A headless
model returns the map in place of the logits.

Parameter trees (``init_resnet_params``) use the JAX package's keys
(``layer1_0/conv1/kernel``, ``downsample_conv``, ``downsample_bn``, conv
kernels HWIO); ``core.checkpoint`` maps them to the module's torchvision
names (``layer1.0.conv1.weight``, ``downsample.0``, ``downsample.1``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.models.activations import relu
from vipers_torch.models.cnn import BatchNorm, Conv2d, Linear, conv_extent, name_batch_norms
from vipers_torch.models.vit import _lecun_normal


class BasicBlock(nn.Module):
    """``inner``: conv1's output width (None: ``planes``), the block's one
    residual-free width, which structured slimming shrinks."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 prev_dilation: int = 1, downsample: bool = False, inner=None):
        super().__init__()
        inner = inner or planes
        self.conv1 = Conv2d(inplanes, inner, 3, stride, padding=prev_dilation,
                            dilation=prev_dilation, bias=False)
        self.bn1 = BatchNorm(inner)
        self.conv2 = Conv2d(inner, planes, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                         BatchNorm(planes)) if downsample else None)

    def forward(self, x, stats=None):
        y = relu(self.bn1(self.conv1(x), stats))
        y = self.bn2(self.conv2(y), stats)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), stats)
        return relu(y + x)


class Bottleneck(nn.Module):
    """``inner``: (conv1's, conv2's) output widths (None: ``planes``
    each), the block's residual-free widths."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 prev_dilation: int = 1, downsample: bool = False, inner=None):
        super().__init__()
        out = planes * self.expansion
        in1, in2 = inner or (planes, planes)
        self.conv1 = Conv2d(inplanes, in1, 1, bias=False)
        self.bn1 = BatchNorm(in1)
        # torchvision passes previous_dilation to a dilated stage's first
        # block and the new dilation afterwards (ResNet sets prev_dilation)
        self.conv2 = Conv2d(in1, in2, 3, stride, padding=prev_dilation,
                            dilation=prev_dilation, bias=False)
        self.bn2 = BatchNorm(in2)
        self.conv3 = Conv2d(in2, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(Conv2d(inplanes, out, 1, stride, bias=False),
                                         BatchNorm(out)) if downsample else None)

    def forward(self, x, stats=None):
        y = relu(self.bn1(self.conv1(x), stats))
        y = relu(self.bn2(self.conv2(y), stats))
        y = self.bn3(self.conv3(y), stats)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), stats)
        return relu(y + x)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """``replace_stride_with_dilation``: for stages 2-4, keep stride 1 and
    dilate the 3x3 convolutions instead (``_spec``'s dilate 2 and 4).
    ``inner_widths``: block name (``layer1_0``) -> residual-free inner
    width, an int for a BasicBlock (conv1's outputs), a (conv1, conv2)
    pair for a Bottleneck (structured slimming); missing blocks keep
    ``planes``."""

    stage_sizes: Tuple[int, ...]
    bottleneck: bool
    num_classes: int = 1000
    replace_stride_with_dilation: Tuple[bool, bool, bool] = (False, False, False)
    headless: bool = False
    num_filters: int = 64
    inner_widths: Optional[Dict[str, Any]] = None

    def inner(self, stage: int, block: int):
        """The inner width of block ``layer{stage+1}_{block}``, or None; a
        pair from a JSON sidecar (a list) as a tuple."""
        w = (self.inner_widths or {}).get(f"layer{stage + 1}_{block}")
        return tuple(w) if isinstance(w, (list, tuple)) else w

    def stages(self):
        """(planes, stride, dilation, prev_dilation) of each stage, by
        torchvision's ``_make_layer`` rule."""
        dilation, out = 1, []
        for stage in range(len(self.stage_sizes)):
            stride = 1 if stage == 0 else 2
            prev = dilation
            if stage > 0 and self.replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            out.append((self.num_filters * 2 ** stage, stride, dilation, prev))
        return out


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        block = Bottleneck if cfg.bottleneck else BasicBlock
        self.conv1 = Conv2d(3, cfg.num_filters, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(cfg.num_filters)
        inplanes = cfg.num_filters
        self.layers = []
        for s, (planes, stride, dilation, prev) in enumerate(cfg.stages()):
            blocks = []
            for b in range(cfg.stage_sizes[s]):
                first = b == 0
                blocks.append(block(
                    inplanes, planes, stride if first else 1, dilation,
                    prev if first else dilation,
                    downsample=first and (stride != 1 or inplanes != planes * block.expansion),
                    inner=cfg.inner(s, b)))
                inplanes = planes * block.expansion
            layer = nn.ModuleList(blocks)
            setattr(self, f"layer{s + 1}", layer)
            self.layers.append(layer)
        self.fc = None if cfg.headless else Linear(inplanes, cfg.num_classes)
        name_batch_norms(self)

    def feature_extent(self, px: int) -> int:
        """Cells of the layer4 map along an input axis of ``px`` pixels."""
        n = conv_extent(conv_extent(px, 7, 2, 3), 3, 2, 1)  # stem conv, max-pool
        for _planes, stride, _dilation, prev in self.cfg.stages():
            n = conv_extent(n, 3, stride, prev, prev)
        return n

    def forward(self, x, need_attn: bool = True, tap_delta=None):  # need_attn: no-op for CNNs
        """``tap_delta``: the explain tap, (N, H', W', C) added to the layer4
        map before pooling (GradCAM's target layer)."""
        stats = {} if self.training else None
        x = x.permute(0, 3, 1, 2)
        x = relu(self.bn1(self.conv1(x), stats))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer in self.layers:
            for block in layer:
                x = block(x, stats)
        features = x.permute(0, 2, 3, 1)
        if tap_delta is not None:
            features = features + tap_delta
            x = features.permute(0, 3, 1, 2)
        aux = {"features": features}
        if stats is not None:
            aux["batch_stats"] = stats
        if self.fc is None:
            return features, aux
        return self.fc(x.mean(dim=(2, 3))), aux


def init_resnet_params(cfg: ResNetConfig, gen: torch.Generator) -> dict:
    """A parameter tree with the JAX package's keys and layouts (conv HWIO,
    dense (in, out)) and flax's default initializers (lecun_normal kernels,
    dense bias 0, BatchNorm scale 1 and bias 0), drawn from ``gen``. The
    running statistics start at mean 0 and var 1: the module's buffers."""
    def conv(k, cin, cout):
        return {"kernel": _lecun_normal((k, k, cin, cout), k * k * cin, gen)}

    def bn(c):
        return {"scale": torch.ones(c), "bias": torch.zeros(c)}

    expansion = 4 if cfg.bottleneck else 1
    params = {"conv1": conv(7, 3, cfg.num_filters), "bn1": bn(cfg.num_filters)}
    inplanes = cfg.num_filters
    for s, (planes, stride, _d, _p) in enumerate(cfg.stages()):
        for b in range(cfg.stage_sizes[s]):
            out = planes * expansion
            inner = cfg.inner(s, b)
            if cfg.bottleneck:
                in1, in2 = inner or (planes, planes)
                blk = {"conv1": conv(1, inplanes, in1), "bn1": bn(in1),
                       "conv2": conv(3, in1, in2), "bn2": bn(in2),
                       "conv3": conv(1, in2, out), "bn3": bn(out)}
            else:
                in1 = inner or planes
                blk = {"conv1": conv(3, inplanes, in1), "bn1": bn(in1),
                       "conv2": conv(3, in1, planes), "bn2": bn(planes)}
            if b == 0 and (stride != 1 or inplanes != out):
                blk["downsample_conv"] = conv(1, inplanes, out)
                blk["downsample_bn"] = bn(out)
            params[f"layer{s + 1}_{b}"] = blk
            inplanes = out
    if not cfg.headless:
        params["fc"] = {"kernel": _lecun_normal((inplanes, cfg.num_classes), inplanes, gen),
                        "bias": torch.zeros(cfg.num_classes)}
    return params


# the JAX registry's ``_spec``: dilate 2 dilates the last stage, 4 the last two
_DILATE = {1: (False, False, False), 2: (False, False, True), 4: (False, True, True)}


def _spec(name, stage_sizes, bottleneck, num_classes, dilate, headless, input_size):
    if dilate not in _DILATE:
        raise ValueError("resnet dilate must be 1, 2 or 4")
    cfg = ResNetConfig(tuple(stage_sizes), bottleneck, num_classes, _DILATE[dilate], headless)
    return _spec_of(name, cfg, input_size)


def _spec_of(name, cfg: ResNetConfig, input_size):
    return ModelSpec(
        name=name, cfg=cfg, module=lambda: ResNet(cfg),
        init=lambda gen: init_resnet_params(cfg, gen),
        input_size=tuple(input_size), family="resnet",
        num_classes=0 if cfg.headless else cfg.num_classes,
        rebuild=lambda c: _spec_of(name, c, input_size))


@register_model("resnet18")
def resnet18(num_classes=1000, dilate=1, headless=False, input_size=(224, 224)):
    return _spec("resnet18", (2, 2, 2, 2), False, num_classes, dilate, headless, input_size)


@register_model("resnet34")
def resnet34(num_classes=1000, dilate=1, headless=False, input_size=(224, 224)):
    return _spec("resnet34", (3, 4, 6, 3), False, num_classes, dilate, headless, input_size)


@register_model("resnet50")
def resnet50(num_classes=1000, dilate=1, headless=False, input_size=(224, 224)):
    return _spec("resnet50", (3, 4, 6, 3), True, num_classes, dilate, headless, input_size)


@register_model("resnet50_bottom")
def resnet50_bottom(dilate=1, input_size=(224, 224)):
    """Headless ResNet-50 feature extractor (the reference's ``Bottom``)."""
    return _spec("resnet50_bottom", (3, 4, 6, 3), True, 1000, dilate, True, input_size)
