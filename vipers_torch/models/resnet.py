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
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vipers_torch.core.registry import ModelSpec, register_model
from vipers_torch.models.activations import relu
from vipers_torch.models.cnn import BatchNorm, Conv2d, Linear, conv_extent, name_batch_norms
from vipers_torch.models.vit import _lecun_normal


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 prev_dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=prev_dilation,
                            dilation=prev_dilation, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation, dilation=dilation, bias=False)
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
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 prev_dilation: int = 1, downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        # torchvision passes previous_dilation to a dilated stage's first
        # block and the new dilation afterwards (ResNet sets prev_dilation)
        self.conv2 = Conv2d(planes, planes, 3, stride, padding=prev_dilation,
                            dilation=prev_dilation, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
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
    dilate the 3x3 convolutions instead (``_spec``'s dilate 2 and 4)."""

    stage_sizes: Tuple[int, ...]
    bottleneck: bool
    num_classes: int = 1000
    replace_stride_with_dilation: Tuple[bool, bool, bool] = (False, False, False)
    headless: bool = False
    num_filters: int = 64

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
                    downsample=first and (stride != 1 or inplanes != planes * block.expansion)))
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
            if cfg.bottleneck:
                blk = {"conv1": conv(1, inplanes, planes), "bn1": bn(planes),
                       "conv2": conv(3, planes, planes), "bn2": bn(planes),
                       "conv3": conv(1, planes, out), "bn3": bn(out)}
            else:
                blk = {"conv1": conv(3, inplanes, planes), "bn1": bn(planes),
                       "conv2": conv(3, planes, planes), "bn2": bn(planes)}
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
    return ModelSpec(
        name=name, cfg=cfg, module=lambda: ResNet(cfg),
        init=lambda gen: init_resnet_params(cfg, gen),
        input_size=tuple(input_size), family="resnet",
        num_classes=0 if headless else num_classes)


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
