"""int8 quantization: QAT (weight and activation fake-quant with the
observer and BatchNorm freeze schedules), PTQ calibration and real int8
execution (port of ``vipers/train/quantize.py``).

- Weights: symmetric per-output-channel int8 (torch's axis 0, the flax
  kernel's last axis), fake-quantized with a straight-through estimator.
- Activations: affine uint8 at every Dense and Conv input and output,
  from moving-average min/max observers (``ObserverState``) that the step
  carries as a dict {``site:in`` / ``site:out``: state} of device tensors.
  The sites are the JAX package's flax module paths (``layer1_0/conv1``,
  ``encoder_layer_0/mlp/fc1``), mapped from the module names through the
  family's ``flax_path``, in the order a forward calls them.
- flax's method interceptors become scopes over the model's ``nn.Linear``
  and ``nn.Conv2d`` modules: torch forward hooks observe (and fake-quantize
  the output) in QAT and PTQ; int8 execution replaces each site's
  ``forward`` on the instance, as ``explain.lrp`` does. Inside either the
  fused-MLP gate is off (``ops.fused_mlp.interceptors``), so fc1 stays a
  Dense call. The ViT's ``qkv`` and ``attention/out`` (einsums in the JAX
  model) are left out through ``spec.quant_exclude``.
- Real int8: ``int8_dense`` / ``int8_conv`` quantize the input to uint8,
  shift it by 128 into int8 and accumulate int8 x int8 in int32, then fold
  the zero point into a per-output-channel correction. The products: on
  the CPU (the plain versions) integer ``torch.matmul`` / ``F.conv2d`` on
  int32; on the card cuBLASLt's int8 GEMM (``torch._int_mm``), the library
  standing in for XLA's ``dot_general``, with the convolutions as im2col +
  ``_int_mm``, and a depthwise convolution tap by tap in int32 (exact
  integer arithmetic; torch has no integer convolution on CUDA). Every
  route gives the JAX package's int32 accumulators bit for bit; a shape
  ``_int_mm`` refuses is padded with zeros (rows to 17, K and N to multiples
  of 8). ``INT_MM_CALLS`` counts the card's ``_int_mm`` calls.

``run_quantize`` is ``vipers_torch quantize``, one card a process (a
data-parallel run, ``parallel.mesh``, averages the QAT gradients over the
ranks, reduces each observer's batch range over the global batch, and
writes from rank 0): ``--resume`` is required, the masked network is calibrated (``--mode ptq``) or trained
(``--mode qat``, in f32 as the JAX step is), and the JAX package's lines
and files come out, ``.pth`` in place of orbax:
``quantized_post_train_model.pth`` / ``qat_checkpoint.pth`` with
``observers`` {site: {"min", "max"}} beside the weights (and the
``.slim.json`` sidecar of a slimmed model).
"""

from __future__ import annotations

import contextlib
import os
import types
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from vipers_torch.ops.fused_mlp import interceptors
from vipers_torch.parallel import mesh as parallel

ACT_QMIN, ACT_QMAX = 0, 255  # uint8 activations (torch's default affine)

# the card's torch._int_mm calls; chip_smoke.py reads this
INT_MM_CALLS = [0]


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, qmin, qmax):
        inv = x / scale + zero_point
        q = torch.clamp(torch.round(inv), qmin, qmax)
        out = (q - zero_point) * scale
        inside = (inv >= qmin) & (inv <= qmax)
        ctx.save_for_backward(inside)
        # the JAX value: x + (out - x) where inside, out elsewhere
        return torch.where(inside, x + (out - x), out)

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device)), \
            None, None, None, None


def fake_quant(x, scale, zero_point=0.0, qmin=-128, qmax=127):
    """Quantize-dequantize with torch FakeQuantize's straight-through
    gradient: 1 where ``x / scale + zero_point`` lies inside [qmin, qmax]
    inclusive, 0 outside; none to ``scale`` or ``zero_point``."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=x.dtype, device=x.device)
    if not isinstance(zero_point, torch.Tensor):
        zero_point = torch.tensor(zero_point, dtype=x.dtype, device=x.device)
    return _FakeQuant.apply(x, scale.detach(), zero_point.detach(), qmin, qmax)


def per_channel_weight_scale(w, axis: int = 0, qmax: int = 127):
    """Symmetric per-output-channel scales (fbgemm's weight scheme), keeping
    ``w``'s rank: the output channel is torch's axis 0 (the flax kernel's
    last)."""
    axis %= w.dim()
    dims = tuple(i for i in range(w.dim()) if i != axis)
    amax = torch.amax(torch.abs(w), dim=dims, keepdim=True)
    return torch.clamp(amax / qmax, min=1e-9)


def weight_sites(params: Dict[str, torch.Tensor], fam) -> Dict[str, str]:
    """{state-dict key: site} of every Dense/Conv kernel of ``params``
    (state-dict keys, the module's layout): the keys whose flax path ends
    in ``kernel`` at rank 2 or 4; the site is that path less its leaf."""
    out = {}
    for key, w in params.items():
        if w.dim() not in (2, 4):
            continue
        path = fam.flax_path(key, w.dim())
        if path[-1] == "kernel":
            out[key] = "/".join(path[:-1])
    return out


def fake_quant_weights(params: Dict[str, torch.Tensor], fam, exclude=()) -> dict:
    """``params`` with every conv/dense kernel fake-quantized per channel
    int8, except the sites ``exclude`` names."""
    out = dict(params)
    for key, site in weight_sites(params, fam).items():
        if any(e in site for e in exclude):
            continue
        w = params[key]
        out[key] = fake_quant(w, per_channel_weight_scale(w))
    return out


class ObserverState:
    """Per-site moving-average min/max (torch MovingAverageMinMaxObserver,
    averaging constant 0.01): the first update snaps to the batch range,
    later ones move ``min + 0.01 * (mn - min)``. 0-d f32 tensors and a bool
    flag on the device, so updates never wait on the host."""

    __slots__ = ("min_val", "max_val", "initialized")

    def __init__(self, min_val, max_val, initialized):
        self.min_val, self.max_val, self.initialized = min_val, max_val, initialized

    @staticmethod
    def init(device=None):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return ObserverState(z, z, torch.zeros((), dtype=torch.bool, device=device))

    def update(self, x, momentum: float = 0.01):
        x = x.detach()
        # a data-parallel run observes the global batch's range
        mn, mx = parallel.reduce_min_max(torch.amin(x).float(), torch.amax(x).float())
        new_min = torch.where(self.initialized, self.min_val + momentum * (mn - self.min_val), mn)
        new_max = torch.where(self.initialized, self.max_val + momentum * (mx - self.max_val), mx)
        return ObserverState(new_min, new_max, torch.ones_like(self.initialized))

    def qparams(self, qmin=ACT_QMIN, qmax=ACT_QMAX):
        """torch's affine (scale, zero point), the range snapped to hold 0."""
        mn = torch.clamp(self.min_val, max=0.0)
        mx = torch.clamp(self.max_val, min=0.0)
        scale = torch.clamp((mx - mn) / (qmax - qmin), min=1e-9)
        zp = torch.clamp(torch.round(qmin - mn / scale), qmin, qmax)
        return scale, zp


def observers_to_checkpoint(observers: Dict[str, ObserverState]) -> dict:
    """{site: {"min", "max"}} as 0-d f32 CPU tensors: a checkpoint's
    ``observers`` entry."""
    return {k: {"min": o.min_val.detach().cpu(), "max": o.max_val.detach().cpu()}
            for k, o in observers.items()}


def static_qparams_from_observers(observers, device=None):
    """A checkpoint's observer ranges ({site: {"min", "max"}}) -> {site:
    (scale, zero point)} static input qparams for the int8 serving paths:
    ``:in`` stripped, ``:out`` sites skipped; None without observers."""
    if not observers:
        return None
    out = {}
    for site, mm in observers.items():
        site = site[:-3] if site.endswith(":in") else site
        if site.endswith(":out"):
            continue
        obs = ObserverState(torch.tensor(float(mm["min"]), dtype=torch.float32, device=device),
                            torch.tensor(float(mm["max"]), dtype=torch.float32, device=device),
                            torch.ones((), dtype=torch.bool, device=device))
        out[site] = obs.qparams()
    return out or None


def quantize_params_int8(params: Dict[str, torch.Tensor], fam, exclude=()):
    """Bake int8 kernels and their scales ("convert"): (q, scales), both
    {site: tensor} in the module's layout (scales (out, 1[, 1, 1]))."""
    q, scales = {}, {}
    for key, site in weight_sites(params, fam).items():
        if any(e in site for e in exclude):
            continue
        w = params[key].detach()
        s = per_channel_weight_scale(w)
        q[site] = torch.clamp(torch.round(w / s), -128, 127).to(torch.int8)
        scales[site] = s
    return q, scales


def dequantize_params(params: Dict[str, torch.Tensor], fam, q, scales) -> dict:
    """``params`` with each baked site's kernel as ``q * scale`` in f32
    (QDQ inference)."""
    out = dict(params)
    for key, site in weight_sites(params, fam).items():
        if site in q:
            out[key] = q[site].to(torch.float32) * scales[site]
    return out


# ------------------------------------------------ activation observation

def site_modules(model: nn.Module, fam) -> Dict[nn.Module, str]:
    """{module: site} of every ``nn.Linear`` / ``nn.Conv2d`` of ``model``."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            out[m] = "/".join(fam.flax_path(f"{name}.weight", m.weight.dim())[:-1])
    return out


def _call(model, x, tensors, kwargs):
    if tensors is None:
        return model(x, **kwargs)
    return functional_call(model, tensors, (x,), kwargs)


@contextlib.contextmanager
def _forward_hooks(model, fam, hook):
    """``hook(module, site, input, output)`` on every site's forward."""
    handles = [m.register_forward_hook(
        lambda mod, args, out, site=site: hook(mod, site, args[0], out))
        for m, site in site_modules(model, fam).items()]
    try:
        with interceptors():
            yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _eval_mode(model, train: bool):
    was = model.training
    model.train(train)
    try:
        yield
    finally:
        model.train(was)


def observer_sites(model, fam, x, exclude=(), tensors=None, **kwargs):
    """The sites an eval forward of ``x`` calls, in call order, less those
    ``exclude`` names: the observer dict's key set (``init_observers``)
    that ``quantized_apply`` keeps."""
    sites = []

    def hook(_mod, site, _xin, _out):
        if not any(e in site for e in exclude):
            sites.append(site)

    with torch.no_grad(), _eval_mode(model, False), _forward_hooks(model, fam, hook):
        _call(model, x, tensors, kwargs)
    return sites


def init_observers(sites, device=None) -> Dict[str, ObserverState]:
    """Input (``site:in``) and output (``site:out``) observers per site:
    outputs drive the QAT fake-quant, inputs the int8 qparams."""
    return {f"{s}:{io}": ObserverState.init(device) for s in sites for io in ("in", "out")}


@contextlib.contextmanager
def _frozen_batchnorm(model):
    """Every ``models.cnn.BatchNorm`` on its running statistics (neither
    taken from the batch nor updated) while the rest stays in train mode:
    torch's ``freeze_bn_stats``."""
    from vipers_torch.models.cnn import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm) and m.training]
    for m in bns:
        m.eval()
    try:
        yield
    finally:
        for m in bns:
            m.train()


def quantized_apply(model, fam, x, observers: Dict[str, ObserverState],
                    update_observers: bool = True, apply_act_fake_quant: bool = True,
                    exclude=(), freeze_bn: bool = False, tensors=None, **kwargs):
    """Forward with activation observation (and fake-quant) at every site
    that has observers: returns (the forward's output, the new observer
    dict). ``update_observers=False`` is the frozen-observer variant,
    ``apply_act_fake_quant=False`` PTQ calibration (observe only),
    ``freeze_bn`` the BatchNorm freeze; ``tensors`` runs the model on
    these parameters (``torch.func.functional_call``)."""
    new_obs: Dict[str, ObserverState] = {}

    def hook(_mod, site, xin, out):
        if f"{site}:out" not in observers or any(e in site for e in exclude):
            return None
        obs_in = observers[f"{site}:in"]
        new_obs[f"{site}:in"] = obs_in.update(xin) if update_observers else obs_in
        obs_out = observers[f"{site}:out"]
        obs_out = obs_out.update(out) if update_observers else obs_out
        new_obs[f"{site}:out"] = obs_out
        if apply_act_fake_quant:
            scale, zp = obs_out.qparams()
            out = fake_quant(out, scale.to(out.dtype), zp.to(out.dtype), ACT_QMIN, ACT_QMAX)
        return out

    bn = _frozen_batchnorm(model) if freeze_bn else contextlib.nullcontext()
    with bn, _forward_hooks(model, fam, hook):
        out = _call(model, x, tensors, kwargs)
    return out, new_obs


# --------------------------------------------------------- real int8 path

def _quantize_input(x, act_scale, act_zp):
    """uint8 bins of ``x`` shifted by 128 into int8. The index in f32, a
    division as in the JAX package (a bf16 index near the top of the range
    has ulp 1)."""
    xq = torch.clamp(torch.round(x.float() / act_scale + act_zp), ACT_QMIN, ACT_QMAX)
    return (xq - 128.0).to(torch.int8)


def _pad_to(t, dim: int, multiple: int = 8, at_least: int = 0):
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, at_least)
    if want == n:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, want - n]
    return F.pad(t, pad)


def matmul_int32(a, w):
    """int32 (M, N) = a (M, K) int8 @ w (N, K) int8 transposed. The CPU
    multiplies int32 copies (the plain version); the card calls cuBLASLt's
    int8 GEMM (``torch._int_mm``), with the operands zero-padded where it
    refuses the shape (M <= 16; K or N not a multiple of 8): the padded
    rows and columns add nothing."""
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"matmul_int32 takes int8 operands, got {a.dtype}, {w.dtype}")
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), w.to(torch.int32).t())
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    m, n = a.shape[0], w.shape[0]
    a = _pad_to(_pad_to(a, 1), 0, 1, 17)
    w = _pad_to(_pad_to(w, 1), 0)
    INT_MM_CALLS[0] += 1
    acc = torch._int_mm(a.contiguous(), w.contiguous().t())
    return acc[:m, :n]


def conv_int32(xs, w, strides=(1, 1), dil=(1, 1), groups: int = 1):
    """int32 accumulators of an unpadded (VALID) convolution of int8 NCHW
    ``xs`` with int8 OIHW ``w``. The CPU convolves int32 copies (the plain
    version; torch's CPU build has no dilated integer convolution, so a
    dilated one takes the lowered route on int32 matmuls); the card runs
    im2col + ``matmul_int32`` (per group), and a depthwise convolution
    (groups = channels, one output each) as an int32 multiply-add per tap,
    all exact integer arithmetic."""
    if xs.device.type == "cpu" and tuple(dil) == (1, 1):
        return F.conv2d(xs.to(torch.int32), w.to(torch.int32), stride=strides, groups=groups)
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xs.device}")
    return conv_int32_lowered(xs, w, strides, dil, groups)


def conv_int32_lowered(xs, w, strides=(1, 1), dil=(1, 1), groups: int = 1):
    """The card's route of ``conv_int32`` on any device: im2col (one
    strided slice a tap, in the flax kernel's (kh, kw, c) order) +
    ``matmul_int32`` per group, or int32 multiply-adds a tap for a
    depthwise convolution."""
    n, c, h, wd = xs.shape
    o, cg, kh, kw = w.shape
    ho = (h - dil[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (wd - dil[1] * (kw - 1) - 1) // strides[1] + 1

    def tap(x, i, j):
        return x[..., i * dil[0]: i * dil[0] + strides[0] * (ho - 1) + 1: strides[0],
                 j * dil[1]: j * dil[1] + strides[1] * (wo - 1) + 1: strides[1]]

    if groups == c and o == c and cg == 1:
        acc = torch.zeros((n, c, ho, wo), dtype=torch.int32, device=xs.device)
        w32 = w.to(torch.int32)
        for i in range(kh):
            for j in range(kw):
                acc += tap(xs, i, j).to(torch.int32) * w32[:, 0, i, j].reshape(1, c, 1, 1)
        return acc
    outs = []
    og = o // groups
    for g in range(groups):
        xg = xs[:, g * cg:(g + 1) * cg]
        cols = torch.stack([tap(xg, i, j).permute(0, 2, 3, 1)  # (N, Ho, Wo, cg) a tap
                            for i in range(kh) for j in range(kw)], dim=3)
        wg = w[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, kh * kw * cg)
        outs.append(matmul_int32(cols.reshape(n * ho * wo, kh * kw * cg), wg))
    acc = torch.cat(outs, dim=1) if groups > 1 else outs[0]
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


def int8_dense(x, w_q, w_scale, act_scale, act_zp, bias=None):
    """A Dense in integer arithmetic: uint8 activations x int8 weights
    ``w_q`` (out, in), int32 accumulation, dequantized once:

    y = s_x * s_w * [(x_q - 128) @ w_q^T + (128 - zp_x) * rowsum(w_q)] + b
    """
    xs = _quantize_input(x, act_scale, act_zp)
    k = x.shape[-1]
    acc = matmul_int32(xs.reshape(-1, k), w_q).to(torch.float32)
    colsum = torch.sum(w_q.to(torch.int32), dim=1).to(torch.float32)
    acc = acc + (128.0 - act_zp) * colsum
    y = acc * (act_scale * w_scale.reshape(1, -1))
    if bias is not None:
        y = y + bias
    return y.reshape(*x.shape[:-1], w_q.shape[0])


def int8_conv(x, w_q, w_scale, act_scale, act_zp, bias, pads, strides, dil,
              groups: int = 1):
    """A Conv in integer arithmetic, ``int8_dense``'s counterpart: NCHW
    ``x``, OIHW int8 ``w_q``. The shifted activation is padded explicitly
    with ``zp - 128`` (a real zero quantizes to zp), so the 128 shift is
    uniform over all positions and its correction one per-output-channel
    term ``(128 - zp) * sum(w_q)``."""
    xs = _quantize_input(x, act_scale, act_zp)
    pad_val = (act_zp - 128.0).to(torch.int8)
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        n, c, h, w = xs.shape
        padded = pad_val.reshape(1, 1, 1, 1).expand(n, c, h + pt + pb, w + pl + pr).clone()
        padded[:, :, pt:pt + h, pl:pl + w] = xs
        xs = padded
    acc = conv_int32(xs, w_q, strides, dil, groups).to(torch.float32)
    ksum = torch.sum(w_q.to(torch.int32), dim=(1, 2, 3)).to(torch.float32)
    acc = acc + ((128.0 - act_zp) * ksum).reshape(1, -1, 1, 1)
    y = acc * (act_scale * w_scale.reshape(1, -1, 1, 1))
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


def _int8_site(mod, orig, w_q, w_scale, site, qparams_for):
    """The int8 ``forward`` of one Dense/Conv site (``orig`` where
    ``qparams_for`` gives None). A convolution pads with zeros, which the
    integer path pads explicitly; another padding mode raises."""
    from vipers_torch.models.vit import PatchConv

    if isinstance(mod, nn.Conv2d) and mod.padding_mode != "zeros":
        raise ValueError(f"{site}: int8 convolutions pad with zeros, not {mod.padding_mode}")
    patch = isinstance(mod, PatchConv)
    if patch:
        p = mod.kernel_size[0]
        w_patch = w_q.permute(0, 2, 3, 1).reshape(w_q.shape[0], -1)  # (kh, kw, c) rows

    def forward(x):
        qp = qparams_for(site, x)
        if qp is None:
            return orig(x)
        s, zp = qp
        if patch:  # the stride-p patch conv as patches @ kernel
            n, h, w, c = x.shape
            gh, gw = h // p, w // p
            patches = (x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
                       .reshape(n, gh * gw, p * p * c))
            out = int8_dense(patches, w_patch, w_scale, s, zp, mod.bias)
        elif isinstance(mod, nn.Linear):
            out = int8_dense(x, w_q, w_scale, s, zp, mod.bias)
        else:
            out = int8_conv(x, w_q, w_scale, s, zp, mod.bias, tuple((p, p) for p in mod.padding),
                            mod.stride, mod.dilation, mod.groups)
        return out.to(x.dtype)

    return forward


@contextlib.contextmanager
def _int8_sites(model, fam, q, scales, qparams_for):
    """Every site with a baked kernel in ``q`` executes in int8 inside the
    scope (its ``forward`` replaced on the instance)."""
    patched = []
    for m, site in site_modules(model, fam).items():
        if site in q:
            m.forward = _int8_site(m, m.forward, q[site], scales[site], site, qparams_for)
            patched.append(m)
    try:
        with interceptors():
            yield
    finally:
        for m in patched:
            del m.forward  # the class's method again


def int8_apply(model, fam, x, q, scales, observers, tensors=None, **kwargs):
    """Inference with every baked Dense and Conv in real int8, the input
    qparams from the observers (``site:in``); a site without an observer
    runs QDQ on the dequantized kernel. ``tensors``: the parameters to run
    on (the model's own by default)."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    qd = dequantize_params(tensors, fam, q, scales)

    def qparams_for(site, _x):
        obs = observers.get(f"{site}:in")
        return None if obs is None else obs.qparams()

    with _int8_sites(model, fam, q, scales, qparams_for):
        return functional_call(model, qd, (x,), kwargs)


def dynamic_qparams(x, token_mask=None, reduce=None):
    """Per-tensor affine uint8 qparams from the live activation (dynamic
    quantization), the range snapped to hold 0; ``token_mask`` (B, T)
    leaves bucket- and seq-pad rows of a (B, T, C) activation out;
    ``reduce(mn, mx)`` widens the range to other ranks' (the token shards
    of sequence parallelism)."""
    x32 = x.float()
    if token_mask is not None:
        valid = token_mask[..., None].to(torch.bool)
        big = torch.finfo(torch.float32).max
        mn = torch.clamp(torch.amin(torch.where(valid, x32, big)), max=0.0)
        mx = torch.clamp(torch.amax(torch.where(valid, x32, -big)), min=0.0)
    else:
        mn = torch.clamp(torch.amin(x32), max=0.0)
        mx = torch.clamp(torch.amax(x32), min=0.0)
    if reduce is not None:
        mn, mx = reduce(mn, mx)
    scale = torch.clamp((mx - mn) / (ACT_QMAX - ACT_QMIN), min=1e-9)
    zp = torch.clamp(torch.round(ACT_QMIN - mn / scale), ACT_QMIN, ACT_QMAX)
    return scale, zp


@contextlib.contextmanager
def int8_dynamic_sites(model, fam, q, scales, exclude=(), qparams_token_masks=None,
                       static_qparams=None):
    """The JAX package's ``int8_dynamic_apply`` as a scope: ``model``'s
    forwards inside it run every baked Dense/Conv in real int8 with dynamic
    per-tensor input qparams, or the static ones of ``static_qparams``
    ({site: (scale, zp)}, calibrated observers) where given.
    ``qparams_token_masks`` {T: (B, T) mask} leaves pad rows of a (B, T, C)
    input out of its range (give the raw and the seq-padded T). The
    model's other layers run in its own float dtype. Under sequence
    parallelism (``parallel.sp``) a token activation's range leaves this
    rank's pad rows out and spans every rank's tokens."""
    from vipers_torch.parallel.sp import sequence_axis

    def qparams_for(site, xin):
        if any(e in site for e in exclude):
            return None
        if static_qparams is not None and site in static_qparams:
            return static_qparams[site]
        m = None
        seq = sequence_axis()
        if seq is not None and xin.dim() == 3 and xin.shape[1] == seq.local_t:
            m = seq.local_mask
        elif qparams_token_masks and xin.dim() == 3:
            m = qparams_token_masks.get(xin.shape[1])
            if m is not None and m.shape[0] != xin.shape[0]:
                m = None
        return dynamic_qparams(xin, m, seq.reduce_min_max if seq is not None else None)

    with _int8_sites(model, fam, q, scales, qparams_for):
        yield


# ------------------------------------------------------------- QAT step

def make_qat_train_step(num_classes: int, label_smoothing: float = 0.0, exclude=(),
                        observer_update: bool = True, bn_frozen: bool = False,
                        seed: int = 0):
    """``step(state, observers, batch) -> (state, new observers, metrics)``:
    masked weights fake-quantized per channel, activations fake-quantized
    from the observers, masked gradients and updates, in f32 (the JAX step
    takes no compute dtype). ``observer_update`` / ``bn_frozen`` pick the
    variant the epoch driver swaps in where torch's enable/disable_observer
    and freeze_bn_stats flip."""
    from vipers_torch.models.cnn import exact_f32_convs
    from vipers_torch.models.stochastic import dropout_generator, has_random_layers
    from vipers_torch.train.steps import accuracy_topk, cross_entropy, forward_params

    def step(state, observers, batch):
        images, labels = batch
        model, fam = state.model, state.family
        kw = {"need_attn": False}
        if has_random_layers(model):
            kw["generator"] = dropout_generator(seed, state.step, images.device)
        params = dict(model.named_parameters())
        model.train()
        with exact_f32_convs():
            tensors = fake_quant_weights(forward_params(params, state.masks), fam, exclude)
            (logits, aux), new_obs = quantized_apply(
                model, fam, images, observers, update_observers=observer_update,
                exclude=exclude, freeze_bn=bn_frozen, tensors=tensors, **kw)
            loss = cross_entropy(logits, labels, num_classes, label_smoothing)
            grads = torch.autograd.grad(loss, list(params.values()))
        acc1, acc5 = accuracy_topk(logits.detach(), labels)
        grads, (loss, acc1, acc5) = parallel.average_gradients(
            dict(zip(params, grads)), (loss.detach(), acc1, acc5))
        state.opt.step(grads, state.masks)
        stats = aux.get("batch_stats")
        if stats:
            buffers = state.batch_stats
            with torch.no_grad():
                for k, v in stats.items():
                    buffers[k].copy_(v)
        state.step += 1
        return state, new_obs, {"loss": loss, "acc1": acc1, "acc5": acc5}

    return step


def make_int8_eval_step(q, scales, observers, num_classes: int):
    """``step(state, batch) -> {loss_sum, top1, top5, n}`` with every
    Dense and Conv in real int8 (the per-epoch converted-model eval), on
    the masked weights in eval mode."""
    from vipers_torch.models.cnn import exact_f32_convs
    from vipers_torch.train.steps import _topk_indices, cross_entropy, forward_params

    @torch.no_grad()
    def step(state, batch):
        images, labels = batch
        model = state.model
        with _eval_mode(model, False), exact_f32_convs():
            logits, _aux = int8_apply(model, state.family, images, q, scales, observers,
                                      tensors=forward_params(state.params, state.masks),
                                      need_attn=False)
        if labels.dim() == 2:
            labels = torch.argmax(labels, dim=1)
        # sentinel rows (label -1, a data-parallel eval's padding) are left out
        valid = labels >= 0
        safe = labels.clamp(min=0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        per_example = -logp.gather(1, safe[:, None])[:, 0]
        correct = (_topk_indices(logits, min(5, logits.shape[-1])) == safe[:, None]) \
            & valid[:, None]
        return {"loss_sum": torch.where(valid, per_example, per_example.new_zeros(())).sum(),
                "top1": correct[:, :1].sum(), "top5": correct.sum(), "n": valid.sum()}

    return step


def ptq_calibrate(model, fam, observers, batches, num_batches: int = 32, exclude=(),
                  tensors=None):
    """PTQ calibration: observe every site over ``num_batches`` batches of
    (images, labels) in eval mode; no fake-quant."""
    with torch.no_grad(), _eval_mode(model, False):
        for i, (images, _labels) in enumerate(batches):
            if i >= num_batches:
                break
            _out, observers = quantized_apply(
                model, fam, images, observers, update_observers=True,
                apply_act_fake_quant=False, exclude=exclude, tensors=tensors,
                need_attn=False)
    return observers


# ------------------------------------------------------------- CLI driver

def _with_params(state, params):
    """A stand-in for ``state`` whose parameters are ``params``: what the
    train package's eval step reads."""
    return types.SimpleNamespace(model=state.model, params=params, masks=state.masks,
                                 ema_params=None, ema_batch_stats=None)


def _save_artifact(state, params, path: str, observers, epoch: Optional[int] = None):
    """``torch.save`` {"model": the torchvision state dict (masked layers as
    weight_orig / weight_mask, running statistics), "observers"[, "epoch"]}
    through the family's exporter (a temporary file, then renamed)."""
    from vipers_torch.core.checkpoint import contiguous_tensor

    fam = state.family
    p, bs = fam.trees({**params, **state.batch_stats})
    sd = fam.export_pth(p, bs, fam.masks_from_state_dict(state.masks), False)
    obj = {"model": {k: contiguous_tensor(v) for k, v in sd.items()},
           "observers": observers_to_checkpoint(observers)}
    if epoch is not None:
        obj["epoch"] = int(epoch)
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _refuse_tensor_parallel(cfg):
    """``--model-parallel`` exits: a CNN has no tensor-parallel spec (the
    train driver's message); a ViT's QAT observers would have to span the
    column-split qkv and fc1 outputs, which is not ported yet (A10).
    ``--pipeline-parallel`` and ``--pp-*`` are ignored, as the JAX
    quantize driver ignores them."""
    from vipers_torch.core.config import refuse_unported
    from vipers_torch.core.registry import build_model

    refuse_unported(cfg, "quantize")
    spec = build_model(cfg.model)
    if spec.family != "vit":
        raise SystemExit("--model-parallel shards ViT attention/MLP features; "
                         f"model {cfg.model!r} (family {spec.family!r}) has no "
                         "tensor-parallel spec")
    raise SystemExit("vipers_torch quantize: --model-parallel (QAT observers over the "
                     "column-split qkv and fc1 outputs) is not ported yet (ROADMAP A10)")


def run_quantize(args) -> int:
    """``vipers_torch quantize``: ``--mode ptq`` calibrates the masked model
    on ``--calibration-batches`` train batches, evaluates it QDQ and in
    int8 and writes ``quantized_post_train_model.pth``; ``--mode qat``
    trains it with fake-quant for ``--epochs`` (observers frozen from
    ``--num-observer-update-epochs``, BatchNorm from
    ``--num-batch-norm-update-epochs``), evaluating QAT and int8 and
    writing ``qat_checkpoint.pth`` every epoch."""
    from vipers_torch.core.config import config_from_args
    from vipers_torch.core.device import resolve_device
    from vipers_torch.pruning.structured import write_sidecar
    from vipers_torch.train.driver import (_train_loader, _val_loader, build_session,
                                           resume_session)
    from vipers_torch.train.loop import evaluate
    from vipers_torch.train.steps import forward_params

    cfg = config_from_args(args)
    if cfg.model_parallel > 1:
        _refuse_tensor_parallel(cfg)
    resolve_device(cfg.device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    s = build_session(cfg, cmd="quantize")
    if not cfg.resume:
        # quantizing random weights "works" but means nothing
        raise SystemExit("vipers_torch quantize requires --resume <checkpoint> (a trained, "
                         "possibly pruned model to quantize)")
    resume_session(s, cfg.resume)
    state = s.state
    model, fam = state.model, state.family
    exclude = s.spec.quant_exclude
    h = w = cfg.train_crop_size

    def masked():
        # the PRUNED network: masks are forward-only, so calibration and
        # conversion read the masked weights
        return {k: v.detach() for k, v in forward_params(state.params, state.masks).items()}

    sites = observer_sites(model, fam, torch.zeros((1, h, w, 3), device=s.device),
                           exclude=exclude, tensors=masked(), need_attn=False)
    observers = init_observers(sites, s.device)
    print(f"{len(sites)} quantizable activation sites")

    def write(path, params, epoch=None):
        # every rank holds the same weights and observers: rank 0 writes
        if parallel.is_main():
            _save_artifact(state, params, path, observers, epoch)
            if s.arch_overrides:
                write_sidecar(path, cfg.model, s.arch_overrides)
        parallel.barrier()

    if args.mode == "ptq":
        batches = ((s.normalize(i), lab) for i, lab in _train_loader(s, 0))
        observers = ptq_calibrate(model, fam, observers, batches, args.calibration_batches,
                                  exclude, tensors=masked())
        m = masked()
        q, scales = quantize_params_int8(m, fam, exclude)
        qdq = dequantize_params(m, fam, q, scales)
        acc1, acc5, _loss = evaluate(s.eval_step, _with_params(state, qdq), _val_loader(s),
                                     normalize_fn=s.normalize)
        print(f"PTQ QDQ:  acc1 {acc1:.3f} acc5 {acc5:.3f}")
        int8_step = make_int8_eval_step(q, scales, observers, cfg.num_classes)
        acc1_i, acc5_i, _ = evaluate(int8_step, state, _val_loader(s), normalize_fn=s.normalize)
        print(f"PTQ int8: acc1 {acc1_i:.3f} acc5 {acc5_i:.3f} "
              f"(Dense/Conv layers executed in int8)")
        write(os.path.join(cfg.output_dir, "quantized_post_train_model.pth"), qdq)
        return 0

    n_obs_epochs = args.num_observer_update_epochs
    n_bn_epochs = args.num_batch_norm_update_epochs
    step_cache = {}
    for epoch in range(cfg.optim.epochs):
        observer_update = epoch < n_obs_epochs
        bn_frozen = epoch >= n_bn_epochs
        key = (observer_update, bn_frozen)
        if key not in step_cache:
            step_cache[key] = make_qat_train_step(
                cfg.num_classes, cfg.optim.label_smoothing, exclude,
                observer_update=observer_update, bn_frozen=bn_frozen, seed=cfg.seed)
        if not observer_update and epoch == n_obs_epochs:
            print(f"Disabling observer for subseq epochs, epoch = {epoch}")
        if bn_frozen and epoch == n_bn_epochs:
            print(f"Freezing BN for subseq epochs, epoch = {epoch}")
        qat_step = step_cache[key]
        for i, (images, labels) in enumerate(_train_loader(s, epoch)):
            state, observers, metrics = qat_step(state, observers, (s.normalize(images), labels))
            if cfg.print_freq and i % cfg.print_freq == 0:
                print(f"QAT epoch {epoch} [{i}] loss {float(metrics['loss']):.4f}")
        m = masked()
        evaluate(s.eval_step, _with_params(state, fake_quant_weights(m, fam, exclude)),
                 _val_loader(s), epoch, normalize_fn=s.normalize, log_suffix="QAT")
        q, scales = quantize_params_int8(m, fam, exclude)
        evaluate(make_int8_eval_step(q, scales, observers, cfg.num_classes), state,
                 _val_loader(s), epoch, normalize_fn=s.normalize, log_suffix="INT8")
        write(os.path.join(cfg.output_dir, "qat_checkpoint.pth"),
              {k: v.detach() for k, v in state.params.items()}, epoch)
    s.state = state
    return 0
