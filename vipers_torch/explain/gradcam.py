"""GradCAM / Guided-GradCAM / ViT attention heatmaps (port of
``vipers/explain/gradcam.py``).

``model_apply(x, tap_delta=None) -> (logits, aux)`` is the model with its
weights (the JAX functions take ``variables`` beside it; here the module
holds them). The model's parameters must not require gradients: the
gradients below are taken with respect to the input or the tap only.

  * GradCAM: activations A at a tap layer and gradients G = d(score)/dA,
    taken with ``torch.autograd.grad`` on a zero ``tap_delta`` that
    requires grad (the model adds it to the target activation). Neither
    the input nor a parameter requires grad, so the backward ends at the
    tap, in the last block of a ViT. Weights = spatial mean of G, cam =
    relu(sum_c w_c A_c), min-max normalized, resized to the input
    (``models.interpolate.resize_bilinear``, ``jax.image.resize``'s
    bilinear) and normalized again.
  * Guided-GradCAM: guided-backprop input gradients (the ReLUs of
    ``models.activations`` inside ``guided_backprop()``) times the
    upsampled non-negative GradCAM.
  * ViT attention heatmap: last block's CLS attention, head-summed, resized
    to the image.

Target class = the model's own argmax prediction.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from vipers_torch.models.activations import guided_backprop
from vipers_torch.models.interpolate import resize_bilinear


def _resize_bilinear(img, out_hw):
    """(H, W) or (H, W, C) bilinear resize, ``jax.image.resize``'s."""
    if img.dim() == 2:
        return resize_bilinear(img, tuple(out_hw))
    return resize_bilinear(img, (*out_hw, img.shape[-1]))


def _minmax(x, eps=1e-7):
    lo = torch.min(x)
    hi = torch.max(x)
    return (x - lo) / (hi - lo + eps)


def make_gradcam(
    model_apply: Callable,
    tap_shape: Tuple[int, ...],
    token_grid: Optional[Tuple[int, int]] = None,
    aux_key: str = "features",
):
    """Returns fn(x) -> (cam (H, W) in [0, 1], predicted class tensor).

    The tap activation is ``aux[aux_key]`` with shape ``tap_shape``: for
    CNNs (1, H', W', C); for ViTs (1, T, D), and ``token_grid`` reshapes the
    tokens (minus CLS) to a grid. One forward and one backward to the tap.
    """

    def cam_fn(x):
        tap = torch.zeros(tap_shape, dtype=torch.float32, device=x.device, requires_grad=True)
        with torch.enable_grad():
            logits, aux = model_apply(x, tap_delta=tap)
            target = torch.argmax(logits[0])
            # the tap contributes additively: A = the activation at zero
            # delta, G = dS/dA = the gradient with respect to the delta
            (g,) = torch.autograd.grad(logits[0, target], tap)
        a = aux[aux_key].detach()
        if token_grid is not None:
            gh, gw = token_grid
            a = a[:, 1:, :].reshape(1, gh, gw, -1)
            g = g[:, 1:, :].reshape(1, gh, gw, -1)
        w = torch.mean(g, dim=(1, 2), keepdim=True)  # GAP over spatial
        cam = torch.sum(w * a, dim=-1)[0]
        cam = torch.clamp(cam, min=0.0)
        cam = _minmax(cam)
        cam = _resize_bilinear(cam, x.shape[1:3])
        cam = _minmax(cam)  # pytorch_grad_cam normalizes after scaling too
        return cam, target

    return cam_fn


def gradcam(model_apply, x, tap_shape, token_grid=None, aux_key: str = "features"):
    """One-call GradCAM; returns (cam np (H, W), predicted class)."""
    cam, target = make_gradcam(model_apply, tap_shape, token_grid, aux_key)(x)
    return cam.cpu().numpy(), int(target)


def input_gradient(model_apply, x, target):
    """d logits[0, target] / dx (``target`` an int or None for the argmax)."""
    xr = x.detach().requires_grad_(True)
    with torch.enable_grad():
        logits, _ = model_apply(xr)
        t = torch.argmax(logits[0]) if target is None else target
        (g,) = torch.autograd.grad(logits[0, t], xr)
    return g


def guided_backprop_attr(model_apply, x, target=None):
    """Guided-backprop input attribution (Captum GBP): the input gradient
    with every ReLU passing only positive gradients at positive inputs."""
    with guided_backprop():
        g = input_gradient(model_apply, x, target)
    return g.cpu().numpy()


def guided_gradcam(model_apply, x, tap_shape, token_grid=None, aux_key: str = "features"):
    """Captum GuidedGradCam: elementwise product of the (upsampled,
    non-negative) layer GradCAM with the guided-backprop gradients."""
    cam, target = gradcam(model_apply, x, tap_shape, token_grid, aux_key)
    gbp = guided_backprop_attr(model_apply, x, target=target)
    return gbp * cam[None, :, :, None], target


def vit_attention_heatmap(attn, grid_hw, out_hw, patch_size: int):
    """Head-summed CLS attention upsampled to the image: attn (1, nh, T, T)
    -> (H, W) float map. The per-head upsample is x``patch_size``, then the
    sum is resized to ``out_hw``."""
    gh, gw = grid_hw
    nh = attn.shape[1]
    grid = attn[0, :, 0, 1:].float().reshape(nh, gh, gw)
    up = resize_bilinear(grid, (nh, gh * patch_size, gw * patch_size))
    summed = torch.sum(up, dim=0)
    return _resize_bilinear(summed, out_hw).cpu().numpy()
