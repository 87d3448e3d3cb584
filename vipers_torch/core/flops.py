"""Analytic FLOP counts of the ViT forward and train step (port of
``vipers/core/flops.py``), for the MFU line of ``tools/profile_lost.py``.

``H100_SXM_BF16_DENSE_PEAK`` is the NVIDIA H100 SXM's dense bf16 tensor
peak, 989 TFLOP/s, the figure ``PERF.md`` divides kernel bounds by.
"""

from __future__ import annotations

# NVIDIA H100 SXM dense bf16 tensor-core peak, FLOP/s
H100_SXM_BF16_DENSE_PEAK = 989e12


def vit_train_flops_per_image(d: int, layers: int, grid_tokens: int, patch: int,
                              mlp_ratio: int = 4, seq_pad_multiple: int = 128) -> float:
    """Forward + backward FLOPs an image of the classification train step,
    by the MFU convention: the backward is twice the forward (an input-
    and a weight-gradient product for every forward product)."""
    return 3.0 * vit_forward_flops_per_image(d=d, layers=layers, grid_tokens=grid_tokens,
                                             patch=patch, mlp_ratio=mlp_ratio,
                                             seq_pad_multiple=seq_pad_multiple)


def vit_forward_flops_per_image(d: int, layers: int, grid_tokens: int, patch: int,
                                mlp_ratio: int = 4, seq_pad_multiple: int = 128) -> float:
    """Forward FLOPs an image of the LOST ViT pipeline: all ``layers``
    blocks, attention at the flash-padded sequence length, and the patch
    convolution. ``grid_tokens``: gh*gw patch tokens (the CLS is added
    here)."""
    t = grid_tokens + 1
    t_pad = -(-t // seq_pad_multiple) * seq_pad_multiple
    dense_macs = layers * t * (3 * d * d + d * d + 2 * mlp_ratio * d * d)
    attn_macs = layers * 2 * t_pad * t_pad * d
    patch_macs = t * (patch * patch * 3) * d
    return 2.0 * (dense_macs + attn_macs + patch_macs)
