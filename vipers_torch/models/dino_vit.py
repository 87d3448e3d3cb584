"""DINO ViT pieces (port of ``vipers/models/dino_vit.py``): so far the
true timm/DINO qkv split, which Swin LOST reads. The DINO backbones
themselves and ``--arch dino`` come with ROADMAP A2."""

from __future__ import annotations


def split_qkv_dino(qkv_out, num_heads: int):
    """(N, T, 3D) qkv projection -> q, k, v each (N, T, D): the true
    layout, (3, heads, head dim) along the last axis."""
    n, t, d3 = qkv_out.shape
    d = d3 // 3
    qkv = qkv_out.reshape(n, t, 3, num_heads, d // num_heads).permute(2, 0, 3, 1, 4)

    def flat(z):
        return z.permute(0, 2, 1, 3).reshape(n, t, d)

    return flat(qkv[0]), flat(qkv[1]), flat(qkv[2])
