"""Token-axis padding helpers (port of ``vipers/ops/tokens.py``).

Pad the (N, T, D) token stream once to a multiple, mark pad rows invalid in
the token mask, and undo with one slice after the encoder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_tokens(x, token_mask, seq_len: int, multiple: int):
    """Pad (N, T, D) ``x`` to a ``multiple`` of tokens with zero rows and
    extend/synthesize the (N, T) bool mask marking pads invalid. Returns
    (x, token_mask) unchanged when already aligned."""
    if not multiple or seq_len % multiple == 0:
        return x, token_mask
    t_pad = round_up(seq_len, multiple)
    n = x.shape[0]
    x = F.pad(x, (0, 0, 0, t_pad - seq_len))
    base = (token_mask if token_mask is not None
            else torch.ones((n, seq_len), dtype=torch.bool, device=x.device))
    return x, F.pad(base, (0, t_pad - seq_len), value=False)


def unpad_tokens(x, qkv_like, attn, seq_len: int):
    """Undo ``pad_tokens`` on the token stream, the ln_1 aux tensor and
    (if present) the (N, H, T, T) attention."""
    if x.shape[1] == seq_len:
        return x, qkv_like, attn
    x = x[:, :seq_len]
    qkv_like = qkv_like[:, :seq_len]
    if attn is not None:
        attn = attn[:, :, :seq_len, :seq_len]
    return x, qkv_like, attn
