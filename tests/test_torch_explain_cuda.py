"""The explain path's kernels and heatmaps on the card.

Marked ``requires_cuda``: each test skips where torch has no usable card.
This file imports neither jax nor the JAX package (run it on the GPU
machine with ``python -m pytest --noconftest -m requires_cuda
tests/test_torch_explain_cuda.py``).

  * The f32 flash forward (row 1) and backward (rows 12-13) at the shapes
    ``explain-eval`` gives them on ViT-B/16: B = 1, 12 heads of 64, no key
    mask, T = 577 and 769 (VOC images padded to 16), against their plain
    versions: out within 1e-5 + 1e-4 relative (lse 1e-4), dq, dk and dv
    within 1e-4 of each gradient's scale.
  * ``compute_heatmaps`` on the card against the CPU on a small ViT (2
    blocks, D 128, 2 heads of 64, 10 classes) whose first block takes the
    flash route (``VIPERS_FLASH_MIN_T=16``; 64 x 96 input, T = 25), the
    same weights and the same CPU-drawn SmoothGrad noise: GradCAM, IG and
    the attention map within 1e-4 of each map's scale; LRP at eps 1e-2 (the
    default eps is ill conditioned in f32) within 1e-3.
"""

import numpy as np
import pytest
import torch

from vipers_torch.explain import driver as tdriver
from vipers_torch.explain import lrp as tlrp
from vipers_torch.models import vit as tvit
from vipers_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA build of torch); the kernels "
                    "have no CPU or interpret mode")
    return torch.device("cuda")


def _qkv(t, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(1, 12, t, 64, generator=g).to(dev) for _ in range(3)]


def _close_to_scale(a, c, frac):
    scale = c.float().abs().max().item()
    assert (a.float() - c.float()).abs().max().item() <= frac * scale


@pytest.mark.parametrize("t", [577, 769])
def test_f32_flash_forward_at_explain_shapes(cuda, t):
    q, k, v = _qkv(t, cuda, seed=t)
    n0 = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_attention_fwd(q, k, v, None)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {**n0, "float32": n0["float32"] + 1}
    want, want_lse = tfa.flash_attention_plain(q, k, v, None)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t", [577, 769])
def test_f32_flash_backward_at_explain_shapes(cuda, t):
    q, k, v = _qkv(t, cuda, seed=t + 1)
    scale = 64 ** -0.5
    out, lse = tfa.flash_attention_plain(q, k, v, None, scale)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(t)).to(cuda)
    n0 = dict(tfa.BWD_LAUNCHES)
    got = tfa.flash_attention_bwd(q, k, v, None, out, lse, g, scale)
    want = tfa.flash_attention_bwd_plain(q, k, v, None, out, lse, g, scale)
    torch.cuda.synchronize()
    assert tfa.BWD_LAUNCHES == {**n0, "float32": n0["float32"] + 1}
    for a, c in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == c.shape
        _close_to_scale(a, c, 1e-4)


def _small_vit():
    """Seed-0 weights, every leaf perturbed by N(0, 0.02), on the CPU."""
    from vipers_torch.core.checkpoint import family

    spec = tvit._build("vit_explain_cuda", tvit.ViTConfig(16, 2, 2, 128, 256, 10), (64, 64))
    rng = np.random.default_rng(0)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: perturb(v) for k, v in tree.items()}
        return tree + torch.from_numpy(rng.normal(0, 0.02, tuple(tree.shape)).astype(np.float32))

    model = spec.module()
    model.load_state_dict(family(spec).state_dict(perturb(spec.init(
        torch.Generator().manual_seed(0)))))
    return spec, model.eval().requires_grad_(False)


def test_compute_heatmaps_card_matches_cpu(cuda, monkeypatch):
    monkeypatch.setenv("VIPERS_FLASH_MIN_T", "16")
    spec, model = _small_vit()
    img = np.random.default_rng(1).normal(0, 1, (64, 96, 3)).astype(np.float32)
    methods = ["gradcam", "ig", "attention"]
    want = tdriver.compute_heatmaps(spec, model, img, methods, ig_steps=4)
    x = torch.from_numpy(img)[None]
    rel_cpu, t_cpu = tlrp.lrp_attribution(tdriver._apply_fn(spec, model, 64, 96), model, x,
                                          eps=1e-2)
    model.to(cuda)
    n_fwd, n_bwd = tfa.LAUNCHES["float32"], tfa.BWD_LAUNCHES["float32"]
    got = tdriver.compute_heatmaps(spec, model, img, methods, ig_steps=4)
    # one flash block: the forward, GradCAM's forward, 8 IG passes (forward
    # and backward each); GradCAM's backward stops at the last block's tap
    assert tfa.LAUNCHES["float32"] - n_fwd == 1 + 1 + 8
    assert tfa.BWD_LAUNCHES["float32"] - n_bwd == 8
    assert int(np.argmax(got["prediction"])) == int(np.argmax(want["prediction"]))
    for m in methods:
        _close_to_scale(torch.from_numpy(got[m]), torch.from_numpy(want[m]), 1e-4)
    rel_card, t_card = tlrp.lrp_attribution(tdriver._apply_fn(spec, model, 64, 96), model,
                                            x.to(cuda), eps=1e-2)
    assert t_card == t_cpu
    _close_to_scale(torch.from_numpy(rel_card), torch.from_numpy(rel_cpu), 1e-3)
