"""vipers_torch — the PyTorch/CUDA port of ``vipers`` for NVIDIA Hopper.

The module layout mirrors ``vipers/``. The port imports ``torch`` and never
``jax`` or anything of ``vipers``; the JAX package stays the reference and
the parity tests in ``tests/test_torch_*.py`` hold the two against each
other on the same numpy inputs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every TPU kernel on the ported path is a hand-written CUDA kernel for
``sm_90a`` (``vipers_torch/csrc/``), built with ``nvcc`` on first use; on a
CPU tensor each kernel wrapper runs its plain PyTorch version instead.

Ported so far: the batched ViT LOST pipeline
(``vipers_torch.discovery.driver.LostFeatureExtractor``) and the bf16
masked ViT train step (``vipers_torch.train``).
"""

__version__ = "0.1.0"
