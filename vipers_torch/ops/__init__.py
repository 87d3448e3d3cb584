"""Kernels (CUDA sources in ``vipers_torch/csrc``) and token helpers.

Importing this package registers the kernels as ``torch.library`` custom
ops (``vipers_torch::flash_attention_fwd``, ``flash_attention_bwd``,
``flash_attention_packed``, ``fused_ln_dense_gelu``): a program that
``torch.export`` wrote calls them by name, so loading one needs this
package and nothing else of ``vipers_torch``. Nothing is compiled here.
"""

from vipers_torch.ops import flash_attention, fused_mlp  # noqa: F401  (registers the ops)
