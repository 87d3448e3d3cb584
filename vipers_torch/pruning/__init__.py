"""Pruning masks and global magnitude pruning."""

from vipers_torch.pruning.magnitude import magnitude_prune  # noqa: F401
from vipers_torch.pruning.masks import (apply_masks,  # noqa: F401
                                        compute_sparsity_global, init_masks,
                                        prunable_paths)
