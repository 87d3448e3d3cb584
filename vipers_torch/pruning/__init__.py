"""Pruning masks, global magnitude pruning and SNIP."""

from vipers_torch.pruning.magnitude import magnitude_prune  # noqa: F401
from vipers_torch.pruning.masks import (apply_masks,  # noqa: F401
                                        compute_sparsity_global, init_masks,
                                        prunable_paths)
from vipers_torch.pruning.snip import (snip_prune, snip_saliency,  # noqa: F401
                                       snip_threshold)
