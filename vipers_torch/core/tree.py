"""Nested parameter dicts <-> flat {path tuple: leaf} dicts.

The port's parameter tree has the JAX package's (flax's) keys and layouts,
so pruning ranks weights in the same order on both sides; the counterpart
of ``flax.traverse_util.flatten_dict`` / ``unflatten_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

Path = Tuple[str, ...]


def flatten_dict(tree: Dict[str, Any], prefix: Path = ()) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    for key, val in tree.items():
        path = prefix + (key,)
        if isinstance(val, dict):
            out.update(flatten_dict(val, path))
        else:
            out[path] = val
    return out


def unflatten_dict(flat: Dict[Path, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree
