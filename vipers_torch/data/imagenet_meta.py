"""ImageNet-1k class metadata accessors (the port's copy of
``vipers/data/imagenet_meta.py`` and its data files).

The 1000 category names and wnid->name mapping (public torchvision
metadata, counterpart of the reference's ``_meta.py:7`` and
``imagenet_classes.py:4``) ship as a JSON *data* file.
"""

from __future__ import annotations

import functools
import json
import os


@functools.lru_cache(maxsize=1)
def _load():
    path = os.path.join(os.path.dirname(__file__), "meta", "imagenet.json")
    with open(path) as f:
        return json.load(f)


def imagenet_categories():
    """Index-ordered list of 1000 class names."""
    return _load()["categories"]


def imagenet_wnid_to_name():
    """{wnid: human-readable name} ordered dict-equivalent."""
    return _load()["wnid_to_name"]


def class_name(index: int) -> str:
    return imagenet_categories()[index]
