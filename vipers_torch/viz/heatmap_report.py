"""Heatmap grids and animated GIFs across pruning iterations (port of
``vipers/viz/heatmap_report.py``): for a class and a method, the
per-iteration heatmap images ``explain`` saved, as an n-per-row grid
figure (matplotlib) and a GIF stepping through the sparsity levels (PIL).
"""

from __future__ import annotations

import glob as globlib
import os
import re
from typing import List, Optional

import numpy as np
from PIL import Image


def list_classes(root: str, method: str) -> List[str]:
    """Class subdirectories present under the explain-driver layout
    (``{root}/pruning_iteration_{NN}/{method}/{cls}/`` or the flat
    single-iteration ``{root}/{method}/{cls}/``) — the single source of
    truth for the directory contract ``collect_iteration_images`` reads."""
    pats = [
        os.path.join(root, "pruning_iteration_*", method, "*"),
        os.path.join(root, method, "*"),
    ]
    return sorted({
        os.path.basename(d)
        for pat in pats for d in globlib.glob(pat)
        if os.path.isdir(d)
    })


def collect_iteration_images(root: str, method: str, cls: str,
                             pattern: str = "heatmap_*") -> List[str]:
    """Find per-iteration heatmap files saved by the explain driver under
    ``{root}/pruning_iteration_{NN}/{method}/{cls}/``; falls back to a flat
    ``{root}/{method}/{cls}`` layout (single iteration).

    The attention method writes ``blended_heatmap_*``/``attention_
    heatmap_*`` instead of a bare ``heatmap_*`` (the reference's two-file
    attention rendering), so the default pattern falls back to the
    blended overlay when the bare name finds nothing."""
    def _hits(d):
        for pat in (pattern, "blended_" + pattern):
            got = sorted(globlib.glob(os.path.join(d, method, cls, pat)))
            if got:
                return got
        return []

    out = []
    it_dirs = sorted(globlib.glob(os.path.join(root, "pruning_iteration_*")))
    if it_dirs:
        for d in it_dirs:
            hits = _hits(d)
            if hits:
                out.append(hits[0])
    else:
        out = _hits(root)
    return out


def heatmap_grid(image_paths: List[str], out_path: str, per_row: int = 6,
                 titles: Optional[List[str]] = None):
    """5x6-style grid of heatmaps (`:16-76`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(image_paths)
    rows = -(-n // per_row)
    fig, axes = plt.subplots(rows, per_row, figsize=(2.2 * per_row, 2.2 * rows))
    axes = np.atleast_2d(axes)
    for i in range(rows * per_row):
        ax = axes[i // per_row, i % per_row]
        ax.axis("off")
        if i < n:
            ax.imshow(Image.open(image_paths[i]))
            if titles and i < len(titles):
                ax.set_title(titles[i], fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def heatmap_gif(image_paths: List[str], out_path: str, duration_ms: int = 400):
    """Animated GIF across pruning iterations (`:78-122`)."""
    frames = [Image.open(p).convert("P") for p in image_paths]
    if not frames:
        raise ValueError("no frames")
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:],
        duration=duration_ms, loop=0,
    )
    return out_path
