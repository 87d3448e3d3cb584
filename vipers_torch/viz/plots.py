"""Sparsity-vs-metric plots (port of ``vipers/viz/plots.py``), host work:
matplotlib and numpy, no device.

``run_plot_cli`` is ``vipers_torch plot --kind lost|mass_rank|mvh|
mvh-compare|heatmaps``: LOST CorLoc curves from ``results_iteration_NN.txt``
(with ``performance.txt`` through ``core.metrics.MetricsWriter``), RMA/RRA
curves from ``{method}_{model}_pruning_iteration_NN.txt``, model-vs-human
curves from ``{model}_pruning_step_N.csv``, and heatmap grids and GIFs
(``viz.heatmap_report``): the text contracts the pipelines write, read as
the JAX package reads them.
"""

from __future__ import annotations

import glob as globlib
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from vipers_torch.core.metrics import MetricsWriter

# The 17 model-vs-human distortion benchmarks, row order of the MvH CSVs
# (the reference's `mvh_performance_plot_2.py:19-39`).
MVH_BENCHMARKS = [
    "colour", "contrast", "cue-conflict", "edge", "eidolonI", "eidolonII",
    "eidolonIII", "false-colour", "high-pass", "low-pass", "phase-scrambling",
    "power-equalisation", "rotation", "silhouette", "sketch", "stylized",
    "uniform-noise",
]

# pruning iterations run per model in the paper's experiments
# (the reference's `mvh_performance_plot_2.py:40-45`)
MVH_MAX_PRUNE = {"resnet18": 27, "resnet50": 26, "swin": 8, "vit_b_32": 14}


def read_results_iterations(results_dir: str) -> List[Tuple[int, float]]:
    """Parse results_iteration_NN.txt files -> [(iteration, corloc%)]."""
    out = []
    for path in sorted(globlib.glob(os.path.join(results_dir, "results_iteration_*.txt"))):
        m = re.search(r"results_iteration_(\d+)\.txt", path)
        line = open(path).read().strip()
        corloc = float(line.split(",")[1])
        out.append((int(m.group(1)), corloc))
    return out


def read_mass_rank(results_dir: str, method: str, model: str):
    """Parse {method}_{model}_pruning_iteration_NN.txt -> [(it, mass, rank)]."""
    out = []
    pat = os.path.join(results_dir, f"{method}_{model}_pruning_iteration_*.txt")
    for path in sorted(globlib.glob(pat)):
        m = re.search(r"pruning_iteration_(\d+)\.txt", path)
        lines = open(path).read().splitlines()
        mass = float(lines[0].split(":")[1])
        rank = float(lines[1].split(":")[1])
        out.append((int(m.group(1)), mass, rank))
    return out


def plot_lost_curves(results_dir: str, performance_txt: Optional[str],
                     out_path: str, title: str = "LOST CorLoc vs sparsity"):
    """Dual-axis CorLoc + top-1 vs pruning iteration/sparsity
    (`lost_performance_plot.py:72-180`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_results_iterations(results_dir)
    if not rows:
        raise FileNotFoundError(f"no results_iteration_*.txt under {results_dir}")
    its = [r[0] for r in rows]
    corloc = [r[1] for r in rows]
    fig, ax1 = plt.subplots(figsize=(8, 5))
    if performance_txt and os.path.exists(performance_txt):
        perf = MetricsWriter.read_performance_txt(performance_txt)
        xs = [perf[i][1] if i < len(perf) else i for i in its]
        ax1.set_xlabel("sparsity (%)")
        ax2 = ax1.twinx()
        ax2.plot(xs, [perf[i][0] if i < len(perf) else np.nan for i in its],
                 "s--", color="tab:orange", label="top-1")
        ax2.set_ylabel("ImageNet top-1 (%)")
    else:
        xs = its
        ax1.set_xlabel("pruning iteration")
    ax1.plot(xs, corloc, "o-", color="tab:blue", label="CorLoc")
    ax1.set_ylabel("CorLoc (%)")
    ax1.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_mass_rank(results_dir: str, model: str, out_path: str,
                   methods=("gradCAM", "attention", "ig"),
                   performance_txt: Optional[str] = None):
    """RMA/RRA per method vs iteration/sparsity (`mass_rank_plots.py:78-147`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_m, ax_r) = plt.subplots(1, 2, figsize=(12, 5))
    perf = (MetricsWriter.read_performance_txt(performance_txt)
            if performance_txt and os.path.exists(performance_txt) else None)
    for method in methods:
        rows = read_mass_rank(results_dir, method, model)
        if not rows:
            continue
        xs = [perf[i][1] if perf and i < len(perf) else i for i, _, _ in rows]
        ax_m.plot(xs, [m for _, m, _ in rows], "o-", label=method)
        ax_r.plot(xs, [r for _, _, r in rows], "o-", label=method)
    xlabel = "sparsity (%)" if perf else "pruning iteration"
    for ax, name in ((ax_m, "Relevance Mass Accuracy"), (ax_r, "Relevance Rank Accuracy")):
        ax.set_xlabel(xlabel)
        ax.set_title(name)
        ax.legend()
    fig.suptitle(model)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def read_mvh_csv(path: str) -> Dict[str, float]:
    """One {model}_pruning_step_N.csv: benchmark rows -> accuracy (last
    column). Reads the toolbox row layout `model,benchmark,accuracy
    (top-k),...,value` (what `write_mvh_csv` emits); top-5 rows get an
    "@5" key suffix so they never shadow the top-1 value. The legacy
    benchmark-first layout is still accepted."""
    out = {}
    with open(path) as f:
        for i, line in enumerate(f.read().strip().splitlines()):
            parts = [p.strip() for p in line.replace(";", ",").split(",")]
            if len(parts) >= 3 and parts[1] in MVH_BENCHMARKS:
                name = parts[1] + ("@5" if "top-5" in parts[2] else "")
            elif parts[0] in MVH_BENCHMARKS:
                name = parts[0]
            elif _is_float(parts[0]):
                name = MVH_BENCHMARKS[i % len(MVH_BENCHMARKS)]
            else:  # header / legacy reserved row
                continue
            vals = [float(p) for p in parts if _is_float(p)]
            if vals:
                out[name] = vals[-1]
    return out


def _is_float(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def plot_mvh(results_dir: str, model: str, out_path: str,
             performance_txt: Optional[str] = None):
    """MvH accuracy per distortion benchmark vs pruning step
    (`mvh_performance_plot.py:44-189`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps = []
    for path in sorted(globlib.glob(os.path.join(results_dir, f"{model}_pruning_step_*.csv"))):
        m = re.search(r"pruning_step_(\d+)\.csv", path)
        steps.append((int(m.group(1)), read_mvh_csv(path)))
    if not steps:
        raise FileNotFoundError(f"no {model}_pruning_step_*.csv under {results_dir}")
    perf = (MetricsWriter.read_performance_txt(performance_txt)
            if performance_txt and os.path.exists(performance_txt) else None)
    fig, ax = plt.subplots(figsize=(10, 6))
    benchmarks = sorted({k for _, d in steps for k in d})
    for b in benchmarks:
        xs = [perf[s][1] if perf and s < len(perf) else s for s, _ in steps]
        ys = [d.get(b, np.nan) for _, d in steps]
        ax.plot(xs, ys, "o-", label=b, alpha=0.7)
    ax.set_xlabel("sparsity (%)" if perf else "pruning step")
    ax.set_ylabel("accuracy")
    ax.set_title(f"model-vs-human distortions — {model}")
    ax.legend(fontsize=7, ncol=2)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_mvh_comparison(results_dir: str, models, benchmarks, out_path: str,
                        max_prune: int = 26):
    """Model/benchmark comparison curves over pruning steps — the
    generalization of the reference's three fixed-combination scripts:
    `mvh_triple_comparison.py` (one model, silhouette+colour+false-colour),
    `mvh_performance_rn50_vs_rn18.py` (rotation, rn18 solid vs rn50
    dashed), `mvh_performance_plot_2.py`. One curve per (model, benchmark)
    pair from `{model}_pruning_step_{N}.csv`; missing steps warn and are
    skipped like the reference's FileNotFoundError handler."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    unknown = [b for b in benchmarks if b not in MVH_BENCHMARKS]
    if unknown:
        raise ValueError(
            f"unknown benchmark(s) {unknown}; valid names: {MVH_BENCHMARKS}"
        )
    # one read per (model, step); curves plotted at TRUE step numbers so
    # models with different missing-step patterns stay x-aligned (the
    # reference scripts skip-and-shift, but they never overlay models)
    per_model = {}
    for model in models:
        rows = {}
        for step in range(max_prune):
            path = os.path.join(results_dir,
                                f"{model}_pruning_step_{step}.csv")
            if not os.path.exists(path):
                print(f"Warning: Could not find {model} data for "
                      f"pruning step {step}")
                continue
            rows[step] = read_mvh_csv(path)
        per_model[model] = rows

    fig, ax = plt.subplots(figsize=(12, 7))
    linestyles = ["-", "--", "-.", ":"]
    plotted = 0
    for mi, model in enumerate(models):
        rows = per_model[model]
        for b in benchmarks:
            xs = sorted(rows)
            ys = [rows[s].get(b, np.nan) for s in xs]
            if ys and np.isfinite(ys).any():
                ax.plot(xs, ys, label=f"{model} on {b}", linewidth=3,
                        linestyle=linestyles[mi % len(linestyles)],
                        marker="s", markersize=4)
                plotted += 1
    if not plotted:
        raise FileNotFoundError(
            f"no {models} pruning_step CSVs with {benchmarks} data under "
            f"{results_dir}"
        )
    ax.set_ylim(0, 1)
    ax.set_xlabel("Pruning step")
    ax.set_ylabel("Accuracy")
    ax.grid(True, linestyle="-", alpha=0.1)
    ax.legend(loc="upper right", frameon=True, edgecolor="black")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out_path


def run_plot_cli(args) -> int:
    if args.kind == "lost":
        plot_lost_curves(args.results_dir, args.performance_txt, args.out)
    elif args.kind == "mass_rank":
        plot_mass_rank(args.results_dir, model=getattr(args, "model", "resnet50"),
                       out_path=args.out, performance_txt=args.performance_txt)
    elif args.kind == "mvh":
        plot_mvh(args.results_dir, model=getattr(args, "model", "resnet50"),
                 out_path=args.out, performance_txt=args.performance_txt)
    elif args.kind == "mvh-compare":
        plot_mvh_comparison(
            args.results_dir,
            models=getattr(args, "models", None) or [args.model],
            benchmarks=getattr(args, "benchmarks", None) or ["rotation"],
            out_path=args.out,
            max_prune=getattr(args, "max_prune", 26),
        )
    elif args.kind == "heatmaps":
        # 5x6 grids (+ optional GIFs) of heatmaps across pruning iterations
        # (`explainations_heatmaps_gif_and_plot.py:16-122` flow)
        from vipers_torch.viz.heatmap_report import (
            collect_iteration_images, heatmap_gif, heatmap_grid, list_classes,
        )

        method = getattr(args, "method", "gradcam")
        classes = (
            [args.cls] if getattr(args, "cls", "")
            else list_classes(args.results_dir, method)
        )
        base, ext = os.path.splitext(args.out)
        if ext.lower() in ("", ".gif"):  # grids go to matplotlib formats
            ext = ".png"
        n_written = 0
        for cls in classes:
            imgs = collect_iteration_images(args.results_dir, method, cls)
            if not imgs:
                continue
            heatmap_grid(imgs, f"{base}_{method}_{cls}{ext}")
            if getattr(args, "gif", False):
                heatmap_gif(imgs, f"{base}_{method}_{cls}.gif")
            n_written += 1
        print(f"heatmap reports for {n_written} classes")
        if n_written == 0:
            raise SystemExit(
                f"no heatmaps found under {args.results_dir} for "
                f"method={method!r}"
                + (f" cls={args.cls!r}" if getattr(args, "cls", "") else "")
            )
        return 0
    print(f"wrote {args.out}")
    return 0
