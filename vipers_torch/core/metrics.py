"""Console meters and the metrics stream (the port's own copy of
``vipers/core/metrics.py``): ``SmoothedScalar`` and ``MeterSet`` keep a
windowed and a global average per scalar and print progress lines with an
ETA; ``MetricsWriter`` appends one JSON record an event to
``metrics.jsonl`` and writes and reads ``performance.txt``."""

from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Dict, Optional


class SmoothedScalar:
    """Windowed + global average of a scalar series.

    The semantics of the reference's SmoothedValue: a deque window for
    display plus a running global sum/count.
    """

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        if not self.window:
            return math.nan
        s = sorted(self.window)
        return s[len(s) // 2]

    @property
    def avg(self) -> float:
        if not self.window:
            return math.nan
        return sum(self.window) / len(self.window)

    @property
    def global_avg(self) -> float:
        if self.count == 0:
            return math.nan
        return self.total / self.count

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else math.nan

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg, value=self.value
        )


class MeterSet:
    """A named collection of SmoothedScalars with periodic console logging."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedScalar] = collections.defaultdict(SmoothedScalar)
        self.delimiter = delimiter

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(v, n=n)

    def __getattr__(self, name):
        meters = object.__getattribute__(self, "meters")
        if name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None, pre_print=None):
        """Yield items, printing progress/ETA every ``print_freq`` steps.

        ``pre_print`` (optional callable) runs immediately before each
        print: the train loop uses it to flush its grouped device-metric
        fetches, so every printed value is the per-step value.
        """
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        start = time.time()
        iter_time = SmoothedScalar(fmt="{avg:.4f}")
        data_time = SmoothedScalar(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                if pre_print is not None:
                    pre_print()
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = f" eta: {eta:.0f}s"
                    pos = f"[{i}/{total}]"
                else:
                    eta_str = ""
                    pos = f"[{i}]"
                print(
                    f"{header} {pos}{eta_str}  {self}  "
                    f"time: {iter_time}  data: {data_time}"
                )
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {elapsed:.1f}s")


class MetricsWriter:
    """Append-only JSONL stream, one record an event: ``{"ts": float,
    "tag": str, "step": int | None, **scalars}``. ``export_performance_txt``
    writes the reference's ``performance.txt`` (a header line, then one
    ``acc1\tsparsity`` row per pruning iteration). The JAX package's wandb
    and echo options are not ported: no flag reaches them."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path is not None:  # None: a data-parallel rank other than 0 writes nothing
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, tag: str, step: Optional[int] = None, **scalars):
        rec = {"ts": time.time(), "tag": tag, "step": step}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    @staticmethod
    def export_performance_txt(path: str, rows):
        """``rows``: (acc1, sparsity) per pruning iteration."""
        with open(path, "w") as f:
            f.write("acc1\tsparsity\n")
            for acc1, sparsity in rows:
                f.write(f"{acc1}\t{sparsity}\n")

    @staticmethod
    def read_performance_txt(path: str):
        """The rows of a ``performance.txt``: the header skipped, tab- (or
        comma-) separated (acc1, sparsity)."""
        rows = []
        with open(path) as f:
            lines = f.read().strip().splitlines()
        for line in lines[1:]:
            parts = line.replace(",", "\t").split("\t")
            if len(parts) >= 2:
                rows.append((float(parts[0]), float(parts[1])))
        return rows
