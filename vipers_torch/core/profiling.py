"""Device traces, the NaN sanitizer and the img/s meter (port of
``vipers/core/profiling.py``).

* ``device_trace(dir)``: a ``torch.profiler`` trace of the enclosed region
  (CPU activities, and CUDA's where a card is present), written into
  ``dir`` as a Chrome trace (``chrome://tracing``, Perfetto); ``train
  --profile-dir`` wraps the first training run in it.
* ``enable_nan_check(on)``: ``train --debug-nans``. Fails fast on the first
  NaN, as ``jax_debug_nans`` does: a global forward hook checks every
  module's outputs and raises ``FloatingPointError``, and autograd's
  anomaly mode with ``check_nan`` catches a NaN that a backward produces
  (``nan_errors`` turns its ``RuntimeError`` into ``FloatingPointError``).
  Off by default; off, no hook is registered and nothing is checked.
* ``StepTimer``: images per second per device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_NAN_HOOK = None


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Trace the enclosed region into ``trace_dir`` (a no-op when empty)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
    print(f"[vipers_torch.profiling] trace written to {path}")


def _has_nan(out):
    """Whether a module's output (a tensor, or tensors nested in tuples,
    lists and dicts) holds a NaN."""
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_has_nan(o) for o in out)
    if isinstance(out, dict):
        return any(_has_nan(o) for o in out.values())
    return False


def _check_outputs(module, _inputs, output):
    if _has_nan(output):
        raise FloatingPointError(f"NaN in the output of {type(module).__name__} "
                                 "(--debug-nans)")


def enable_nan_check(enable: bool = True):
    """Turn the NaN sanitizer on or off for every module and backward."""
    global _NAN_HOOK
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable and _NAN_HOOK is None:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(_check_outputs)
    elif not enable and _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None


@contextlib.contextmanager
def nan_errors():
    """Re-raise anomaly mode's NaN ``RuntimeError`` as ``FloatingPointError``."""
    try:
        yield
    except RuntimeError as e:
        if "nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise


class StepTimer:
    """Images per second per device (the reference's img/s convention):
    the devices are the visible cards, or the host's one without a card."""

    def __init__(self, n_chips: Optional[int] = None):
        self.n_chips = n_chips or torch.cuda.device_count() or 1
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def step(self, batch_size: int):
        self._images += batch_size

    @property
    def images_per_sec_per_chip(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._images / dt / self.n_chips
