"""Tracing / profiling / numerics-debug helpers (port of
``ssdn_tpu/utils/debug.py``).

``torch.profiler`` takes the place of the XLA profiler, autograd's anomaly
mode that of ``jax_debug_nans``, and a walk over the tree with
``torch.isfinite`` that of chex's finiteness assertion.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    and copies when there is a GPU) into ``logdir/trace.json`` (Chrome
    trace format; open it in Perfetto or chrome://tracing):
    with profile_trace(d): run_steps()."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode: a backward function that returns a NaN
    raises, naming the forward op that made it (CI use). Unlike JAX's
    ``jax_debug_nans`` it checks the backward only: a NaN made in a
    forward or outside autograd passes. The previous mode is restored on
    exit."""
    old = torch.is_anomaly_enabled()
    old_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old, check_nan=old_nan)


class StepTimer:
    """Lightweight wall-clock step timer with EMA, for throughput logging."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._t is not None:
            dt = now - self._t
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema
            )
        self._t = now
        return self.ema


def assert_finite_tree(tree, path: str = "") -> None:
    """Raise AssertionError naming the first leaf of a nested dict / list /
    tuple of tensors (or arrays, or numbers) that holds a NaN or an inf
    (test/CI helper)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            assert_finite_tree(v, f"{path}/{k}" if path else str(k))
    elif not bool(torch.isfinite(torch.as_tensor(tree)).all()):
        raise AssertionError(f"non-finite values at {path or '(root)'}")
