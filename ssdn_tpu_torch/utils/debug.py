"""Tracing / profiling / numerics-debug helpers (port of
``ssdn_tpu/utils/debug.py``).

``torch.profiler`` takes the place of the XLA profiler, autograd's anomaly
mode that of ``jax_debug_nans``, and a walk over the tree with
``torch.isfinite`` that of chex's finiteness assertion.

``span(name)`` marks a part of the port's own work (the Trainer's loop and
step, the Prefetcher's workers, a request's pad, forward and copies; every
name starts with ``ssdn.``) while a ``torch.profiler`` session records, and
costs one global read and a call when none does. A span is a
``record_function`` in the profiler's timeline, with the operations and
device work under it, and a record in ``spans()``: a span on a thread that
Python started, such as a Prefetcher worker, is in ``spans()`` only, as the
profiler does not see it.

``conv_layouts()`` counts the convolutions of a block by the memory layout
of their operands: how often the trunk hands cuDNN NHWC-dense tensors.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode


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


class Span(NamedTuple):
    """One span of ``spans()``: its start and end on ``time.time_ns()``,
    the clock of the profiler's events (``end_ns`` is None while it is
    open), the OS id of its thread, and the index in ``spans()`` of the
    span it lies in on that thread (None for a root, whose index its
    children share: one per request, one per step)."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    thread: int
    parent: Optional[int]


_OFF = contextlib.nullcontext()
_lock = threading.Lock()
# each thread's stack of open spans, and its OS id, read once per thread:
# a system call per span took ~0.3 ms on a loaded H100 host
_local = threading.local()
_records: List[list] = []
_fresh = True  # the next span recorded starts a new list


class _Recorded:
    __slots__ = ("_name", "_rf", "_rec")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        global _records, _fresh
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        start = time.time_ns()
        with _lock:
            if _fresh:
                _records, _fresh = [], False
            records = _records
            # a span left open from an older list parents nothing here
            parent = (stack[-1][1] if stack and stack[-1][0] is records
                      else None)
            self._rec = [self._name, start, None, _local.thread, parent]
            stack.append((records, len(records)))
            records.append(self._rec)
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _local.stack.pop()
        self._rec[2] = time.time_ns()
        return False


def span(name: str):
    """``with span("ssdn.x"):`` records the block while a ``torch.profiler``
    session records (module docstring); otherwise it is one shared no-op
    context that records nothing. ``spans()`` holds the newest session's
    spans: the first span recorded after one that found no session starts
    a new list."""
    global _fresh
    if not _autograd_profiler._is_profiler_enabled:
        _fresh = True
        return _OFF
    return _Recorded(name)


def spans() -> List[Span]:
    """The recorded spans, in the order they started."""
    with _lock:
        return [Span(*r) for r in _records]


def totals() -> Dict[str, Tuple[int, float]]:
    """{name: (count, seconds)} of the closed spans of ``spans()``."""
    out: Dict[str, Tuple[int, float]] = {}
    for s in spans():
        if s.end_ns is not None:
            n, t = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, t + (s.end_ns - s.start_ns) / 1e9)
    return out


def reset() -> None:
    """Empty ``spans()``."""
    global _records
    with _lock:
        _records = []


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


_CONV_OPS = {  # op -> the positions of its activation / gradient operands
    torch.ops.aten.convolution.default: ("convolution", (0,)),
    torch.ops.aten.convolution_backward.default: ("convolution_backward",
                                                  (0, 1)),
}
LAYOUTS = ("channels_last", "nchw", "strided")


class _ConvCensus(TorchDispatchMode):
    def __init__(self, counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = _CONV_OPS.get(func)
        if op is not None:
            name, where = op
            ts = [args[i] for i in where]
            if all(t.is_contiguous(memory_format=torch.channels_last)
                   for t in ts):
                layout = "channels_last"
            elif all(t.is_contiguous() for t in ts):
                layout = "nchw"
            else:
                layout = "strided"
            self.counts[name][layout] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def conv_layouts() -> Iterator[Dict[str, Dict[str, int]]]:
    """Count the ``aten.convolution`` and ``aten.convolution_backward``
    calls made inside the block, forward and backward (a test and operator
    tool: it intercepts every op of the block, so no timed run uses it):

        with conv_layouts() as n:
            loss = step(); loss.backward()
        n["convolution_backward"]["channels_last"]

    A call counts as ``channels_last`` when every activation and gradient
    operand (the input; the output's gradient and the input) is NHWC-dense,
    as ``nchw`` when every one is NCHW-contiguous, else as ``strided``. A
    tensor dense in both layouts (one channel, or 1x1 images) counts as
    either. Weights are not read: PyTorch lays them out as the input."""
    counts = {name: dict.fromkeys(LAYOUTS, 0)
              for name, _ in _CONV_OPS.values()}
    with _ConvCensus(counts):
        yield counts
