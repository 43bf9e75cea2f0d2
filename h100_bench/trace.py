"""The traced window: one ``torch.profiler`` window around the measured
work, reduced to what the per-layer metrics and the result line read.

- ``busy_s``: the union of the intervals of every device event (kernels,
  copies, memsets, on every stream), in seconds;
- ``window_s``: the host clock from the window's start to its end, which
  ends after a device synchronise, so every device event lies inside it;
- ``kernel_s``: device seconds summed per kernel name;
- ``idle_gaps``: the device's idle time, each gap named by the innermost
  host operation that the window's own thread was in at the gap's middle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

WINDOW_SPAN = "h100_bench.window"
TOP = 10


def _on_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


class Window:
    """``with Window(on, device): ...`` profiles the block when ``on``;
    ``summary()`` then gives the reduction above (None when off)."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = torch.device(device)
        self.prof = None
        self.window_s = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        if self.on:
            self._span.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[Dict]:
        if not self.on:
            return None
        events = self.prof.profiler.kineto_results.events()
        dev, host, main = [], {}, None
        for e in events:
            a = e.start_ns()
            span = (a, a + e.duration_ns(), e.name())
            if _on_device(e):
                dev.append(span)
            else:
                tid = e.start_thread_id()
                host.setdefault(tid, []).append(span)
                if main is None and e.name() == WINDOW_SPAN:
                    main = tid
        # the device's copies of host annotations (record_function) are
        # spans, not work: drop every device event named like a host one
        names = {h[2] for spans in host.values() for h in spans}
        dev = [d for d in dev if d[2] not in names]
        return reduce_trace(dev, host.get(main, []), self.window_s)


def reduce_trace(dev: List[tuple], main_host: List[tuple],
                 window_s: float) -> Dict:
    """dev: (start_ns, end_ns, name) device events; main_host: the window
    thread's host events, nested as a call stack."""
    kernel_s: Dict[str, float] = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e9
    busy, gaps, end = 0, [], None
    for a, b, _ in sorted(dev):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    # one sweep: the stack of host events open at each gap's middle (the
    # thread's events nest, so its top is the innermost)
    main_host = sorted(main_host, key=lambda h: (h[0], -h[1]))
    by_label: Dict[str, float] = {}
    stack, i = [], 0
    for a, b in gaps:  # in time order
        mid = (a + b) // 2
        while i < len(main_host) and main_host[i][0] <= mid:
            while stack and stack[-1][1] < main_host[i][0]:
                stack.pop()
            stack.append(main_host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "host: none"
        if label == WINDOW_SPAN:
            label = "host: between operations"
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
    top = lambda d: sorted(([k[:120], v] for k, v in d.items()),
                           key=lambda t: -t[1])[:TOP]
    return {"busy_s": busy / 1e9, "window_s": window_s,
            "kernel_s": kernel_s, "device_ops": top(kernel_s),
            "idle_gaps": top(by_label)}


def device_seconds(summary: Dict, *needles: str) -> float:
    """Device seconds of the kernels whose names hold any of ``needles``."""
    return sum(s for name, s in summary["kernel_s"].items()
               if any(n in name for n in needles))
