"""The traced window: ``torch.profiler`` kept in memory, reduced to device
intervals and host ranges.

The window is the host range ``portbench.window`` that every driver opens
around its timed loop.  ``busy_s`` is the union of the device's operations
(kernels, copies, memsets) inside it, ``window_s`` its length.  A per-layer
metric's reader gets a :class:`Reading`: the run, the driver's record of the
window, and this trace.
"""

from __future__ import annotations

import re

import numpy as np

WINDOW = "portbench.window"


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


class Trace:
    """Device operations ``(name, start_us, end_us)`` and host ranges of one
    window, on the profiler's clock."""

    def __init__(self, device_ops, host_ops, window):
        self.window = window  # (start_us, end_us)
        w0, w1 = window
        self.dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device_ops if b > w0 and a < w1]
        self.dev.sort(key=lambda x: x[1])
        self.host = host_ops  # (name, start_us, end_us), every CPU range

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def intervals(self):
        """The union of the device's operations: merged (start, end) pairs."""
        merged = []
        for _, a, b in self.dev:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def ops(self, pattern: str) -> list:
        """Device operations whose name matches the regular expression."""
        rx = re.compile(pattern)
        return [op for op in self.dev if rx.search(op[0])]

    def seconds(self, pattern: str) -> float:
        return sum(b - a for _, a, b in self.ops(pattern)) / 1e6

    def count(self, pattern: str) -> int:
        return len(self.ops(pattern))

    def gaps(self):
        """Idle stretches of the device inside the window: (start, end)."""
        out, t = [], self.window[0]
        for a, b in self.intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost ``portbench.``
        range and the innermost other CPU range that cover it."""
        mine, other = None, None
        for name, a, b in self.host:
            if a <= t <= b:
                if name.startswith("portbench.") and name != WINDOW:
                    if mine is None or b - a < mine[1]:
                        mine = (name[len("portbench."):], b - a)
                elif not name.startswith("portbench.") and (other is None or b - a < other[1]):
                    other = (name, b - a)
        return f"{mine[0] if mine else '-'}/{other[0] if other else 'python'}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle time by what the host was doing, from the longest gaps."""
        by_op: dict = {}
        for name, a, b in self.dev:
            by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:200]
        by_host: dict = {}
        self._index_host()
        for a, b in gaps:
            name = self.host_at((a + b) / 2)
            by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}

    def _index_host(self):
        """Keep only the host ranges that overlap a long gap (host_at scans)."""
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:200]
        if not gaps or not self.host:
            return
        starts = np.array([h[1] for h in self.host], dtype=np.float64)
        ends = np.array([h[2] for h in self.host], dtype=np.float64)
        keep = np.zeros(len(self.host), dtype=bool)
        for a, b in gaps:
            m = (a + b) / 2
            keep |= (starts <= m) & (ends >= m)
        self.host = [h for h, k in zip(self.host, keep) if k]


def read(prof) -> Trace:
    """Reduce a stopped profiler to a :class:`Trace` of its ``portbench.window``."""
    from torch.autograd import DeviceType

    device_ops, host_ops, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, a, b))
        else:
            host_ops.append((e.name, a, b))
            if e.name == WINDOW:
                window = (a, b)
    # a host range (``record_function``: ours, the optimizer's step) also
    # shows on the device's row under its own name; kernels, copies and
    # memsets never share a name with a host range
    ranges = {name for name, _, _ in host_ops}
    device_ops = [op for op in device_ops if op[0] not in ranges]
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    if not device_ops:
        raise RuntimeError("the profiler saw no device activity: device time not measured")
    return Trace(device_ops, host_ops, window)


class Reading:
    """What a per-layer metric's reader gets: ``run`` (cell, config, peaks),
    ``rec`` (the driver's record of the window: calls, shapes, counters) and
    ``trace`` (:class:`Trace`)."""

    def __init__(self, run, rec, trace: Trace):
        self.run, self.rec, self.trace = run, rec, trace
        self.peaks = run.peaks
