"""Spans around the calls into the program, and the reading of a
torch.profiler trace into device time per span, kernel times, the device's
busy time and its idle gaps.

A device operation belongs to the span in which the host launched it: its
launch is found by the trace's correlation id among the CUDA runtime and
driver calls (a run prints how many operations were placed so; an
operation whose launch the trace lacks belongs to no span). Spans add no
synchronization, so a traced run overlaps launches as an untraced one
does. Untraced runs take no spans.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench."


class Spans:
    """`span(name)` is a no-op when tracing is off; when on, it is a
    record_function range whose host duration is kept by name."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.host_s: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        self.host_s[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose `.view` is the TraceView once the block ends
    (None when tracing is off). The chrome trace is written under TMPDIR and
    removed once read."""
    holder = type("Holder", (), {"view": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            holder.view = TraceView(json.load(fh)["traceEvents"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del prof


def _union(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length covered by the intervals inside [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


class TraceView:
    """Device operations and benchmark spans of one traced window, times in
    seconds on the trace's clock."""

    def __init__(self, events: list[dict]):
        self.ops: list[tuple[str, str, float, float]] = []   # (cat, name, start, end)
        self.spans: list[tuple[str, float, float]] = []      # (name, start, end)
        launches: dict[int, float] = {}                       # correlation -> host time
        corr: list[int | None] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, name = ev.get("cat", ""), ev.get("name", "")
            start = float(ev["ts"]) * 1e-6
            end = start + float(ev.get("dur", 0.0)) * 1e-6
            if cat in DEVICE_CATS:
                self.ops.append((cat, name, start, end))
                corr.append((ev.get("args") or {}).get("correlation"))
            elif cat in LAUNCH_CATS and "correlation" in (ev.get("args") or {}):
                launches[ev["args"]["correlation"]] = start
            elif cat == "user_annotation" and name.startswith(PREFIX):
                self.spans.append((name[len(PREFIX):], start, end))
        #: host time at which each op was launched (None where the trace
        #: holds no launch for it)
        self.launched_at = [launches.get(c) for c in corr]
        self.by_correlation = sum(t is not None for t in self.launched_at)
        self.spans.sort(key=lambda s: s[1])
        fields = [s for s in self.spans if s[0] == "field"]
        self.window = ((fields[0][1], fields[-1][2]) if fields else
                       (min(o[2] for o in self.ops), max(o[3] for o in self.ops))
                       if self.ops else (0.0, 0.0))
        self.fields = len(fields)
        self._leaves = [s for s in self.spans if s[0] != "field"]
        self._starts = [s[1] for s in self._leaves]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def span_at(self, t: float | None) -> str | None:
        """The leaf span whose host interval holds time t."""
        import bisect

        if t is None:
            return None
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._leaves[i][1] <= t <= self._leaves[i][2]:
            return self._leaves[i][0]
        return None

    def in_window(self, cats=("kernel",)):
        return [o for o, _ in self._in_window(cats)]

    def _in_window(self, cats):
        lo, hi = self.window
        return [(o, t) for o, t in zip(self.ops, self.launched_at)
                if o[0] in cats and o[3] > lo and o[2] < hi]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        lo, hi = self.window
        return _union([(o[2], o[3]) for o in self.in_window(cats)], lo, hi)

    def device_s(self, span: str, cats=("kernel",)) -> float:
        """Seconds of device operations launched inside spans named `span`."""
        return sum(o[3] - o[2] for o, t in self._in_window(cats) if self.span_at(t) == span)

    def kernel_times(self, pattern: str) -> list[float]:
        """Durations of the window's kernels whose name matches `pattern`."""
        rx = re.compile(pattern)
        return [o[3] - o[2] for o in self.in_window() if rx.search(o[1])]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the device (no operation of any kind) by the span the host was in."""
        by_op: dict[str, float] = defaultdict(float)
        ops = self.in_window(DEVICE_CATS)
        for _, name, a, b in ops:
            by_op[_short(name)] += b - a
        lo, hi = self.window
        gaps: dict[str, float] = defaultdict(float)
        end = lo
        for a, b in sorted((o[2], o[3]) for o in ops) + [(hi, hi)]:
            a = min(a, hi)
            if a > end:
                gaps[self.span_at((a + end) / 2) or "between spans"] += a - end
            end = max(end, min(b, hi))
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    head = name.split("(", 1)[0] if not name.startswith("void ") else name[5:].split("(", 1)[0]
    return head.strip()[:120] or name[:120]
