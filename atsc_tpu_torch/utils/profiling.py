"""Throughput counters and a device trace: the twins of
atsc_tpu/utils/profiling.py's ThroughputMeter (host clock) and `profile`
(torch.profiler here, the JAX profiler there)."""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field

from atsc_tpu_torch import params as P


@dataclass
class ThroughputMeter:
    """Tracks fields/samples throughput, real-time margin, and step-cadence
    jitter (the gap between successive add_fields calls, one per encode
    step in the CLI's encode loop; a real-time deployment needs the max gap to
    stay under the sink's buffered slack)."""

    t0: float = field(default_factory=time.perf_counter)
    fields: int = 0
    channels: int = 1
    _last: float | None = None
    _gaps: list = field(default_factory=list)

    def add_fields(self, n: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._gaps.append(now - self._last)
        self._last = now
        self.fields += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def fields_per_sec(self) -> float:
        return self.fields / max(self.elapsed, 1e-9)

    @property
    def samples_per_sec(self) -> float:
        return self.fields_per_sec * P.SYMBOLS_PER_FIELD

    @property
    def realtime_factor(self) -> float:
        """>1 means faster than the 8VSB sample clock (per stream)."""
        return self.fields_per_sec / self.channels / P.FIELD_RATE

    def summary(self) -> dict:
        out = {
            "elapsed_s": round(self.elapsed, 3),
            "fields": self.fields,
            "fields_per_sec": round(self.fields_per_sec, 2),
            "samples_per_sec": round(self.samples_per_sec, 1),
            "realtime_factor_per_channel": round(self.realtime_factor, 2),
        }
        if self._gaps:
            g = sorted(self._gaps)
            out["steps"] = len(g) + 1
            out["step_ms_mean"] = round(sum(g) / len(g) * 1e3, 2)
            # nearest-rank p99 (ceil(0.99*n)-th order statistic); for
            # n < 100 this is simply the max
            p99 = g[min(len(g) - 1, math.ceil(0.99 * len(g)) - 1)]
            out["step_ms_p99"] = round(p99 * 1e3, 2)
            out["step_ms_max"] = round(g[-1] * 1e3, 2)
        return out


@contextlib.contextmanager
def profile(logdir: str):
    """Trace the block with torch.profiler (CPU activity, and CUDA kernels
    where a card is present) and write a Chrome trace,
    `<host>_<pid>.<timestamp>.pt.trace.json`, into `logdir` (made if missing;
    view it in chrome://tracing, Perfetto or TensorBoard). Yields logdir."""
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
