"""Copied from mjpeg423_tpu/utils/profile.py at commit bfc8537.

Stage timing/size metrics (the reference's profiling formalized).

The reference accumulates (sum, count, max, min) per probe behind compile
flags (reference: core0/software/profile.h:44-88, profile.c:17-35) and wires
only whole-video wall time (main.c:113-123).  Here every pipeline stage gets
a probe by default, cheap enough to leave on; torch.profiler traces are
opt-in via Profiler.trace_dir.

Two changes from the original.  start_trace/stop_trace drive
torch.profiler (CPU and, with a card, CUDA activities) and write
<trace_dir>/trace.json in Chrome's trace format, where the original drives
jax.profiler.  And time(name) is also a torch.profiler.record_function span
while a torch profiler records on the calling thread, so that each timed
stage lies in the same trace as the kernels and copies, on their clock;
with none recording it costs one check of torch's profiler state.  Probes,
counters and reports are as copied.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch


@dataclasses.dataclass
class Probe:
    """Aggregate of one timed/sized quantity (profile.h:44-60 analog).

    Thread-safe: probes are shared across the pipeline's parse workers and
    StreamPool's per-stream threads, so updates take a per-probe lock.
    """

    name: str
    total: float = 0.0
    count: int = 0
    max: float = 0.0
    min: float = float("inf")
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def add(self, value: float) -> None:
        with self._lock:
            self.total += value
            self.count += 1
            if value > self.max:
                self.max = value
            if value < self.min:
                self.min = value

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {
            "name": self.name,
            "total": self.total,
            "count": self.count,
            "mean": self.mean,
            "max": self.max,
            "min": self.min if self.count else 0.0,
        }


class Profiler:
    """Thread-safe probe registry with timing contexts and size counters."""

    def __init__(self, trace_dir: str | None = None):
        self._probes: dict[str, Probe] = {}
        self._lock = threading.Lock()
        self.trace_dir = trace_dir
        self._trace = None

    def probe(self, name: str) -> Probe:
        with self._lock:
            if name not in self._probes:
                self._probes[name] = Probe(name)
            return self._probes[name]

    @contextlib.contextmanager
    def time(self, name: str):
        span = (torch.profiler.record_function(name)
                if torch.autograd._profiler_enabled()
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with span:
                yield
        finally:
            self.probe(name).add(time.perf_counter() - t0)

    def add_size(self, name: str, nbytes: int) -> None:
        self.probe(name).add(float(nbytes))

    def start_trace(self) -> None:
        # _lock guards the check-then-act: two pool threads sharing one
        # Profiler must not both start a trace, and a stop must find the
        # trace its start made.
        with self._lock:
            if not self.trace_dir or self._trace is not None:
                return
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=acts)
            self._trace.start()

    def stop_trace(self) -> None:
        with self._lock:
            trace, self._trace = self._trace, None
        if trace is None:
            return
        trace.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        trace.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))

    def report(self) -> dict[str, dict]:
        with self._lock:
            return {n: p.summary() for n, p in self._probes.items()}

    def format_report(self) -> str:
        lines = []
        for name, s in sorted(self.report().items()):
            lines.append(
                f"{name:32s} n={s['count']:<6d} total={s['total']:.4f} "
                f"mean={s['mean']:.5f} max={s['max']:.5f} min={s['min']:.5f}"
            )
        return "\n".join(lines)


# Module-level default profiler (the reference's static arrays analog).
default_profiler = Profiler()
