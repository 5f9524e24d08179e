"""Requests, spans and the device trace of one run.

`Tracer` wraps every request a driver makes.  With `--trace 1` it drives a
torch.profiler whose CUPTI start-up is paid before the window opens and
which records only requests [skip, skip + n) of the window, a short steady
part.  `analyse` reduces the exported Chrome trace to what the per-layer
readers and the result's `device` and `breakdown` need.
"""
from __future__ import annotations

import bisect
import contextlib
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "python_function")
SPAN = "h100bench/"
REQUEST = "request:"


class Tracer:
    """Counts a run's requests; with a profiler, traces requests
    [skip, skip + n) and names every request and span in the trace."""

    def __init__(self, profiler=None, skip: int = 0, n: int = 0):
        self.prof = profiler
        self.skip, self.n = skip, n
        self.count = 0

    @property
    def tracing(self) -> bool:
        return self.prof is not None and self.skip <= self.count < self.skip + self.n

    @contextlib.contextmanager
    def request(self, name: str):
        """One request; yields whether it is traced."""
        traced = self.tracing
        with self.span(REQUEST + name):
            yield traced
        self.count += 1
        if self.prof is not None:
            self.prof.step()

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN + name)


def start_profiler(skip: int, n: int):
    """A CPU + CUDA profiler that warms up (CUPTI starts now, outside the
    window) for `skip` requests and records the next `n`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   schedule=schedule(wait=0, warmup=max(skip, 1), active=n, repeat=1))
    prof.start()
    return prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events: list[dict]) -> dict:
    """Reduce Chrome-trace events (times in us) to seconds:

    window_s  first traced request's start to the last one's end
    busy_s    union of device kernels, copies and memsets in the window
    kernel_s  sum of device kernel durations in the window
    memcpy_s  {"HtoD", "DtoH", "DtoD", ...}: sum of copy durations by kind
    device_ops  [[name, s]] the device operations that took most time
    idle_gaps   [[host activity, s]] device idle time by what the host did
    """
    reqs = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(SPAN + REQUEST)]
    if not reqs:
        return {}
    lo = min(e["ts"] for e in reqs)
    hi = max(e["ts"] + e["dur"] for e in reqs)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    clipped = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev]
    busy = _merge(clipped)
    busy_us = sum(e - s for s, e in busy)
    kernel_us = sum(e["dur"] for e in dev if e["cat"] == "kernel")
    memcpy: dict[str, float] = {}
    ops: dict[str, float] = {}
    for e in dev:
        if e["cat"] == "gpu_memcpy":
            kind = _copy_kind(e["name"])
            memcpy[kind] = memcpy.get(kind, 0.0) + e["dur"] * 1e-6
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] * 1e-6
    main_tid = reqs[0].get("tid")
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == main_tid and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    holes = []
    edge = lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            holes.append((edge, s))
        edge = max(edge, e)
    gaps: dict[str, float] = {}
    for (s, e), name in zip(holes, _host_at(host, [(s + e) / 2 for s, e in holes])):
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
        "kernel_s": kernel_us * 1e-6, "memcpy_s": memcpy,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in idle],
    }


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP"):
        if kind in name:
            return kind
    return "other"


def _host_at(host: list[dict], times: list[float]) -> list[str]:
    """For each time (us, ascending), the innermost benchmark span and the
    innermost other host event on the main thread then."""
    span = [None] * len(times)
    other = [None] * len(times)
    for e in host:
        mine = e["name"].startswith(SPAN)
        if not mine and e["name"].startswith("ProfilerStep"):
            continue
        best = span if mine else other
        lo = bisect.bisect_left(times, e["ts"])
        hi = bisect.bisect_left(times, e["ts"] + e["dur"])
        for i in range(lo, hi):
            if best[i] is None or e["dur"] < best[i]["dur"]:
                best[i] = e
    names = []
    for s, o in zip(span, other):
        parts = ([s["name"][len(SPAN):]] if s else []) + ([o["name"]] if o else [])
        names.append(" > ".join(parts) or "untraced host work")
    return names


def load(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def probe_ms(window, names: list[str], per) -> float | None:
    """Host milliseconds of the window's probes `names` per unit of work;
    0 where the layer never ran, None where there was no work."""
    if not per:
        return None
    return 1e3 * sum(window.probes.get(n, {}).get("total", 0.0) for n in names) / per


def idle_pct(analysis: dict) -> float | None:
    """The share of the traced window with no kernel, copy or memset on the
    device, in %."""
    if not analysis.get("window_s"):
        return None
    return 100.0 * (1.0 - analysis["busy_s"] / analysis["window_s"])
