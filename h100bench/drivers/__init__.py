"""Drivers: one module a kind of traffic, named by a mix's `driver` key.

A driver module has a class `Cell(config, traffic, seed, device, log)`:
`make_inputs()` makes the inputs from the seed, `start()` builds the
program's objects and warms the cell's shapes, `window(seconds, tracer)`
runs the measured loop and returns a `Window`, `release()` frees the
program's state and `check(control)` judges what the window produced
against the reference (`h100bench/mjpeg.py`), or, with control, the
reference's float32 variant put in the program's place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    end_to_end: dict                     # metric name -> value
    attempted: int
    failed: int
    counts: dict                         # the whole window's work
    traced: dict                         # the traced requests' work
    probes: dict                         # Profiler.report() of the window


def check(name: str, value, limit, op: str = "<=") -> tuple[str, dict]:
    return name, {"value": value, "limit": limit, "op": op}


def halves(ends: list[tuple[float, int]]) -> list[float]:
    """Frames/s over each half of a window, from (seconds, frames so far)
    at each request's end: a rate that drifts within a run shows here."""
    if len(ends) < 2:
        return []
    mid = min(ends, key=lambda e: abs(e[0] - ends[-1][0] / 2))
    t1, f1 = ends[-1]
    return [mid[1] / mid[0], (f1 - mid[1]) / (t1 - mid[0])]


def raster(frames, bh: int, bw: int) -> torch.Tensor:
    """A program's frames as (N, H, W) int64 BGRA: host uint32 rasters, or
    device uint32 windows in the kernels' blocked layout (N, 8 columns,
    bh/k, 8 rows, k*bw) or raster (N, H, W)."""
    if isinstance(frames, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(frames).view(np.int32))
    else:
        t = frames.view(torch.int32)
    t = t.to(torch.int64) & 0xFFFFFFFF
    if t.dim() == 3:
        return t
    n, _, g, _, _ = t.shape
    k = bh // g
    x = t.reshape(n, 8, g, 8, k, bw).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, bh * 8, bw * 8)
