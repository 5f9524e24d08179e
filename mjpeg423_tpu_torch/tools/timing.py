"""CUDA-event timers for the port's kernels (need an NVIDIA GPU).

time_card gives a call's time on the card alone, time_per_call the time
between two events around one call, in which the host's share of the call
(argument checks, allocation, the ctypes call; 0.04-0.08 ms for the
kernels' wrappers) counts wherever the card is done first.
"""
from __future__ import annotations

import statistics

import torch


def time_per_call(fn, reps: int = 20) -> float:
    """Median milliseconds between two CUDA events around one warm fn()."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_card(fn, launches: int = 20, replays: int = 5) -> float:
    """Median milliseconds of one fn() on the card alone: `launches` calls
    are captured into a CUDA graph (a wrapper allocates and launches on the
    current stream, which capture allows) and the replay is timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)
