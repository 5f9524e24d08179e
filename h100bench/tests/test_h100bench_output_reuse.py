"""The reader of the share of drained windows that landed in a recycled
host array, on hand-made contexts: what it reads, 0 where no window was
drained to the host, and nothing from a program that drained windows
without the counters."""
from __future__ import annotations

import types

import pytest

from h100bench import run


def _read(probes: dict):
    window = types.SimpleNamespace(
        probes={n: {"total": t, "count": 1} for n, t in probes.items()},
        counts={"frames": 200})
    ctx = types.SimpleNamespace(window=window, trace={}, device_kind="cpu")
    return run.load_reader("output_reuse_share")(ctx)


def test_output_reuse_share_counts_windows_not_bytes():
    """One count a drained window, whatever its size: 3 recycled of 4."""
    probes = {"output/reused": 3.0, "output/fresh": 1.0, "output/raster": 2.0,
              "output/wait": 0.1}
    assert _read(probes) == pytest.approx(75.0)


def test_only_fresh_arrays_read_0():
    assert _read({"output/fresh": 5.0, "output/raster": 2.0}) == 0


def test_no_host_drain_reads_0():
    """Frames kept on the card, or a run that only encodes."""
    assert _read({"encode/convert": 1.0, "parse/window": 9.0, "device/put": 1.0}) == 0


def test_a_program_without_the_counters_reads_nothing():
    """The probes of a pipeline from before the drain recycled its arrays."""
    older = {"parse/window": 9.0, "device/put": 1.0, "device/dispatch": 0.1,
             "output/transfer": 2.0, "output/raster": 1.0}
    assert _read(older) is None
