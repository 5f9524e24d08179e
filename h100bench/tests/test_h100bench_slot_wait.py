"""The reader of the time the pipeline spends getting its host staging
buffers, on hand-made contexts: what it reads, 0 where no window waited
or the layer never ran, and nothing from a program that parsed without
the probe."""
from __future__ import annotations

import types

import pytest

from h100bench import run

FRAMES = 200


def _read(probes: dict, frames=FRAMES):
    window = types.SimpleNamespace(
        probes={n: {"total": t, "count": 1} for n, t in probes.items()},
        counts={"frames": frames})
    ctx = types.SimpleNamespace(window=window, trace={}, device_kind="cpu")
    return run.load_reader("slot_wait_ms_per_frame")(ctx)


def test_slot_waits_are_ms_per_frame():
    probes = {"pipeline/slot_wait": 0.5, "pipeline/parse_wait": 2.0, "parse/window": 9.0}
    assert _read(probes) == pytest.approx(1e3 * 0.5 / FRAMES)


@pytest.mark.parametrize("probes", [
    {"pipeline/slot_wait": 0.0, "parse/window": 9.0},
    {"encode/convert": 1.0},
], ids=["no_window_waited", "never_parsed"])
def test_no_wait_reads_0(probes):
    assert _read(probes) == 0


def test_a_program_without_the_probe_reads_nothing():
    """The probes of a pipeline from before the staging buffers."""
    older = {"parse/window": 9.0, "pipeline/parse_wait": 1.0, "device/put": 1.0,
             "output/transfer": 2.0, "output/raster": 1.0}
    assert _read(older) is None


def test_no_frames_read_nothing():
    assert _read({"pipeline/slot_wait": 0.5, "parse/window": 9.0}, frames=0) is None
