"""The readers of the pipeline's spans and copy counters, on hand-made
contexts: what each reads, 0 where its layer never ran, and nothing from
a program that ran the layer without the span or counter."""
from __future__ import annotations

import types

import pytest

from h100bench import run

FRAMES = 200


def _ctx(probes: dict, idle_gaps=(), window_s=2.0, frames=FRAMES):
    window = types.SimpleNamespace(
        probes={n: {"total": t, "count": 1} for n, t in probes.items()},
        counts={"frames": frames})
    trace = {"window_s": window_s, "idle_gaps": [list(g) for g in idle_gaps]}
    return types.SimpleNamespace(window=window, trace=trace, device_kind="cpu")


def _read(name, ctx):
    return run.load_reader(name)(ctx)


@pytest.mark.parametrize("name, probe", [
    ("parse_wait_ms_per_frame", "pipeline/parse_wait"),
    ("output_wait_ms_per_frame", "output/wait"),
])
def test_wait_readers_are_ms_per_frame(name, probe):
    ctx = _ctx({probe: 0.5, "parse/window": 9.0, "output/transfer": 1.0})
    assert _read(name, ctx) == pytest.approx(1e3 * 0.5 / FRAMES)


def test_device_idle_parse_wait_sums_only_the_parse_waits():
    gaps = [("next_window > pipeline/parse_wait", 0.25),
            ("next_window > output/raster", 0.5),
            ("pipeline/parse_wait > aten::empty", 0.125),
            ("consume > pipeline/parse_wait", 0.25),
            ("next_window", 0.75)]
    ctx = _ctx({"pipeline/parse_wait": 1.0, "parse/window": 9.0}, gaps)
    assert _read("device_idle.parse_wait", ctx) == pytest.approx(100.0 * 0.5 / 2.0)


def test_copy_pad_share_ignores_the_pinned_pageable_split():
    split = _ctx({"copy/h2d_bytes.pageable": 600.0, "copy/h2d_bytes.pinned": 200.0,
                  "copy/d2h_bytes.pinned": 200.0, "copy/h2d_pad_bytes": 80.0,
                  "copy/d2h_pad_bytes": 20.0, "device/put": 1.0})
    whole = _ctx({"copy/h2d_bytes.pageable": 800.0, "copy/d2h_bytes.pageable": 200.0,
                  "copy/h2d_pad_bytes": 80.0, "copy/d2h_pad_bytes": 20.0,
                  "device/put": 1.0})
    assert _read("copy_pad_share", split) == pytest.approx(10.0)
    assert _read("copy_pad_share", whole) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["parse_wait_ms_per_frame", "output_wait_ms_per_frame",
                                  "copy_pad_share", "device_idle.parse_wait"])
def test_a_layer_that_never_ran_reads_0(name):
    ctx = _ctx({"encode/convert": 1.0}, [("next_window", 0.5)])
    assert _read(name, ctx) == 0


@pytest.mark.parametrize("name", ["parse_wait_ms_per_frame", "output_wait_ms_per_frame",
                                  "copy_pad_share", "device_idle.parse_wait"])
def test_a_program_without_the_span_reads_nothing(name):
    """The probes of a pipeline that has neither the wait spans nor the
    copy counters, as before they were added."""
    older = {"parse/window": 9.0, "device/put": 1.0, "device/dispatch": 0.1,
             "output/transfer": 2.0, "output/raster": 1.0}
    assert _read(name, _ctx(older, [("next_window", 0.5)])) is None
