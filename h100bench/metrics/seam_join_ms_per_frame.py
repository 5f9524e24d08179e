"""seam_join_ms_per_frame (ms/frame): host time of decode_streams' join of a
seam window's per-archive parse runs into the window's staging buffer
(probe parse/seam_join, on the parse worker) per thumbnail delivered in the
window; 0 where no window crossed a seam.  A program that batched archives
but has no such probe (no streams/windows counter) reads nothing."""
from h100bench.trace import probe_ms


def read(ctx):
    probes = ctx.window.probes
    if "parse/seam_join" not in probes and "streams/windows" not in probes:
        return None
    return probe_ms(ctx.window, ["parse/seam_join"], ctx.window.counts.get("frames"))
