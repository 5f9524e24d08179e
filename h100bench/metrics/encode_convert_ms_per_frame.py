"""encode_convert_ms_per_frame (ms/frame): host time of the colour convert
(probe encode/convert) per frame encoded in the window."""
from h100bench.trace import probe_ms


def read(ctx):
    return probe_ms(ctx.window, ["encode/convert"], ctx.window.counts.get("frames"))
