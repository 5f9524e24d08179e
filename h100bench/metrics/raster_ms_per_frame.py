"""raster_ms_per_frame (ms/frame): host time of the drain's blocked-to-raster
copy (probe output/raster) per frame delivered in the window; 0 where the
frames stay on the card."""
from h100bench.trace import probe_ms


def read(ctx):
    return probe_ms(ctx.window, ["output/raster"], ctx.window.counts.get("frames"))
