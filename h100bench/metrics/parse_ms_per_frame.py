"""parse_ms_per_frame (ms/frame): host time of the pipeline's entropy parse,
probe parse/window summed over its pool threads, per frame delivered in the
window."""
from h100bench.trace import probe_ms


def read(ctx):
    return probe_ms(ctx.window, ["parse/window"], ctx.window.counts.get("frames"))
