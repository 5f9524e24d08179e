"""parse_wait_ms_per_frame (ms/frame): host time the pipeline's device loop
waited for its parse look-ahead (probe pipeline/parse_wait, on the decoding
thread) per frame delivered in the window; 0 where no window waited.  A
program that parsed but has no such probe reads nothing."""
from h100bench.trace import probe_ms


def read(ctx):
    probes = ctx.window.probes
    if "pipeline/parse_wait" not in probes and "parse/window" in probes:
        return None
    return probe_ms(ctx.window, ["pipeline/parse_wait"], ctx.window.counts.get("frames"))
