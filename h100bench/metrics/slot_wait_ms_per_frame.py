"""slot_wait_ms_per_frame (ms/frame): host time the decoding thread spent
getting the pipeline's host staging buffers (probe pipeline/slot_wait: the
parse look-ahead's buffer for each window, and each drained window's
landing buffer; on the card a pinned block of torch's caching host
allocator, which pins a new one where none is free) per frame delivered in
the window; 0 where no window took one.  A program that parsed but has no
such probe reads nothing."""
from h100bench.trace import probe_ms


def read(ctx):
    probes = ctx.window.probes
    if "pipeline/slot_wait" not in probes and "parse/window" in probes:
        return None
    return probe_ms(ctx.window, ["pipeline/slot_wait"], ctx.window.counts.get("frames"))
