"""output_wait_ms_per_frame (ms/frame): host time the drain waited for the
work queued on the card ahead of each window's device-to-host copy (probe
output/wait) per frame delivered in the window; 0 where no window came back
to the host.  A program that copied back but has no such probe reads
nothing."""
from h100bench.trace import probe_ms


def read(ctx):
    probes = ctx.window.probes
    if "output/wait" not in probes and "output/transfer" in probes:
        return None
    return probe_ms(ctx.window, ["output/wait"], ctx.window.counts.get("frames"))
