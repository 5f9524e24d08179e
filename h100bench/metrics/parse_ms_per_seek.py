"""parse_ms_per_seek (ms): all host time of the player's parse pool (probe
parse/window, summed over its threads) over the window, per seek.  It takes
in the windows parsed ahead and thrown away, which run on into the next
seeks, so it is no part of one seek's latency to set beside seek_p50_ms."""
from h100bench.trace import probe_ms


def read(ctx):
    return probe_ms(ctx.window, ["parse/window"], ctx.window.counts.get("seeks"))
