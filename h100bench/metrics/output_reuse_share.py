"""output_reuse_share (%): the share of the windows drained to the host
that the drain rastered into a recycled host array rather than a fresh one:
the program's counters output/reused over output/reused plus output/fresh
(one a window each) in the window; 0 where no window was drained to the
host.  A program that drained windows but has neither counter reads
nothing."""

COUNTERS = ("output/reused", "output/fresh")


def read(ctx):
    probes = ctx.window.probes
    reused, fresh = (probes.get(n, {}).get("total", 0.0) for n in COUNTERS)
    if not reused + fresh:
        return None if "output/raster" in probes else 0.0
    return 100.0 * reused / (reused + fresh)
