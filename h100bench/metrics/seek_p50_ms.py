"""seek_p50_ms (ms): the median of the window's seeks, each from the seek call
to its first frame at the sink on the host."""


def read(ctx):
    return ctx.window.counts.get("seek_ms_p50")
