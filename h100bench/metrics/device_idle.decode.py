"""device_idle.decode (%): the share of the traced requests' window in which
no kernel, copy or memset ran on the card, from the torch.profiler trace."""
from h100bench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
