"""device_idle.parse_wait (%): the share of the traced requests' window in
which the card was idle while the decoding thread waited for the parse
look-ahead: the seconds of the idle gaps whose host activity ends in the
span pipeline/parse_wait, over the window, from the torch.profiler trace.
It reads the top-10 list of idle gaps that h100bench/trace.py's analyse
returns; 0 where none of them is such a wait.  A program that parsed but
has no such span reads nothing."""
SPAN = "pipeline/parse_wait"


def read(ctx):
    probes = ctx.window.probes
    if not ctx.trace.get("window_s") or (SPAN not in probes and "parse/window" in probes):
        return None
    idle = sum(s for name, s in ctx.trace["idle_gaps"] if name.split(" > ")[-1] == SPAN)
    return 100.0 * idle / ctx.trace["window_s"]
