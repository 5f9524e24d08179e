"""encode_pack_ms_per_frame (ms/frame): host time of select-then-pack, the
native size scan and pack (probes encode/sizes + encode/pack), per frame
encoded in the window."""
from h100bench.trace import probe_ms


def read(ctx):
    return probe_ms(ctx.window, ["encode/sizes", "encode/pack"],
                    ctx.window.counts.get("frames"))
