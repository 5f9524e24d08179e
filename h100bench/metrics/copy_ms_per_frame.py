"""copy_ms_per_frame (ms/frame): device time of the host-to-device and
device-to-host copies in the traced requests, from the torch.profiler
trace, per frame they delivered."""


def read(ctx):
    frames = ctx.window.traced.get("frames")
    if not ctx.trace or not frames:
        return None
    m = ctx.trace["memcpy_s"]
    return 1e3 * (m.get("HtoD", 0.0) + m.get("DtoH", 0.0)) / frames
