"""downscale_ms_per_frame (ms/frame): device time of the traced requests'
kernels other than the decode window kernel (the device_ops entries whose
name holds decode_window_kernel), per thumbnail they delivered, from the
torch.profiler trace: the box downscale on the card, and with it the zero
fill of the last window's pad rows.  Nothing where the trace holds no
kernel time."""
K1 = "decode_window_kernel"


def read(ctx):
    frames = ctx.window.traced.get("frames")
    if not ctx.trace or not ctx.trace.get("kernel_s") or not frames:
        return None
    k1 = sum(s for name, s in ctx.trace["device_ops"] if K1 in name)
    return 1e3 * (ctx.trace["kernel_s"] - k1) / frames
