"""decode_kernel_roofline (%): the least time of the traced requests' decode
work at the card's memory bandwidth (container bytes of the frames decoded
in, 4 bytes a delivered pixel out; h100bench/roofline.py) over the device
time of all their kernels, copies excluded."""
from h100bench import roofline


def read(ctx):
    t = ctx.window.traced
    if not ctx.trace:
        return None
    return roofline.share_pct(roofline.decode_bytes(t["payload_bytes"], t["pixels"]),
                              ctx.trace["kernel_s"], roofline.peak_bytes_per_s(ctx.device_kind))
