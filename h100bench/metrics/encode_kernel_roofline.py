"""encode_kernel_roofline (%): the least time of the traced requests' encode
work at the card's memory bandwidth (3 bytes a source pixel in, the
container bytes out; h100bench/roofline.py) over the device time of all
their kernels, copies excluded."""
from h100bench import roofline


def read(ctx):
    t = ctx.window.traced
    if not ctx.trace:
        return None
    return roofline.share_pct(roofline.encode_bytes(t["source_pixels"], t["container_bytes"]),
                              ctx.trace["kernel_s"], roofline.peak_bytes_per_s(ctx.device_kind))
