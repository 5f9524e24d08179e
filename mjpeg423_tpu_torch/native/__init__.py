"""Copied from mjpeg423_tpu/native/__init__.py at commit bfc8537.

Native (C) host-side runtime components.

centropy: the entropy codec, the serial hot path of host-side decode,
mirroring the reference's decision to run entropy decode on the CPUs while
hardware did the transforms (reference: playback.c:59-64, core1/main.c:257).
The library builds into this package's own native/_build/.
"""
from .centropy import (  # noqa: F401
    decode_plane,
    decode_batch,
    encode_plane,
    native_available,
)
