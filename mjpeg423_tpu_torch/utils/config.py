"""Copied from mjpeg423_tpu/utils/config.py at commit bfc8537.

Typed runtime configuration (the reference's config.h made first-class).

Every compile-time #define knob from the reference (reference:
core0/software/common/config.h:23-62) appears here as a dataclass field,
plus the device knobs (tile size, kernel path).

The fields, their names and their defaults are the original's, so a config
object of either package drives either pipeline (the parity tests rely on
it).  The comments are the port's: the original's give measurements of the
JAX package on its accelerator, which say nothing about this one.  In the
port ``use_pallas`` means "the hand-written CUDA kernel": True exactly on a
CUDA device, False exactly on the CPU, None to follow the device.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DecodeConfig:
    """Decode/playback configuration.

    Reference knob mapping:
      fps / frame_period_us     <- FRAME_RATE_US 41666 (config.h:29)
      num_output_buffers        <- DISPLAY_NUM_OUTPUT_BUFFERS 4 (config.h:27)
      force_periodic            <- FORCE_PERIODIC (config.h:31)
      max_i_interval            <- MAX_IFRAME_OFFSET 24 (config.h:54)
      use_pallas                <- IDCT_HW_ACCEL / YCBCR_TO_RGB_HW_ACCEL
                                   (config.h:47-52: HW accel on/off becomes
                                   the hand-written kernel vs the plain
                                   PyTorch version)
    """

    # Playback pacing
    fps: float = 24.0
    force_periodic: bool = True
    num_output_buffers: int = 4

    # Stream structure
    max_i_interval: int = 24

    # Device execution
    use_pallas: bool | None = None     # None = follow the device: the
                                       # hand-written kernel on CUDA, the
                                       # plain PyTorch version on the CPU.
                                       # A value that contradicts the
                                       # device is refused
    coef_major: bool | None = None     # None = block-major.  True parses
                                       # coefficient-major windows for the
                                       # coefficient-major kernel; ignored
                                       # without the native codec or with
                                       # pack_i8
    pack_i8: bool = False              # int16 DC + int8 AC device input
                                       # when a window's amplitudes fit
                                       # (int16 otherwise): half the
                                       # host->device bytes
    raster_on_device: bool = False     # True: the kernels store raster
                                       # rows; False: their blocked layout,
                                       # made raster by a host copy after
                                       # transfer
    pallas_tile: int = 512             # block tile of transform_coefmajor
    frames_per_batch: int = 20         # device window.  Window boundaries
                                       # need no GOP alignment (the carry
                                       # is exact)
    prefetch_batches: int = 2          # host->device in-flight batches
    latency_mode: bool = False         # first-window latency over
                                       # throughput: the FIRST window of a
                                       # decode() parses alone, dispatches,
                                       # and is drained BEFORE any later
                                       # window's H2D is posted, so its
                                       # delivery never queues behind
                                       # prefetch traffic (the reference
                                       # shows the sought frame
                                       # immediately, playback.c:245)

    # Host entropy decode
    parse_workers: int = 0             # 0 = os.cpu_count()
    use_native_entropy: bool = True
    spec_segments: int = 0             # >0: speculative intra-plane parallel
                                       # parse with this many segments per
                                       # plane (single-stream latency mode;
                                       # disables the coef-major layout)

    # Multi-device execution is explicit, not config-driven: use
    # parallel.decode_stream_sharded(data, mesh) for batch decode over a
    # mesh of devices.

    @property
    def frame_period_us(self) -> float:
        return 1e6 / self.fps


@dataclasses.dataclass
class EncodeConfig:
    """Encoder knobs (reference: mjpeg423_encoder.h:14 arguments)."""

    max_i_interval: int = 24
    use_native_entropy: bool = True
    # Device-path transform batch (encode_frames_device): frames staged,
    # transformed, and packed per window, which bounds host memory at
    # O(window) blocked planes instead of the whole clip.
    frames_per_batch: int = 16
    # Device-path stage overlap: host convert (window N+1) and serial pack
    # (window N) run concurrently with the device FDCT+quantize + D2H of
    # the windows between them (producer thread + bounded staging slots:
    # the reference's post-early/join-late shape, playback.c:80-134).
    # False: strict convert -> transform -> pack sequence per window.
    overlap_device: bool = True
    inflight_windows: int = 2          # staged windows in flight (device
                                       # path); host memory O(inflight+1
                                       # windows)
    fetch_i8: bool = False             # device path: narrow quantized
                                       # planes ON DEVICE to int16 DC +
                                       # int8 AC before D2H (the decode
                                       # pack_i8 mirror; a window whose AC
                                       # leaves int8 is fetched whole as
                                       # int16, byte-identical)
