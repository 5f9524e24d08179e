"""mjpeg423_tpu_torch — the MJPEG423 codec on PyTorch and CUDA (Hopper).

A port of ``mjpeg423_tpu`` that keeps its host half (container index,
native entropy codec, colour conversion, frame packer, parse/queue/latency
logic) by import and replaces only what ran on the accelerator:

  ops/transform.py        plain PyTorch dequant / scan / IDCT / colour
                          (counterpart of mjpeg423_tpu/ops/transform_jax.py)
  ops/transform_fused.py  the fused decode-window entry point: CUDA kernel on
                          a CUDA tensor, the plain version on a CPU tensor
  ops/encode.py           plain PyTorch FDCT / quantize / I-P differentials
                          (counterpart of mjpeg423_tpu/ops/encode_jax.py)
  ops/encode_fused.py     the fused encode-window entry point (FDCT +
                          quantize): CUDA kernel or the plain version
  csrc/decode_window.cu,  the hand-written sm_90a kernels, built with nvcc
  csrc/encode_window.cu   at first use (ops/_build.py)
  runtime/pipeline.py     DecodePipeline on a torch device
  codec/encoder.py        encode_frames_device on a torch device
  codec/__init__.py       that, plus the shared host encoder and index

Importing this package imports neither jax nor triton and builds nothing.
"""

__version__ = "0.1.0"
