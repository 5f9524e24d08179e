"""mjpeg423_tpu_torch — the MJPEG423 decoder on PyTorch and CUDA (Hopper).

A port of ``mjpeg423_tpu`` that keeps its host half (container index,
native entropy codec, parse/queue/latency logic) by import and replaces
only what ran on the accelerator:

  ops/transform.py        plain PyTorch dequant / scan / IDCT / colour
                          (counterpart of mjpeg423_tpu/ops/transform_jax.py)
  ops/transform_fused.py  the fused decode-window entry point: CUDA kernel on
                          a CUDA tensor, the plain version on a CPU tensor
  csrc/decode_window.cu   the hand-written sm_90a kernel, built with nvcc at
                          first use (ops/_build.py)
  runtime/pipeline.py     DecodePipeline on a torch device
  codec.py                the shared host encoder and container index

Importing this package imports neither jax nor triton and builds nothing.
"""

__version__ = "0.1.0"
