"""mjpeg423_tpu_torch — the MJPEG423 codec on PyTorch and CUDA (Hopper).

A port of ``mjpeg423_tpu`` that stands alone: it imports torch and NumPy,
never jax and nothing of ``mjpeg423_tpu``.  The host half (container index,
native entropy codec, colour conversion, frame packer, NumPy oracles,
configs, probes) is a copy of the JAX package's, at the same relative
paths; what ran on the accelerator is written again:

  core/, native/, utils/,     host copies (each file's docstring names its
  ops/*_ref.py                source and commit)
  ops/transform.py            plain PyTorch dequant / scan / IDCT / colour
                              (counterpart of ops/transform_jax.py)
  ops/transform_fused.py      the fused decode-window entry points: CUDA
                              kernel on a CUDA tensor, the plain version on
                              a CPU tensor
  ops/transform_coefmajor.py  IDCT + colour on pre-accumulated coefficient-
                              major states (counterpart of
                              ops/transform_pallas.py), same dispatch
  ops/encode.py               plain PyTorch FDCT / quantize / I-P
                              differentials (counterpart of encode_jax.py)
  ops/encode_fused.py         the fused encode-window entry point
  ops/scale.py                box downscale on the device
  csrc/*.cu, csrc/*.cuh       the hand-written sm_90a kernels, built with
                              nvcc at first use (ops/_build.py)
  runtime/pipeline.py         DecodePipeline on a torch device, on one
                              device or a mesh (mesh=)
  runtime/live.py, serve.py,  live ingest, the serving pool and the player
  playback.py                 on the pipeline's device loop
  codec/encoder.py            encode_frames and encode_frames_device (the
                              fused path, K4; the candidate path,
                              use_pallas=False; both with mesh=)
  codec/decoder.py,           host copies: the NumPy decoder and re-GOP;
  transcode.py, io/           BMP and frame-source readers
  parallel/                   mesh of torch devices, sharded segmented scan,
                              sharded decode and encode, and the
                              multi-process control plane (multihost.py)
  cli.py                      the mjpeg423-torch command line
  entry.py                    top-level entry points: entry() and
                              dryrun_multichip(n)
  examples/, scripts/, tools/ runnable examples, card measurements, timing

Importing this package imports neither jax nor triton and builds nothing.
"""

import os as _os

# Copied from mjpeg423_tpu/__init__.py at commit bfc8537: NumPy
# madvise(MADV_HUGEPAGE)s every >=4 MB allocation; on hosts with THP
# defrag=madvise the first touch of such a buffer then runs synchronous
# compaction, which stalls this workload's allocate-use-free pattern.
# numpy is typically imported before this package, so the
# NUMPY_MADVISE_HUGEPAGE env var is too late: use the runtime toggle.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # private API, present in numpy 1.x and 2.x
    from numpy._core.multiarray import _set_madvise_hugepage
except ImportError:  # pragma: no cover
    try:
        from numpy.core.multiarray import _set_madvise_hugepage
    except ImportError:
        _set_madvise_hugepage = None
if (
    _set_madvise_hugepage is not None
    # Respect an explicit opt-in through either knob.
    and _os.environ.get("MJPEG423_MADVISE_HUGEPAGE", "0") != "1"
    and _os.environ.get("NUMPY_MADVISE_HUGEPAGE", "0") != "1"
):
    _set_madvise_hugepage(False)

__version__ = "0.1.0"
