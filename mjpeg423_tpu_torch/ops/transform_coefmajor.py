"""IDCT + colour on pre-accumulated coefficient-major states (K5).

The counterpart of mjpeg423_tpu/ops/transform_pallas.py, with its three
entry points (its file name says how the TPU kernel was written; this one
says what the kernel computes):

  transform_coefmajor             (64, N) int16 states x3 -> (64, N) uint32
                                  BGRA words, natural order [row*8+col, n],
                                  for any N
  decode_transform_states_kernel  (..., B, 64) states x3 -> (..., H, W)
                                  (decode_transform_states_pallas there)
  decode_transform_kernel         (F, B, 64) amplitudes x3 + I-frame mask
                                  -> (F, H, W) (decode_transform_pallas)

No dequantization and no temporal recurrence happen in the kernel: its
caller, the cross-device-carry path of parallel/decode.py, has already
accumulated the states across devices.  A CUDA tensor launches the
hand-written kernel in csrc/transform_coefmajor.cu; a CPU tensor runs the
plain PyTorch version, transform_coefmajor_ref, built from ops/transform.py.
Nothing falls back from one to the other: any other device raises, and so
does a failed build or launch.  The relayouts around the kernel (block-major
to coefficient-major on the way in, coefficient-major to raster rows on the
way out) are plain torch, as they are plain XLA in the JAX package.

The JAX functions take a `tile` (a size of the TPU's on-chip memory: N must
be a multiple of it, and callers pad with zero blocks).  The CUDA kernel
guards its tail and takes any N, so the port's functions have no such
argument and pad nothing.
"""
from __future__ import annotations

import torch

from . import _build, transform
from ._counters import LaunchCounts

# Kernel launches made by transform_coefmajor (the plain version is not
# counted).  A run resets it to 0 (COUNTS.reset()) and reads it back
# (COUNTS.get("LAUNCHES_K5"), or the module attribute LAUNCHES_K5) to show
# that its states went through K5.
COUNTS = LaunchCounts("LAUNCHES_K5")
__getattr__ = COUNTS.module_getattr(__name__)


def _check_states(y, cb, cr) -> int:
    """Validate three (64, N) int16 planes on one device; returns N."""
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dim() != 2 or t.shape[0] != 64 or t.shape != y.shape:
            raise ValueError(
                f"{name} must be (64, N) like y {tuple(y.shape)}, got "
                f"{tuple(t.shape)}"
            )
        if t.dtype != torch.int16:
            raise TypeError(f"{name} must be int16, got {t.dtype}")
        if t.device != y.device:
            raise ValueError(
                f"inputs on different devices: {y.device}, {t.device}"
            )
    return y.shape[1]


def transform_coefmajor_ref(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device and any N."""
    n = _check_states(y, cb, cr)
    planes = [transform.idct_blocks(s.T.reshape(n, 8, 8)) for s in (y, cb, cr)]
    packed = transform.ycbcr_to_rgba(*planes).view(torch.int32)  # (N, 8, 8)
    return packed.reshape(n, 64).T.contiguous().view(torch.uint32)


def transform_coefmajor(
    y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
) -> torch.Tensor:
    """Coefficient-major states (64, N) int16 x3 -> (64, N) uint32 packed
    BGRA (K5), for any N >= 0.

    On a CUDA device this launches the kernel (asynchronously, on that
    device's current stream); on the CPU it runs transform_coefmajor_ref.
    """
    n = _check_states(y, cb, cr)
    dev = y.device
    if dev.type == "cpu":
        return transform_coefmajor_ref(y, cb, cr)
    if dev.type != "cuda":
        raise ValueError(f"transform_coefmajor runs on cpu or cuda, not {dev}")
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((64, n), dtype=torch.uint32, device=dev)
    if n == 0:
        return out
    lib = _build.load()
    code = lib.mj423_transform_coefmajor(
        y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(), n,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "transform_coefmajor launch")
    COUNTS.add("LAUNCHES_K5")
    return out


def decode_transform_states_kernel(
    y_state: torch.Tensor,
    cb_state: torch.Tensor,
    cr_state: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
) -> torch.Tensor:
    """Pre-accumulated (..., B, 64) int16 states -> (..., H, W) uint32.

    The drop-in replacement of ops/transform.decode_transform_states on the
    kernel: one transpose into coefficient-major (64, N), K5, and one
    permutation from (64, N) to raster rows, which doubles as the
    block->raster reassembly.  Nothing is padded.
    """
    lead = tuple(y_state.shape[:-2])
    if y_state.shape[-2] != blocks_h * blocks_w or y_state.shape[-1] != 64:
        raise ValueError(
            f"states must be (..., {blocks_h * blocks_w}, 64), got "
            f"{tuple(y_state.shape)}"
        )

    def to_cm(x):  # (..., B, 64) -> (64, N) coefficient-major
        return x.reshape(-1, 64).T.contiguous()

    packed = transform_coefmajor(
        to_cm(y_state), to_cm(cb_state), to_cm(cr_state)
    ).view(torch.int32)
    # (64, N) -> raster: [r*8+c, f*B + by*bw + bx] -> (..., bh*8, bw*8)
    x = packed.reshape((8, 8) + lead + (blocks_h, blocks_w))
    k = len(lead)
    # axes: (r, c, *lead, by, bx) -> (*lead, by, r, bx, c)
    perm = tuple(range(2, 2 + k)) + (2 + k, 0, 3 + k, 1)
    return x.permute(perm).reshape(
        lead + (blocks_h * 8, blocks_w * 8)
    ).view(torch.uint32)


def decode_transform_kernel(
    amps_y: torch.Tensor,
    amps_cb: torch.Tensor,
    amps_cr: torch.Tensor,
    is_iframe: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
) -> torch.Tensor:
    """Full device decode on K5: amplitudes -> (F, H, W) uint32.

    The contract of ops/transform.decode_transform: amps (F, B, 64) int16
    with the I-frame DC cumsum applied, is_iframe (F,) bool.  Dequantization
    and the segmented temporal scan stay plain torch (exact int16); the IDCT
    and colour run in the kernel.
    """
    yq, cq = transform.quant_tensors(amps_y.device)
    states = [
        transform.segmented_scan(transform.dequantize(a, q), is_iframe)
        for a, q in ((amps_y, yq), (amps_cb, cq), (amps_cr, cq))
    ]
    return decode_transform_states_kernel(
        *states, blocks_h=blocks_h, blocks_w=blocks_w
    )
