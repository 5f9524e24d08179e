"""Fused encode window: sample blocks -> quantized planes in one pass.

The counterpart of mjpeg423_tpu/ops/encode_fused.py::encode_window_fused,
with its signature and layouts.  A CUDA tensor launches the hand-written
kernel in csrc/encode_window.cu; a CPU tensor runs the plain PyTorch
version, encode_window_fused_ref, built from ops/encode.py.  Nothing falls
back from one to the other: any other device raises, and so does a failed
build or launch.

Every 8x8 block is independent (the output is the ABSOLUTE quantized
planes; the host packer forms the I-DC chain and the P deltas), so there is
no carry.  rows_per_step is accepted for the JAX signature: there it only
widens the TPU's lane tiles and never changes the output, and here it
changes nothing at all.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build, encode, transform
from ._counters import LaunchCounts
from .transform_fused import _quants

# Kernel launches made by encode_window_fused (the plain version is not
# counted).  A run resets it to 0 (COUNTS.reset()) and reads it back
# (COUNTS.get("LAUNCHES"), or the module attribute LAUNCHES) to show that
# its windows went through the kernel.
COUNTS = LaunchCounts("LAUNCHES")
__getattr__ = COUNTS.module_getattr(__name__)


_MULTS: dict[torch.device, torch.Tensor] = {}
_SLOTS: dict[torch.device, int] = {}


def quant_multipliers(q) -> np.ndarray:
    """The kernel's stand-in for its quantizer's division, per quant value.

    The quantizer is sign(c) * ((2|c| + q) // (2q)).  For n = 2|c| + q <=
    65,791 and d = 2q with q in 1..255, n // d == (n * m) >> 32 with
    m = 2**32 // d + 1: m * d exceeds 2**32 by e <= d, so n * m / 2**32 =
    n / d + n * e / (d * 2**32), and n * e <= n * d < 2**32 keeps the
    excess under 1 / d, too little to carry n / d over the next integer.
    Returns m as uint32, in q's shape."""
    d = 2 * np.asarray(q).astype(np.uint64)
    if d.size and (d.min() < 2 or d.max() > 510):
        raise ValueError("quant values must lie in 1..255")
    return ((np.uint64(1) << np.uint64(32)) // d + np.uint64(1)).astype(np.uint32)


def _mults(device: torch.device) -> torch.Tensor:
    """(2, 64) multipliers of the [luma, chroma] quant rows as the int32
    bit patterns of their uint32 values, cached per device."""
    m = _MULTS.get(device)
    if m is None:
        rows = quant_multipliers(_quants(torch.device("cpu")).numpy())
        m = torch.from_numpy(rows.view(np.int32)).to(device)
        _MULTS[device] = m
    return m


def _slots(lib, device: torch.device) -> int:
    """Thread blocks of the kernel that the card holds at once (the cap of
    its grid), asked of the built kernel once per device."""
    slots = _SLOTS.get(device)
    if slots is None:
        slots = _build.resident_blocks(
            lib, lib.mj423_encode_window_slots, device.index,
            "encode_window_fused")
        _SLOTS[device] = slots
    return slots


def quantize_probe_ref(coefs: torch.Tensor) -> torch.Tensor:
    """The plain version of quantize_probe, on any device: encode.quantize,
    which divides."""
    if coefs.dim() != 1 or coefs.dtype != torch.int16:
        raise TypeError("coefs must be a 1-D int16 tensor")
    q = _quants(coefs.device).reshape(128, 1)
    return encode.quantize(coefs.reshape(1, -1).expand(128, -1), q)


def quantize_probe(coefs: torch.Tensor) -> torch.Tensor:
    """The kernel's quantizer alone: (N,) int16 coefficients -> (128, N)
    int16, row j quantized by entry j of the flattened [luma, chroma] quant
    rows.  A CUDA tensor runs the device function the encode kernel calls
    (multiply-high by quant_multipliers); a CPU tensor runs
    quantize_probe_ref."""
    dev = coefs.device
    if dev.type == "cpu":
        return quantize_probe_ref(coefs)
    if coefs.dim() != 1 or coefs.dtype != torch.int16:
        raise TypeError("coefs must be a 1-D int16 tensor")
    if dev.type != "cuda":
        raise ValueError(f"quantize_probe runs on cpu or cuda, not {dev}")
    lib = _build.load()
    coefs = coefs.contiguous()
    out = torch.empty((128, coefs.shape[0]), dtype=torch.int16, device=dev)
    code = lib.mj423_quantize_probe(
        coefs.data_ptr(), _quants(dev).data_ptr(), _mults(dev).data_ptr(),
        out.data_ptr(), coefs.shape[0], dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "quantize_probe launch")
    return out


def _check_args(samples, blocks_h: int, blocks_w: int,
                rows_per_step: int) -> int:
    """Validate shape and dtype; returns the window length W."""
    if samples.dim() != 4 or samples.shape[0] != 3 or samples.shape[3] != 64:
        raise ValueError(
            f"samples must be (3, W, B, 64), got {tuple(samples.shape)}"
        )
    if samples.dtype != torch.uint8:
        raise TypeError(f"samples must be uint8, got {samples.dtype}")
    if samples.shape[2] != blocks_h * blocks_w:
        raise ValueError(
            f"B={samples.shape[2]} != blocks_h*blocks_w={blocks_h}*{blocks_w}"
        )
    if rows_per_step < 1 or blocks_h % rows_per_step:
        raise ValueError(
            f"blocks_h {blocks_h} not divisible by rows_per_step {rows_per_step}"
        )
    return samples.shape[1]


def encode_window_fused_ref(
    samples: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    rows_per_step: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    w_frames = _check_args(samples, blocks_h, blocks_w, rows_per_step)
    nb = blocks_h * blocks_w
    yq, cq = transform.quant_tensors(samples.device)
    planes = [
        encode.quantize(
            encode.fdct_blocks(samples[p].reshape(w_frames, nb, 8, 8))
            .reshape(w_frames, nb, 64),
            q,
        )
        for p, q in ((0, yq), (1, cq), (2, cq))
    ]
    return torch.stack(planes)


def encode_window_fused(
    samples: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    rows_per_step: int = 1,
) -> torch.Tensor:
    """Fused FDCT + quantize of a frame window.

    samples: (3, W, B, 64) uint8 blocked Y/Cb/Cr sample planes (B =
    blocks_h * blocks_w, row-major; each block 8x8 flattened).
    Returns (3, W, B, 64) int16 ABSOLUTE quantized amplitudes (luma table
    for plane 0, chroma for planes 1 and 2), the input of the host packer
    (codec.encoder.encode_quantized_frames).

    On a CUDA device this launches the kernel (asynchronously, on the
    current stream); on the CPU it runs encode_window_fused_ref.
    """
    w_frames = _check_args(samples, blocks_h, blocks_w, rows_per_step)
    dev = samples.device
    if dev.type == "cpu":
        return encode_window_fused_ref(
            samples, blocks_h=blocks_h, blocks_w=blocks_w,
            rows_per_step=rows_per_step,
        )
    if dev.type != "cuda":
        raise ValueError(f"encode_window_fused runs on cpu or cuda, not {dev}")
    lib = _build.load()
    if not samples.is_contiguous():
        raise ValueError("samples must be contiguous")
    if samples.data_ptr() % 8:
        raise ValueError("samples must be 8-byte aligned")
    out = torch.empty(samples.shape, dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mj423_encode_window(
        samples.data_ptr(), _quants(dev).data_ptr(), _mults(dev).data_ptr(),
        out.data_ptr(), w_frames, blocks_h, blocks_w, _slots(lib, dev),
        dev.index, stream,
    )
    _build.check(lib, code, "encode_window_fused launch")
    COUNTS.add("LAUNCHES")
    return out
