"""Fused decode window: amplitudes -> frames plus the coefficient carry.

The counterpart of mjpeg423_tpu/ops/transform_fused.py::decode_window_fused,
with its signature and layouts.  A CUDA tensor launches the hand-written
kernel in csrc/decode_window.cu; a CPU tensor runs the plain PyTorch
version, decode_window_fused_ref, built from ops/transform.py.  Nothing
falls back from one to the other: any other device raises, and so does a
failed build or launch.

The codec has no weights.  Its state is the quant tables (shared from
mjpeg423_tpu/core/tables.py) and the int16 coefficient carry, which
carry_from_jax / carry_to_numpy move between a JAX decode and this one.
"""
from __future__ import annotations

import numpy as np
import torch

from mjpeg423_tpu.core import tables as T
from mjpeg423_tpu.native import centropy

from . import transform

# Kernel launches made by decode_window_fused (the plain version is not
# counted).  A run resets it to 0 and reads it back to show that its frames
# went through the kernel.
LAUNCHES = 0

_QUANTS: dict[torch.device, torch.Tensor] = {}


def _quants(device: torch.device) -> torch.Tensor:
    """(2, 64) int16 [luma, chroma] quant rows, cached per device."""
    q = _QUANTS.get(device)
    if q is None:
        q = torch.as_tensor(
            np.stack([T.YQUANT64, T.CQUANT64]), dtype=torch.int16,
            device=device,
        )
        _QUANTS[device] = q
    return q


def _check_args(amps, seg, carry, blocks_h: int, blocks_w: int,
                rows_per_step: int) -> int:
    """Validate shapes, dtypes and devices; returns the window length W."""
    if amps.dim() != 4 or amps.shape[0] != 3 or amps.shape[3] != 64:
        raise ValueError(f"amps must be (3, W, B, 64), got {tuple(amps.shape)}")
    w_frames, nb = amps.shape[1], amps.shape[2]
    if nb != blocks_h * blocks_w:
        raise ValueError(f"B={nb} != blocks_h*blocks_w={blocks_h}*{blocks_w}")
    if tuple(seg.shape) != (w_frames,):
        raise ValueError(f"seg must be ({w_frames},), got {tuple(seg.shape)}")
    if tuple(carry.shape) != (3, nb, 64):
        raise ValueError(f"carry must be (3, {nb}, 64), got {tuple(carry.shape)}")
    if amps.dtype != torch.int16 or carry.dtype != torch.int16:
        raise TypeError(
            f"amps and carry must be int16, got {amps.dtype} and {carry.dtype}"
        )
    if seg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"seg must be bool or uint8, got {seg.dtype}")
    if not (amps.device == seg.device == carry.device):
        raise ValueError(
            f"amps, seg and carry on different devices: {amps.device}, "
            f"{seg.device}, {carry.device}"
        )
    if rows_per_step < 1 or blocks_h % rows_per_step:
        raise ValueError(
            f"blocks_h {blocks_h} not divisible by rows_per_step {rows_per_step}"
        )
    return w_frames


def _raster_to_blocked(frames: torch.Tensor, blocks_h: int, blocks_w: int,
                       k: int) -> torch.Tensor:
    """(W, H, width) -> the kernel's blocked (W, 8[outcol], bh/k, 8[row],
    k*bw) layout (the inverse of the JAX package's _unfold_raster)."""
    w = frames.shape[0]
    g = blocks_h // k
    x = frames.reshape(w, g, k, 8, blocks_w, 8)
    return x.permute(0, 5, 1, 3, 2, 4).reshape(w, 8, g, 8, k * blocks_w)


def decode_window_fused_ref(
    amps: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device."""
    _check_args(amps, seg, carry, blocks_h, blocks_w, rows_per_step)
    yq, cq = transform.quant_tensors(amps.device)
    states = [
        transform.segmented_scan(
            transform.dequantize(amps[p], q), seg, carry=carry[p]
        )
        for p, q in ((0, yq), (1, cq), (2, cq))
    ]
    new_carry = torch.stack([s[-1] for s in states])
    frames = transform.decode_transform_states(
        *states, blocks_h=blocks_h, blocks_w=blocks_w
    )
    if not raster:
        frames = _raster_to_blocked(
            frames.view(torch.int32), blocks_h, blocks_w, rows_per_step
        ).contiguous().view(torch.uint32)
    return frames, new_carry


def decode_window_fused(
    amps: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused decode of a frame window with coefficient-state carry.

    amps:  (3, W, B, 64) int16 amplitudes (I-frame DC cumsum applied;
           B = blocks_h * blocks_w, row-major).
    seg:   (W,) bool I-frame mask.
    carry: (3, B, 64) int16 state of the frame before the window.
    Returns (frames, new_carry (3, B, 64) int16).  frames is (W, H, width)
    uint32 when raster, else the blocked (W, 8[outcol], bh/k, 8[row], k*bw)
    layout with k = rows_per_step.

    On a CUDA device this launches the kernel (asynchronously, on the
    current stream); on the CPU it runs decode_window_fused_ref.
    """
    global LAUNCHES
    w_frames = _check_args(amps, seg, carry, blocks_h, blocks_w, rows_per_step)
    dev = amps.device
    if dev.type == "cpu":
        return decode_window_fused_ref(
            amps, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=raster, rows_per_step=rows_per_step,
        )
    if dev.type != "cuda":
        raise ValueError(f"decode_window_fused runs on cpu or cuda, not {dev}")
    from . import _build

    lib = _build.load()
    if w_frames > lib.mj423_max_window():
        raise ValueError(
            f"window of {w_frames} frames exceeds the kernel's "
            f"{lib.mj423_max_window()}"
        )
    for name, t in (("amps", amps), ("seg", seg), ("carry", carry)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if amps.data_ptr() % 16:
        raise ValueError("amps must be 16-byte aligned")
    nb = blocks_h * blocks_w
    if raster:
        frames = torch.empty(
            (w_frames, blocks_h * 8, blocks_w * 8), dtype=torch.uint32,
            device=dev,
        )
    else:
        k = rows_per_step
        frames = torch.empty(
            (w_frames, 8, blocks_h // k, 8, k * blocks_w), dtype=torch.uint32,
            device=dev,
        )
    new_carry = torch.empty((3, nb, 64), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.mj423_decode_window(
        amps.data_ptr(), seg.data_ptr(), carry.data_ptr(),
        _quants(dev).data_ptr(), frames.data_ptr(), new_carry.data_ptr(),
        w_frames, blocks_h, blocks_w, rows_per_step, int(raster), dev.index,
        stream,
    )
    _build.check(lib, code, "decode_window_fused launch")
    LAUNCHES += 1
    return frames, new_carry


def blocked_to_raster_host(
    blocked: np.ndarray, blocks_h: int, blocks_w: int
) -> np.ndarray:
    """Host raster conversion of the blocked layout: (W, 8, bh/k, 8, k*bw)
    uint32 -> (W, 8*bh, 8*bw).  The native codec's copy when it is built,
    else the NumPy permutation."""
    native = centropy.blocked_to_raster(blocked, blocks_h, blocks_w)
    if native is not None:
        return native
    w, _, g, _, _ = blocked.shape
    k = blocks_h // g
    x = np.asarray(blocked).reshape(w, 8, g, 8, k, blocks_w)
    return x.transpose(0, 2, 4, 3, 5, 1).reshape(w, blocks_h * 8, blocks_w * 8)


def carry_from_jax(carry, device) -> torch.Tensor:
    """A JAX decode's (3, B, 64) int16 carry (any array NumPy can read) as a
    tensor on `device`, ready to continue the stream in this port."""
    return torch.tensor(np.asarray(carry, dtype=np.int16), device=device)


def carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    """The port's carry as a host int16 array (what a JAX step accepts)."""
    return carry.detach().cpu().numpy()
