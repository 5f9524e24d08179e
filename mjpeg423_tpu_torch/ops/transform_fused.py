"""Fused decode window: amplitudes -> frames plus the coefficient carry.

The counterparts of the three kernels of mjpeg423_tpu/ops/transform_fused.py,
with their signatures and layouts (W frames, B = blocks_h * blocks_w blocks,
fold k = rows_per_step):

  decode_window_fused     block-major int16 (3, W, B, 64)              K1
  decode_window_fused_cm  coefficient-major int16 (3, W, bh/k, 64, k*bw) K2
  decode_window_fused_i8  int16 DC (3, W, B) + int8 AC (3, W, B, 64)    K3

A CUDA tensor launches the hand-written kernel in csrc/decode_window.cu
(one body for the three layouts); a CPU tensor runs the plain PyTorch
version, decode_window_fused_ref, built from ops/transform.py, after the
cm and i8 inputs are laid out block-major.  Nothing falls back from one to
the other: any other device raises, and so does a failed build or launch.

The codec has no weights.  Its state is the quant tables (core/tables.py)
and the int16 coefficient carry, which
carry_from_jax / carry_to_numpy move between a JAX decode and this one and
carry_to_cm / carry_from_cm between the two carry layouts.  to_cm and
pack_amps_i8 are the JAX module's host-side layout helpers, copied here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import tables as T
from ..native import centropy

from . import _build, transform

# Kernel launches made by each wrapper (the plain versions are not counted):
# K1 decode_window_fused, K2 decode_window_fused_cm, K3 decode_window_fused_i8.
# A run resets them to 0 and reads them back to show which kernel decoded
# its windows.
LAUNCHES = 0
LAUNCHES_CM = 0
LAUNCHES_I8 = 0

_TILE = 32  # image blocks per thread block of the decode kernels

_QUANTS: dict[torch.device, torch.Tensor] = {}
_K1_SLOTS: dict[torch.device, int] = {}


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


def window_chunk_frames(w_frames: int, tiles: int, slots: int) -> int:
    """Frames of a window that one thread block of K1 decodes.

    The kernel's grid is tiles x ceil(w_frames / chunk).  A chunk that does
    not start at an I-frame replays the recurrence of the frames since the
    last one, so the window is split only as far as the card needs it:
    not at all when the tiles alone give every one of its `slots` (thread
    blocks it holds at once) a thread block, else into the most chunks
    that still run as a single wave, in chunks of equal length (the last
    may be shorter)."""
    if w_frames < 1 or tiles < 1:
        raise ValueError(f"empty window: {w_frames} frames, {tiles} tiles")
    if tiles >= slots:
        return w_frames
    chunks = min(w_frames, slots // tiles)
    return -(-w_frames // chunks)


def window_slots(device: torch.device) -> int:
    """Thread blocks of K1 that the card holds at once (SMs x resident
    blocks per SM, asked of the built kernel), cached per device."""
    slots = _K1_SLOTS.get(device)
    if slots is None:
        lib = _build.load()
        slots = _build.resident_blocks(
            lib, lib.mj423_decode_window_slots, device.index,
            "decode_window_fused")
        _K1_SLOTS[device] = slots
    return slots


def _check_fold(blocks_h: int, k: int) -> None:
    if k < 1 or blocks_h % k:
        raise ValueError(f"blocks_h {blocks_h} not divisible by rows_per_step {k}")


def _check_window(w_frames: int, seg, carry, carry_shape: tuple, typed) -> None:
    """The checks the three layouts share.  typed: (name, tensor, dtype) of
    every input but seg, the carry included."""
    if tuple(seg.shape) != (w_frames,):
        raise ValueError(f"seg must be ({w_frames},), got {tuple(seg.shape)}")
    if tuple(carry.shape) != carry_shape:
        raise ValueError(f"carry must be {carry_shape}, got {tuple(carry.shape)}")
    for name, t, dtype in typed:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if seg.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"seg must be bool or uint8, got {seg.dtype}")
    devices = {str(t.device) for _, t, _ in typed} | {str(seg.device)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(devices)}")


def _check_args(amps, seg, carry, blocks_h: int, blocks_w: int,
                rows_per_step: int) -> int:
    """Validate a block-major window; returns the window length W."""
    if amps.dim() != 4 or amps.shape[0] != 3 or amps.shape[3] != 64:
        raise ValueError(f"amps must be (3, W, B, 64), got {tuple(amps.shape)}")
    w_frames, nb = amps.shape[1], amps.shape[2]
    if nb != blocks_h * blocks_w:
        raise ValueError(f"B={nb} != blocks_h*blocks_w={blocks_h}*{blocks_w}")
    _check_window(w_frames, seg, carry, (3, nb, 64),
                  [("amps", amps, torch.int16), ("carry", carry, torch.int16)])
    _check_fold(blocks_h, rows_per_step)
    return w_frames


def _check_args_cm(amps_cm, seg, carry_cm, blocks_h: int, blocks_w: int,
                   rows_per_step: int) -> int:
    """Validate a coefficient-major window; returns W."""
    _check_fold(blocks_h, rows_per_step)
    g, bwe = blocks_h // rows_per_step, rows_per_step * blocks_w
    if (amps_cm.dim() != 5 or amps_cm.shape[0] != 3
            or tuple(amps_cm.shape[2:]) != (g, 64, bwe)):
        raise ValueError(
            f"amps_cm must be (3, W, {g}, 64, {bwe}), got {tuple(amps_cm.shape)}"
        )
    w_frames = amps_cm.shape[1]
    _check_window(w_frames, seg, carry_cm, (3, g, 64, bwe),
                  [("amps_cm", amps_cm, torch.int16),
                   ("carry_cm", carry_cm, torch.int16)])
    return w_frames


def _check_args_i8(dc, ac8, seg, carry, blocks_h: int, blocks_w: int) -> int:
    """Validate an int8-packed window; returns W."""
    nb = blocks_h * blocks_w
    if dc.dim() != 3 or dc.shape[0] != 3 or dc.shape[2] != nb:
        raise ValueError(f"dc must be (3, W, {nb}), got {tuple(dc.shape)}")
    w_frames = dc.shape[1]
    if tuple(ac8.shape) != (3, w_frames, nb, 64):
        raise ValueError(
            f"ac8 must be (3, {w_frames}, {nb}, 64), got {tuple(ac8.shape)}"
        )
    _check_window(w_frames, seg, carry, (3, nb, 64),
                  [("dc", dc, torch.int16), ("ac8", ac8, torch.int8),
                   ("carry", carry, torch.int16)])
    return w_frames


def _prepare_launch(name: str, tensors: dict, aligned: dict, carry,
                    w_frames: int, blocks_h: int, blocks_w: int,
                    raster: bool, k: int):
    """What every launch needs past the shape checks: a CUDA device, the
    built library, contiguous and aligned inputs, and the outputs.
    Returns (lib, frames, new_carry in the carry's layout, stream)."""
    dev = carry.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    lib = _build.load()
    if w_frames > lib.mj423_max_window():
        raise ValueError(
            f"window of {w_frames} frames exceeds the kernel's "
            f"{lib.mj423_max_window()}"
        )
    for tname, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    for tname, nbytes in aligned.items():
        if tensors[tname].data_ptr() % nbytes:
            raise ValueError(f"{tname} must be {nbytes}-byte aligned")
    if raster:
        shape = (w_frames, blocks_h * 8, blocks_w * 8)
    else:
        shape = (w_frames, 8, blocks_h // k, 8, k * blocks_w)
    frames = torch.empty(shape, dtype=torch.uint32, device=dev)
    new_carry = torch.empty_like(carry)
    return lib, frames, new_carry, torch.cuda.current_stream(dev).cuda_stream


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
    """Fused decode of a frame window with coefficient-state carry (K1).

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
    if amps.device.type == "cpu":
        return decode_window_fused_ref(
            amps, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=raster, rows_per_step=rows_per_step,
        )
    return _launch_window(
        amps, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
        raster=raster, rows_per_step=rows_per_step,
    )


def _launch_window(
    amps: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
    chunk_frames: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's launch, CUDA tensors only: decode_window_fused's arguments and
    result, plus the frames one thread block decodes.  chunk_frames=None is
    what decode_window_fused passes: window_chunk_frames decides from the
    geometry and the card.  A hook for tests and measurements, which force
    other values; the result is the same for every value in 1..W."""
    global LAUNCHES
    w_frames = _check_args(amps, seg, carry, blocks_h, blocks_w, rows_per_step)
    lib, frames, new_carry, stream = _prepare_launch(
        "decode_window_fused", {"amps": amps, "seg": seg, "carry": carry},
        {"amps": 16, "carry": 16}, carry, w_frames, blocks_h, blocks_w,
        raster, rows_per_step,
    )
    if chunk_frames is None:
        chunk_frames = window_chunk_frames(
            w_frames, -(-blocks_h * blocks_w // _TILE),
            window_slots(amps.device))
    elif not 1 <= chunk_frames <= w_frames:
        raise ValueError(f"chunk_frames {chunk_frames} outside 1..{w_frames}")
    code = lib.mj423_decode_window(
        amps.data_ptr(), seg.data_ptr(), carry.data_ptr(),
        _quants(amps.device).data_ptr(), frames.data_ptr(),
        new_carry.data_ptr(), w_frames, blocks_h, blocks_w, rows_per_step,
        int(raster), chunk_frames, amps.device.index, stream,
    )
    _build.check(lib, code, "decode_window_fused launch")
    LAUNCHES += 1
    return frames, new_carry


def to_cm(amps, blocks_h: int, blocks_w: int, rows_per_step: int = 1):
    """Block-major (..., B, 64) -> the cm kernel layout (..., bh/k, 64, k*bw),
    on the host (NumPy).  The layout the native parser's decode_batch_cm
    emits with row_blocks = k*bw."""
    k = rows_per_step
    g, bwe = blocks_h // k, k * blocks_w
    a = np.asarray(amps)
    return np.ascontiguousarray(
        a.reshape(a.shape[:-2] + (g, bwe, 64)).swapaxes(-1, -2)
    )


def carry_to_cm(carry: torch.Tensor, blocks_h: int, blocks_w: int,
                k: int) -> torch.Tensor:
    """Block-major (..., B, 64) -> coefficient-major (..., bh/k, 64, k*bw),
    contiguous, on the tensor's device: fold k block-rows into one group,
    then transpose each group's (k*bw, 64) tile."""
    g, bwe = blocks_h // k, k * blocks_w
    x = carry.reshape(carry.shape[:-2] + (g, bwe, 64))
    return x.transpose(-1, -2).contiguous()


def carry_from_cm(carry_cm: torch.Tensor, blocks_h: int, blocks_w: int,
                  k: int) -> torch.Tensor:
    """Coefficient-major (..., bh/k, 64, k*bw) -> block-major (..., B, 64),
    contiguous: the inverse of carry_to_cm."""
    x = carry_cm.transpose(-1, -2).contiguous()
    return x.reshape(carry_cm.shape[:-3] + (blocks_h * blocks_w, 64))


def decode_window_fused_cm_ref(
    amps_cm: torch.Tensor,
    seg: torch.Tensor,
    carry_cm: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K2: lay the window and the carry out
    block-major, run decode_window_fused_ref, and lay the new carry out
    coefficient-major again."""
    _check_args_cm(amps_cm, seg, carry_cm, blocks_h, blocks_w, rows_per_step)
    k = rows_per_step
    frames, new_carry = decode_window_fused_ref(
        carry_from_cm(amps_cm, blocks_h, blocks_w, k), seg,
        carry_from_cm(carry_cm, blocks_h, blocks_w, k),
        blocks_h=blocks_h, blocks_w=blocks_w, raster=raster, rows_per_step=k,
    )
    return frames, carry_to_cm(new_carry, blocks_h, blocks_w, k)


def decode_window_fused_cm(
    amps_cm: torch.Tensor,
    seg: torch.Tensor,
    carry_cm: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Coefficient-major fused decode (K2).

    amps_cm:  (3, W, bh/k, 64, k*bw) int16 with k = rows_per_step, the
              native parser's decode_batch_cm layout with row_blocks = k*bw.
    carry_cm: (3, bh/k, 64, k*bw) int16 state in the same layout.
    Returns (frames, new_carry_cm); frames as decode_window_fused's with
    the same k.  A CUDA tensor launches the kernel, a CPU tensor runs
    decode_window_fused_cm_ref.
    """
    global LAUNCHES_CM
    w_frames = _check_args_cm(amps_cm, seg, carry_cm, blocks_h, blocks_w,
                              rows_per_step)
    if amps_cm.device.type == "cpu":
        return decode_window_fused_cm_ref(
            amps_cm, seg, carry_cm, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=raster, rows_per_step=rows_per_step,
        )
    lib, frames, new_carry, stream = _prepare_launch(
        "decode_window_fused_cm",
        {"amps_cm": amps_cm, "seg": seg, "carry_cm": carry_cm}, {}, carry_cm,
        w_frames, blocks_h, blocks_w, raster, rows_per_step,
    )
    code = lib.mj423_decode_window_cm(
        amps_cm.data_ptr(), seg.data_ptr(), carry_cm.data_ptr(),
        _quants(amps_cm.device).data_ptr(), frames.data_ptr(),
        new_carry.data_ptr(), w_frames, blocks_h, blocks_w, rows_per_step,
        int(raster), amps_cm.device.index, stream,
    )
    _build.check(lib, code, "decode_window_fused_cm launch")
    LAUNCHES_CM += 1
    return frames, new_carry


def pack_amps_i8(amps):
    """Host-side compressed packing (NumPy): (3, W, B, 64) int16 ->
    (dc (3, W, B) int16, ac8 (3, W, B, 64) int8 with position 0 zeroed), or
    None when any AC amplitude exceeds int8 (the caller keeps int16)."""
    ac = amps[..., 1:]
    if ac.max(initial=0) > 127 or ac.min(initial=0) < -128:
        return None
    dc = np.ascontiguousarray(amps[..., 0])
    ac8 = amps.astype(np.int8)
    ac8[..., 0] = 0
    return dc, ac8


def decode_window_fused_i8_ref(
    dc: torch.Tensor,
    ac8: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3: widen the AC to int16, put the DC in place
    of coefficient 0 (whatever ac8[..., 0] holds), and run
    decode_window_fused_ref."""
    _check_args_i8(dc, ac8, seg, carry, blocks_h, blocks_w)
    amps = ac8.to(torch.int16)
    amps[..., 0] = dc
    return decode_window_fused_ref(
        amps, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w, raster=raster,
    )


def decode_window_fused_i8(
    dc: torch.Tensor,
    ac8: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed-input fused decode (K3): see pack_amps_i8 for the format.

    Byte-equal to decode_window_fused on the widened amplitudes, with no
    fold (blocked output has k = 1) and a block-major (3, B, 64) carry.  A
    CUDA tensor launches the kernel, a CPU tensor runs
    decode_window_fused_i8_ref.
    """
    global LAUNCHES_I8
    w_frames = _check_args_i8(dc, ac8, seg, carry, blocks_h, blocks_w)
    if dc.device.type == "cpu":
        return decode_window_fused_i8_ref(
            dc, ac8, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
            raster=raster,
        )
    lib, frames, new_carry, stream = _prepare_launch(
        "decode_window_fused_i8",
        {"dc": dc, "ac8": ac8, "seg": seg, "carry": carry}, {"ac8": 8},
        carry, w_frames, blocks_h, blocks_w, raster, 1,
    )
    code = lib.mj423_decode_window_i8(
        dc.data_ptr(), ac8.data_ptr(), seg.data_ptr(), carry.data_ptr(),
        _quants(dc.device).data_ptr(), frames.data_ptr(),
        new_carry.data_ptr(), w_frames, blocks_h, blocks_w, int(raster),
        dc.device.index, stream,
    )
    _build.check(lib, code, "decode_window_fused_i8 launch")
    LAUNCHES_I8 += 1
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
