"""Fused decode window: amplitudes -> frames plus the coefficient carry.

The counterparts of the three kernels of mjpeg423_tpu/ops/transform_fused.py,
with their signatures and layouts (W frames, B = blocks_h * blocks_w blocks,
fold k = rows_per_step):

  decode_window_fused     block-major int16 (3, W, B, 64)              K1
  decode_window_fused_cm  coefficient-major int16 (3, W, bh/k, 64, k*bw) K2
  decode_window_fused_i8  int16 DC (3, W, B) + int8 AC (3, W, B, 64)    K3

A CUDA tensor launches the hand-written kernel in csrc/decode_window.cu
(one frame loop, instantiated for the three layouts); a CPU tensor runs the
plain PyTorch version, decode_window_fused_ref, built from ops/transform.py,
after the cm and i8 inputs are laid out block-major.  Nothing falls back
from one to the other: any other device raises, and so does a failed build
or launch.

A window may have any length.  One launch takes at most the kernel's
mj423_max_window() frames (its I-frame mask lives in shared memory), so a
longer window is walked in sub-windows (_walk_window): one output tensor,
one launch a sub-window writing its slice, the carry handed from launch to
launch.  WINDOW_CAP forces a smaller cap, on the CPU too, where tests
drive the same walk through the plain versions.

The codec has no weights.  Its state is the quant tables (core/tables.py)
and the int16 coefficient carry, which
carry_from_jax / carry_to_numpy move between a JAX decode and this one and
carry_to_cm / carry_from_cm between the two carry layouts.  to_cm and
pack_amps_i8 are the JAX module's host-side layout helpers, copied here.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import tables as T
from ..native import centropy

from . import _build, transform
from ._counters import LaunchCounts

# Kernel launches made by each wrapper (the plain versions are not counted):
# K1 decode_window_fused, K2 decode_window_fused_cm, K3 decode_window_fused_i8.
# A run resets them to 0 (COUNTS.reset()) and reads them back (COUNTS.read(),
# or the module attributes LAUNCHES, LAUNCHES_CM, LAUNCHES_I8) to show which
# kernel decoded its windows.  A walked window adds one per sub-window.
COUNTS = LaunchCounts("LAUNCHES", "LAUNCHES_CM", "LAUNCHES_I8")
__getattr__ = COUNTS.module_getattr(__name__)

# Frames one launch (on the CPU: one call of a plain version) may take.
# None: the built kernel's mj423_max_window() on CUDA, no limit on the CPU.
WINDOW_CAP: int | None = None

_TILE = 32  # image blocks per thread block of the decode kernels


@dataclasses.dataclass(frozen=True)
class _Layout:
    """One instantiation of the decode kernel: the wrapper's name, its
    launch counter, the library's number for it and its entry point,
    whether that takes a fold (rows_per_step), and the alignment its input
    planes need (the carry needs `carry_align`)."""
    name: str
    counter: str
    index: int
    entry: str
    takes_fold: bool
    plane_align: tuple[int, ...]
    carry_align: int


_BM = _Layout("decode_window_fused", "LAUNCHES", 0, "mj423_decode_window",
              True, (16,), 16)
_CM = _Layout("decode_window_fused_cm", "LAUNCHES_CM", 1,
              "mj423_decode_window_cm", True, (2,), 2)
_I8 = _Layout("decode_window_fused_i8", "LAUNCHES_I8", 2,
              "mj423_decode_window_i8", False, (2, 8), 16)
_LAYOUTS = {"bm": _BM, "cm": _CM, "i8": _I8}

_QUANTS: dict[torch.device, torch.Tensor] = {}
_SLOTS: dict[tuple[torch.device, int], int] = {}


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
    """Frames of a window that one thread block of a decode kernel decodes.

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


def window_slots(device: torch.device, layout: str = "bm") -> int:
    """Thread blocks of a decode kernel that the card holds at once (SMs x
    resident blocks per SM, asked of the built instantiation for `layout`:
    "bm" K1, "cm" K2, "i8" K3), cached per device and layout."""
    return _slots(device, _LAYOUTS[layout])


def _slots(device: torch.device, lay: _Layout) -> int:
    slots = _SLOTS.get((device, lay.index))
    if slots is None:
        lib = _build.load()
        slots = _build.resident_blocks(
            lib, functools.partial(lib.mj423_decode_window_slots, lay.index),
            device.index, lay.name)
        _SLOTS[(device, lay.index)] = slots
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


def _frames_shape(blocks_h: int, blocks_w: int, raster: bool, k: int) -> tuple:
    """One frame of the output: raster (H, width), or blocked
    (8[outcol], bh/k, 8[row], k*bw)."""
    if raster:
        return (blocks_h * 8, blocks_w * 8)
    return (8, blocks_h // k, 8, k * blocks_w)


def _walk_window(w_frames: int, cap: int, carry: torch.Tensor,
                 frame_shape: tuple, step) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a window of any length in sub-windows of at most `cap`
    frames.  step(lo, hi, carry, out) decodes frames [lo, hi) from `carry`
    into `out`, the (hi - lo, *frame_shape) slice of the one output tensor,
    and returns the carry after frame hi - 1, which the next step takes.
    Returns (frames, the last step's carry)."""
    if cap < 1:
        raise ValueError(f"window cap {cap} < 1")
    frames = torch.empty((w_frames, *frame_shape), dtype=torch.uint32,
                         device=carry.device)
    for lo in range(0, w_frames, cap):
        hi = min(lo + cap, w_frames)
        carry = step(lo, hi, carry, frames[lo:hi])
    return frames, carry


def _walk_plain(ref, planes: tuple, seg, carry, frame_shape: tuple, **kw):
    """The CPU path of the three wrappers: the plain version `ref` on the
    whole window, or walked like a launch's where WINDOW_CAP is shorter."""
    w_frames = seg.shape[0]
    if WINDOW_CAP is None or w_frames <= WINDOW_CAP:
        return ref(*planes, seg, carry, **kw)

    def step(lo, hi, c, out):
        f, c = ref(*(t[:, lo:hi] for t in planes), seg[lo:hi], c, **kw)
        out.view(torch.int32).copy_(f.view(torch.int32))
        return c

    return _walk_window(w_frames, WINDOW_CAP, carry, frame_shape, step)


def _launch(lay: _Layout, planes: tuple, seg, carry, *, blocks_h: int,
            blocks_w: int, raster: bool, k: int, chunk_frames: int | None):
    """Launch the kernel of `lay` on a checked window, CUDA tensors only.
    planes: the input tensors with the frame axis second; k: the fold.
    chunk_frames=None lets window_chunk_frames decide the frames one thread
    block decodes from the geometry and the card; a forced value is a hook
    for tests and measurements, the result the same for every one in 1..W.
    Returns (frames, new_carry in the carry's layout)."""
    dev = carry.device
    if dev.type != "cuda":
        raise ValueError(f"{lay.name} runs on cpu or cuda, not {dev}")
    lib = _build.load()
    w_frames = seg.shape[0]
    for t, nbytes in ((seg, 1), (carry, lay.carry_align),
                      *zip(planes, lay.plane_align)):
        if not t.is_contiguous():
            raise ValueError(f"{lay.name}: every input must be contiguous")
        if t.data_ptr() % nbytes:
            raise ValueError(f"{lay.name}: an input of {t.dtype} is not "
                             f"{nbytes}-byte aligned")
    if chunk_frames is not None and not 1 <= chunk_frames <= w_frames:
        raise ValueError(f"chunk_frames {chunk_frames} outside 1..{w_frames}")
    cap = lib.mj423_max_window()
    if WINDOW_CAP is not None:
        cap = min(cap, WINDOW_CAP)
    tiles = -(-blocks_h * blocks_w // _TILE)
    slots = _slots(dev, lay)
    entry = getattr(lib, lay.entry)
    fold = (k,) if lay.takes_fold else ()
    quants = _quants(dev).data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def step(lo, hi, c, out):
        n = hi - lo
        chunk = (window_chunk_frames(n, tiles, slots) if chunk_frames is None
                 else min(chunk_frames, n))
        new_carry = torch.empty_like(c)
        code = entry(
            *(t.data_ptr() + lo * t.stride(1) * t.element_size()
              for t in planes),
            seg.data_ptr() + lo, c.data_ptr(), quants, out.data_ptr(),
            new_carry.data_ptr(), n, w_frames, blocks_h, blocks_w, *fold,
            int(raster), chunk, dev.index, stream,
        )
        _build.check(lib, code, f"{lay.name} launch")
        COUNTS.add(lay.counter)
        return new_carry

    return _walk_window(w_frames, cap, carry,
                        _frames_shape(blocks_h, blocks_w, raster, k), step)


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
        _check_args(amps, seg, carry, blocks_h, blocks_w, rows_per_step)
        return _walk_plain(
            decode_window_fused_ref, (amps,), seg, carry,
            _frames_shape(blocks_h, blocks_w, raster, rows_per_step),
            blocks_h=blocks_h, blocks_w=blocks_w, raster=raster,
            rows_per_step=rows_per_step)
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
    result, plus the frames one thread block decodes (see _launch).  A hook
    for tests and measurements."""
    _check_args(amps, seg, carry, blocks_h, blocks_w, rows_per_step)
    return _launch(_BM, (amps,), seg, carry, blocks_h=blocks_h,
                   blocks_w=blocks_w, raster=raster, k=rows_per_step,
                   chunk_frames=chunk_frames)


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
    if amps_cm.device.type == "cpu":
        _check_args_cm(amps_cm, seg, carry_cm, blocks_h, blocks_w,
                       rows_per_step)
        return _walk_plain(
            decode_window_fused_cm_ref, (amps_cm,), seg, carry_cm,
            _frames_shape(blocks_h, blocks_w, raster, rows_per_step),
            blocks_h=blocks_h, blocks_w=blocks_w, raster=raster,
            rows_per_step=rows_per_step)
    return _launch_window_cm(
        amps_cm, seg, carry_cm, blocks_h=blocks_h, blocks_w=blocks_w,
        raster=raster, rows_per_step=rows_per_step,
    )


def _launch_window_cm(
    amps_cm: torch.Tensor,
    seg: torch.Tensor,
    carry_cm: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    rows_per_step: int = 1,
    chunk_frames: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's launch, CUDA tensors only, with its frame chunks as
    _launch_window has K1's."""
    _check_args_cm(amps_cm, seg, carry_cm, blocks_h, blocks_w, rows_per_step)
    return _launch(_CM, (amps_cm,), seg, carry_cm, blocks_h=blocks_h,
                   blocks_w=blocks_w, raster=raster, k=rows_per_step,
                   chunk_frames=chunk_frames)


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
    if dc.device.type == "cpu":
        _check_args_i8(dc, ac8, seg, carry, blocks_h, blocks_w)
        return _walk_plain(
            decode_window_fused_i8_ref, (dc, ac8), seg, carry,
            _frames_shape(blocks_h, blocks_w, raster, 1),
            blocks_h=blocks_h, blocks_w=blocks_w, raster=raster)
    return _launch_window_i8(
        dc, ac8, seg, carry, blocks_h=blocks_h, blocks_w=blocks_w,
        raster=raster,
    )


def _launch_window_i8(
    dc: torch.Tensor,
    ac8: torch.Tensor,
    seg: torch.Tensor,
    carry: torch.Tensor,
    *,
    blocks_h: int,
    blocks_w: int,
    raster: bool = True,
    chunk_frames: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's launch, CUDA tensors only, with its frame chunks as
    _launch_window has K1's."""
    _check_args_i8(dc, ac8, seg, carry, blocks_h, blocks_w)
    return _launch(_I8, (dc, ac8), seg, carry, blocks_h=blocks_h,
                   blocks_w=blocks_w, raster=raster, k=1,
                   chunk_frames=chunk_frames)


def blocked_to_raster_host(
    blocked: np.ndarray, blocks_h: int, blocks_w: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Host raster conversion of the blocked layout: (W, 8, bh/k, 8, k*bw)
    uint32 -> (W, 8*bh, 8*bw).  The native codec's copy when it is built,
    else the NumPy permutation.  out: a C-contiguous uint32 array of the
    result's shape to write it into (and return) instead of a fresh one."""
    native = centropy.blocked_to_raster(blocked, blocks_h, blocks_w, out)
    if native is not None:
        return native
    w, _, g, _, _ = blocked.shape
    k = blocks_h // g
    x = np.asarray(blocked).reshape(w, 8, g, 8, k, blocks_w)
    x = x.transpose(0, 2, 4, 3, 5, 1).reshape(w, blocks_h * 8, blocks_w * 8)
    if out is None:
        return x
    if out.shape != x.shape or out.dtype != np.uint32:
        raise ValueError(f"out must be a uint32 array of shape {x.shape}, "
                         f"not {out.dtype} {out.shape}")
    np.copyto(out, x)
    return out


def carry_from_jax(carry, device) -> torch.Tensor:
    """A JAX decode's (3, B, 64) int16 carry (any array NumPy can read) as a
    tensor on `device`, ready to continue the stream in this port."""
    return torch.tensor(np.asarray(carry, dtype=np.int16), device=device)


def carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    """The port's carry as a host int16 array (what a JAX step accepts)."""
    return carry.detach().cpu().numpy()
