"""Device encoder on a torch device: encode_frames_device.

The counterpart of the device half of mjpeg423_tpu/codec/encoder.py, on its
fused select-then-pack structure (_encode_frames_device_fused there).  The
host converts RGB to blocked YCbCr (float64, bit-exact with the reference's
doubles) and packs; the device runs FDCT + quantize over windows of
config.frames_per_batch frames (ops/encode_fused.encode_window_fused: the
CUDA kernel on a CUDA device, its plain PyTorch version on the CPU).  The
kernel returns ABSOLUTE quantized planes, so the whole back half (candidate
sizes, smaller-wins frame types, container assembly) is the host encoder's
own encode_quantized_frames, imported rather than copied: the containers
are byte-identical to encode_frames by construction.

config.overlap_device (default True) runs a producer thread that converts,
stages and dispatches windows while the caller's thread fetches and packs
earlier ones, as in the JAX encoder.  On CUDA the staging windows are
pinned host buffers, the producer owns a CUDA stream on which each window's
H2D copy, kernel and D2H copy run without blocking, and a CUDA event per
window tells the consumer when its planes have landed.  config.fetch_i8
narrows each window on the device to an int16 DC and an int8 AC before the
copy back (a window whose AC leaves int8 is fetched whole as int16).

Not ported yet, and refused rather than run some other way: mesh-sharded
encode (mesh=).  The JAX encoder's other structure, the XLA candidate path
(encode_jax.encode_transform with a threaded candidate pack, taken there
with use_pallas=False), is not wired in: the port has the one path, and
parallel_entropy is accepted and ignored, as that path ignores it in JAX.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from mjpeg423_tpu.codec.encoder import (
    _resolve_entropy_encode,
    _rgb_to_blocked_planes,
    encode_quantized_frames,
)
from mjpeg423_tpu.utils.config import EncodeConfig
from mjpeg423_tpu.utils.profile import default_profiler

from ..ops import encode_fused, resolve_device

# Seconds the overlapped encoder waits for its producer thread to stop once
# the encode has ended or failed.  A producer still alive after that is
# left behind (it is a daemon thread) with a RuntimeWarning.
PRODUCER_JOIN_TIMEOUT_S = 30.0


def _pack_q3(q3: torch.Tensor):
    """fetch_i8's narrowing, on q3's device: (3, W, B, 64) int16 ->
    (dc (3, W, B) int16, ac8 (3, W, B, 64) int8 with coefficient 0 zeroed,
    over: a 0-dim bool that is True when an AC value leaves int8)."""
    dc = q3[..., 0].contiguous()
    ac8 = q3.to(torch.int8)
    ac8[..., 0] = 0
    ac = q3[..., 1:]
    over = ((ac > 127) | (ac < -128)).any()
    return dc, ac8, over


def _frame_into(q3_out: np.ndarray, fetched, j: int) -> None:
    """Copy frame j of a fetched window into a ping-pong buffer, widening
    the narrowed format exactly when it was used."""
    if fetched[0] == "i8":
        _, dc, ac8 = fetched
        np.copyto(q3_out, ac8[:, j], casting="unsafe")
        q3_out[..., 0] = dc[:, j]
    else:
        np.copyto(q3_out, fetched[1][:, j])


def _encode_frames_device_fused(
    frames_rgb, w, h, nf, max_i_interval, entropy_encode, config, dev,
    profiler=None,
) -> bytes:
    bh, bw = h // 8, w // 8
    nb = bh * bw
    W = max(1, min(int(config.frames_per_batch), nf))
    prof = profiler or default_profiler
    cuda = dev.type == "cuda"
    use_fetch_i8 = bool(config.fetch_i8)

    def new_stage() -> torch.Tensor:
        """A (3, W, nb, 64) uint8 host staging window, pinned for CUDA.
        Every window ships all W frames, so the kernel sees one shape;
        rows past a short last window's count are stale and ignored."""
        return torch.empty((3, W, nb, 64), dtype=torch.uint8, pin_memory=cuda)

    def convert(stage: np.ndarray, ws: int, count: int, scratch: dict):
        with prof.time("encode/convert"):
            for j in range(count):
                yb, cbb, crb = _rgb_to_blocked_planes(frames_rgb[ws + j], scratch)
                stage[0, j] = yb.reshape(nb, 64)
                stage[1, j] = cbb.reshape(nb, 64)
                stage[2, j] = crb.reshape(nb, 64)

    def dispatch(stage: torch.Tensor):
        """Transform one staged window on the current stream and post its
        copy back.  Returns the payload (done, host, q3): done is the CUDA
        event after the D2H (None on the CPU), host the landing tensors and
        q3 the device planes, kept for fetch_i8's whole-window fetch."""
        q3 = encode_fused.encode_window_fused(
            stage.to(dev, non_blocking=True), blocks_h=bh, blocks_w=bw
        )
        outs = _pack_q3(q3) if use_fetch_i8 else (q3,)
        keep = q3 if use_fetch_i8 else None
        if not cuda:
            return None, outs, keep
        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs
        )
        for dst, src in zip(host, outs):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return done, host, keep

    def fetch(payload):
        """Wait for a window and return ('full', q3w) or ('i8', dc, ac8)
        as host arrays.  The overflow flag is read here, by the consumer,
        so the producer never waits on the device."""
        done, host, q3 = payload
        if done is not None:
            done.synchronize()
        if not use_fetch_i8:
            return ("full", host[0].numpy())
        dc, ac8, over = host
        if bool(over):
            return ("full", q3.cpu().numpy())
        return ("i8", dc.numpy(), ac8.numpy())

    def quantized_sequential():
        scratch: dict = {}
        stage = new_stage()
        # The packer reads one frame back (P candidate), so frames go out
        # through a ping-ponged pair of contiguous planes.
        q3_pair = [np.empty((3, nb, 64), np.int16) for _ in range(2)]
        fi = 0
        for ws in range(0, nf, W):
            count = min(W, nf - ws)
            convert(stage.numpy(), ws, count, scratch)
            with prof.time("encode/device_transform"):
                fetched = fetch(dispatch(stage))
            for j in range(count):
                q3 = q3_pair[fi % 2]
                _frame_into(q3, fetched, j)
                fi += 1
                yield q3

    def quantized_overlapped():
        class _StageError:
            def __init__(self, exc):
                self.exc = exc

        inflight = max(1, int(config.inflight_windows))
        # Staging slots: a slot goes back to the pool once the consumer has
        # waited for its window's event, which follows the slot's H2D on
        # the producer's stream.  inflight+1 slots keep the producer
        # converting while `inflight` windows are in flight.
        slot_pool: queue.Queue = queue.Queue()
        for _ in range(inflight + 1):
            slot_pool.put(new_stage())
        out_q: queue.Queue = queue.Queue(maxsize=inflight)
        stop = threading.Event()

        def _put_or_drop(item) -> bool:
            while True:
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        def producer():
            err: BaseException | None = None
            try:
                # The current device and stream are per thread.
                if cuda:
                    torch.cuda.set_device(dev)
                    on_stream = torch.cuda.stream(torch.cuda.Stream(dev))
                else:
                    on_stream = contextlib.nullcontext()
                scratch: dict = {}
                with on_stream:
                    for ws in range(0, nf, W):
                        count = min(W, nf - ws)
                        while True:
                            try:
                                stage = slot_pool.get(timeout=0.1)
                                break
                            except queue.Empty:
                                if stop.is_set():
                                    return
                        convert(stage.numpy(), ws, count, scratch)
                        with prof.time("encode/device_dispatch"):
                            payload = dispatch(stage)
                        if not _put_or_drop((count, stage, payload)):
                            return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                err = e
            finally:
                _put_or_drop(_StageError(err) if err is not None else None)

        t = threading.Thread(
            target=producer, daemon=True, name="mj-encode-producer"
        )
        t.start()
        q3_pair = [np.empty((3, nb, 64), np.int16) for _ in range(2)]
        fi = 0
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, _StageError):
                    raise item.exc
                count, stage, payload = item
                with prof.time("encode/device_fetch"):
                    fetched = fetch(payload)
                slot_pool.put(stage)
                for j in range(count):
                    q3 = q3_pair[fi % 2]
                    _frame_into(q3, fetched, j)
                    fi += 1
                    yield q3
        finally:
            stop.set()
            t.join(timeout=PRODUCER_JOIN_TIMEOUT_S)
            if t.is_alive():
                warnings.warn(
                    f"the encode producer thread {t.name!r} was still running "
                    f"{PRODUCER_JOIN_TIMEOUT_S} s after the encode ended; it "
                    "is left behind as a daemon thread",
                    RuntimeWarning, stacklevel=2,
                )

    gen = (quantized_overlapped if config.overlap_device
           else quantized_sequential)()
    try:
        return encode_quantized_frames(
            gen, w, h, max_i_interval, entropy_encode, config,
            profiler=profiler,
        )
    finally:
        # Stop the producer now, also when the packer raised (the
        # exception's traceback would otherwise keep the generator open).
        gen.close()


def encode_frames_device(
    frames_rgb: Sequence[np.ndarray],
    max_i_interval: int | None = None,
    entropy_encode: Callable[[np.ndarray], bytes] | None = None,
    parallel_entropy: bool = True,
    config: EncodeConfig | None = None,
    mesh=None,
    use_pallas: bool | None = None,
    profiler=None,
    device="cuda",
) -> bytes:
    """Byte-identical to encode_frames, with FDCT + quantize on `device`.

    The signature of mjpeg423_tpu's encode_frames_device plus `device`:
    "cuda" (the default) runs the hand-written kernel and raises
    RuntimeError when torch sees no CUDA device; "cpu" runs the plain
    PyTorch version and must be asked for by name.  use_pallas, when given,
    must agree with the device (True exactly on CUDA).  parallel_entropy is
    accepted and ignored (the select-then-pack back half packs one frame
    at a time); mesh= raises NotImplementedError until the multi-device
    port.
    """
    if mesh is not None:
        raise NotImplementedError("mesh-sharded encode is not ported yet")
    dev = resolve_device(device, use_pallas)
    config = config or EncodeConfig()
    if max_i_interval is None:
        max_i_interval = config.max_i_interval
    entropy_encode = _resolve_entropy_encode(entropy_encode, config)
    first = np.asarray(frames_rgb[0])
    h, w = first.shape[:2]
    if h % 8 or w % 8:
        raise ValueError(f"dimensions must be multiples of 8, got {w}x{h}")
    return _encode_frames_device_fused(
        frames_rgb, w, h, len(frames_rgb), max_i_interval, entropy_encode,
        config, dev, profiler=profiler,
    )
