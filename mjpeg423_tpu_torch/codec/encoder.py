"""The encoder: the host half, then encode_frames_device on a torch device.

Host half (down to LiveEncoder): copied from mjpeg423_tpu/codec/encoder.py
lines 1-481 at commit bfc8537: _resolve_entropy_encode,
_rgb_to_blocked_planes, FramePacker, encode_quantized_frames,
encode_frames, _Quantizer and LiveEncoder.  It generates byte-exact .MPG
containers with the reference encoder's pipeline and frame-type selection
(reference: encoder/mjpeg423_encoder.c:18-231): per frame, RGB -> YCbCr ->
FDCT -> quantize as I and (if not first) as P -> entropy-code both
candidates -> keep the smaller, forcing I at frame 0 and at least every
max_i_interval frames.  The previous frame's state is round(coef/quant)
whichever candidate wins.  It runs on NumPy and the native C codec only.

Device half (from PRODUCER_JOIN_TIMEOUT_S on): the counterpart of the
device half of mjpeg423_tpu/codec/encoder.py, with both of its structures;
use_pallas picks between them as there.

The fused select-then-pack path (_encode_frames_device_fused there and
here, the default): the host converts RGB to blocked YCbCr (float64,
bit-exact with the reference's doubles) and packs; the device runs FDCT +
quantize over windows of config.frames_per_batch frames
(ops/encode_fused.encode_window_fused: the CUDA kernel on a CUDA device, its
plain PyTorch version on the CPU).  The kernel returns ABSOLUTE quantized
planes, so the whole back half (candidate sizes, smaller-wins frame types,
container assembly) is the host half's encode_quantized_frames: the
containers are byte-identical to encode_frames by construction.
config.overlap_device (default True) runs a producer thread that converts,
stages and dispatches windows while the caller's thread fetches and packs
earlier ones, as in the JAX encoder.  On CUDA the staging windows are
pinned host buffers, the producer owns a CUDA stream on which each window's
H2D copy, kernel and D2H copy run without blocking, and a CUDA event per
window tells the consumer when its planes have landed.  config.fetch_i8
narrows each window on the device to an int16 DC and an int8 AC before the
copy back (a window whose AC leaves int8 is fetched whole as int16).

The candidate path (use_pallas=False, on the CPU or on the card; also
use_pallas=None on the CPU when the native packer is missing, whose
select-then-pack would be serial pure Python; on the card None is K4):
ops/encode.encode_transform computes both candidates of every frame on
the device, the I candidate (DC-differenced) and the P delta against
the previous frame, over windows of W + 1 staging
slots whose slot 0 is the previous window's last frame (the P halo).
Every candidate of every plane is entropy-coded, on a thread pool when
parallel_entropy (the native coder releases the GIL), and the smaller
wins on the host.  JAX runs this transform in XLA, outside any Pallas
kernel, so the port runs it in plain PyTorch on the card too.

mesh= (parallel.make_mesh) works with both: the fused path splits each
window's frames over the "data" axis, K4 on every shard with no exchange;
the candidate path stages the whole clip, as the JAX one does, and runs
parallel/encode.encode_transform_sharded (one halo copy a shard).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from ..core import tables as T
from ..core.format import (
    FILE_HEADER_BYTES,
    FRAME_HEADER_BYTES,
    PAD512,
    FileHeader,
    Frame,
    _U32x2,
    _U32x4,
    serialize_file,
)
from ..native import centropy
from ..ops import encode, encode_fused, encode_ref, entropy_ref, resolve_device
from ..ops.transform_ref import raster_to_blocks
from ..parallel.encode import PLANES, encode_transform_sharded, shard_samples
from ..parallel.mesh import DATA_AXIS, data_devices
from ..utils.config import EncodeConfig
from ..utils.profile import default_profiler


def _resolve_entropy_encode(
    entropy_encode: Callable[[np.ndarray], bytes] | None,
    config: EncodeConfig | None,
) -> Callable[[np.ndarray], bytes]:
    """Default bit-packer: the native C encoder (which itself falls back to
    the Python oracle when the shared library is unavailable) — the
    reference compiles its encoder into every app (core0 Makefile:145-164),
    so the fast path is the default here too."""
    if entropy_encode is not None:
        return entropy_encode
    if (config or EncodeConfig()).use_native_entropy:
        from ..native import centropy

        return centropy.encode_plane
    return entropy_ref.encode_plane


def _rgb_to_blocked_planes(
    rgb: np.ndarray, scratch: dict | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (y, cb, cr) blocked (B, 8, 8) uint8 planes.

    Native one-pass OpenMP conversion when available (bit-exact with the
    NumPy reference doubles — see centropy.c mj423_rgb_to_ycbcr_blocked);
    NumPy chain + blocking otherwise.  With scratch, the returned planes
    are reused (overwritten) by the next same-scratch call.
    """
    rgb = np.asarray(rgb, dtype=np.uint8)
    native = centropy.rgb_to_ycbcr_blocked(rgb, scratch)
    if native is not None:
        return native
    y, cb, cr = encode_ref.rgb_to_ycbcr_frame(rgb)
    return raster_to_blocks(y), raster_to_blocks(cb), raster_to_blocks(cr)


class FramePacker:
    """One-frame-at-a-time candidate coding + smaller-wins packing.

    The stateful back half of the encoder — quantize both candidates'
    entropy codings, pick the smaller (forcing I at frame 0 and at least
    every max_i_interval frames), emit the frame's final container bytes
    (reference: mjpeg423_encoder.c:154-201) — factored to a push-style
    object so the stored encoder (encode_quantized_frames) and the live
    encoder (LiveEncoder) share one implementation.

    State across calls: the previous frame's absolute quantized planes
    (ping-pong contract: the caller may reuse the array it passed, but only
    two calls later — pack() reads one frame back), the last I-frame
    index, and the native packer's scratch workspace.
    """

    def __init__(
        self,
        max_i_interval: int | None = None,
        entropy_encode: Callable[[np.ndarray], bytes] | None = None,
        config: EncodeConfig | None = None,
        exact_tail: bool = False,
        profiler=None,
        strict_range: bool = False,
    ):
        config = config or EncodeConfig()
        self._prof = profiler or default_profiler
        self.max_i_interval = (
            config.max_i_interval if max_i_interval is None else max_i_interval
        )
        entropy_encode = _resolve_entropy_encode(entropy_encode, config)
        self._use_native = (
            entropy_encode is centropy.encode_plane
            and centropy.native_available()
        )
        if exact_tail and not self._use_native:
            if entropy_encode not in (
                centropy.encode_plane, entropy_ref.encode_plane
            ):
                raise ValueError(
                    "exact_tail requires the default entropy packers"
                )
            # Python oracle with the exact-tail writer (bit-identical to
            # the native path; only the final partial byte differs from
            # quirk mode).
            def entropy_encode(c, _f=entropy_ref.encode_plane):
                return _f(c, exact_tail=True)
        self._entropy_encode = entropy_encode
        self._exact_tail = exact_tail
        self._strict_range = strict_range
        self._scratch: dict = {}
        self._prev_q3: np.ndarray | None = None
        self._last_iframe = 0
        self._fi = 0

    def _raise_clamped(self):
        raise ValueError(
            f"frame {self._fi}: values exceed the VLI 11-bit range "
            "(|v| > 2047) — the format clamps these (lossy); "
            "refusing strict_range encode"
        )

    def pack(self, q3: np.ndarray):
        """Pack one frame's absolute quantized planes (3, B, 64) int16.

        Returns (is_iframe, packed) where packed is the frame's complete
        container bytes — 16-byte header, winning candidate's three plane
        bitstreams, 4-byte alignment pad (a uint8 ndarray on the native
        path, bytes on the fallback; both buffer-protocol writable).
        """
        if self._use_native:
            out = self._pack_native(q3)
        else:
            out = self._pack_fallback(q3)
        self._prev_q3 = q3
        self._fi += 1
        return out

    def _pack_native(self, q3):
        # Select-then-pack with zero-copy frame assembly: exact candidate
        # byte sizes come from a size-only symbol scan (no bit writer), the
        # smaller-wins rule (mjpeg423_encoder.c:154-185) picks the frame
        # type from sizes alone, and only the winning candidate is packed —
        # directly into the frame's final container bytes (the tail-exact
        # bit appender never stores outside a plane's span, so the 16-byte
        # header and alignment pad written here are never clobbered).  The
        # losing pack, the per-plane blobs, and the serialize-time join all
        # disappear; sizes == pack lengths is enforced both by the packer
        # (RuntimeError) and tests/test_native.py.
        fi, prev_q3 = self._fi, self._prev_q3
        with self._prof.time("encode/sizes"):
            if self._strict_range:
                sizes, clamped = centropy.candidate_sizes(
                    q3, prev_q3, want_clamped=True
                )
            else:
                sizes = centropy.candidate_sizes(q3, prev_q3)
        size_i = sum(sizes[:3])
        size_p = sum(sizes[3:]) if prev_q3 is not None else None
        pick_i = (
            fi == 0
            or size_p is None
            or size_i <= size_p
            or fi - self._last_iframe >= self.max_i_interval
        )
        if self._strict_range and any(
            clamped[:3] if pick_i else clamped[3:]
        ):
            self._raise_clamped()
        psz = sizes[:3] if pick_i else sizes[3:]
        raw = FRAME_HEADER_BYTES + psz[0] + psz[1] + psz[2]
        frame_size = raw + (-raw) % 4
        buf = np.empty(frame_size, np.uint8)
        _U32x4.pack_into(
            buf, 0, frame_size,
            T.FRAME_TYPE_I if pick_i else T.FRAME_TYPE_P,
            psz[0], psz[1],
        )
        buf[raw:] = 0  # 4-byte alignment pad (encoder.c:187-201)
        offs = (
            FRAME_HEADER_BYTES,
            FRAME_HEADER_BYTES + psz[0],
            FRAME_HEADER_BYTES + psz[0] + psz[1],
        )
        with self._prof.time("encode/pack"):
            centropy.encode_candidates_into(
                q3, None if pick_i else prev_q3, buf, offs, psz,
                self._scratch, self._exact_tail, which=1 if pick_i else 2,
            )
        if pick_i:
            self._last_iframe = fi
        return pick_i, buf

    def _pack_fallback(self, q3):
        fi, prev_q3 = self._fi, self._prev_q3
        entropy_encode = self._entropy_encode
        bits_i: dict[str, bytes] = {}
        bits_p: dict[str, bytes | None] = {}
        clamp_i = clamp_p = False
        for i, name in enumerate(("y", "cb", "cr")):
            # Difference once; the clamp test and the entropy pack share
            # the same tensors (recomputing them doubled the dominant
            # numpy work of this fallback path).
            di = encode_ref.diff_dc_i(q3[i])
            dp = (
                encode_ref.diff_p(q3[i], prev_q3[i])
                if prev_q3 is not None else None
            )
            if self._strict_range:
                clamp_i = clamp_i or int(np.abs(di).max(initial=0)) > 2047
                if dp is not None:
                    clamp_p = clamp_p or int(np.abs(dp).max(initial=0)) > 2047
            bits_i[name] = entropy_encode(di)
            bits_p[name] = entropy_encode(dp) if dp is not None else None

        size_i = sum(len(b) for b in bits_i.values())
        size_p = (
            sum(len(b) for b in bits_p.values() if b is not None)
            if prev_q3 is not None
            else None
        )
        # Frame-type selection (reference: mjpeg423_encoder.c:155-157)
        pick_i = (
            fi == 0
            or size_p is None
            or size_i <= size_p
            or fi - self._last_iframe >= self.max_i_interval
        )
        if self._strict_range and (clamp_i if pick_i else clamp_p):
            self._raise_clamped()
        if pick_i:
            self._last_iframe = fi
            fr = Frame(
                T.FRAME_TYPE_I, bits_i["y"], bits_i["cb"], bits_i["cr"]
            )
        else:
            fr = Frame(
                T.FRAME_TYPE_P, bits_p["y"], bits_p["cb"], bits_p["cr"]  # type: ignore[arg-type]
            )
        return pick_i, fr.pack()


def encode_quantized_frames(
    q3_frames,
    width: int,
    height: int,
    max_i_interval: int | None = None,
    entropy_encode: Callable[[np.ndarray], bytes] | None = None,
    config: EncodeConfig | None = None,
    exact_tail: bool = False,
    profiler=None,
    strict_range: bool = False,
) -> bytes:
    """Pack absolute quantized planes into an .MPG container.

    q3_frames: iterable of (3, B, 64) int16 arrays — per frame the ABSOLUTE
    quantized Y/Cb/Cr planes (natural order, absolute per-block DC), i.e.
    exactly the encoder's round(coef/quant) state.  This is the shared back
    half of the encoder (candidate coding + smaller-wins frame-type
    selection, reference mjpeg423_encoder.c:154-185); encode_frames feeds
    it from RGB via FDCT, codec/transcode.py feeds it from an existing
    stream's entropy-parsed amplitude state (lossless re-GOP).

    A yielded array may be reused (ping-ponged) by the producer: only the
    immediately previous frame is read back, never older ones.

    exact_tail: write each plane's true final partial byte instead of the
    reference encoder's 0x00 output_rest quirk (which silently drops up to
    7 tail bits when the last block is dense).  Only valid with the default
    packers; the transcoder passes True so re-GOP stays lossless on ALL
    content.

    strict_range: raise ValueError if any value of the CHOSEN candidate
    exceeds the VLI's 11-bit range (|v| > 2047) — the format clamps such
    values (reference encode_VLI, lossless_encode.c:121-138), which is
    lossy.  Unreachable from the RGB encoder on valid input; the
    transcoder passes True so a corrupt/extreme source stream fails
    loudly instead of silently re-GOPping to different pixels.
    """
    packer = FramePacker(
        max_i_interval, entropy_encode, config, exact_tail, profiler,
        strict_range,
    )
    chunks: list = []
    trailer: list[tuple[int, int]] = []
    pos = FILE_HEADER_BYTES
    nf = 0
    for fi, q3 in enumerate(q3_frames):
        nf = fi + 1
        is_i, packed = packer.pack(q3)
        if is_i:
            trailer.append((fi, pos))
        chunks.append(packed)
        pos += len(packed)
    header = FileHeader(
        nf, width, height, len(trailer), pos - FILE_HEADER_BYTES
    ).pack()
    tr = b"".join(_U32x2.pack(i, p) for i, p in trailer)
    return b"".join([header, *chunks, tr, b"\x00" * PAD512])


def encode_frames(
    frames_rgb: Sequence[np.ndarray],
    max_i_interval: int | None = None,
    entropy_encode: Callable[[np.ndarray], bytes] | None = None,
    config: EncodeConfig | None = None,
    profiler=None,
) -> bytes:
    """Encode RGB frames into an .MPG container byte string.

    frames_rgb: sequence of (H, W, 3) uint8 arrays (R, G, B channel order).
    max_i_interval: force an I-frame at least this often
    (reference: mjpeg423_encoder.c:154-157 selection rule); defaults from
    config (24, the reference's MAX_IFRAME_OFFSET).
    entropy_encode: plane bit-packer override; the default is the native C
    encoder (byte-identical to the Python oracle).
    """
    first = np.asarray(frames_rgb[0])
    h, w = first.shape[:2]
    if h % 8 or w % 8:
        raise ValueError(f"dimensions must be multiples of 8, got {w}x{h}")

    def quantized():
        qz = _Quantizer(profiler)
        for rgb in frames_rgb:
            yield qz.quantize(rgb)

    return encode_quantized_frames(
        quantized(), w, h, max_i_interval, entropy_encode, config,
        profiler=profiler,
    )


class _Quantizer:
    """RGB -> absolute quantized planes, one frame at a time.

    One workspace for the whole encode: fresh multi-MB buffers per frame
    were measured 25-100x slower than reuse on this host (first-touch page
    faults + THP compaction stalls).  q3 ping-pongs over two buffers
    because the P-candidate reads the previous frame's planes (the
    FramePacker / encode_quantized_frames contract — the reference's
    prev/next DCACq buffer swap, mjpeg423_encoder.c:154-185).
    """

    def __init__(self, profiler=None):
        self._prof = profiler or default_profiler
        self._scratch: dict = {}
        self._pair: list[np.ndarray | None] = [None, None]
        self._fi = 0

    def quantize(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (3, B, 64) int16 absolute quantized
        planes.  The returned array is overwritten two calls later."""
        with self._prof.time("encode/convert"):
            yb, cbb, crb = _rgb_to_blocked_planes(rgb, self._scratch)
        nb = yb.shape[0]
        q3 = self._pair[self._fi % 2]
        if q3 is None or q3.shape != (3, nb, 64):
            q3 = np.empty((3, nb, 64), dtype=np.int16)
            self._pair[self._fi % 2] = q3
        with self._prof.time("encode/fdct"):
            for i, (blocks, quant) in enumerate((
                (yb, T.YQUANT64), (cbb, T.CQUANT64), (crb, T.CQUANT64)
            )):
                q = centropy.fdct_quant_blocks(blocks, quant, out=q3[i])
                if q is None:  # NumPy oracle fallback
                    coefs = encode_ref.fdct_blocks(blocks).reshape(-1, 64)
                    q3[i] = encode_ref.quantize_blocks(coefs, quant)
        self._fi += 1
        return q3


class LiveEncoder:
    """Encode RGB frames into a byte sink as they arrive (live producer).

    Writes the open-ended live header (num_frames = 0 sentinel, no trailer
    — the runtime/live.py stream contract), then one complete container
    frame per write_frame call, straight to the sink: a camera / screen
    producer feeds any number of live consumers with O(1 frame) memory.

    If the sink is seekable, finalize() appends the I-frame trailer + the
    512-byte pad and back-patches the header — exactly the reference
    encoder's end-of-encode fixup (reference: mjpeg423_encoder.c:204-225)
    — turning the feed into a stored container byte-identical to
    encode_frames() of the same input.  For pure streams (pipes/sockets)
    finalize() is a no-op returning False; EOF at the frame boundary is
    the end-of-stream marker.
    """

    def __init__(
        self,
        out,
        width: int,
        height: int,
        max_i_interval: int | None = None,
        entropy_encode: Callable[[np.ndarray], bytes] | None = None,
        config: EncodeConfig | None = None,
        profiler=None,
    ):
        if not width or not height or width % 8 or height % 8:
            raise ValueError(
                f"dimensions must be multiples of 8, got {width}x{height}"
            )
        self._out = out
        self.width = width
        self.height = height
        self._quant = _Quantizer(profiler)
        self._packer = FramePacker(
            max_i_interval, entropy_encode, config, profiler=profiler
        )
        self._pos = FILE_HEADER_BYTES
        self._trailer: list[tuple[int, int]] = []
        self.frames_written = 0
        self._finalized = False
        self._did_patch = False
        # The header's sink offset — finalize() must patch where the
        # header actually landed, not offset 0 (the sink may hold prior
        # content).  Trailer frame_positions stay container-relative
        # (frame_position is an offset within the container per the
        # format, mjpeg423_encoder.c:204-207).
        try:
            self._base = out.tell() if out.seekable() else 0
        except (AttributeError, OSError):
            self._base = 0
        out.write(FileHeader(0, width, height, 0, 0).pack())

    def write_frame(self, rgb: np.ndarray) -> None:
        """Encode and emit one (H, W, 3) uint8 RGB frame."""
        if self._finalized:
            raise ValueError("LiveEncoder already finalized")
        rgb = np.asarray(rgb, dtype=np.uint8)
        if rgb.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"frame is {rgb.shape[1]}x{rgb.shape[0]}, feed is "
                f"{self.width}x{self.height}"
            )
        is_i, packed = self._packer.pack(self._quant.quantize(rgb))
        if is_i:
            self._trailer.append((self.frames_written, self._pos))
        self._out.write(packed)
        self._pos += len(packed)
        self.frames_written += 1

    def finalize(self) -> bool:
        """Seekable sinks: write trailer + pad, back-patch the header
        (the stored-container fixup).  Returns True if patched.
        Idempotent — repeat calls return the first result unchanged."""
        if self._finalized:
            return self._did_patch
        self._finalized = True
        if not getattr(self._out, "seekable", lambda: False)():
            return False
        out = self._out
        out.write(b"".join(_U32x2.pack(i, p) for i, p in self._trailer))
        out.write(b"\x00" * PAD512)
        out.seek(self._base)
        out.write(FileHeader(
            self.frames_written, self.width, self.height,
            len(self._trailer), self._pos - FILE_HEADER_BYTES,
        ).pack())
        out.seek(0, 2)
        self._did_patch = True
        return True


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
    elif fetched[0] == "shards":  # (shards, 3, W / shards, B, 64)
        q3s = fetched[1]
        np.copyto(q3_out, q3s[j // q3s.shape[2], :, j % q3s.shape[2]])
    else:
        np.copyto(q3_out, fetched[1][:, j])


def _on_stream(dev: torch.device, streams: dict | None):
    """dev current, on streams[dev] when given (else its current stream);
    nothing on the CPU."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.cuda.device(dev))
    if streams is not None:
        ctx.enter_context(torch.cuda.stream(streams[dev]))
    return ctx


def _encode_frames_device_fused(
    frames_rgb, w, h, nf, max_i_interval, entropy_encode, config, devs,
    profiler=None,
) -> bytes:
    """The device half of encode_frames_device over `devs`: one device, or
    the data shards of a mesh, each transforming its slice of every
    window."""
    bh, bw = h // 8, w // 8
    nb = bh * bw
    n_shards = len(devs)
    W = max(1, min(int(config.frames_per_batch), nf))
    W = max(W, n_shards) // n_shards * n_shards  # window divisible by shards
    wd = W // n_shards
    prof = profiler or default_profiler
    cuda = devs[0].type == "cuda"
    use_fetch_i8 = bool(config.fetch_i8) and n_shards == 1

    def new_stage() -> torch.Tensor:
        """A (shards, 3, W / shards, nb, 64) uint8 host staging window,
        pinned for CUDA: shard d's frames are stage[d], contiguous.  Every
        window ships all W frames, so the kernel sees one shape; rows past
        a short last window's count are stale and ignored."""
        return torch.empty((n_shards, 3, wd, nb, 64), dtype=torch.uint8,
                           pin_memory=cuda)

    def convert(stage: np.ndarray, ws: int, count: int, scratch: dict):
        with prof.time("encode/convert"):
            for j in range(count):
                yb, cbb, crb = _rgb_to_blocked_planes(frames_rgb[ws + j], scratch)
                shard = stage[j // wd]
                shard[0, j % wd] = yb.reshape(nb, 64)
                shard[1, j % wd] = cbb.reshape(nb, 64)
                shard[2, j % wd] = crb.reshape(nb, 64)

    def dispatch(stage: torch.Tensor, streams: dict | None = None):
        """Transform one staged window, each shard on its device (on
        streams[device] when given, else that device's current stream), and
        post the copies back into its slice of one landing tensor.  Returns
        the payload (events, host, q3): the CUDA event after each shard's
        D2H (none on the CPU), the landing tensors and, for fetch_i8's
        whole-window fetch, the device planes."""
        if use_fetch_i8:
            with _on_stream(devs[0], streams):
                q3 = encode_fused.encode_window_fused(
                    stage[0].to(devs[0], non_blocking=True),
                    blocks_h=bh, blocks_w=bw,
                )
                outs = _pack_q3(q3)
                if not cuda:
                    return [], outs, q3
                host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True) for t in outs)
                for dst, src in zip(host, outs):
                    dst.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                return [done], host, q3
        host = torch.empty(stage.shape, dtype=torch.int16, pin_memory=cuda)
        events = []
        for d, dev in enumerate(devs):
            with _on_stream(dev, streams):
                q3 = encode_fused.encode_window_fused(
                    stage[d].to(dev, non_blocking=True),
                    blocks_h=bh, blocks_w=bw,
                )
                host[d].copy_(q3, non_blocking=cuda)
                if cuda:
                    events.append(torch.cuda.Event())
                    events[-1].record()
        return events, (host,), None

    def fetch(payload):
        """Wait for a window and return ('shards', q3s) or ('i8', dc, ac8)
        (or, when an AC value left int8, ('full', q3w)) as host arrays.
        The overflow flag is read here, by the consumer, so the producer
        never waits on the device."""
        events, host, q3 = payload
        for done in events:
            done.synchronize()
        if not use_fetch_i8:
            return ("shards", host[0].numpy())
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
                # A stream of the producer's own on each card it uses.
                streams = ({dev: torch.cuda.Stream(dev)
                            for dev in dict.fromkeys(devs)} if cuda else None)
                scratch: dict = {}
                for ws in range(0, nf, W):
                    count = min(W, nf - ws)
                    with prof.time("encode/slot_wait"):
                        while True:
                            try:
                                stage = slot_pool.get(timeout=0.1)
                                break
                            except queue.Empty:
                                if stop.is_set():
                                    return
                    convert(stage.numpy(), ws, count, scratch)
                    with prof.time("encode/device_dispatch"):
                        payload = dispatch(stage, streams)
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
                with prof.time("encode/queue_wait"):
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


def _candidate_windows(frames_rgb, nb, nf, W, dev, prof):
    """The candidate path's device half on one device: (first frame,
    count, I candidates, P candidates) a window, as host arrays keyed by
    plane.  I row k + 1 is frame first + k; P row k is frame first + k
    against its predecessor (row 0 of the first window is frame 0 against
    the zero halo, which the caller skips)."""
    cuda = dev.type == "cuda"
    # (plane, W + 1, B, 8, 8): slot 0 is the halo, the previous window's
    # last frame; one copy to the device a window.
    stage = torch.zeros((3, W + 1, nb, 8, 8), dtype=torch.uint8,
                        pin_memory=cuda)
    host = stage.numpy()
    scratch: dict = {}
    for ws in range(0, nf, W):
        count = min(W, nf - ws)
        with prof.time("encode/convert"):
            for k in range(count):
                planes = _rgb_to_blocked_planes(frames_rgb[ws + k], scratch)
                for p, blk in enumerate(planes):
                    np.copyto(host[p, k + 1], blk)
        with prof.time("encode/device_transform"):
            on_dev = stage.to(dev, non_blocking=True)
            ci, cp = encode.encode_transform(*on_dev)
            # .cpu() waits for the device, so the stage is free again.
            ci = {n: v.cpu().numpy() for n, v in ci.items()}
            cp = {n: v.cpu().numpy() for n, v in cp.items()}
        yield ws, count, ci, cp
        stage[:, 0].copy_(stage[:, count])  # halo for the next window


def _encode_frames_device_candidates(
    frames_rgb, w, h, nf, max_i_interval, entropy_encode, parallel_entropy,
    config, devs, mesh=None, profiler=None,
) -> bytes:
    """The candidate path: both candidates of every frame and plane from
    the device, entropy-coded (threaded when parallel_entropy), the
    smaller kept (mjpeg423_tpu/codec/encoder.py:812-945)."""
    prof = profiler or default_profiler
    nb = (h // 8) * (w // 8)
    bits_i: dict = {}
    bits_p: dict = {}
    ex = None
    if parallel_entropy:
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor()

    def pack(jobs, planes_of):
        """Entropy-code (frame, plane) jobs; planes_of(frame, plane) is
        the (B, 64) int16 candidate."""
        def one(job):
            return entropy_encode(planes_of(*job))

        with prof.time("encode/pack"):
            return list(zip(jobs, ex.map(one, jobs) if ex is not None
                            else map(one, jobs)))

    try:
        if mesh is None:
            W = max(1, min(int(config.frames_per_batch), nf))
            for ws, count, ci, cp in _candidate_windows(
                    frames_rgb, nb, nf, W, devs[0], prof):
                frames = range(ws, ws + count)
                bits_i.update(pack(
                    [(fi, n) for fi in frames for n in PLANES],
                    lambda fi, n: ci[n][fi - ws + 1]))
                bits_p.update(pack(
                    [(fi, n) for fi in frames if fi > 0 for n in PLANES],
                    lambda fi, n: cp[n][fi - ws]))
        else:
            # The whole clip, padded to a multiple of the data axis.
            n_pad = -(-nf // mesh.shape[DATA_AXIS]) * mesh.shape[DATA_AXIS]
            host = np.zeros((3, n_pad, nb, 8, 8), np.uint8)
            with prof.time("encode/convert"):
                for fi, rgb in enumerate(frames_rgb):
                    for p, blk in enumerate(_rgb_to_blocked_planes(rgb)):
                        host[p, fi] = blk
            with prof.time("encode/device_transform"):
                cand_i, cand_p = encode_transform_sharded(
                    *shard_samples(mesh, *host), mesh=mesh)
                # cand_p is frame-indexed: row 0 is meaningless.
                ci = {n: v.numpy()[:nf] for n, v in cand_i.items()}
                cp = {n: v.numpy()[:nf] for n, v in cand_p.items()}
            bits_i.update(pack(
                [(fi, n) for fi in range(nf) for n in PLANES],
                lambda fi, n: ci[n][fi]))
            bits_p.update(pack(
                [(fi, n) for fi in range(1, nf) for n in PLANES],
                lambda fi, n: cp[n][fi]))
    finally:
        if ex is not None:
            ex.shutdown()

    out_frames: list[Frame] = []
    last_iframe = 0
    for fi in range(nf):
        size_i = sum(len(bits_i[(fi, n)]) for n in PLANES)
        pick_i = (
            fi == 0
            or size_i <= sum(len(bits_p[(fi, n)]) for n in PLANES)
            or fi - last_iframe >= max_i_interval
        )
        src = bits_i if pick_i else bits_p
        if pick_i:
            last_iframe = fi
        out_frames.append(Frame(
            T.FRAME_TYPE_I if pick_i else T.FRAME_TYPE_P,
            *(src[(fi, n)] for n in PLANES),
        ))
    return serialize_file(w, h, out_frames)


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
    "cuda" (the default) runs on the current card and raises RuntimeError
    when torch sees no CUDA device; "cpu" must be asked for by name.

    use_pallas picks the structure, as in the JAX encoder, and keeps its
    meaning of "the hand-written kernel": None (default) is the fused
    select-then-pack path (K4 on CUDA, its plain version on the CPU; on
    the CPU without the native packer, the candidate path); True is the
    fused path and must have CUDA devices; False is the candidate path,
    on the CPU or on the card (the plain PyTorch transform, as JAX's is
    XLA).  parallel_entropy spreads the candidate path's entropy coding
    over a thread pool; the fused path packs one frame at a time and
    ignores it.

    mesh= (parallel.make_mesh): the mesh's devices take the place of
    `device`, all CUDA or all CPU.  The fused path splits each window's
    frames over the "data" axis, every data shard running K4 on its slice
    on its own device with no exchange (the split of
    parallel/encode.encode_window_fused_sharded), so the window is rounded
    down to a multiple of the data-axis size, and fetch_i8 is off.  The
    candidate path stages the whole clip and runs
    parallel/encode.encode_transform_sharded.
    """
    kernel = True if use_pallas else None  # False runs on either device
    devs = ([resolve_device(device, kernel)] if mesh is None
            else data_devices(mesh, kernel))
    config = config or EncodeConfig()
    if max_i_interval is None:
        max_i_interval = config.max_i_interval
    entropy_encode = _resolve_entropy_encode(entropy_encode, config)
    first = np.asarray(frames_rgb[0])
    h, w = first.shape[:2]
    if h % 8 or w % 8:
        raise ValueError(f"dimensions must be multiples of 8, got {w}x{h}")
    if use_pallas is None:
        # On the card the default is K4.  On the CPU the fused path's back
        # half packs through the native coder; without it that is serial
        # pure Python, so take the threaded candidates there, as JAX does.
        use_pallas = devs[0].type == "cuda" or centropy.native_available()
    if not use_pallas:
        return _encode_frames_device_candidates(
            frames_rgb, w, h, len(frames_rgb), max_i_interval,
            entropy_encode, parallel_entropy, config, devs, mesh=mesh,
            profiler=profiler,
        )
    return _encode_frames_device_fused(
        frames_rgb, w, h, len(frames_rgb), max_i_interval, entropy_encode,
        config, devs, profiler=profiler,
    )
