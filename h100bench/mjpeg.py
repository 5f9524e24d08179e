"""The benchmark's own MJPEG423 codec in plain PyTorch: the reference that
decides `correct`, and the frozen encoder that makes the decode cells'
containers.

Written from the format (the reference C codec's encoder/ and decoder/
sources, as the port's docstrings cite them); the tables are copied from
mjpeg423_tpu_torch/core/tables.py at commit 22cff87.  It imports nothing of
the program, so a change to the program moves neither the decode cells'
inputs nor the answers they are held to.

Every step is vectorised over frames and blocks and runs on any torch
device: the integer transforms (LL&M FDCT, islow IDCT, 14-bit colour) are
exact on both, and the float64 steps (RGB -> YCbCr, quantize) are single
IEEE operations in the reference C code's order.  The entropy coder builds
one token per symbol and scatters bits; the entropy decoder finds every
block's start without a serial walk: the block that would start at each bit
position is decoded for all positions at once (`_block_ends`), and the real
starts follow by pointer doubling from bit 0 (`_block_starts`).

`precision` selects the arithmetic of the float steps (`torch.float64`,
as the format states) and, for the decoder, of the IDCT and colour
conversion ("int", as the format states): the benchmark's control runs the
same code with float32, the step below.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

# --- Tables (copied from mjpeg423_tpu_torch/core/tables.py) ----------------
YQUANT64 = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
)
CQUANT64 = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
) + (99,) * 32
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63,
)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
COLOR_SHIFT, C_CR_R, C_CR_G, C_CB_G, C_CB_B = 14, 22970, 11700, 5638, 29032

FILE_HEADER = struct.Struct("<5I")
FRAME_HEADER = struct.Struct("<4I")
PAD512 = 512
_ZRL = (0, 0xF0, 0xF0F0, 0xF0F0F0)  # 0..3 ZRL symbols (a run of <= 62)


def _quant(plane: int, device) -> torch.Tensor:
    return torch.tensor(YQUANT64 if plane == 0 else CQUANT64,
                        dtype=torch.int32, device=device)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int16 modular wrap (the reference's DCTELEM stores)."""
    return (((x.to(torch.int64) + 32768) & 0xFFFF) - 32768).to(torch.int16)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


# --- Encoder: colour, FDCT, quantize -----------------------------------------

def rgb_to_ycbcr(rgb: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(..., H, W, 3) uint8 RGB -> (..., 3, H, W) uint8 YCbCr, the reference
    encoder's doubles (rgb_to_ycbcr.c:58-70) truncated toward zero."""
    r, g, b = (rgb[..., i].to(dtype) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return torch.stack([torch.floor(v) for v in (y, cb, cr)], -3).to(torch.uint8)


def raster_to_blocks(planes: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/8 * W/8, 8, 8), blocks row-major."""
    *lead, h, w = planes.shape
    x = planes.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def blocks_to_raster(blocks: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """(..., bh*bw, 8, 8) -> (..., 8*bh, 8*bw)."""
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, bh, bw, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, bh * 8, bw * 8)


def _fdct_1d(x, pass1: bool):
    """One LL&M forward butterfly (fdct.c:33-91 rows, :99-160 columns)."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if pass1:
        out0 = (tmp10 + tmp11) << PASS1_BITS
        out4 = (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out0 = _descale(tmp10 + tmp11, PASS1_BITS + 3)
        out4 = _descale(tmp10 - tmp11, PASS1_BITS + 3)
        n = CONST_BITS + PASS1_BITS + 3
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out2 = _descale(z1 + tmp13 * FIX_0_765366865, n)
    out6 = _descale(z1 + tmp12 * (-FIX_1_847759065), n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    return [out0, _descale(tmp7 + z1 + z4, n), out2,
            _descale(tmp6 + z2 + z3, n), out4,
            _descale(tmp5 + z2 + z4, n), out6,
            _descale(tmp4 + z1 + z3, n)]


def fdct(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) uint8 samples -> (..., 64) int16 coefficients (x8), the
    pass-1 results stored as int16 between passes (fdct.c:52-87)."""
    x = blocks.to(torch.int32)
    p1 = _fdct_1d([x[..., :, c] for c in range(8)], True)      # [u] (..., 8 rows)
    p1 = [_wrap16(v).to(torch.int32) for v in p1]
    p2 = _fdct_1d([torch.stack(p1, -1)[..., r, :] for r in range(8)], False)
    return _wrap16(torch.stack(p2, -2)).reshape(*blocks.shape[:-2], 64)


def quantize(coefs: torch.Tensor, plane: int, dtype=torch.float64):
    """round-half-away-from-zero(coef / quant) as int16 (quantize.c:16)."""
    q = torch.tensor(YQUANT64 if plane == 0 else CQUANT64, dtype=dtype,
                     device=coefs.device)
    x = coefs.to(dtype) / q
    return (torch.sign(x) * torch.floor(torch.abs(x) + 0.5)).to(torch.int64).to(torch.int16)


def quantized_planes(rgb: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(F, H, W, 3) uint8 -> (F, 3, B, 64) int16 absolute quantized planes."""
    blocks = raster_to_blocks(rgb_to_ycbcr(rgb, dtype))
    return torch.stack([quantize(fdct(blocks[:, p]), p, dtype)
                        for p in range(3)], 1)


# --- Entropy coder -------------------------------------------------------------

def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """VLI size of |v| capped at 11 (lossless_encode.c:121-138); 0 for 0."""
    a = torch.abs(v.to(torch.int32))
    s = torch.zeros_like(a)
    for b in range(11):
        s = s + (a >= (1 << b)).to(torch.int32)
    return s


def _vli(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    mask = (torch.ones_like(v) << s) - 1
    return torch.where(v > 0, v, v - 1) & mask


def tokens(c: torch.Tensor):
    """Entropy-coder tokens of differenced planes (..., B, 64) int16 natural
    order: (lengths, values), each (..., B, 65): column 0 the DC symbol,
    column k its zig-zag AC coefficient with its ZRLs, column 64 END."""
    zz = c[..., list(ZIGZAG)].to(torch.int32)
    dc, ac = zz[..., 0], zz[..., 1:]
    sd = _bitlen(dc)
    dc_len = 4 + sd
    dc_val = (sd.to(torch.int64) << sd) | _vli(dc, sd)
    nz = ac != 0
    k = torch.arange(1, 64, device=c.device, dtype=torch.int32)
    pos = torch.where(nz, k, torch.zeros_like(k))
    prev = torch.cummax(pos, -1).values
    prev = torch.cat([torch.zeros_like(prev[..., :1]), prev[..., :-1]], -1)
    run = k - prev - 1
    zrl, r = run // 16, run % 16
    s = _bitlen(ac)
    ac_len = torch.where(nz, 8 * zrl + 8 + s, torch.zeros_like(s))
    zrl_bits = torch.tensor(_ZRL, dtype=torch.int64, device=c.device)[zrl.clamp(0, 3)]
    ac_val = (((zrl_bits << 8) | ((r << 4) | s).to(torch.int64)) << s) | _vli(ac, s)
    ac_val = torch.where(nz, ac_val, torch.zeros_like(ac_val))
    end_len = torch.where(nz[..., -1], 0, 8).to(torch.int32)
    lens = torch.cat([dc_len[..., None], ac_len, end_len[..., None]], -1)
    vals = torch.cat([dc_val[..., None], ac_val, torch.zeros_like(dc_val)[..., None]], -1)
    return lens, vals


def plane_bytes(c: torch.Tensor) -> torch.Tensor:
    """Byte size of each plane's bitstream, (...,) int64: ceil(bits / 8)
    (the final partial byte is written, as 0x00)."""
    lens, _ = tokens(c)
    return (lens.sum((-1, -2), dtype=torch.int64) + 7) // 8


def pack_planes(c: torch.Tensor) -> list[bytes]:
    """Entropy-code planes (N, B, 64) int16 into N bitstreams: MSB-first,
    a final partial byte written as 0x00 (the reference's output_rest)."""
    return pack_tokens(*tokens(c))


def pack_tokens(lens: torch.Tensor, vals: torch.Tensor) -> list[bytes]:
    """`pack_planes` from the planes' `tokens`, (N, B, 65) each."""
    n = lens.shape[0]
    lens, vals = lens.reshape(n, -1), vals.reshape(n, -1)
    dev = lens.device
    bits = lens.sum(1, dtype=torch.int64)
    nbytes = (bits + 7) // 8
    base = torch.cumsum(nbytes, 0) - nbytes                  # plane's first byte
    keep = lens > 0
    plane = torch.arange(n, device=dev)[:, None].expand_as(lens)[keep]
    tl, tv = lens[keep].to(torch.int64), vals[keep]
    tstart = torch.cumsum(tl, 0) - tl                        # in the concatenation
    first = torch.cumsum(bits, 0) - bits
    tstart = tstart - first[plane] + 8 * base[plane]
    tok = torch.repeat_interleave(torch.arange(tl.numel(), device=dev), tl)
    off = torch.arange(tok.numel(), device=dev) - (torch.cumsum(tl, 0) - tl)[tok]
    bit = (tv[tok] >> (tl[tok] - 1 - off)) & 1
    total = int(nbytes.sum())
    buf = torch.zeros(total * 8, dtype=torch.uint8, device=dev)
    buf[tstart[tok] + off] = bit.to(torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=dev)
    out = (buf.reshape(-1, 8).to(torch.int32) * weights).sum(1).to(torch.uint8)
    partial = (bits % 8) != 0
    out[(base + bits // 8)[partial]] = 0                     # output_rest quirk
    host = out.cpu().numpy().tobytes()
    b, e = base.tolist(), (base + nbytes).tolist()
    return [host[i:j] for i, j in zip(b, e)]


def diff_i(q: torch.Tensor) -> torch.Tensor:
    """I candidate: DC minus the previous block's DC (quantize.c:18-25)."""
    out = q.clone()
    out[..., 1:, 0] = _wrap16(q[..., 1:, 0].to(torch.int32) - q[..., :-1, 0])
    return out


def diff_p(q: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """P candidate: every coefficient minus the previous frame's (:33-42)."""
    return _wrap16(q.to(torch.int32) - prev.to(torch.int32))


def encode(rgb: torch.Tensor, max_i_interval: int, dtype=torch.float64,
           chunk: int = 8) -> bytes:
    """(F, H, W, 3) uint8 RGB (any device) -> an .MPG container, as the
    reference encoder makes it (mjpeg423_encoder.c:18-231): both
    candidates sized, the smaller kept (I on ties), I forced at frame 0 and
    at least every max_i_interval frames.  chunk frames are in flight at a
    time."""
    nf, h, w, _ = rgb.shape
    qs = [quantized_planes(rgb[i:i + chunk], dtype) for i in range(0, nf, chunk)]
    q = torch.cat(qs)
    del qs
    types: list[int] = []
    last_i = 0
    planes: list[bytes] = []
    for s in range(0, nf, chunk):
        e = min(nf, s + chunk)
        ci = diff_i(q[s:e])
        # frame 0 has no P candidate; it is paired with itself and forced I
        prev = torch.cat([q[max(s - 1, 0):max(s, 1)], q[s:e - 1]])
        cp = diff_p(q[s:e], prev)
        tok_i, tok_p = tokens(ci), tokens(cp)
        size_i = ((tok_i[0].sum(-1, dtype=torch.int64).sum(-1) + 7) // 8).sum(1).tolist()
        size_p = ((tok_p[0].sum(-1, dtype=torch.int64).sum(-1) + 7) // 8).sum(1).tolist()
        pick = []
        for j in range(e - s):
            fi = s + j
            is_i = (fi == 0 or size_i[j] <= size_p[j]
                    or fi - last_i >= max_i_interval)
            if is_i:
                last_i = fi
            types.append(0 if is_i else 1)
            pick.append(is_i)
        sel = torch.tensor(pick, device=q.device)[:, None, None, None]
        lens, vals = (torch.where(sel, a, b) for a, b in zip(tok_i, tok_p))
        del tok_i, tok_p
        planes += pack_tokens(lens.reshape(-1, *lens.shape[2:]),
                              vals.reshape(-1, *vals.shape[2:]))
    return _container(w, h, types, planes)


def _container(w: int, h: int, types: list[int], planes: list[bytes]) -> bytes:
    chunks, trailer = [], []
    pos = FILE_HEADER.size
    for fi, t in enumerate(types):
        y, cb, cr = planes[3 * fi:3 * fi + 3]
        raw = FRAME_HEADER.size + len(y) + len(cb) + len(cr)
        size = raw + (-raw) % 4
        chunks.append(FRAME_HEADER.pack(size, t, len(y), len(cb)) + y + cb + cr
                      + b"\x00" * (size - raw))
        if t == 0:
            trailer.append(struct.pack("<2I", fi, pos))
        pos += size
    head = FILE_HEADER.pack(len(types), w, h, len(trailer), pos - FILE_HEADER.size)
    return b"".join([head, *chunks, *trailer, b"\x00" * PAD512])


# --- Container index -------------------------------------------------------

@dataclasses.dataclass
class Index:
    width: int
    height: int
    types: list[int]
    offsets: list[int]                        # frame header offsets
    planes: list[tuple[tuple[int, int], ...]]  # per frame 3 x (offset, length)

    @property
    def num_frames(self) -> int:
        return len(self.types)

    def frame_bytes(self, fi: int) -> int:
        (o, _), _, (co, cl) = self.planes[fi]
        return co + cl - self.offsets[fi]

    def gop_start(self, fi: int) -> int:
        while self.types[fi] != 0:
            fi -= 1
        return fi


def index(data: bytes) -> Index:
    """Walk the frame headers (mjpeg423_decoder.c:33-107); Cr runs to the
    end of the frame, alignment pad included, as the reference reads it."""
    nf, w, h, _, _ = FILE_HEADER.unpack_from(data, 0)
    pos = FILE_HEADER.size
    types, offs, planes = [], [], []
    for _ in range(nf):
        size, t, ys, cbs = FRAME_HEADER.unpack_from(data, pos)
        if size < FRAME_HEADER.size + ys + cbs or pos + size > len(data) or t > 1:
            raise ValueError(f"corrupt frame at offset {pos}")
        b = pos + FRAME_HEADER.size
        planes.append(((b, ys), (b + ys, cbs), (b + ys + cbs, size - 16 - ys - cbs)))
        types.append(t)
        offs.append(pos)
        pos += size
    return Index(w, h, types, offs, planes)


# --- Entropy decoder -----------------------------------------------------------

_TAIL = 256  # zero bytes after each stream: reads past its end see zeros


def _windows(buf: torch.Tensor) -> torch.Tensor:
    """For every bit position p of buf (uint8), the 32 bits from p, int64."""
    b = torch.cat([buf, torch.zeros(5, dtype=torch.uint8, device=buf.device)]).to(torch.int64)
    v40 = (b[:-4] << 32) | (b[1:-3] << 24) | (b[2:-2] << 16) | (b[3:-1] << 8) | b[4:]
    v40 = v40[:-1]
    sh = torch.arange(8, device=buf.device, dtype=torch.int64)
    return ((v40[:, None] << sh) >> 8 & 0xFFFFFFFF).reshape(-1)


def _get(win: torch.Tensor, pos: torch.Tensor, n) -> torch.Tensor:
    return (win[pos] >> (32 - n)) & ((torch.ones_like(pos) << n) - 1 if
                                     isinstance(n, torch.Tensor) else (1 << n) - 1)


def _extend(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """HUFF_EXTEND (lossless_decode.c:204); 0 where s == 0."""
    half = torch.ones_like(x) << (s - 1).clamp(min=0)
    v = torch.where(x < half, x - (half << 1) + 1, x)
    return torch.where(s > 0, v, torch.zeros_like(v))


def _block_ends(win: torch.Tensor, sink: int) -> torch.Tensor:
    """For every bit position, where the block starting there would end
    (`sink` where it is malformed), decoded for all positions at once."""
    n = win.numel()
    end = torch.full((n,), sink, dtype=torch.int64, device=win.device)
    idx = torch.arange(n, device=win.device)
    pos = (idx + 4 + _get(win, idx, 4)).clamp(max=sink)
    k = torch.ones_like(idx)
    while idx.numel():
        w = _get(win, pos, 8)
        s, r = w & 15, w >> 4
        coef = s > 0
        zrl = ~coef & (r == 15)
        knew = torch.where(zrl, k + 16, torch.where(coef, k + r, k))
        bad = (zrl & (knew > 64)) | (coef & (knew > 63))
        nxt = (pos + 8 + s).clamp(max=sink)
        done = ~bad & ((~coef & ~zrl) | (coef & (knew >= 63)))
        end[idx[done]] = nxt[done]
        live = ~(done | bad)
        idx, pos, k = idx[live], nxt[live], (knew + coef.to(knew.dtype))[live]
    end[sink] = sink
    return end


def _block_starts(end: torch.Tensor, first: torch.Tensor, nb: int) -> torch.Tensor:
    """(S, nb) start bits of the nb blocks of S streams starting at `first`:
    start[j + 2^l] = end^(2^l)(start[j]), one doubling of `end` a level."""
    starts = first[:, None]
    jump = end
    while starts.shape[1] < nb:
        starts = torch.cat([starts, jump[starts]], 1)
        jump = jump[jump]
    return starts[:, :nb]


def decode_planes(streams: list[bytes], is_p: list[bool], nb: int,
                  device) -> torch.Tensor:
    """Entropy-decode plane bitstreams into (S, nb, 64) int16 amplitudes,
    natural order, an I plane's DC summed along its blocks (int16 wrap), as
    lossless_decode.c:60-246 reads them.  Raises on a malformed stream."""
    lens = [len(s) for s in streams]
    base = np.cumsum([0] + [n + _TAIL for n in lens])
    host = np.zeros(int(base[-1]), np.uint8)
    for s, b in zip(streams, base[:-1]):
        host[b:b + len(s)] = np.frombuffer(s, np.uint8)
    win = _windows(torch.from_numpy(host).to(device))
    sink = win.numel() - 1                 # inside the last stream's zero tail
    end = _block_ends(win, sink)
    first = torch.tensor(base[:-1] * 8, dtype=torch.int64, device=device)
    starts = _block_starts(end, first, nb)
    last_end = end[starts[:, -1]]
    limit = torch.tensor((base[:-1] + np.array(lens) + 4) * 8, device=device)
    if bool((starts == sink).any()) or bool((last_end > limit).any()):
        raise ValueError("corrupt MJPEG423 plane bitstream")
    pos = starts.reshape(-1)
    nblk = pos.numel()
    out = torch.zeros((nblk, 64), dtype=torch.int32, device=device)
    s = _get(win, pos, 4)
    out[:, 0] = _extend(_get(win, pos + 4, s), s)
    pos = pos + 4 + s
    zz = torch.tensor(ZIGZAG, device=device)
    blk = torch.arange(nblk, device=device)
    k = torch.ones_like(pos)
    while blk.numel():
        w = _get(win, pos, 8)
        s, r = w & 15, w >> 4
        coef = s > 0
        zrl = ~coef & (r == 15)
        k = torch.where(zrl, k + 16, torch.where(coef, k + r, k))
        amp = _extend(_get(win, pos + 8, s), s)
        cb = blk[coef]
        out[cb, zz[k[coef]]] = amp[coef].to(torch.int32)
        live = zrl | (coef & (k < 63))
        blk, pos, k = blk[live], (pos + 8 + s)[live], (k + coef.to(k.dtype))[live]
    out = out.reshape(len(streams), nb, 64)
    ip = torch.tensor([not p for p in is_p], device=device)
    dc = torch.where(ip[:, None], torch.cumsum(out[:, :, 0].to(torch.int64), 1),
                     out[:, :, 0].to(torch.int64))
    out[:, :, 0] = _wrap16(dc).to(torch.int32)
    return out.to(torch.int16)


# --- Decoder: dequantize, IDCT, colour -------------------------------------------

def _fdescale(x: torch.Tensor, n: int) -> torch.Tensor:
    """`_descale` in floating point: every sum rounded to the type."""
    return torch.floor((x + float(1 << (n - 1))) * (1.0 / (1 << n)))


def _idct_1d(x, pass1: bool):
    """One islow butterfly (idct.c:41-109 pass 1, :116-180 pass 2), on
    integer tensors as the format states or, for the control, on float
    tensors with every product and sum rounded to their type."""
    fp = x[0].is_floating_point()
    descale = _fdescale if fp else _descale
    scale = float(1 << CONST_BITS) if fp else None
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) * scale if fp else (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) * scale if fp else (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if pass1 else CONST_BITS + PASS1_BITS + 3
    return [descale(v, n) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1,
                                     tmp13 + t0, tmp13 - t0, tmp12 - t1,
                                     tmp11 - t2, tmp10 - t3)]


def idct(coefs: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """(..., 64) int16 dequantized -> (..., 8, 8) int32 samples in [0, 255];
    a float `dtype` runs the same steps in that type (the control)."""
    x = coefs.to(dtype).reshape(*coefs.shape[:-1], 8, 8)
    ws = _idct_1d([x[..., r, :] for r in range(8)], True)   # ws[r]: (..., 8 cols)
    ws = torch.stack(ws, -2)
    out = _idct_1d([ws[..., :, c] for c in range(8)], False)  # out[c]: (..., 8 rows)
    return torch.stack(out, -1).clamp(0, 255).to(torch.int32)


def ycbcr_to_bgra(y, cb, cr, dtype=torch.int32) -> torch.Tensor:
    """14-bit fixed-point 4:4:4 YCbCr -> packed BGRA (ycbcr_to_rgb.c:19-49),
    int64 holding the uint32 pixel blue | green << 8 | red << 16; a float
    `dtype` runs the same steps in that type (the control)."""
    cbb, crr = cb.to(dtype) - 128, cr.to(dtype) - 128
    fp = cbb.is_floating_point()
    yy = y.to(dtype) * float(1 << COLOR_SHIFT) if fp else y.to(dtype) << COLOR_SHIFT

    def norm(v):
        v = torch.floor(v * (1.0 / (1 << COLOR_SHIFT))).to(torch.int32) if fp else v >> COLOR_SHIFT
        return torch.where(v < 0, torch.zeros_like(v), v.clamp(max=255))

    r = norm(yy + C_CR_R * crr)
    g = norm(yy - C_CB_G * cbb - C_CR_G * crr)
    b = norm(yy + C_CB_B * cbb)
    return (b | (g << 8) | (r << 16)).to(torch.int64)


class Decoder:
    """The reference decoder of one container: frames as (H, W) int64 packed
    BGRA on `device`.  precision "int" is the format's arithmetic;
    torch.float32 runs the IDCT and colour conversion in float32."""

    def __init__(self, data: bytes, device, precision="int"):
        self.data = data
        self.idx = index(data)
        self.device = device
        self.precision = precision
        self.bh, self.bw = self.idx.height // 8, self.idx.width // 8

    def amplitudes(self, frames: list[int]) -> torch.Tensor:
        """(len(frames), 3, B, 64) int16 amplitudes."""
        streams, is_p = [], []
        for fi in frames:
            for o, n in self.idx.planes[fi]:
                streams.append(self.data[o:o + n])
                is_p.append(bool(self.idx.types[fi]))
        amps = decode_planes(streams, is_p, self.bh * self.bw, self.device)
        return amps.reshape(len(frames), 3, self.bh * self.bw, 64)

    def states(self, lo: int, hi: int, chunk: int = 8):
        """Yield (frame, (3, B, 64) int16 dequantized state) for frames
        [lo, hi); lo must be an I-frame."""
        quant = torch.stack([_quant(p, self.device) for p in range(3)])[:, None, :]
        state = None
        for s in range(lo, hi, chunk):
            fr = list(range(s, min(hi, s + chunk)))
            amps = self.amplitudes(fr)
            for j, fi in enumerate(fr):
                deq = amps[j].to(torch.int32) * quant
                if self.idx.types[fi] == 0:
                    state = _wrap16(deq)
                else:
                    state = _wrap16(state.to(torch.int32) + deq)
                yield fi, state

    def pixels(self, state: torch.Tensor) -> torch.Tensor:
        dtype = torch.int32 if self.precision == "int" else self.precision
        y, cb, cr = (idct(state[p], dtype) for p in range(3))
        return blocks_to_raster(ycbcr_to_bgra(y, cb, cr, dtype), self.bh, self.bw)

    def frames(self, wanted: set[int]):
        """Yield (frame, (H, W) int64 BGRA) for every wanted frame, in
        order, decoding each needed GOP prefix once."""
        todo = sorted(wanted)
        while todo:
            lo = self.idx.gop_start(todo[0])
            hi = todo[0] + 1
            # extend through the GOP while later wanted frames share it
            for f in todo[1:]:
                if self.idx.gop_start(f) == lo:
                    hi = f + 1
            for fi, state in self.states(lo, hi):
                if fi in wanted:
                    yield fi, self.pixels(state)
            todo = [f for f in todo if f >= hi]
