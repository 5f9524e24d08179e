"""Copied from mjpeg423_tpu/io/bmp.py at commit bfc8537.

BMP read/write + PPM ingest (the 2.2 analog).

The reference writes 32-bpp BMPs from its BGRA frame buffers via libbmp
(reference: encoder/encode_bmp.c:7-25, libbmp/bmpfile.h:121-140) and reads
arbitrary BMPs via NetSurf libnsbmp (decoder/decode_bmp.c:38-90).  The
reader here covers the same content classes libnsbmp does: 1/4/8-bit
paletted, RLE4/RLE8 compressed, 16-bpp (555 and BITFIELDS masks), 24- and
32-bpp, top-down or bottom-up rows — so real photographic corpora flow
through encode -> decode without external tooling.  PPM (P6) read/write is
included as the lowest-friction interchange with standard image tools.
"""
from __future__ import annotations

import struct

import numpy as np

_FILE_HDR = struct.Struct("<2sIHHI")      # BITMAPFILEHEADER
_INFO_HDR = struct.Struct("<IiiHHIIiiII")  # BITMAPINFOHEADER

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


def write_bmp32(path: str, rgba_packed: np.ndarray) -> None:
    """Write an (H, W) uint32 packed BGRA frame as a 32-bpp BMP.

    Matches the reference's output pixel layout: the packed word is
    b | g<<8 | r<<16 (rgb_pixel_t, mjpeg423_types.h:56-61), which is exactly
    BMP's little-endian BGRX byte order — the frame dumps directly.
    BMP rows are bottom-up.
    """
    h, w = rgba_packed.shape
    img = np.ascontiguousarray(rgba_packed[::-1].astype("<u4"))
    pixel_bytes = img.tobytes()
    info = _INFO_HDR.pack(40, w, h, 1, 32, 0, len(pixel_bytes), 2835, 2835, 0, 0)
    offset = _FILE_HDR.size + _INFO_HDR.size
    hdr = _FILE_HDR.pack(b"BM", offset + len(pixel_bytes), 0, 0, offset)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(info)
        f.write(pixel_bytes)


def _read_palette(data: bytes, pal_off: int, n_colors: int,
                  entry_bytes: int) -> np.ndarray:
    """Palette -> (n, 3) uint8 RGB (entries are BGR0 or BGR)."""
    raw = np.frombuffer(
        data, dtype=np.uint8, count=n_colors * entry_bytes, offset=pal_off
    ).reshape(n_colors, entry_bytes)
    return np.ascontiguousarray(raw[:, 2::-1])


def _decode_rle(data: bytes, offset: int, w: int, h: int, rle4: bool
                ) -> np.ndarray:
    """RLE8/RLE4 -> (H, W) palette indices, bottom-up rows like BI_RGB
    (libnsbmp bmp_decode_rle semantics: delta, EOL, EOB escapes)."""
    # Unlike the BI_RGB paths (where np.frombuffer(count=...) ties the
    # dimensions to actual payload bytes), RLE dims come purely from the
    # header, and the EOB/delta escapes make tiny payloads LEGITIMATE for
    # any image size — so the guard must be an absolute pixel cap, not
    # payload coupling.  2^28 pixels (16Kx16K) bounds the (h, w) + x3
    # palette expansion to ~1 GB; without it a <100-byte file claiming
    # 2^20 x 2^20 demands terabytes before any decode runs.
    if h * w > 1 << 28:
        raise ValueError(f"implausible RLE BMP dimensions {w}x{h}")
    out = np.zeros((h, w), dtype=np.uint8)
    x = y = 0
    i = offset
    n = len(data)
    while i + 1 < n and y < h:
        count, val = data[i], data[i + 1]
        i += 2
        if count:  # encoded run
            if rle4:
                pair = [(val >> 4) & 0xF, val & 0xF]
                for k in range(count):
                    if x < w:
                        out[y, x] = pair[k & 1]
                        x += 1
            else:
                end = min(x + count, w)
                out[y, x:end] = val
                x += count
            continue
        # escape codes
        if val == 0:      # end of line
            x, y = 0, y + 1
        elif val == 1:    # end of bitmap
            break
        elif val == 2:    # delta
            if i + 1 >= n:
                break
            x += data[i]
            y += data[i + 1]
            i += 2
        else:             # absolute run of `val` pixels
            if rle4:
                nb = (val + 1) // 2
                chunk = data[i:i + nb]
                if len(chunk) < nb:
                    raise ValueError("truncated RLE4 absolute run")
                i += nb + (nb & 1)  # word-aligned
                for k in range(val):
                    if x < w:
                        b = chunk[k // 2]
                        out[y, x] = (b >> 4) & 0xF if k % 2 == 0 else b & 0xF
                        x += 1
            else:
                take = data[i:i + val]
                if len(take) < val:
                    raise ValueError("truncated RLE8 absolute run")
                end = min(x + val, w)
                if end > x:  # x may already be past the row width
                    # (corrupt/overlong runs clamp, like the encoded-run
                    # path — not a broadcast error)
                    out[y, x:end] = np.frombuffer(
                        take, dtype=np.uint8
                    )[: end - x]
                i += val + (val & 1)  # word-aligned
                x += val
    return out[::-1]  # RLE rows are stored bottom-up


def _mask_shift(mask: int) -> tuple[int, int]:
    """(shift, width) of a contiguous channel bitmask."""
    if mask == 0:
        return 0, 0
    shift = (mask & -mask).bit_length() - 1
    width = (mask >> shift).bit_length()
    return shift, width


def read_bmp(path: str) -> np.ndarray:
    """Read a BMP -> (H, W, 3) uint8 RGB.

    Supports the libnsbmp content classes (decode_bmp.c:38-90): 1/4/8-bit
    paletted, RLE4/RLE8, 16-bpp (555 default or BITFIELDS masks), 24/32-bpp,
    top-down (negative height) or bottom-up rows.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FILE_HDR.size + _INFO_HDR.size:
        raise ValueError("truncated BMP header")
    magic, _size, _r1, _r2, offset = _FILE_HDR.unpack_from(data, 0)
    if magic != b"BM":
        raise ValueError("not a BMP file")
    (hdr_size, w, h, _planes, bpp, compression, _isize, _xp, _yp,
     clr_used, _clr_imp) = _INFO_HDR.unpack_from(data, _FILE_HDR.size)
    if hdr_size < 40:
        raise ValueError(f"unsupported BMP header size {hdr_size}")
    if w <= 0 or h == 0 or abs(h) > 1 << 20 or w > 1 << 20:
        raise ValueError(f"bad BMP dimensions {w}x{h}")
    flip = h > 0
    h = abs(h)
    pal_off = _FILE_HDR.size + hdr_size
    masks = None
    if compression == BI_BITFIELDS:
        if len(data) < pal_off + 12:
            raise ValueError("truncated BITFIELDS masks")
        if hdr_size == 40:  # masks follow the info header
            masks = struct.unpack_from("<III", data, pal_off)
            pal_off += 12
        else:               # V4/V5 headers embed the masks at offset 40
            masks = struct.unpack_from("<III", data, _FILE_HDR.size + 40)

    if bpp in (1, 4, 8):
        n_colors = clr_used or (1 << bpp)
        palette = _read_palette(data, pal_off, n_colors, 4)
        if compression in (BI_RLE8, BI_RLE4):
            idx = _decode_rle(
                data, offset, w, h, rle4=(compression == BI_RLE4)
            )
            if not flip:  # top-down RLE is nonstandard but honor the sign
                idx = idx[::-1]
        elif compression == BI_RGB:
            row_bytes = ((w * bpp + 31) // 32) * 4
            rows = np.frombuffer(
                data, dtype=np.uint8, count=row_bytes * h, offset=offset
            ).reshape(h, row_bytes)
            if bpp == 8:
                idx = rows[:, :w]
            elif bpp == 4:
                nib = np.empty((h, row_bytes * 2), dtype=np.uint8)
                nib[:, 0::2] = rows >> 4
                nib[:, 1::2] = rows & 0xF
                idx = nib[:, :w]
            else:  # 1-bpp
                bits = np.unpackbits(rows, axis=1)
                idx = bits[:, :w]
            if flip:
                idx = idx[::-1]
        else:
            raise ValueError(
                f"unsupported compression {compression} for {bpp}-bpp"
            )
        if int(idx.max(initial=0)) >= n_colors:
            raise ValueError("palette index out of range (corrupt BMP)")
        return np.ascontiguousarray(palette[idx])

    if bpp == 16:
        if compression not in (BI_RGB, BI_BITFIELDS):
            raise ValueError(
                f"unsupported compression {compression} for 16-bpp"
            )
        row_bytes = (w * 2 + 3) & ~3
        raw = np.frombuffer(
            data, dtype=np.uint8, count=row_bytes * h, offset=offset
        ).reshape(h, row_bytes)[:, : w * 2]
        px = raw.reshape(h, w, 2).view("<u2").reshape(h, w).astype(np.uint32)
        rm, gm, bm = masks if masks else (0x7C00, 0x03E0, 0x001F)
        out = np.empty((h, w, 3), dtype=np.uint8)
        for c, m in enumerate((rm, gm, bm)):
            shift, width = _mask_shift(m)
            v = (px >> shift) & ((1 << width) - 1)
            # scale channel to 8 bits (replicate top bits, libnsbmp-style);
            # >8-bit masks (e.g. 2-10-10-10) keep the TOP 8 bits — a plain
            # uint8 cast would keep the low 8 (v mod 256), garbage colors.
            if width and width < 8:
                v = (v * 255) // ((1 << width) - 1)
            elif width > 8:
                v = v >> (width - 8)
            out[..., c] = v.astype(np.uint8)
        if flip:
            out = out[::-1]
        return np.ascontiguousarray(out)

    if bpp in (24, 32):
        if compression not in (BI_RGB, BI_BITFIELDS):
            raise ValueError(f"unsupported BMP compression {compression}")
        if compression == BI_BITFIELDS and bpp == 24:
            raise ValueError("BI_BITFIELDS is only valid for 16/32 bpp")
        nch = bpp // 8
        row_bytes = (w * nch + 3) & ~3
        px = np.frombuffer(
            data, dtype=np.uint8, count=row_bytes * h, offset=offset
        )
        px = px.reshape(h, row_bytes)[:, : w * nch].reshape(h, w, nch)
        if flip:
            px = px[::-1]
        if bpp == 32 and masks is not None:
            # Arbitrary channel order: extract by mask (e.g. RGBA-order
            # files would otherwise come back with R/B swapped).
            words = np.ascontiguousarray(px).reshape(h, w * 4)
            words = words.view("<u4").reshape(h, w).astype(np.uint32)
            out = np.empty((h, w, 3), dtype=np.uint8)
            for c, m in enumerate(masks):
                shift, width = _mask_shift(m)
                v = (words >> shift) & ((1 << width) - 1)
                if width and width < 8:
                    v = (v * 255) // ((1 << width) - 1)
                elif width > 8:  # >8-bit masks: top 8 bits, not v mod 256
                    v = v >> (width - 8)
                out[..., c] = v.astype(np.uint8)
            return out
        # BGR(A) -> RGB
        return np.ascontiguousarray(px[..., 2::-1])

    raise ValueError(f"unsupported BMP bpp {bpp}")


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as binary PPM (P6)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read a binary PPM (P6) -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError("not a P6 PPM")
    # header = magic, width, height, maxval — whitespace/comment separated
    fields: list[int] = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported PPM maxval {maxval}")
    px = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i)
    return px.reshape(h, w, 3).copy()


def read_image(path: str) -> np.ndarray:
    """Read an image by magic -> (H, W, 3) uint8 RGB.

    BMP (incl. paletted/RLE/16bpp — the libnsbmp analog, decode_bmp.c) and
    PPM are native; any other format (PNG, JPEG, ...) is read through PIL
    when it is importable — gated, not required."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"BM":
        return read_bmp(path)
    if magic == b"P6":
        return read_ppm(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"unrecognized image format in {path} (not BMP/PPM, and PIL "
            "is not installed for other formats)"
        ) from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def packed_to_rgb(frame: np.ndarray) -> np.ndarray:
    """(H, W) uint32 packed -> (H, W, 3) uint8 RGB."""
    r = (frame >> 16) & 0xFF
    g = (frame >> 8) & 0xFF
    b = frame & 0xFF
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def rgb_to_packed(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint32 packed BGRA (alpha 0)."""
    rgb = rgb.astype(np.uint32)
    return rgb[..., 2] | (rgb[..., 1] << 8) | (rgb[..., 0] << 16)
