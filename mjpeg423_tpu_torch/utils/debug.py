"""Copied from mjpeg423_tpu/utils/debug.py at commit bfc8537.

Debug dump helpers (the reference's print_block/print_dct/print_bitstream,
util.c:18-51, as returned strings instead of prints)."""
from __future__ import annotations

import numpy as np


def format_block(block: np.ndarray, title: str = "block") -> str:
    """8x8 sample/coefficient block as an aligned grid."""
    b = np.asarray(block).reshape(8, 8)
    lines = [f"{title}:"]
    for r in range(8):
        lines.append(" ".join(f"{int(v):6d}" for v in b[r]))
    return "\n".join(lines)


def format_bitstream(data: bytes, limit: int = 64) -> str:
    """Hex dump of the first `limit` bytes (print_bitstream analog)."""
    view = data[:limit]
    lines = []
    for off in range(0, len(view), 16):
        chunk = view[off:off + 16]
        hexpart = " ".join(f"{b:02x}" for b in chunk)
        lines.append(f"{off:06x}: {hexpart}")
    if len(data) > limit:
        lines.append(f"... ({len(data)} bytes total)")
    return "\n".join(lines)


def block_diff(a: np.ndarray, b: np.ndarray) -> str:
    """Where two 8x8 blocks differ — the stage-isolation debugging aid."""
    a = np.asarray(a).reshape(8, 8)
    b = np.asarray(b).reshape(8, 8)
    diffs = np.argwhere(a != b)
    if not len(diffs):
        return "blocks identical"
    lines = [f"{len(diffs)} differing coefficients:"]
    for r, c in diffs[:16]:
        lines.append(f"  [{r},{c}]: {int(a[r, c])} != {int(b[r, c])}")
    if len(diffs) > 16:
        lines.append("  ...")
    return "\n".join(lines)
