"""copy_pad_share (%): the share of the bytes the pipeline's window copies
handed over, host to device and back, that were pad rows beyond a short
window's frames: the program's counters copy/h2d_pad_bytes and
copy/d2h_pad_bytes over every copy/h2d_bytes.* and copy/d2h_bytes.*
(pinned and pageable alike) in the window; 0 where nothing was copied.  A
program that put windows but has no such counters reads nothing."""

PAD = ("copy/h2d_pad_bytes", "copy/d2h_pad_bytes")
ALL = ("copy/h2d_bytes.", "copy/d2h_bytes.")


def read(ctx):
    probes = ctx.window.probes
    total = sum(p["total"] for n, p in probes.items() if n.startswith(ALL))
    if not total:
        return None if "device/put" in probes else 0.0
    return 100.0 * sum(probes.get(n, {}).get("total", 0.0) for n in PAD) / total
