#!/usr/bin/env python3
"""Ported from scripts/fuzz_native.py at commit 16f1f46.

Corruption-fuzz campaign against the port's native codec and its
resilient decode (opt-in, long-running).

For each round: build a random container (random geometry/content/GOP
structure), then hammer the native parse surfaces with byte corruptions:

  * every parse must either succeed or raise ValueError — never crash the
    process (ctypes: a native fault kills Python) and never hang;
  * uncorrupted parses must stay byte-exact vs the Python oracle;
  * the container indexer must reject corrupt frame chains;
  * the resilient decode (DecodePipeline.decode_resilient_array, windows
    of 5 frames on --device: K1 on the card) keeps every frame before the
    damage and from the next I-frame on byte-exact or reports it skipped.

    python mjpeg423_tpu_torch/scripts/fuzz_native.py [rounds] [seed] [--device cpu|cuda]

It prints the seed first and a line per round, and exits nonzero on the
first invariant violation; [rounds] [seed] replays it.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time
from struct import error as struct_error

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from mjpeg423_tpu_torch.codec import decoder, encoder  # noqa: E402
from mjpeg423_tpu_torch.codec.transcode import regop  # noqa: E402
from mjpeg423_tpu_torch.core import format as fmt  # noqa: E402
from mjpeg423_tpu_torch.native import centropy  # noqa: E402
from mjpeg423_tpu_torch.ops import entropy_ref  # noqa: E402
from mjpeg423_tpu_torch.runtime import DecodeConfig, DecodePipeline  # noqa: E402


def resilient_pipeline(device) -> DecodePipeline:
    """The pipeline of the resilient campaign: windows of 5 frames."""
    return DecodePipeline(DecodeConfig(frames_per_batch=5), device=device)


def one_round(rng: np.random.Generator, pipe: DecodePipeline
              ) -> tuple[dict, list]:
    """One round.  Returns the stats and the resilient campaign's cases:
    (mutated container, frames and RecoveryLog.skipped, or None where the
    decode raised ValueError).  Raises AssertionError on a violation."""
    h = 8 * int(rng.integers(1, 7))
    w = 8 * int(rng.integers(1, 9))
    nf = int(rng.integers(1, 9))
    maxi = int(rng.integers(1, 6))
    nb = (h // 8) * (w // 8)
    frames = []
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for i in range(nf):
        if rng.random() < 0.3:
            base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        else:
            base = base.copy()
            base[rng.integers(0, h)] ^= int(rng.integers(1, 32))
        frames.append(base)
    data = bytearray(encoder.encode_frames(frames, max_i_interval=maxi))
    index = fmt.index_frames(bytes(data))

    stats = {"ok": 0, "raised": 0, "decoded_differently": 0}
    # clean parse must match the oracle
    for p in range(3):
        for fi in range(nf):
            o = int(index.plane_off[p, fi])
            ln = int(index.plane_len[p, fi])
            is_p = bool(index.frame_type[fi])
            got = centropy.decode_plane(bytes(data[o:o + ln]), nb, is_p)
            want = entropy_ref.decode_plane(bytes(data[o:o + ln]), nb, is_p)
            if not (got == want).all():
                raise AssertionError("clean parse diverged from oracle")

    # corruption hammering: flip/zero/truncate random plane bytes
    for _ in range(60):
        p = int(rng.integers(0, 3))
        fi = int(rng.integers(0, nf))
        o = int(index.plane_off[p, fi])
        ln = int(index.plane_len[p, fi])
        if ln == 0:
            continue
        blob = bytearray(data[o:o + ln])
        mode = rng.integers(0, 4)
        if mode == 0:
            blob[int(rng.integers(0, len(blob)))] ^= int(rng.integers(1, 256))
        elif mode == 1:
            blob = blob[: int(rng.integers(0, len(blob)))]
        elif mode == 2:
            for _k in range(int(rng.integers(1, 6))):
                blob[int(rng.integers(0, max(1, len(blob))))] = 0xFF
        else:
            blob = bytearray(rng.integers(0, 256, len(blob)).astype(np.uint8))
        is_p = bool(index.frame_type[fi])
        try:
            got = centropy.decode_plane(bytes(blob), nb, is_p)
        except ValueError:
            stats["raised"] += 1
            continue
        # A parse that "succeeds" on corrupt input must equal the oracle's
        # parse of the same bytes (both see the same stream).
        try:
            want = entropy_ref.decode_plane(bytes(blob), nb, is_p)
        except ValueError:
            raise AssertionError(
                "native accepted a stream the oracle rejects"
            )
        if not (got == want).all():
            raise AssertionError("corrupt-parse divergence")
        stats["ok"] += 1

        # speculative decoder must agree or fall back, never crash
        spec = centropy.decode_plane_spec(bytes(blob), nb, is_p, 3)
        if not (spec == got).all():
            raise AssertionError("speculative decoder diverged")

    # whole-container corruption: the decoder must raise or give
    # byte-exact output, never crash or silently truncate
    for _ in range(10):
        mut = bytearray(data)
        pos = int(rng.integers(20, len(mut)))
        mut[pos] ^= int(rng.integers(1, 256))
        try:
            out = decoder.decode_stream_array(bytes(mut))
        except ValueError:
            stats["raised"] += 1
        else:
            if out.shape[0] != nf:
                raise AssertionError("silent truncation on corrupt container")
            stats["ok"] += 1
        # the indexer must reject corrupt chains with ValueError, not crash
        try:
            fmt.index_frames(bytes(mut))
        except ValueError:
            pass
        # the lossless transcoder must raise or stay decode-identical
        try:
            re = regop(bytes(mut), max_i_interval=3)
        except (ValueError, struct_error):
            stats["raised"] += 1
        else:
            try:
                a = decoder.decode_stream_array(bytes(mut))
            except ValueError:
                raise AssertionError(
                    "regop accepted a container the decoder rejects"
                )
            b = decoder.decode_stream_array(re)
            # regop runs strict_range: it must RAISE when the stream's
            # amplitude state exceeds the VLI's 11-bit range, so any
            # successful transcode must be decode-identical.
            if not (np.asarray(a) == np.asarray(b)).all():
                raise AssertionError(
                    "regop succeeded but changed decoded output"
                )
            stats["ok"] += 1

    # resilient decode: random payload/trailer corruption.  Invariants that
    # hold even for UNDETECTABLE corruption (no checksums in the format):
    # frames before the damaged frame are byte-exact; frames at/after the
    # next I-frame following it are byte-exact or inside a reported skipped
    # range (I-frames rebuild all state); trailer-only corruption with an
    # intact chain must decode fully byte-exact (no resync ever consulted).
    want = decoder.decode_stream_array(bytes(data))
    hdr_offs = [
        int(index.plane_off[0, f]) - fmt.FRAME_HEADER_BYTES
        for f in range(nf)
    ]
    payload_end = fmt.FILE_HEADER_BYTES + index.header.payload_size
    is_i = index.is_iframe
    cases = []
    for _ in range(8):
        in_trailer = rng.random() < 0.25 and payload_end < len(data)
        lo_b = payload_end if in_trailer else fmt.FILE_HEADER_BYTES
        hi_b = len(data) if in_trailer else payload_end
        off = int(rng.integers(lo_b, hi_b))
        n = int(rng.integers(1, 32))
        mut = bytearray(data)
        garbage = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        # Clamp the write to the region it targets: a payload mutation must
        # not spill into the trailer (the invariants below assume an intact
        # trailer), nor a trailer mutation past EOF.
        end = min(off + n, hi_b)
        mut[off:end] = garbage[: end - off]
        try:
            got, rec = pipe.decode_resilient_array(bytes(mut))
        except ValueError:
            stats["raised"] += 1
            cases.append((bytes(mut), None))
            continue
        skipped = rec.skipped
        cases.append((bytes(mut), (got, list(skipped))))
        if got.shape[0] != nf:
            raise AssertionError("resilient output lost frame slots")
        if not (skipped == sorted(skipped) and all(
                0 <= a < b <= nf for a, b in skipped)):
            raise AssertionError(f"malformed skip ranges {skipped}")
        if in_trailer:
            if skipped or not (got == want).all():
                raise AssertionError(
                    "trailer corruption with an intact chain must decode "
                    "fully byte-exact"
                )
            stats["ok"] += 1
            continue
        # The damage spans [off, end): map BOTH edges to frames — the next
        # I-frame must follow the LAST damaged frame, not the first.
        f_bad = max(f for f in range(nf) if hdr_offs[f] <= off)
        f_last = max(f for f in range(nf) if hdr_offs[f] <= end - 1)
        nz = np.flatnonzero(is_i[f_last + 1:])
        nxt = f_last + 1 + int(nz[0]) if nz.size else nf
        in_skip = np.zeros(nf, dtype=bool)
        for a, b in skipped:
            in_skip[a:b] = True
        # Frames before the damage are byte-exact or reported skipped (the
        # trailer cross-check invalidates back to the last verified anchor
        # when it cannot localize a parse-valid chain rewrite).
        for g in range(f_bad):
            if not (in_skip[g] or (got[g] == want[g]).all()):
                raise AssertionError(
                    f"frame {g} before the damage neither skipped nor "
                    f"byte-exact (off={off}, f_bad={f_bad})"
                )
        for g in range(nxt, nf):
            if not (in_skip[g] or (got[g] == want[g]).all()):
                raise AssertionError(
                    f"frame {g} past the next I-frame neither skipped nor "
                    f"byte-exact (off={off}, f_last={f_last})"
                )
        stats["ok"] += 1
    return stats, cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", nargs="?", type=int, default=50)
    ap.add_argument("seed", nargs="?", type=int, default=None)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    args = ap.parse_args(argv)
    seed = int(time.time()) if args.seed is None else args.seed
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fuzz: --device cuda needs an NVIDIA GPU; pass --device cpu "
              "for the plain path", file=sys.stderr)
        return 1
    print(f"fuzzing {args.rounds} rounds, seed {seed}, device {args.device}",
          flush=True)
    rng = np.random.default_rng(seed)
    pipe = resilient_pipeline(args.device)
    t0 = time.time()
    for r in range(args.rounds):
        try:
            stats, _ = one_round(rng, pipe)
        except AssertionError as e:
            print(f"round {r}: VIOLATION {e} (replay: {args.rounds} {seed} "
                  f"--device {args.device})", file=sys.stderr, flush=True)
            return 1
        print(f"round {r}: {stats} ({time.time() - t0:.0f}s)", flush=True)
    print("ALL ROUNDS CLEAN")
    return 0


if __name__ == "__main__":
    sys.exit(main())
