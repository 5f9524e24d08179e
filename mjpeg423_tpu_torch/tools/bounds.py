"""The least time an NVIDIA H100 could take for the port's kernels' work.

A bound is the larger of two times: the bytes a call must move (each input
read once, each output written once) over the card's memory rate, and the
least int32 machine instructions that compute its function over the card's
integer issue rate.  chip_smoke.py and the bench (bench.py) both bound the
kernels with these numbers.

The card's peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of device
memory; 67 TFLOP/s float32 outside the tensor cores, which is 2 operations
on 128 lanes per SM and clock.  An int32 instruction issues on 64 lanes per
SM and clock, on one of two pipes: IMAD (multiply-add, and an add, a left
shift or a move written as one) on the FMA pipe; add, logic, shift,
permute, min/max, compare and select on the ALU pipe.  The two issue side by
side (mjpeg423_tpu_torch/scripts/int_pipes.py on an H100 at 700 W: 33 + 69
thread-instructions per SM and clock in a 1:2 mix, 86 for IMAD alone, 67
for the ALU alone), so the least time for a count of instructions that a
kernel may balance between the pipes is the count over 128 lanes: half the
data sheet's float32 rate.  bound_ms_one_pipe is the stricter reading, all
of them on one pipe (a quarter).  Each of add, three-operand add (IADD3),
multiply, multiply-add (IMAD), shift, min/max, compare and select counts as
ONE operation.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 2
# The least machine operations that compute each function, not the
# operators of the source text: a multiply and the add that depends on it
# are one IMAD (so is `x << 13` followed by an add: a multiply by 8192), a
# sum of three terms is one IADD3, and a rounding constant or a level shift
# rides in an add that is there anyway.  Address arithmetic and the
# unpacking of loaded words are not counted.
#   islow IDCT butterfly, 44: the even part's rotation 4 (add, multiply, 2
#     IMAD) and its four sums 6 (x0 +- x4, 4 IMAD by 8192); the odd part 18
#     (4 adds; z5 add + multiply; z3, z4 2 IMAD; z1, z2 2 multiplies; t0..t3
#     an add and an IMAD each); 8 outputs of an IADD3 with the rounding
#     constant and a shift.  A plane block is 16 butterflies and 64 clamps
#     of 2 (the +128 rides in pass 2's rounding constant);
#   colour conversion and pack of one pixel, 16: y << 14, r and b one IMAD
#     each, g two (the chroma's -128 folds into its clamp's limits), three
#     normalizations of shift, min, max, and the pack as 2 IMAD;
#   dequantization and recurrence of one coefficient, 3: the select of the
#     previous state, one IMAD, the int16 sign extension;
#   forward DCT butterfly, 44 in both passes: 12 sums and differences;
#     outputs 0 and 4 two each; 2 and 6 six together (add, 2 IMAD with the
#     rounding constant in the first, IMAD, 2 shifts); the odd part 22 (4
#     adds; z5 add + IMAD with the rounding constant; z3, z4 2 IMAD; z1, z2
#     2 multiplies; 4 outputs of IMAD, add, shift).  A plane block is 16
#     butterflies, 128 int16 sign extensions and 64 quantizations of 6
#     (abs, 2|c| + q, high multiply by q's reciprocal, shift, compare,
#     negating select).
OPS_IDCT_PLANE = 16 * 44 + 64 * 2
OPS_COLOUR_BLOCK = 64 * 16
OPS_RECUR_PLANE = 64 * 3
OPS_FDCT_QUANT_PLANE = 16 * 44 + 128 + 64 * 6
OPS_DECODE_BLOCK = 3 * (OPS_IDCT_PLANE + OPS_RECUR_PLANE) + OPS_COLOUR_BLOCK
OPS_K5_BLOCK = 3 * OPS_IDCT_PLANE + OPS_COLOUR_BLOCK

# Input bytes a block (three planes) of each decode window layout: int16
# amplitudes (K1, K2), int16 DC + int8 AC (K3).
DECODE_IN_BYTES = {"k1": 3 * 64 * 2, "k2": 3 * 64 * 2, "k3": 3 * (64 + 2)}


def bound(nbytes: int, ops: int) -> dict:
    """The least milliseconds the card could take: each input byte read
    once and each output byte written once at the memory rate, or the
    least int32 instructions (see OPS_*) at one per lane and clock on both
    integer pipes, whichever is larger; and the same with one pipe."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_ms_one_pipe": max(by_bytes, 2 * by_ops),
            "bytes": nbytes, "operations": ops}


def decode_window_bytes(w: int, nb: int, in_bytes_per_block: int) -> int:
    """Bytes a fused decode window must move: amplitudes, the I-frame mask,
    the two quant rows, the carry in and out, and the frames out."""
    return (w * nb * in_bytes_per_block + w + 2 * 64 * 2
            + 2 * 3 * nb * 64 * 2 + w * nb * 64 * 4)


def kernel_bound(kernel: str, frames: int, nb: int) -> dict:
    """bound() of one call of a kernel on `frames` frames of nb blocks a
    plane: "k1", "k2", "k3" a decode window, "k4" an encode window, "k5"
    the IDCT and colour of frames * nb pre-accumulated block states."""
    if kernel in DECODE_IN_BYTES:
        return bound(decode_window_bytes(frames, nb, DECODE_IN_BYTES[kernel]),
                     frames * nb * OPS_DECODE_BLOCK)
    if kernel == "k4":
        return bound(frames * nb * 3 * 64 * (1 + 2),
                     frames * nb * 3 * OPS_FDCT_QUANT_PLANE)
    if kernel == "k5":
        return bound(frames * nb * 64 * (3 * 2 + 4), frames * nb * OPS_K5_BLOCK)
    raise ValueError(f"no bound for kernel {kernel!r}")
