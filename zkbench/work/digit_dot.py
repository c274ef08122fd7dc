"""Least time one H100 could take for the products of 8-bit digit planes
that the `digit_dot` kernel's launches did: C (M, N) int32 = A (M, K) @
Wt (N, K)^T.

Operations: 2 * M * K * N (a multiply and an add per digit product),
against 1,979 TOP/s of dense int8 on the tensor cores (NVIDIA H100 SXM
datasheet, 700 W).  Bytes: A and Wt read once and C written once,
M * K + K * N + 4 * M * N, against the HBM3's 3.35 TB/s.  K is the depth
the caller asked for, before the kernel pads it to a multiple of 32.
The least time of a launch is the larger of the two; launches add.
"""

KERNEL = "digit_dot"             # the device kernel's name holds this
PEAK_OPS = 1.979e15
PEAK_BYTES = 3.35e12


def least_seconds(shapes) -> float:
    """shapes: (M, K, N) of each launch."""
    return sum(max(2.0 * m * k * n / PEAK_OPS,
                   (m * k + k * n + 4.0 * m * n) / PEAK_BYTES)
               for m, k, n in shapes)
