"""Least time one H100 could take for the Poseidon2 t=12 permutations
that the `poseidon12` kernel's launches did.

The work is the permutation's own field arithmetic, from its definition
(zk-lisp poseidon/mod.rs; `zkbench/reference/poseidon2.py`): per round,
the x^3 S-box takes 2 field products in each of the 12 lanes and the
12 x 12 MDS takes 144, so 168 products of two 128-bit field elements
(the additions, the round constants and the modular reduction are not
counted).  Each product is counted as the 16 x 16 = 256 products of
8-bit digits that its schoolbook form needs, each a multiply and an add:
512 integer operations, against 1,979 TOP/s of dense int8 on the
tensor cores (NVIDIA H100 SXM datasheet, 700 W): 0.26 ps per field
product.  Of the chip's published rates this gives the least time for
a 128-bit product: FP64 on the tensor cores (26-bit digits, 25 exact
products of 2 flops at 67 TFLOP/s) needs 0.75 ps, FP32 (24-bit digits,
36 products at 67 TFLOP/s) 1.07 ps, and 32-bit integer multiply-adds,
whose rate NVIDIA publishes only per SM and clock, no less.  (Splitting
each product as Karatsuba does would need fewer digit products; the
count stays the schoolbook one so that every kernel is read against the
same work.)

Bytes: each state is read once and written once, 12 elements of 16
bytes each way, at the HBM3's 3.35 TB/s.  The least time is the larger
of the two.
"""

KERNEL = "poseidon12"            # the device kernel's name holds this
PEAK_OPS = 1.979e15              # int8 dense, operations per second
PEAK_BYTES = 3.35e12             # HBM3 bytes per second
LANES = 12
FIELD_BYTES = 16
PRODUCTS_PER_ROUND = 2 * LANES + LANES * LANES          # 168
OPS_PER_PRODUCT = 2 * FIELD_BYTES * FIELD_BYTES         # 512


def ops(states: int, rounds: int) -> float:
    return float(states) * rounds * PRODUCTS_PER_ROUND * OPS_PER_PRODUCT


def nbytes(states: int) -> float:
    return 2.0 * states * LANES * FIELD_BYTES


def least_seconds(batches, rounds: int) -> float:
    """batches: the states of each launch."""
    states = sum(batches)
    return max(ops(states, rounds) / PEAK_OPS, nbytes(states) / PEAK_BYTES)
