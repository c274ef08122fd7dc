"""The 128-bit prime field of zk-lisp (winterfell's f128,
p = 2^128 - 45 * 2^40 + 1, two-adicity 40, generator 3) on plain Python
integers, for the benchmark's reference."""

from __future__ import annotations

P = (1 << 128) - 45 * (1 << 40) + 1
POW2_64 = (1 << 64) % P
TWO_ADICITY = 40
GENERATOR = 3
COSET_OFFSET = 3          # the LDE's and FRI's coset offset


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("the inverse of zero")
    return pow(a, P - 2, P)


def root_of_unity(n: int) -> int:
    """The primitive n-th root of unity, n a power of two."""
    if n <= 0 or n & (n - 1) or n.bit_length() - 1 > TWO_ADICITY:
        raise ValueError(f"no root of unity of order {n}")
    g = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    return pow(g, 1 << (TWO_ADICITY - (n.bit_length() - 1)), P)


def be_from_le8(b32: bytes) -> int:
    """lo64 + hi64 * 2^64 (mod p) of the first 16 bytes."""
    return (int.from_bytes(b32[0:8], "little")
            + int.from_bytes(b32[8:16], "little") * POW2_64) % P


def fold32(b32: bytes) -> int:
    """lo128 + hi128 * 2^64 (mod p) of 32 bytes."""
    return (int.from_bytes(b32[:16], "little") % P
            + (int.from_bytes(b32[16:32], "little") % P) * POW2_64) % P


class Felt:
    """A field value with the operators the AIR's expressions use."""
    __slots__ = ("v",)

    def __init__(self, v: int) -> None:
        self.v = v % P

    def __add__(self, o):
        return Felt(self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return Felt(self.v - _val(o))

    def __rsub__(self, o):
        return Felt(_val(o) - self.v)

    def __mul__(self, o):
        return Felt(self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return Felt(-self.v)

    def __repr__(self):
        return f"Felt({self.v})"


def _val(o) -> int:
    return o.v if isinstance(o, Felt) else o
