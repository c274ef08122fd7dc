"""Host-side f128 field arithmetic (scalar + numpy-vectorized).

The field is Winterfell's `f128`: p = 2^128 - 45 * 2^40 + 1
(reference: zk-lisp uses winterfell::math::fields::f128::BaseElement
throughout, imported at zk-lisp-proof-winterfell/src/lib.rs:40).

Properties:
  * two-adicity 40 (p - 1 = 2^40 * m with m odd)
  * multiplicative generator g = 3
  * canonical (non-Montgomery) integer representation in [0, p)

Host scalars are plain Python ints (exact, arbitrary precision).  Vector
math on the host uses numpy uint64 limb arrays via :mod:`f128_numpy`;
device math uses JAX limb arrays via :mod:`f128_jax`.  All three agree
bit-exactly and are cross-tested in tests/test_f128.py.
"""

from __future__ import annotations

# Field modulus: 2^128 - 45*2^40 + 1
P = (1 << 128) - 45 * (1 << 40) + 1

# p = 2^128 - C128  =>  2^128 ≡ C128 (mod p)
C128 = 45 * (1 << 40) - 1

TWO_ADICITY = 40

# Multiplicative generator of F_p^* (matches winterfell f128 GENERATOR = 3;
# also used by the reference's ROM weight schedule, utils.rs:114-141).
GENERATOR = 3

# 2^40-th primitive root of unity: g^((p-1) / 2^40)
ROOT_OF_UNITY = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return (P - a) if a else 0


def mul(a: int, b: int) -> int:
    return (a * b) % P


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("f128 inverse of zero")
    return pow(a, P - 2, P)


def batch_inv(xs):
    """Montgomery batch inversion; zeros map to zero (like winterfell)."""
    n = len(xs)
    out = [0] * n
    prefix = [0] * n
    acc = 1
    for i, x in enumerate(xs):
        prefix[i] = acc
        if x:
            acc = (acc * x) % P
    acc = pow(acc, P - 2, P)
    for i in range(n - 1, -1, -1):
        x = xs[i]
        if x:
            out[i] = (acc * prefix[i]) % P
            acc = (acc * x) % P
    return out


def get_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity (n must be a power of two <= 2^40)."""
    assert n > 0 and (n & (n - 1)) == 0, "n must be a power of two"
    log_n = n.bit_length() - 1
    assert log_n <= TWO_ADICITY
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)


# ---------------------------------------------------------------------------
# Byte/int encodings (reference: utils.rs:50-97, 346-390)
# ---------------------------------------------------------------------------

POW2_64 = pow(2, 64, P)


def from_u128(n: int) -> int:
    """Reduce a u128 into the field (utils.rs `be_from_u128`)."""
    return n % P


def from_le_bytes16(b16: bytes) -> int:
    assert len(b16) == 16
    return int.from_bytes(b16, "little") % P


def fold_bytes32_to_fe(b32: bytes) -> int:
    """utils.rs `fold_bytes32_to_fe`: lo128 + hi128 * 2^64 (mod p)."""
    assert len(b32) == 32
    a = from_le_bytes16(b32[0:16])
    b = from_le_bytes16(b32[16:32])
    return (a + b * POW2_64) % P


def fe_to_bytes_fold(x: int) -> bytes:
    """utils.rs `fe_to_bytes_fold`: 16 LE bytes of x, zero-padded to 32."""
    return x.to_bytes(16, "little") + b"\x00" * 16


def fe_from_bytes_fold(b32: bytes) -> int:
    """utils.rs `fe_from_bytes_fold`: low 16 LE bytes as field element."""
    return from_le_bytes16(b32[0:16])


def be_from_le8(b32: bytes) -> int:
    """utils.rs `be_from_le8`: fold first 16 bytes as lo64 + hi64 * 2^64."""
    lo = int.from_bytes(b32[0:8], "little")
    hi = int.from_bytes(b32[8:16], "little")
    return (lo + hi * POW2_64) % P


def to_bytes16(x: int) -> bytes:
    """Canonical 16-byte LE serialization (winterfell element encoding)."""
    return x.to_bytes(16, "little")


def from_bytes16(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= P:
        raise ValueError("non-canonical f128 element encoding")
    return v
