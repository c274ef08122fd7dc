"""Quadratic extension of f128: F[φ] / (φ² − φ − 1).

The reference verifies (and therefore proves) its aggregation STARK over
winterfell's `QuadExtension<BaseElement>` whenever ≥128-bit conjectured
security is requested (zk-lisp-proof-winterfell/src/lib.rs:352-378,
src/prove.rs:732-800).  winter-math defines that extension by the
irreducible polynomial x² − x − 1; this module reimplements the same
algebra from that definition (spec-derived — see PARITY.md):

  (a0 + a1φ)(b0 + b1φ) = (a0b0 + a1b1) + (a0b1 + a1b0 + a1b1)φ
  conj(a + bφ) = (a + b) − bφ          (the other root of x² − x − 1)
  norm(a + bφ) = a² + ab − b²          (x · conj(x), lands in f128)
  inv(x) = conj(x) / norm(x)

Elements are (re, im) int tuples; `QFelt` wraps them with the operator
interface of `felt.Felt`, so AIR constraint expressions written against
Felt evaluate unchanged on extension values (used for the aggregation
verifier's OOD consistency check).

Aggregation traces are tiny (31 columns × #children rows, min 8), so the
extension path is host-scalar Python — no limb vectorization needed.
"""

from __future__ import annotations

from typing import Tuple

from . import f128

P = f128.P

QElem = Tuple[int, int]

ZERO: QElem = (0, 0)
ONE: QElem = (1, 0)


def from_base(v: int) -> QElem:
    return (v % P, 0)


def add(a: QElem, b: QElem) -> QElem:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub(a: QElem, b: QElem) -> QElem:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def neg(a: QElem) -> QElem:
    return (-a[0] % P, -a[1] % P)


def mul(a: QElem, b: QElem) -> QElem:
    a0, a1 = a
    b0, b1 = b
    t = a1 * b1 % P
    return ((a0 * b0 + t) % P, (a0 * b1 + a1 * b0 + t) % P)


def mul_base(a: QElem, k: int) -> QElem:
    return (a[0] * k % P, a[1] * k % P)


def conj(a: QElem) -> QElem:
    return ((a[0] + a[1]) % P, -a[1] % P)


def norm(a: QElem) -> int:
    a0, a1 = a
    return (a0 * a0 + a0 * a1 - a1 * a1) % P


def inv(a: QElem) -> QElem:
    if a == (0, 0):
        return (0, 0)  # winterfell convention: inv(0) = 0
    n_inv = f128.inv(norm(a))
    c = conj(a)
    return (c[0] * n_inv % P, c[1] * n_inv % P)


def exp(a: QElem, e: int) -> QElem:
    result = ONE
    base = a
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def eq(a: QElem, b: QElem) -> bool:
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


# --- packed-int container encoding ------------------------------------------
# Proof containers and codecs store one extension element as a single int
# re + (im << 128); base-field values pack with im = 0.  (The wire format
# writes 32 LE bytes per element in extension mode — see formats._w_fe.)

def pack(a: QElem) -> int:
    return (a[0] % P) | ((a[1] % P) << 128)


def unpack(v: int) -> QElem:
    return (v & ((1 << 128) - 1), v >> 128)


def flatten(vals) -> list:
    """[QElem] -> interleaved base components [re0, im0, re1, im1, ...]
    (the order winterfell's `as_base_elements` exposes for hashing)."""
    out = []
    for v in vals:
        out.append(v[0] % P)
        out.append(v[1] % P)
    return out


class QFelt:
    """Operator-overloaded extension scalar, interoperable with Felt/int."""

    __slots__ = ("v",)

    def __init__(self, v) -> None:
        if isinstance(v, QFelt):
            self.v = v.v
        elif isinstance(v, tuple):
            self.v = (v[0] % P, v[1] % P)
        else:
            self.v = (int(v) % P, 0)

    def __add__(self, o):
        o = _coerce(o)
        if o is None:
            return NotImplemented
        return QFelt(add(self.v, o))

    __radd__ = __add__

    def __sub__(self, o):
        o = _coerce(o)
        if o is None:
            return NotImplemented
        return QFelt(sub(self.v, o))

    def __rsub__(self, o):
        o = _coerce(o)
        if o is None:
            return NotImplemented
        return QFelt(sub(o, self.v))

    def __mul__(self, o):
        o = _coerce(o)
        if o is None:
            return NotImplemented
        return QFelt(mul(self.v, o))

    __rmul__ = __mul__

    def __neg__(self):
        return QFelt(neg(self.v))

    def __eq__(self, o):
        o = _coerce(o)
        return o is not None and eq(self.v, o)

    def __hash__(self):
        return hash(self.v)

    def inv(self) -> "QFelt":
        return QFelt(inv(self.v))

    def __repr__(self):
        return f"QFelt({self.v[0]}, {self.v[1]})"


def _coerce(o):
    if isinstance(o, QFelt):
        return o.v
    if isinstance(o, int):
        return (o % P, 0)
    # felt.Felt (avoid import cycle: duck-type on .v being an int)
    v = getattr(o, "v", None)
    if isinstance(v, int):
        return (v % P, 0)
    return None
