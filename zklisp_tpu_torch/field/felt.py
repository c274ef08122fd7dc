"""Operator-overloaded field values: host scalars and device vectors.

AIR constraint expressions are written once against this interface and
evaluated either:
  * per-row on host ints (`Felt`) — preflight / OOD checks / unit tests
  * per-column over the whole LDE domain as limb arrays (`FVec`) — the
    prover's batched constraint evaluation on device

Both represent f128 elements; `FVec` wraps a (..., 8) uint32 limb array
plus the array namespace (numpy or jax.numpy).
"""

from __future__ import annotations

from typing import Union

import numpy as _np

from . import f128
from . import limb_host as limb

P = f128.P


class Felt:
    __slots__ = ("v",)

    def __init__(self, v: int) -> None:
        self.v = v % P

    def __add__(self, o):
        v = _val(o)
        if v is None:
            return NotImplemented
        return Felt(self.v + v)

    __radd__ = __add__

    def __sub__(self, o):
        v = _val(o)
        if v is None:
            return NotImplemented
        return Felt(self.v - v)

    def __rsub__(self, o):
        v = _val(o)
        if v is None:
            return NotImplemented
        return Felt(v - self.v)

    def __mul__(self, o):
        v = _val(o)
        if v is None:
            return NotImplemented
        return Felt(self.v * v)

    __rmul__ = __mul__

    def __neg__(self):
        return Felt(-self.v)

    def __eq__(self, o):
        return self.v == _val(o)

    def __hash__(self):
        return hash(self.v)

    def inv(self):
        return Felt(f128.inv(self.v))

    def __repr__(self):
        return f"Felt({self.v})"


def _val(o):
    if isinstance(o, Felt):
        return o.v
    if isinstance(o, int):
        return o
    return None


class FVec:
    """Vector of field elements as a limb array; shape excludes limb dim."""

    __slots__ = ("a", "xp")

    def __init__(self, a, xp) -> None:
        self.a = a
        self.xp = xp

    # -- constructors --

    @staticmethod
    def from_ints(values, xp) -> "FVec":
        return FVec(xp.asarray(limb.from_ints(values)), xp)

    @staticmethod
    def const(v: int, shape, xp) -> "FVec":
        base = limb.from_ints([v % P])[0]
        a = xp.broadcast_to(xp.asarray(base), tuple(shape) + (limb.NLIMB,))
        return FVec(a, xp)

    @staticmethod
    def zeros(shape, xp) -> "FVec":
        return FVec(limb.zeros(shape, xp), xp)

    # -- arithmetic --

    def _coerce(self, o) -> "FVec":
        if isinstance(o, FVec):
            return o
        if isinstance(o, Felt):
            return FVec.const(o.v, self.shape, self.xp)
        return FVec.const(int(o), self.shape, self.xp)

    def __add__(self, o):
        o = self._coerce(o)
        return FVec(limb.add(self.a, o.a, self.xp), self.xp)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return FVec(limb.sub(self.a, o.a, self.xp), self.xp)

    def __rsub__(self, o):
        return self._coerce(o).__sub__(self)

    def __mul__(self, o):
        o = self._coerce(o)
        return FVec(limb.mul(self.a, o.a, self.xp), self.xp)

    __rmul__ = __mul__

    def __neg__(self):
        return FVec(limb.neg(self.a, self.xp), self.xp)

    @property
    def shape(self):
        return self.a.shape[:-1]

    def to_ints(self):
        return list(limb.to_ints(_np.asarray(self.a)))

    def __repr__(self):
        return f"FVec(shape={self.shape})"


ONE = Felt(1)
ZERO = Felt(0)
