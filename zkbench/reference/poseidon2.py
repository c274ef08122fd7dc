"""Poseidon2 t=12 over the 128-bit prime field, as zk-lisp defines it
(zk-lisp-proof-winterfell/src/poseidon/mod.rs), for the benchmark's
reference: parameters derived per suite id from a BLAKE3 random oracle,
a 12 x 12 Cauchy MDS, x^3 S-box in every round, 27 rounds; two-lane
hash = lane 0 of the permutation of [l, r, 0 x 8, dom0, dom1].

Plain Python integers: slow and obviously right.
"""

from __future__ import annotations

from functools import lru_cache

from .blake3 import blake3
from .field import P, be_from_le8, fold32  # noqa: F401 (fold32 re-exported)

ROUNDS = 27


def fe_bytes(x: int) -> bytes:
    """16 LE bytes of x, zero-padded to 32."""
    return x.to_bytes(16, "little") + bytes(16)


def ro(domain: bytes, *parts: bytes) -> int:
    """blake3(domain || parts) folded to a field element: lo64 + hi64 * 2^64
    of its first 16 bytes."""
    return be_from_le8(blake3(domain + b"".join(parts)))


def _points(domain: bytes, sid: bytes, n: int) -> list:
    pts, ctr = [], 0
    while len(pts) < n:
        c = ro(domain, sid, bytes([len(pts)]), ctr.to_bytes(4, "little"))
        if c and c not in pts:
            pts.append(c)
        else:
            ctr = (ctr + 1) & 0xFFFFFFFF
    return pts


@lru_cache(maxsize=8)
def suite(sid: bytes, rounds: int = ROUNDS):
    """(dom0, dom1, mds 12x12, round constants rounds x 12) of a suite."""
    dom = (ro(b"zkl/poseidon2/dom/c0", sid), ro(b"zkl/poseidon2/dom/c1", sid))
    xs = _points(b"zkl/poseidon2/mds/x", sid, 12)
    ys = _points(b"zkl/poseidon2/mds/y", sid, 12)
    ctr = 0
    while any((x + y) % P == 0 for x in xs for y in ys):
        ys = [ro(b"zkl/poseidon2/mds/y", sid, bytes([j]),
                 ctr.to_bytes(4, "little")) or 1 for j in range(12)]
        ctr += 1
    mds = tuple(tuple(pow((x + y) % P, P - 2, P) for y in ys) for x in xs)
    rc = tuple(tuple(ro(b"zkl/poseidon2/rc", sid, bytes([r]), bytes([i]))
                     for i in range(12)) for r in range(rounds))
    return dom, mds, rc


@lru_cache(maxsize=8)
def rom_suite(sid: bytes, rounds: int = ROUNDS):
    """(mds 3x3, round constants rounds x 3) of the t=3 ROM accumulator
    (zk-lisp poseidon/mod.rs, rom3 domains)."""
    xs = _points(b"zkl/rom3/mds/x", sid, 3)
    ys = _points(b"zkl/rom3/mds/y", sid, 3)
    mds = tuple(tuple(pow((x + y) % P, P - 2, P) for y in ys) for x in xs)
    rc = tuple(tuple(ro(b"zkl/rom3/rc", sid, bytes([r]), bytes([i]))
                     for i in range(3)) for r in range(rounds))
    return mds, rc


def permute(state, sid: bytes, rounds: int = ROUNDS) -> list:
    _, mds, rc = suite(bytes(sid), rounds)
    s = list(state)
    for r in range(rounds):
        c = [v * v % P * v % P for v in s]
        s = [(sum(m * v for m, v in zip(row, c)) + rc[r][i]) % P
             for i, row in enumerate(mds)]
    return s


def hash2(sid: bytes, left: int, right: int) -> int:
    dom, _, _ = suite(bytes(sid))
    return permute([left, right] + [0] * 8 + list(dom), sid)[0]


def absorb(sid: bytes, inputs) -> int:
    """One sponge level of the VM: up to 10 inputs in lanes 0..9, the
    domain tags in 10 and 11, one permutation, lane 0 out."""
    if len(inputs) > 10:
        raise ValueError("sponge rate is 10 lanes")
    dom, _, _ = suite(bytes(sid))
    return permute(list(inputs) + [0] * (10 - len(inputs)) + list(dom),
                   sid)[0]
