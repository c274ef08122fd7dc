"""The Merkle and Fiat-Shamir hasher of zk-lisp's winterfell proofs, for
the benchmark's check of a step proof's openings: Poseidon2 t=12 of the
all-zero suite (reference/poseidon2.py) in a rate-10 sponge over 32-byte
chunks, each chunk folded to a field element (lo128 + hi128 * 2^64), the
domain tag first (zk-lisp poseidon/hasher.rs).

Many hashes of one shape go through one batched permutation in plain
PyTorch, on the card where the run has one.  A field element is 8 limbs
of 16 bits in int64, kept lazily: every limb below 2^18, the value below
about 2^130 and reduced to [0, p) only when read back.  A product of limb
vectors is an anti-diagonal sum of 16-bit products and the dense MDS a
sum of 96 of them; each such sum stays below 2^40, so a float64 matrix
product computes it exactly.  `tests/test_zkbench_stark.py` holds it
against the plain-integer permutation of reference/poseidon2.py.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import poseidon2
from .field import P, fold32

SUITE = bytes(32)                         # the hasher's suite id
RATE = 10
MASK = 0xFFFF
I64, F64 = torch.int64, torch.float64


def domain_fe(domain: bytes) -> int:
    return fold32(domain[:32].ljust(32, b"\x00"))


def to_limbs(values: Sequence[int], device) -> torch.Tensor:
    """Field elements (ints in [0, p)) as a (len, 8) int64 tensor."""
    raw = b"".join(int(v).to_bytes(16, "little") for v in values)
    arr = np.frombuffer(raw, dtype="<u2").astype(np.int64)
    return torch.from_numpy(arr.reshape(len(values), 8)).to(device)


def to_ints(limbs: torch.Tensor) -> List[int]:
    """Lazy limbs (..., 8) read back as ints in [0, p), flattened."""
    out = []
    for row in limbs.reshape(-1, 8).cpu().tolist():
        v = 0
        for i in reversed(range(8)):
            v = (v << 16) + row[i]
        out.append(v % P)
    return out


def _pass(x: torch.Tensor) -> torch.Tensor:
    """One carry pass: every limb but the top keeps 16 bits and hands the
    rest up; the top limb keeps all of its own."""
    hi = x[..., :-1] >> 16
    out = x.clone()
    out[..., :-1] &= MASK
    out[..., 1:] += hi
    return out


def _carry(x: torch.Tensor, width: int) -> torch.Tensor:
    """Limbs below 2^40 -> `width` limbs below 2^17 of the same value
    (two passes: 2^40 -> 2^16 + 2^24 -> 2^16 + 2^8)."""
    if x.shape[-1] < width:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1],
                                      width - x.shape[-1])], dim=-1)
    return _pass(_pass(x))


def _residues(width: int) -> torch.Tensor:
    """(width, 8): row i the limbs of 2^(16 i) mod p."""
    return to_limbs([pow(2, 16 * i, P) for i in range(width)],
                    "cpu").to(F64)


def _conv(width_a: int, width_b: int) -> torch.Tensor:
    """(width_a * width_b, width_a + width_b - 1) 0/1: the anti-diagonal
    sums of a flattened outer product of two limb vectors."""
    d = torch.zeros(width_a, width_b, width_a + width_b - 1, dtype=F64)
    for i in range(width_a):
        for j in range(width_b):
            d[i, j, i + j] = 1
    return d.reshape(width_a * width_b, -1)


class Permutation:
    """Poseidon2 t=12 of one suite, batched: x^3 on every lane, then the
    dense MDS and the round constants, `rounds` times.

    A round reduces once: s (8 limbs) squared is 15 limbs, carried to 17;
    times s, 24 limbs, carried to 26; the MDS of those, 33 limbs; each
    limb sum stays below 2^40.  The reduction carries the 33 limbs to 35
    below 2^17 and maps limb i >= 8 onto the limbs of 2^(16 i) mod p
    (below 2^38 each), then twice more with the 3 and 1 top limbs that
    the carries leave, and carries into 8."""

    def __init__(self, sid: bytes, rounds: int, device) -> None:
        self.device = torch.device(device)
        dom, mds, rc = poseidon2.suite(bytes(sid), rounds)
        self.dom = dom
        self.sq = _conv(8, 8).to(self.device)
        self.cube = _conv(17, 8).to(self.device)
        # out[k] = sum_j mds[k][j] * c[j], limb by limb:
        # W[(j, s), (k, t)] = limb t - s of mds[k][j]
        m = to_limbs([mds[k][j] for k in range(12) for j in range(12)],
                     "cpu").reshape(12, 12, 8).permute(1, 0, 2).to(F64)
        w = torch.zeros(12, 26, 12, 33, dtype=F64)
        for s in range(26):
            w[:, s, :, s:s + 8] = m
        self.w = w.reshape(12 * 26, 12 * 33).to(self.device)
        self.fold = {k: _residues(k)[8:].to(self.device)
                     for k in (35, 11, 9)}
        self.rc = [to_limbs(r, self.device) for r in rc]

    def _product(self, a, b, conv):
        outer = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
        return (outer.to(F64) @ conv).to(I64)

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        for width in (35, 11, 9):
            x = _carry(x, width)
            hi = (x[..., 8:].to(F64) @ self.fold[width]).to(I64)
            x = x[..., :8] + hi
        return _pass(_pass(x))

    def __call__(self, s: torch.Tensor) -> torch.Tensor:
        """(B, 12, 8) lazy limbs -> the same after the permutation."""
        B = s.shape[0]
        for rc in self.rc:
            s2 = _carry(self._product(s, s, self.sq), 17)
            s3 = _carry(self._product(s2, s, self.cube), 26)
            t = (s3.reshape(B, 12 * 26).to(F64) @ self.w).to(I64)
            t = t.reshape(B, 12, 33)
            t[..., :8] += rc
            s = self._reduce(t)
        return s


class Hasher:
    """The sponge and the digests made from it, each over a batch of
    inputs of one shape.  Digests are field elements (ints): the 32-byte
    digest of x is fe_bytes(x) and folds back to x."""

    def __init__(self, rounds: int, device) -> None:
        self.perm = Permutation(SUITE, rounds, device)
        self.device = self.perm.device

    def sponge(self, domain: bytes, msgs: Sequence[Sequence[int]]
               ) -> List[int]:
        """Lane 0 after absorbing [domain tag, *msgs[b]] for every b (all
        of one length), a permutation after every 10 and at the end."""
        B = len(msgs)
        if B == 0:
            return []
        flat = [domain_fe(domain)] * B
        K = len(msgs[0]) + 1
        rows = [[flat[b]] + list(msgs[b]) for b in range(B)]
        if any(len(r) != K for r in rows):
            raise ValueError("a batch of the sponge has one length")
        m = to_limbs([v for r in rows for v in r],
                     self.device).reshape(B, K, 8)
        s = torch.zeros(B, 12, 8, dtype=I64, device=self.device)
        s[:, 10:12] = to_limbs(self.perm.dom, self.device)
        for k0 in range(0, K, RATE):
            blk = m[:, k0:k0 + RATE]
            s[:, :blk.shape[1]] += blk
            s = self.perm(_pass(s))
        return to_ints(s[:, 0])

    def hash_elements(self, rows: Sequence[Sequence[int]]) -> List[int]:
        """winterfell hash_elements of each row: 16 LE bytes an element,
        so a 32-byte chunk folds to e[2i] + e[2i+1] * 2^64."""
        msgs = []
        for r in rows:
            msgs.append([(r[i] + (r[i + 1] if i + 1 < len(r) else 0)
                          * _POW64) % P for i in range(0, len(r), 2)])
        return self.sponge(b"winter/hash/elements", msgs)

    def merge(self, pairs: Sequence[Sequence[int]]) -> List[int]:
        return self.sponge(b"zkl/winter/hash/merge", pairs)

    def merge_with_int(self, seeds: Sequence[int],
                       values: Sequence[int]) -> List[int]:
        return self.sponge(b"zkl/winter/hash/merge_with_int",
                           [[s, v] for s, v in zip(seeds, values)])


_POW64 = (1 << 64) % P
