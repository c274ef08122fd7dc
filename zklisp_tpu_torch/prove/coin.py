"""Fiat-Shamir random coin over the Poseidon hasher.

Models winterfell's `DefaultRandomCoin<PoseidonHasher>` exactly as the
reference's FS replay assumes (src/agg/fs.rs treats its sequence as the
spec):

  * seed = hash_elements(seed_elements)
  * reseed(digest): seed = merge(seed, digest); counter = 0
  * draw(): counter += 1; digest = merge_with_int(seed, counter);
    candidate = first 16 LE bytes as u128; retry until < p
  * draw_integers(n, domain_size, nonce): seed = merge_with_int(seed,
    nonce) then draw n masked u64 values
  * check_leading_zeros(nonce): trailing zeros of LE u64 head of
    merge_with_int(seed, nonce)

Draws do not mutate the seed — only `reseed` does — which is why the
reference can skip constraint-coefficient draws when replaying the
transcript.
"""

from __future__ import annotations

from typing import List, Sequence

from ..crypto import poseidon as pos
from ..field import f128


class RandomCoin:
    def __init__(self, seed_elements: Sequence[int]) -> None:
        self.seed = pos.hash_elements(list(seed_elements))
        self.counter = 0

    def reseed(self, digest: bytes) -> None:
        assert len(digest) == 32
        self.seed = pos.merge(self.seed, digest)
        self.counter = 0

    def draw(self) -> int:
        """Draw a base-field element."""
        for _ in range(1000):
            self.counter += 1
            digest = pos.merge_with_int(self.seed, self.counter)
            value = int.from_bytes(digest[0:16], "little")
            if value < f128.P:
                return value
        raise RuntimeError("failed to draw a valid field element")

    def draw_many(self, n: int) -> List[int]:
        """n draws; identical to n draw() calls.

        Vectorized through the batched numpy sponge: each draw is one
        merge_with_int(seed, counter) permutation, and the candidate
        value (first 16 digest bytes) IS the lane-0 field element, which
        is always canonical (< p) — the scalar retry loop can never
        trigger — so the batch is exact.  ~100x faster for the ~700
        coefficient draws per segment.
        """
        if n < 8:
            return [self.draw() for _ in range(n)]
        import numpy as np

        from ..crypto import poseidon_host as pj
        from ..field import f128
        from ..field import limb_host as limb

        seed_fe = f128.fold_bytes32_to_fe(self.seed)
        seed_limbs = limb.from_ints([seed_fe])
        counters = np.arange(self.counter + 1, self.counter + n + 1,
                             dtype=np.uint64)
        chunk1 = limb.from_u64(counters, np)
        chunk0 = np.broadcast_to(seed_limbs[None, 0], (n, limb.NLIMB))
        fes = np.stack([chunk0, chunk1], axis=1)
        out = pj.sponge_fes(fes, b"zkl/winter/hash/merge_with_int", np)
        self.counter += n
        return [int(v) for v in limb.to_ints(out)]

    def draw_integers(self, num_values: int, domain_size: int,
                      nonce: int) -> List[int]:
        assert domain_size & (domain_size - 1) == 0
        self.seed = pos.merge_with_int(self.seed, nonce)
        self.counter = 0
        v_mask = domain_size - 1
        values: List[int] = []
        for _ in range(1000):
            if len(values) >= num_values:
                break
            self.counter += 1
            digest = pos.merge_with_int(self.seed, self.counter)
            value = int.from_bytes(digest[0:8], "little") & v_mask
            values.append(value)
        if len(values) < num_values:
            raise RuntimeError("failed to draw enough query positions")
        return values

    def check_leading_zeros(self, nonce: int) -> int:
        digest = pos.merge_with_int(self.seed, nonce)
        head = int.from_bytes(digest[0:8], "little")
        if head == 0:
            return 64
        return (head & -head).bit_length() - 1

    def grind(self, grinding_factor: int, device=None) -> int:
        """Find the smallest nonce whose check_leading_zeros >=
        grinding_factor (`grind_many` of this coin alone)."""
        return RandomCoin.grind_many([self], grinding_factor, device)[0]

    @staticmethod
    def grind_many(coins: List["RandomCoin"], grinding_factor: int,
                   device=None) -> List[int]:
        """Per coin, the smallest nonce whose check_leading_zeros >=
        grinding_factor: each coin's `grind`, all coins searched at once.

        The search is an embarrassingly parallel Poseidon scan (one
        permutation per candidate): merge_with_int(seed, v) absorbs
        exactly two chunks — fold(seed) and v — and the pass/fail test
        is `low 64 bits of the digest = 0 (mod 2^g)`.  It runs on
        `device`, which the caller hands in (default: the CUDA card):
        sweeps of 2^16 candidates per coin on a CUDA card (through the
        poseidon12 kernel, one launch and one copy of S integers per
        sweep), smaller sweeps on the CPU.  Every sweep scans every coin
        (one batch shape for the wave); sweeps go in ascending order and
        each returns every coin's FIRST hit, so each result is that
        coin's smallest passing nonce."""
        if grinding_factor <= 0:
            return [0] * len(coins)
        from ..device import resolve
        from ..field import f128, limb
        from . import kernels

        dev = resolve(device)
        seeds = limb.from_ints(
            [f128.fold_bytes32_to_fe(c.seed) for c in coins], dev)
        if dev.type == "cuda":
            batch = 1 << 16
        else:
            batch = max(1024, min(1 << 13, 2 << grinding_factor))
        nonces: List[int | None] = [None] * len(coins)
        start = 0
        while start < (1 << 62):
            hits = kernels.grind_hit_many(seeds, start, batch,
                                          grinding_factor)
            for i, h in enumerate(hits):
                if nonces[i] is None and h < batch:
                    nonces[i] = start + h
            if all(v is not None for v in nonces):
                return nonces
            start += batch
        raise RuntimeError("grinding failed to find a nonce")
