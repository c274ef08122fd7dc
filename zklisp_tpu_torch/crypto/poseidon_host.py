"""Batched Poseidon2 over limb arrays: the numpy host half.

The host coin, the host Merkle commitments and the multiproofs call this
module with ``xp=np``; the torch counterpart is poseidon_torch.py.

The proving hot path hashes with Poseidon everywhere (trace fills, Merkle
commitments, FRI layer commitments).  The reference runs scalar Rust on CPU
(poseidon/mod.rs, poseidon/hasher.rs); here every permutation is batched
over thousands of states and executed as vectorized limb arithmetic:

  * `permute12_batch` — B parallel t=12 permutations; the MDS layer is a
    single fused multiply-accumulate (limb.dot) per output lane.
  * `hash_rows` — winterfell `hash_elements` of B rows of W field elements
    each (Merkle leaf hashing), fully vectorized over B.
  * `merge_level` — B/2 parallel digest merges (Merkle tree level).
  * `merkle_tree` — bottom-up tree build; returns all levels (device).

Digests are carried as single field elements (lane 0); the byte digest is
fe_to_bytes_fold(fe) = 16 LE bytes + 16 zero bytes, matching
poseidon/hasher.rs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as _np

from ..field import f128
from ..field import limb_host as limb
from . import poseidon as pos


@lru_cache(maxsize=None)
def _suite_arrays(suite_id: bytes, rounds: int):
    """(mds (12,12,8), rc (rounds,12,8), dom (2,8)) as numpy limb arrays."""
    s = pos.get_poseidon_suite(suite_id, rounds)
    mds = limb.from_ints(s.mds)
    rc = limb.from_ints(s.rc)
    dom = limb.from_ints(list(s.dom))
    return mds, rc, dom


@lru_cache(maxsize=None)
def _rom_arrays(suite_id: bytes):
    mds3, rc3 = pos.get_rom_suite(suite_id)
    return limb.from_ints(mds3), limb.from_ints(rc3)


def _native_ok() -> bool:
    from .. import native
    return native.available()


@lru_cache(maxsize=None)
def _suite_bytes(suite_id: bytes, rounds: int):
    """(mds, rc) as 16-byte-LE buffers for the native batch kernel."""
    s = pos.get_poseidon_suite(suite_id, rounds)
    mds_flat = [v for row in s.mds for v in row]
    rc_flat = [v for row in s.rc for v in row]
    pack = lambda vals: b"".join(int(v).to_bytes(16, "little")
                                 for v in vals)
    return pack(mds_flat), pack(rc_flat)


def permute12_batch(states, suite_id: bytes, xp, rounds: int | None = None):
    """states: (..., 12, 8) -> (..., 12, 8) after full Poseidon2."""
    rounds = rounds if rounds is not None else pos.POSEIDON_ROUNDS
    mds, rc, _ = _suite_arrays(bytes(suite_id), rounds)
    mds = xp.asarray(mds)
    rc = xp.asarray(rc)

    # numpy host path: the native C++ batch kernel when available
    # (u128 scalar arithmetic, ~20x the numpy limb path), else numpy.
    if _native_ok():
        from .. import native
        lead = states.shape[:-2]
        b = int(_np.prod(lead)) if lead else 1
        mds_b, rc_b = _suite_bytes(bytes(suite_id), rounds)
        inp = _np.ascontiguousarray(
            states.reshape(b * 12, limb.NLIMB)).astype("<u2").tobytes()
        raw = native.poseidon12_batch_raw(inp, mds_b, rc_b, b, rounds)
        out = _np.frombuffer(raw, dtype="<u2").astype(_np.uint32)
        return out.reshape(lead + (12, limb.NLIMB))

    s = states
    for r in range(rounds):
        s2 = limb.mul(s, s, xp)
        s3 = limb.mul(s2, s, xp)
        # out[..., i] = sum_j mds[i, j] * s3[..., j]  + rc[r, i]
        y = limb.dot(mds, s3[..., None, :, :], xp)
        s = limb.add(y, xp.broadcast_to(rc[r], y.shape), xp)
    return s


def permute3_batch(states, suite_id: bytes, xp):
    """states: (..., 3, 8) ROM t=3 permutation (27 rounds)."""
    mds3, rc3 = _rom_arrays(bytes(suite_id))
    mds3 = xp.asarray(mds3)
    rc3 = xp.asarray(rc3)
    s = states
    for r in range(pos.POSEIDON_ROUNDS):
        s2 = limb.mul(s, s, xp)
        s3 = limb.mul(s2, s, xp)
        y = limb.dot(mds3, s3[..., None, :, :], xp)
        s = limb.add(y, xp.broadcast_to(rc3[r], y.shape), xp)
    return s


# ---------------------------------------------------------------------------
# Vectorized winterfell-hasher sponge (domain-prefixed, rate 10)
# ---------------------------------------------------------------------------

POW2_64_INT = f128.POW2_64


def _dom_fe(domain: bytes) -> int:
    dbuf = domain[:32] + b"\x00" * max(0, 32 - len(domain))
    return f128.fold_bytes32_to_fe(dbuf)


def sponge_fes(chunk_fes, domain: bytes, xp, rounds: int | None = None):
    """Vectorized sponge over pre-folded 32-byte-chunk field elements.

    chunk_fes: (B, C, 8) — C chunk elements per row (already folded).
    Returns (B, 8): lane 0 of the final state (the digest fe).
    Mirrors poseidon/hasher.rs ro_bytes_sponge: absorb domain fe then C
    chunks into rate lanes 0..9, permuting when full and once at the end
    if a partial group remains.
    """
    rounds = rounds if rounds is not None else pos.hasher_rounds()
    B, C = chunk_fes.shape[0], chunk_fes.shape[1]
    _, _, dom = _suite_arrays(pos.HASHER_SUITE_ID, rounds)
    dom = xp.asarray(dom)

    dfe = xp.asarray(limb.from_ints([_dom_fe(domain)]))  # (1, 8)
    total = 1 + C
    state = limb.zeros((B, 12), xp)
    state = xp.concatenate(
        [state[:, :10], xp.broadcast_to(dom[None], (B, 2, limb.NLIMB))],
        axis=1)

    # stream = [domain, chunk_0, ..., chunk_{C-1}]
    stream = xp.concatenate(
        [xp.broadcast_to(dfe[None], (B, 1, limb.NLIMB)), chunk_fes], axis=1)

    n_full = total // 10
    rem = total % 10

    for gi in range(n_full):
        group = stream[:, gi * 10:(gi + 1) * 10]
        lanes = limb.add(state[:, :10], group, xp)
        state = xp.concatenate([lanes, state[:, 10:]], axis=1)
        state = permute12_batch(state, pos.HASHER_SUITE_ID, xp, rounds)

    if rem:
        tail = stream[:, n_full * 10:]
        lanes = limb.add(state[:, :rem], tail, xp)
        state = xp.concatenate([lanes, state[:, rem:]], axis=1)
        state = permute12_batch(state, pos.HASHER_SUITE_ID, xp, rounds)
    return state[:, 0]


def fold_row_chunks(rows, xp):
    """rows: (B, W, 8) field elements -> (B, ceil(W/2), 8) 32-byte chunks.

    Element serialization is 16 LE bytes each, so byte-chunk i folds
    elements (2i, 2i+1) as e0 + e1 * 2^64 (hasher.rs fold_bytes32_to_fe).
    """
    B, W = rows.shape[0], rows.shape[1]
    if W % 2 == 1:
        rows = xp.concatenate([rows, limb.zeros((B, 1), xp)], axis=1)
        W += 1
    e0 = rows[:, 0::2]
    e1 = rows[:, 1::2]
    p64 = xp.asarray(limb.from_ints([POW2_64_INT]))
    return limb.add(e0, limb.mul(e1, p64[None], xp), xp)


def hash_rows(rows, xp, domain: bytes = b"winter/hash/elements"):
    """winterfell hash_elements over B rows: (B, W, 8) -> (B, 8) digests."""
    return sponge_fes(fold_row_chunks(rows, xp), domain, xp)


def hash_rows_partitioned(rows, partition_size: int, xp):
    """Partitioned row hashing (agg/child.rs hash_row_poseidon).

    Rows are split into chunks of exactly `partition_size` elements (the
    last chunk may be smaller), each chunk hashed with hash_elements, and
    the chunk digests combined with merge_many.  A single chunk reduces to
    plain hash_elements.
    """
    B, W = rows.shape[0], rows.shape[1]
    if partition_size >= W:
        return hash_rows(rows, xp)
    n_full = W // partition_size
    rem = W - n_full * partition_size
    full = rows[:, :n_full * partition_size].reshape(
        B * n_full, partition_size, limb.NLIMB)
    digests = hash_rows(full, xp).reshape(B, n_full, limb.NLIMB)
    if rem:
        rem_digest = hash_rows(rows[:, n_full * partition_size:], xp)
        digests = xp.concatenate(
            [digests, rem_digest[:, None, :]], axis=1)
    if digests.shape[1] == 1:
        return digests[:, 0]
    # each 32-byte digest is exactly one sponge chunk (fe + 16 zero bytes)
    return sponge_fes(digests, b"zkl/winter/hash/merge_many", xp)


def merge_level(digests, xp):
    """(B, 8) sibling-adjacent digests -> (B/2, 8) parent digests."""
    B = digests.shape[0]
    pairs = digests.reshape(B // 2, 2, limb.NLIMB)
    return sponge_fes(pairs, b"zkl/winter/hash/merge", xp)


def merkle_tree(leaf_digests, xp) -> List:
    """Bottom-up Poseidon Merkle tree.

    leaf_digests: (N, 8) with N a power of two.
    Returns [leaves, level1, ..., root(1,8)] (device arrays).
    """
    levels = [leaf_digests]
    cur = leaf_digests
    while cur.shape[0] > 1:
        cur = merge_level(cur, xp)
        levels.append(cur)
    return levels
