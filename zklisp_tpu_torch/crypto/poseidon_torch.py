"""Batched Poseidon2 sponge, row hashing and Merkle trees on PyTorch
tensors (counterpart of the JAX package's crypto/poseidon_jax.py).

Every permutation goes through `poseidon_cuda.permute12`: on a CUDA
tensor that is the hand-written kernel at every batch size, on a CPU
tensor its plain version.

  * `permute12_batch` — B parallel t=12 permutations.
  * `hash_rows` — winterfell `hash_elements` of B rows of W field
    elements each (Merkle leaf hashing), vectorized over B.
  * `merge_level` — B/2 parallel digest merges (Merkle tree level).
  * `merkle_tree` — bottom-up build of one tree, or of several equal
    trees laid end to end (a wave's segments): each level is ONE merge
    over every tree, since siblings never cross a tree.

Digests are carried as single field elements (lane 0); the byte digest is
fe_to_bytes_fold(fe) = 16 LE bytes + 16 zero bytes.
"""

from __future__ import annotations

from typing import List

import torch

from ..field import f128, limb
from . import poseidon as pos
from . import poseidon_cuda
from .poseidon_host import _dom_fe

POW2_64_INT = f128.POW2_64

_FE_CACHE: dict = {}


def _fe_const(value: int, device):
    """(1, 8) limb tensor of one field constant, uploaded once per
    device: the sponges below run inside loops that must not touch the
    host (the FRI chain)."""
    key = (value, str(device))
    t = _FE_CACHE.get(key)
    if t is None:
        t = limb.from_ints([value], device)
        _FE_CACHE[key] = t
    return t


def permute12_batch(states, suite_id: bytes, rounds: int | None = None):
    """states: (..., 12, 8) -> (..., 12, 8) after full Poseidon2."""
    rounds = rounds if rounds is not None else pos.POSEIDON_ROUNDS
    return poseidon_cuda.permute12(states, bytes(suite_id), rounds)


def sponge_fes(chunk_fes, domain: bytes, rounds: int | None = None):
    """Vectorized sponge over pre-folded 32-byte-chunk field elements.

    chunk_fes: (B, C, 8) — C chunk elements per row (already folded).
    Returns (B, 8): lane 0 of the final state (the digest fe).
    Absorbs the domain fe then the C chunks into rate lanes 0..9,
    permuting when full and once at the end if a partial group remains.
    """
    rounds = rounds if rounds is not None else pos.hasher_rounds()
    B, C = chunk_fes.shape[0], chunk_fes.shape[1]
    dev = chunk_fes.device
    _, _, dom = poseidon_cuda.suite_tensors(pos.HASHER_SUITE_ID, rounds, dev)

    dfe = _fe_const(_dom_fe(domain), dev)                    # (1, 8)
    total = 1 + C
    state = limb.zeros((B, 12), dev)
    state[:, 10:] = dom

    # stream = [domain, chunk_0, ..., chunk_{C-1}]
    stream = torch.cat([dfe[None].expand(B, 1, limb.NLIMB), chunk_fes],
                       dim=1)
    n_full = total // 10
    rem = total % 10
    for gi in range(n_full):
        state[:, :10] = limb.add(state[:, :10],
                                 stream[:, gi * 10:(gi + 1) * 10])
        state = permute12_batch(state, pos.HASHER_SUITE_ID, rounds)
    if rem:
        state[:, :rem] = limb.add(state[:, :rem], stream[:, n_full * 10:])
        state = permute12_batch(state, pos.HASHER_SUITE_ID, rounds)
    return state[:, 0]


def fold_row_chunks(rows):
    """rows: (B, W, 8) field elements -> (B, ceil(W/2), 8) 32-byte chunks.

    Element serialization is 16 LE bytes each, so byte-chunk i folds
    elements (2i, 2i+1) as e0 + e1 * 2^64.
    """
    B, W = rows.shape[0], rows.shape[1]
    if W % 2 == 1:
        rows = torch.cat([rows, limb.zeros((B, 1), rows.device)], dim=1)
    e0 = rows[:, 0::2]
    e1 = rows[:, 1::2]
    p64 = _fe_const(POW2_64_INT, rows.device)
    return limb.add(e0, limb.mul(e1, p64))


def hash_rows(rows, domain: bytes = b"winter/hash/elements"):
    """winterfell hash_elements over B rows: (B, W, 8) -> (B, 8) digests."""
    return sponge_fes(fold_row_chunks(rows), domain)


def hash_rows_partitioned(rows, partition_size: int):
    """Partitioned row hashing.

    Rows are split into chunks of exactly `partition_size` elements (the
    last chunk may be smaller), each chunk hashed with hash_elements, and
    the chunk digests combined with merge_many.  A single chunk reduces to
    plain hash_elements.
    """
    B, W = rows.shape[0], rows.shape[1]
    if partition_size >= W:
        return hash_rows(rows)
    n_full = W // partition_size
    rem = W - n_full * partition_size
    full = rows[:, :n_full * partition_size].reshape(
        B * n_full, partition_size, limb.NLIMB)
    digests = hash_rows(full).reshape(B, n_full, limb.NLIMB)
    if rem:
        rem_digest = hash_rows(rows[:, n_full * partition_size:])
        digests = torch.cat([digests, rem_digest[:, None, :]], dim=1)
    if digests.shape[1] == 1:
        return digests[:, 0]
    # each 32-byte digest is exactly one sponge chunk (fe + 16 zero bytes)
    return sponge_fes(digests, b"zkl/winter/hash/merge_many")


def merge_level(digests):
    """(B, 8) sibling-adjacent digests -> (B/2, 8) parent digests."""
    B = digests.shape[0]
    pairs = digests.reshape(B // 2, 2, limb.NLIMB)
    return sponge_fes(pairs, b"zkl/winter/hash/merge")


def merkle_tree(leaf_digests, n_trees: int = 1) -> List:
    """Bottom-up Poseidon Merkle tree(s).

    leaf_digests: (n_trees * N, 8), the leaves of `n_trees` trees of N
    leaves each (N a power of two) laid end to end.  Returns [leaves,
    level1, ..., roots (n_trees, 8)] (tensors on the same device); level
    d holds every tree's nodes of that level, tree t at rows
    [t * N >> d, (t + 1) * N >> d), so sibling and parent indices are
    those of one tree (i ^ 1, i >> 1) and a sibling path of leaf p of
    tree t is the path of leaf t * N + p."""
    levels = [leaf_digests]
    cur = leaf_digests
    while cur.shape[0] > n_trees:
        cur = merge_level(cur)
        levels.append(cur)
    return levels
