"""Merkle vector commitments over batched Poseidon digests.

Leaves are matrix rows hashed with the partitioned winterfell row-hash
(crypto/poseidon_jax.hash_rows_partitioned); interior nodes use the
`zkl/winter/hash/merge` sponge.  The tree is built level-by-level with
batched permutations (device-friendly); openings serialize digests as
fe_to_bytes_fold (16 LE bytes + 16 zeros), and verification recomputes the
root with the same path walk as the reference aggregation layer
(agg/child.rs merkle_root_from_leaf).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as _np

from ..crypto import poseidon as pos
from ..crypto import poseidon_host as pj
from ..field import f128
from ..field import limb_host as limb


@dataclass
class MerkleCommitment:
    levels: List          # [leaves(N,8), ..., root(1,8)] limb arrays (host)
    root_fe: int

    @property
    def root(self) -> bytes:
        return f128.fe_to_bytes_fold(self.root_fe)

    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    def open(self, index: int) -> List[bytes]:
        """Sibling path (bottom-up) for a leaf index."""
        path = []
        idx = index
        for level in self.levels[:-1]:
            sib = idx ^ 1
            fe = int(limb.to_ints(level[sib:sib + 1])[0])
            path.append(f128.fe_to_bytes_fold(fe))
            idx >>= 1
        return path


def commit_rows(rows, partition_size: int, xp) -> MerkleCommitment:
    """rows: (N, W, 8) limb array; N a power of two."""
    leaves = pj.hash_rows_partitioned(rows, partition_size, xp)
    levels = pj.merkle_tree(leaves, xp)
    levels = [_np.asarray(lv) for lv in levels]
    root_fe = int(limb.to_ints(levels[-1])[0])
    return MerkleCommitment(levels, root_fe)


def hash_row_host(row: Sequence[int], partition_size: int) -> bytes:
    """Host reference of the leaf hash (agg/child.rs hash_row_poseidon)."""
    if partition_size <= 0:
        return pos.hash_bytes(b"")
    digests = []
    for i in range(0, len(row), partition_size):
        digests.append(pos.hash_elements(list(row[i:i + partition_size])))
    if len(digests) == 1:
        return digests[0]
    return pos.merge_many(digests)


def merkle_root_from_leaf(leaf: bytes, index: int,
                          siblings: Sequence[bytes]) -> bytes:
    acc = leaf
    idx = index
    for sib in siblings:
        if idx & 1 == 0:
            acc = pos.merge(acc, sib)
        else:
            acc = pos.merge(sib, acc)
        idx >>= 1
    return acc


def verify_opening(root: bytes, leaf: bytes, index: int,
                   siblings: Sequence[bytes]) -> bool:
    return merkle_root_from_leaf(leaf, index, siblings) == root


def hash_rows_host_batch(rows: Sequence[Sequence[int]],
                         partition_size: int) -> List[bytes]:
    """Batched hash_row_host: one vectorized sponge over all rows.

    Routes every Poseidon permutation through the native batch kernel
    (B states per call) instead of one native call per permutation —
    the scalar path costs ~110 us of call overhead per permutation,
    which dominates aggregation trace building at q=64.
    """
    from ..crypto import poseidon_host as pj
    rows_l = limb.from_ints([list(r) for r in rows])   # (B, W, 8)
    digests = pj.hash_rows_partitioned(rows_l, partition_size, _np)
    return [f128.fe_to_bytes_fold(int(v))
            for v in limb.to_ints(digests)]


def merkle_roots_host_batch(leaves: Sequence[bytes],
                            indices: Sequence[int],
                            sibling_paths: Sequence[Sequence[bytes]]
                            ) -> List[bytes]:
    """Batched merkle_root_from_leaf over equal-depth paths.

    One vectorized merge (native Poseidon batch) per tree level instead
    of one scalar permutation per (path, level)."""
    from ..crypto import poseidon_host as pj
    B = len(leaves)
    if B == 0:
        return []
    depth = len(sibling_paths[0])
    acc = limb.from_ints([f128.fold_bytes32_to_fe(l) for l in leaves])
    idx = _np.asarray(list(indices), dtype=_np.int64)
    for d in range(depth):
        sib = limb.from_ints(
            [f128.fold_bytes32_to_fe(p[d]) for p in sibling_paths])
        right = (idx & 1).astype(bool)                 # acc is right child
        first = _np.where(right[:, None], sib, acc)
        second = _np.where(right[:, None], acc, sib)
        pairs = _np.stack([first, second], axis=1)     # (B, 2, 8)
        acc = pj.sponge_fes(pairs, b"zkl/winter/hash/merge", _np)
        idx >>= 1
    return [f128.fe_to_bytes_fold(int(v)) for v in limb.to_ints(acc)]
