"""Batch Merkle multiproofs (compressed query openings).

Winterfell ships query openings as one BatchMerkleProof per commitment:
sibling nodes that can be derived from other queried leaves are omitted
and reconstructed during verification (the reference decompresses them
at agg/child.rs:162-520 via BatchMerkleProof::into_openings).  This
module is the TPU build's equivalent: `compress` turns per-position
sibling paths into the deduplicated node set, `expand` reconstructs the
per-position paths (and the root) from queried leaves + nodes.

Canonical node order: per level, ascending frontier index, one sibling
digest for every frontier index whose partner is not itself in the
frontier.  Both directions are deterministic, so host- and device-built
proofs stay byte-identical.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..crypto import poseidon as pos


def _merge_batch(lefts: List[bytes], rights: List[bytes]) -> List[bytes]:
    """Batched pos.merge over digest pairs (one vectorized sponge)."""
    if len(lefts) == 1:
        return [pos.merge(lefts[0], rights[0])]
    import numpy as _np

    from ..crypto import poseidon_host as pj
    from ..field import f128
    from ..field import limb_host as limb
    pairs = _np.stack([
        limb.from_ints([f128.fold_bytes32_to_fe(d) for d in lefts]),
        limb.from_ints([f128.fold_bytes32_to_fe(d) for d in rights]),
    ], axis=1)                                       # (B, 2, 8)
    out = pj.sponge_fes(pairs, b"zkl/winter/hash/merge", _np)
    return [f128.fe_to_bytes_fold(int(v)) for v in limb.to_ints(out)]


@dataclass
class MultiProof:
    depth: int
    nodes: List[List[bytes]]       # per level, ascending-index order

    def num_nodes(self) -> int:
        return sum(len(lv) for lv in self.nodes)


def _frontiers(positions: Sequence[int], depth: int) -> List[List[int]]:
    """Sorted unique index frontier at every level."""
    out = []
    cur = sorted(set(positions))
    for _ in range(depth):
        out.append(cur)
        cur = sorted({i >> 1 for i in cur})
    return out


def compress(positions: Sequence[int],
             paths: Sequence[Sequence[bytes]]) -> MultiProof:
    """Deduplicate per-position sibling paths into a MultiProof.

    positions must be unique (any order); paths[k] is the bottom-up
    sibling path for positions[k].
    """
    if not positions:
        return MultiProof(0, [])
    depth = len(paths[0])
    # representative original query for every frontier index
    rep: Dict[int, int] = {}
    for k, p in enumerate(positions):
        rep.setdefault(p, k)
    nodes: List[List[bytes]] = []
    for level, frontier in enumerate(_frontiers(positions, depth)):
        fs = set(frontier)
        emitted = []
        nrep: Dict[int, int] = {}
        for idx in frontier:
            if (idx ^ 1) not in fs:
                emitted.append(paths[rep[idx]][level])
            nrep.setdefault(idx >> 1, rep[idx])
        nodes.append(emitted)
        rep = nrep
    return MultiProof(depth, nodes)


def expand(mp: MultiProof, positions: Sequence[int],
           leaves: Sequence[bytes]) -> Tuple[List[List[bytes]], bytes]:
    """Reconstruct per-position sibling paths and the root.

    leaves[k] is the leaf digest for positions[k].  Raises ValueError on
    a malformed proof (wrong node count for the position set).
    """
    if not positions:
        return [], b""
    known: Dict[int, bytes] = {}
    for k, p in enumerate(positions):
        known[p] = leaves[k]
    level_maps: List[Dict[int, bytes]] = []
    frontier = sorted(known)
    for level in range(mp.depth):
        fs = set(frontier)
        it = iter(mp.nodes[level])
        try:
            for idx in frontier:
                sib = idx ^ 1
                if sib not in fs:
                    known[sib] = next(it)
        except StopIteration:
            raise ValueError("multiproof has too few nodes")
        if next(it, None) is not None:
            raise ValueError("multiproof has extra nodes")
        level_maps.append(known)
        pars = sorted({idx >> 1 for idx in frontier})
        # one batched Poseidon call per level (the scalar merge path
        # costs ~0.1 ms of native-call overhead per node — dominating
        # FS replay at q=64 when expansion runs per child)
        parents = dict(zip(pars, _merge_batch(
            [known[p * 2] for p in pars],
            [known[p * 2 + 1] for p in pars])))
        known = parents
        frontier = pars
    if len(known) != 1:
        raise ValueError("multiproof did not reduce to a single root")
    root = known[0]
    out_paths = [[level_maps[lv][(p >> lv) ^ 1] for lv in range(mp.depth)]
                 for p in positions]
    return out_paths, root
