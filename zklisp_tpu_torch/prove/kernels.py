"""Device building blocks of the proving hot path on PyTorch tensors:
Merkle commitment (batched Poseidon row hashing + tree build) of
row-major and column-major arrays, and the proof-of-work nonce scan.

Both take several independent instances at once (the segments of a
wave): trees laid end to end share every Merkle level's merge, and the
grind scans every coin seed in one sweep.

Every Poseidon permutation below goes through
`crypto.poseidon_cuda.permute12` — the CUDA kernel on the card.
"""

from __future__ import annotations

from typing import List

import torch

from ..crypto import poseidon_torch as pt
from ..field import limb

ROW_CHUNK = 1 << 15          # bounds transient row-major buffers


def commit_rows(rows, partition_size: int, n_trees: int = 1):
    """rows (n_trees * B, W, 8), already row-major, the rows of
    `n_trees` trees laid end to end -> tree levels (see
    `poseidon_torch.merkle_tree`)."""
    return pt.merkle_tree(pt.hash_rows_partitioned(rows, partition_size),
                          n_trees)


def commit_cols(cols_arr, partition_size: int, row_chunk: int = ROW_CHUNK):
    """Commit to the rows of a column-major (C, N, 8) array, or of S such
    arrays (S, C, N, 8) as S trees, without ever materializing the full
    row-major transpose: leaves are hashed `row_chunk` rows of every
    array at a time.  Returns the levels, each (m, 8), or (S, m, 8)."""
    lead = cols_arr.shape[:-3]
    cols4 = cols_arr.reshape((-1,) + cols_arr.shape[-3:])
    S, C, N = cols4.shape[0], cols4.shape[1], cols4.shape[2]
    parts = [pt.hash_rows_partitioned(
        cols4[:, :, s:s + row_chunk].transpose(1, 2).reshape(
            -1, C, limb.NLIMB), partition_size).reshape(S, -1, limb.NLIMB)
             for s in range(0, N, row_chunk)]
    leaves = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    levels = pt.merkle_tree(leaves.reshape(-1, limb.NLIMB), S)
    return [lv.reshape(lead + (-1, limb.NLIMB)) for lv in levels]


def grind_scan(seed_chunks, start: int, batch: int):
    """Low 64 digest bits (as 4 16-bit limbs) of
    merge_with_int(seed, start + i) for i in [0, batch), for each of the
    S seeds of `seed_chunks` (S, 8): (S, batch, 4).

    merge_with_int(seed, v) absorbs two chunks — fold(seed) and v.  The
    64-bit candidate is an int64 tensor (nonces stay below 2^62)."""
    dev = seed_chunks.device
    S = seed_chunks.shape[0]
    vs = torch.arange(start, start + batch, dtype=torch.int64, device=dev)
    chunk1 = limb.from_i64(vs)                               # (B, 8)
    fes = torch.stack([seed_chunks[:, None].expand(S, batch, limb.NLIMB),
                       chunk1[None].expand(S, batch, limb.NLIMB)], dim=2)
    out = pt.sponge_fes(fes.reshape(S * batch, 2, limb.NLIMB),
                        b"zkl/winter/hash/merge_with_int")
    return out[:, :4].reshape(S, batch, 4)


def grind_hit_many(seed_chunks, start: int, batch: int,
                   grinding_factor: int) -> List[int]:
    """Per seed of `seed_chunks` (S, 8): the index of the FIRST candidate
    in [start, start + batch) whose low 64 digest bits are 0 mod
    2^grinding_factor, or `batch` when none passes.  One sweep of
    S * batch permutations; S integers cross back to the host in one
    copy."""
    assert 0 < grinding_factor <= 62
    out4 = grind_scan(seed_chunks, start, batch).to(torch.int64)
    lo = (out4[..., 0] | (out4[..., 1] << 16) | (out4[..., 2] << 32)
          | ((out4[..., 3] & 0x3FFF) << 48))
    ok = (lo & ((1 << grinding_factor) - 1)) == 0
    idx = torch.where(
        ok, torch.arange(batch, dtype=torch.int64, device=lo.device),
        torch.full((), batch, dtype=torch.int64, device=lo.device))
    return [int(v) for v in idx.min(dim=1).values.cpu()]
