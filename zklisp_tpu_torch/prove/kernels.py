"""Device building blocks of the proving hot path on PyTorch tensors:
Merkle commitment (batched Poseidon row hashing + tree build) of
row-major and column-major arrays, and the proof-of-work nonce scan.

Every Poseidon permutation below goes through
`crypto.poseidon_cuda.permute12` — the CUDA kernel on the card.
"""

from __future__ import annotations

import torch

from ..crypto import poseidon_torch as pt
from ..field import limb

ROW_CHUNK = 1 << 15          # bounds transient row-major buffers


def commit_rows(rows, partition_size: int):
    """rows (B, W, 8), already row-major -> tree levels."""
    return pt.merkle_tree(pt.hash_rows_partitioned(rows, partition_size))


def commit_cols(cols_arr, partition_size: int, row_chunk: int = ROW_CHUNK):
    """Commit to the rows of a column-major (C, N, 8) array without ever
    materializing the full row-major transpose: leaves are hashed
    `row_chunk` rows at a time."""
    N = cols_arr.shape[1]
    parts = [pt.hash_rows_partitioned(
        cols_arr[:, s:s + row_chunk].transpose(0, 1), partition_size)
             for s in range(0, N, row_chunk)]
    leaves = parts[0] if len(parts) == 1 else torch.cat(parts)
    return pt.merkle_tree(leaves)


def grind_scan(seed_chunk, start: int, batch: int):
    """Low 64 digest bits (as 4 16-bit limbs) of
    merge_with_int(seed, start + i) for i in [0, batch).

    merge_with_int(seed, v) absorbs two chunks — fold(seed) and v.  The
    64-bit candidate is an int64 tensor (nonces stay below 2^62)."""
    dev = seed_chunk.device
    vs = torch.arange(start, start + batch, dtype=torch.int64, device=dev)
    chunk1 = limb.from_i64(vs)                               # (B, 8)
    chunk0 = seed_chunk[None].expand(batch, limb.NLIMB)
    fes = torch.stack([chunk0, chunk1], dim=1)               # (B, 2, 8)
    out = pt.sponge_fes(fes, b"zkl/winter/hash/merge_with_int")
    return out[:, :4]


def grind_hit(seed_chunk, start: int, batch: int, grinding_factor: int):
    """Index of the FIRST candidate in [start, start + batch) whose low
    64 digest bits are 0 mod 2^grinding_factor, or `batch` when none
    passes.  One integer crosses back to the host."""
    assert 0 < grinding_factor <= 62
    out4 = grind_scan(seed_chunk, start, batch).to(torch.int64)
    lo = (out4[:, 0] | (out4[:, 1] << 16) | (out4[:, 2] << 32)
          | ((out4[:, 3] & 0x3FFF) << 48))
    ok = (lo & ((1 << grinding_factor) - 1)) == 0
    idx = torch.where(
        ok, torch.arange(batch, dtype=torch.int64, device=lo.device),
        torch.full((), batch, dtype=torch.int64, device=lo.device))
    return int(idx.min())
