"""The length-N NTT and the coset LDE split over the shards of a mesh
(four-step algorithm), counterpart of the JAX package's
parallel/ntt_mesh.py.

A mesh (`mesh_prover.Mesh`) is an ordered tuple of devices on one axis,
"seg"; with C shards the transform splits as N = R x C (Cooley-Tukey):

  n = n1*C + d,  k = k1 + R*k2:
  X[k1 + R*k2] = sum_d [ w_N^(d*k1) * (sum_n1 x[n1*C + d] * w_R^(n1*k1)) ]
                 * w_C^(d*k2)

  1. shard d holds the cyclic slice x[d::C] and runs its length-R NTT on
     its own device (field/ntt.py: the four-step matrix NTT through the
     digit_dot kernel on a card for R >= MXU_NTT_MIN)
  2. it scales the result by w_N^(d*k1)
  3. an all-to-all, done as explicit copies between the shards' devices:
     shard c receives block c of the k1 axis from every shard
  4. shard c runs the length-C NTT over the source-shard axis

The outputs are natural-order evaluations, equal limb for limb to
`ntt.ntt` (and `lde_columns_sharded` to `ntt.coset_evaluate`).  A mesh
may repeat one device: its shards then run one after another on that
device, through the same copies and kernels.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as _np
import torch

from ..field import f128, limb, ntt
from ..field import limb_host as _lh
from ..prove import stark_device as sd

P = f128.P


@lru_cache(maxsize=None)
def _twiddles_dk1(N: int, R: int, C: int) -> _np.ndarray:
    """w_N^(d*k1) table of shape (C, R, 8) (host limb array)."""
    w = f128.get_root_of_unity(N)
    return _np.stack([_lh.powers_np(pow(w, d, P), R) for d in range(C)])


def _col_chunk(B: int, points: int, device) -> int:
    """Columns of `points` points each per NTT call on `device`, within
    the stage budget of its transients."""
    return sd.col_chunk_for(B, points * sd.LDE_BYTES_PER_POINT,
                            sd.stage_budget(device))


def ntt_sharded(x, mesh):
    """Sharded forward NTT of one (N, 8) limb tensor; returns natural-
    order evaluations (== ntt.ntt(x)) on the mesh's first device."""
    return ntt_sharded_batch(x[None], mesh)[0]


def ntt_sharded_batch(xs, mesh):
    """Sharded forward NTT of a (B, N, 8) batch of limb tensors: each
    transform's index space is split over the mesh's C shards (one
    all-to-all per batch).  Returns the (B, N, 8) natural-order
    evaluations, equal to ntt.ntt of each row, on the mesh's first
    device."""
    C = mesh.size
    B, N = xs.shape[0], xs.shape[1]
    R = N // C
    assert R * C == N and (R & (R - 1)) == 0 and (C & (C - 1)) == 0
    tw = _twiddles_dk1(N, R, C)

    # 1-2. shard d: its cyclic slice A[d, b, n1] = xs[b, n1*C + d], the
    # inner length-R NTT and the w_N^(d*k1) twiddle, in column chunks
    cyc = xs.reshape(B, R, C, limb.NLIMB)
    parts = []
    for d, dev in enumerate(mesh.devices):
        a_d = cyc[:, :, d].to(dev, non_blocking=True)
        tw_d = limb.from_numpy(tw[d], dev)
        cols = torch.empty((B, R, limb.NLIMB), dtype=torch.int32,
                           device=dev)
        step = _col_chunk(B, R, dev)
        for s in range(0, B, step):
            cols[s:s + step] = limb.mul(ntt.ntt(a_d[s:s + step]), tw_d)
        del a_d
        parts.append(cols.reshape(B, C, R // C, limb.NLIMB))

    # 3-4. shard c gathers block c of the k1 axis from every source shard
    # (the all-to-all), then the outer length-C NTT over the source axis;
    # out[blk, b, i, k2] = X_b[k1 + R*k2] with k1 = blk*(R//C) + i, written
    # straight into the (B, C_k2, C_blk, R//C, 8) view of the result
    home = mesh.devices[0]
    out = torch.empty((B, N, limb.NLIMB), dtype=torch.int32, device=home)
    out5 = out.view(B, C, C, R // C, limb.NLIMB)
    for c, dev in enumerate(mesh.devices):
        got = torch.stack([parts[d][:, c].to(dev, non_blocking=True)
                           for d in range(C)])          # (C_src, B, R//C, 8)
        rows = got.permute(1, 2, 0, 3)                   # (B, R//C, C, 8)
        del got
        if C > 1:
            step = _col_chunk(B, R, dev)
            rows = torch.cat([ntt.ntt(rows[s:s + step].contiguous())
                              for s in range(0, B, step)])
        out5[:, :, c] = rows.permute(0, 2, 1, 3).to(home, non_blocking=True)
        del rows
    return out


def lde_columns_sharded(polys, blowup: int, mesh,
                        offset: int = ntt.DEFAULT_COSET_OFFSET):
    """Sharded coset LDE of (Cc, n, 8) trace polynomials.

    Scale-by-offset-powers and zero-pad on the polynomials' device, then
    the length-N forward NTT as the four-step sharded NTT.  Returns
    (Cc, N, 8) == ntt.coset_evaluate per column, on the mesh's first
    device."""
    Cc, n = polys.shape[0], polys.shape[1]
    N = n * blowup
    scale = ntt.offset_powers(n, polys.device, offset)
    padded = torch.zeros((Cc, N, limb.NLIMB), dtype=torch.int32,
                         device=polys.device)
    step = _col_chunk(Cc, n, polys.device)
    for s in range(0, Cc, step):
        padded[s:s + step, :n] = limb.mul(polys[s:s + step], scale)
    return ntt_sharded_batch(padded, mesh)
