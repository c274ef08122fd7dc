"""State carried between the JAX package and the port.

There are no weights.  What both packages must agree on is the Poseidon
suite and the data, handed over as numpy: uint32/uint16 limb arrays
(..., 8) of 16-bit digits, the suite tables (MDS (12,12,8), round
constants (rounds,12,8), capacity `dom` (2,8)) and a trace's
`to_limbs16()` (C, n, 8).  The port stores all of them as int32 tensors
in the same digit layout.  The matrix path adds constant tables and a
program: the uint8 digit planes of a weight matrix (`wmat_planes`: DFT
matrices, DEEP coefficients), the four-step twiddle tables (limb arrays,
through `limbs_to_torch`) and the leveled constraint schedule
(`LevelProgram`, numpy index arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .field import limb, mxu
from .prove import cvm


def limbs_to_torch(arr, device=None) -> torch.Tensor:
    """numpy limb array (uint16/uint32/int, digits < 2^16) — field
    elements, or a trace's `to_limbs16()` (C, n, 8) — -> int32 tensor
    on `device` (default: the CUDA card)."""
    a = np.asarray(arr)
    if a.shape[-1] != limb.NLIMB:
        raise ValueError(f"expected (..., 8) limbs, got {a.shape}")
    return limb.from_numpy(a, resolve(device))


def suite_to_torch(mds, rc, dom, device=None):
    """The suite tables of the JAX package's `_suite_arrays` -> int32
    tensors (mds (12,12,8), rc (rounds,12,8), dom (2,8))."""
    return tuple(limbs_to_torch(a, device) for a in (mds, rc, dom))


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> the uint32 array the JAX package reads."""
    return limb.to_numpy_u32(t)


def wmat_planes_to_torch(w_lo, w_hi, device=None) -> torch.Tensor:
    """The JAX package's `mxu.wmat_planes` pair ((J*8, K*16) uint8 each)
    -> the stacked, transposed (2*K*16, J*8) uint8 tensor the port's
    `mxu.field_matmul` takes."""
    lo, hi = np.asarray(w_lo), np.asarray(w_hi)
    if lo.shape != hi.shape or lo.dtype != np.uint8 or hi.dtype != np.uint8:
        raise ValueError(f"expected two uint8 planes of one shape, got "
                         f"{lo.shape} {lo.dtype} and {hi.shape} {hi.dtype}")
    return mxu.stack_planes(lo, hi, resolve(device))


def level_program_from_arrays(lp) -> cvm.LevelProgram:
    """A leveled schedule given as numpy arrays (the JAX package's
    `cvm.LevelProgram`, or anything with its fields) -> the port's
    `LevelProgram`; the index tensors are made per device at first use
    by `cvm.execute_leveled`."""
    levels = [[(str(kind), np.asarray(a_src, np.int32),
                np.asarray(a_k, np.int32), np.asarray(b_src, np.int32),
                np.asarray(b_k, np.int32), int(start))
               for kind, a_src, a_k, b_src, b_k, start in lvl]
              for lvl in lp.levels]
    return cvm.LevelProgram(
        levels, int(lp.n_slots), np.asarray(lp.root_src, np.int32),
        np.asarray(lp.root_k, np.int32), np.asarray(lp.root_aidx, np.int32),
        np.asarray(lp.consts, np.uint32), str(lp.sig))
