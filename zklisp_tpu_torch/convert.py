"""State carried between the JAX package and the port.

There are no weights.  What both packages must agree on is the Poseidon
suite and the data, handed over as numpy: uint32/uint16 limb arrays
(..., 8) of 16-bit digits, the suite tables (MDS (12,12,8), round
constants (rounds,12,8), capacity `dom` (2,8)) and a trace's
`to_limbs16()` (C, n, 8).  The port stores all of them as int32 tensors
in the same digit layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .field import limb


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
