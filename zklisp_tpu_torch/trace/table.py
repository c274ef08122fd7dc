"""Column-major trace table of field elements (host representation).

Values are canonical Python ints in [0, p).  Column-major storage matches
the access pattern of both the builders (per-column fills) and the device
boundary (per-column limb conversion for LDE).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..field import limb_host as limb


class TraceTable:
    __slots__ = ("width", "length", "cols", "_limbs16", "_uniform_usage",
                 "merkle_roots")

    def __init__(self, width: int, length: int) -> None:
        self.width = width
        self.length = length
        self.cols: List[List[int]] = [[0] * length for _ in range(width)]
        self._limbs16 = None
        # cached (vm_usage_mask, ram_delta_clk_bits) of the FULL trace,
        # filled lazily by the prover's uniform-segment mode
        self._uniform_usage = None

    def get(self, col: int, row: int) -> int:
        return self.cols[col][row]

    def set(self, col: int, row: int, v: int) -> None:
        self.cols[col][row] = v

    def col(self, col: int) -> List[int]:
        return self.cols[col]

    def row(self, row: int) -> List[int]:
        return [c[row] for c in self.cols]

    def to_limbs(self, xp=np):
        """(width, length, 8) limb array for device consumption."""
        arr = limb.from_int_cols(self.cols)
        return xp.asarray(arr) if xp is not np else arr

    def to_limbs16(self) -> np.ndarray:
        """(width, length, 8) uint16 limb array, cached on the table.

        Converting ~1M Python ints per segment cost seconds; the full
        trace converts once (through the per-column uint64 fast path —
        limb.from_int_cols) and segments numpy-slice it.  Callers must
        not mutate the table after the first call (builders fill before
        the prover ever reads this).
        """
        if self._limbs16 is None:
            self._limbs16 = limb.from_int_cols(self.cols,
                                               dtype=np.uint16)
        return self._limbs16

    def slice_rows(self, r_start: int, r_end: int,
                   col_map: List[int] | None = None) -> "TraceTable":
        """Row slice; `col_map[seg_col] = full_col` optionally remaps
        columns (segment layouts)."""
        if col_map is None:
            col_map = list(range(self.width))
        out = TraceTable(len(col_map), r_end - r_start)
        for seg_c, full_c in enumerate(col_map):
            out.cols[seg_c] = self.cols[full_c][r_start:r_end]
        if self._limbs16 is not None:
            # carry the parent's cached limb conversion: a numpy fancy
            # slice instead of re-converting ~1M Python ints per
            # segment (a measured multi-second per-segment host cost)
            out._limbs16 = np.ascontiguousarray(
                self._limbs16[np.asarray(col_map, dtype=np.intp),
                              r_start:r_end])
        return out
