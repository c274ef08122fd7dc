"""The rollup-bench workload scaled to a target trace size.

`examples/rollup-bench.zlisp` (RAM tx table + safe-arith debits + sponge
digest chain) has a `(def BATCH k)` knob; `rollup_source(n_ops)` finds
the largest k whose compiled program stays within `n_ops` VM ops.  A
trace has 32 rows per op, padded to a power of two: n_ops = 2048 gives
the 2^16-row trace (16 segments of 4096 rows).
"""

from __future__ import annotations

import os
import re

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROLLUP_ZLISP = os.path.join(_REPO, "examples", "rollup-bench.zlisp")


def _calibrated_source(n_ops_target: int, src_of_k, args) -> tuple:
    """Binary-search the largest k whose program stays <= target ops."""
    from .compiler import compile_entry

    lo, hi, best = 1, n_ops_target, None
    while lo <= hi:
        mid = (lo + hi) // 2
        try:
            prog = compile_entry(src_of_k(mid), args)
        except Exception:
            hi = mid - 1
            continue
        n = len(prog.ops)
        if n <= n_ops_target:
            best = (mid, n)
            lo = mid + 1
        else:
            hi = mid - 1
    k, n = best
    return src_of_k(k), k, n


def rollup_batch_source(batch: int, path: str = ROLLUP_ZLISP) -> str:
    """rollup-bench's source with `(def BATCH batch)`."""
    with open(path) as f:
        base = f.read()
    return re.sub(r"\(def BATCH \d+\)", f"(def BATCH {batch})", base)


def rollup_source(n_ops_target: int, path: str = ROLLUP_ZLISP) -> tuple:
    """(source, BATCH, op count) of rollup-bench scaled to the target."""
    return _calibrated_source(
        n_ops_target, lambda k: rollup_batch_source(k, path), [])
