"""Constraint bytecode VM: the AIR's generic transition constraints,
recorded once and executed over the whole evaluation domain.

Pipeline:
  record   — run the AIR's constraint emitters on `Sym` operands
             (pure-Python tree nodes; milliseconds)
  compile  — post-order flatten each constraint tree to PUSH/ADD/SUB/
             MUL/EMIT instructions; shared subexpressions get slots
  execute  — evaluates sum_i alpha_i * C_i over the domain (PyTorch,
             eager) with one of two executors
  interpret — host reference over a single row of Python ints (tests)

Two executors share the recorded program and give identical limbs:

  stack   — a Python loop over the instructions, each one batched limb
            op over all N rows (~4e3 small ops per segment).
  leveled — the same Sym DAG scheduled into topological LEVELS
            (`compile_levels`); each level is at most three BATCHED limb
            ops (one mul / add / sub over a (K, C, 8) gather from a
            unified operand table), so the program is ~tree-depth x 3
            large ops per row chunk.

`execute` takes the leveled executor for a CUDA tensor and the stack
executor for a CPU tensor; ZKL_CVM_LEVEL=1/0 (read at call time)
overrides.
"""

from __future__ import annotations

import hashlib
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as _np
import torch

from ..field import f128
from ..field import limb_host as limb

P = f128.P

OP_NOP = 0
OP_PUSH_CUR = 1
OP_PUSH_NXT = 2
OP_PUSH_PER = 3
OP_PUSH_CONST = 4
OP_ADD = 5
OP_SUB = 6
OP_MUL = 7
OP_EMIT = 8
OP_PUSH_PLAST = 9
OP_STORE_SLOT = 10     # pop top of stack into slot[arg]
OP_PUSH_SLOT = 11      # push slot[arg]


class Sym:
    """Constraint expression node.  kind: 'cur'|'nxt'|'per' (leaf with
    column index k), 'const' (field element k), 'add'|'sub'|'mul'."""
    __slots__ = ("kind", "a", "b", "k", "_depth")

    def __init__(self, kind: str, a: "Optional[Sym]" = None,
                 b: "Optional[Sym]" = None, k: int = 0):
        self.kind = kind
        self.a = a
        self.b = b
        self.k = k
        self._depth = -1

    @staticmethod
    def _coerce(o) -> "Optional[Sym]":
        if isinstance(o, Sym):
            return o
        if isinstance(o, int):
            return Sym("const", k=o % P)
        v = getattr(o, "v", None)          # Felt
        if isinstance(v, int):
            return Sym("const", k=v % P)
        return None

    def __add__(self, o):
        s = Sym._coerce(o)
        if s is None:
            return NotImplemented
        return Sym("add", self, s)

    __radd__ = __add__

    def __sub__(self, o):
        s = Sym._coerce(o)
        if s is None:
            return NotImplemented
        return Sym("sub", self, s)

    def __rsub__(self, o):
        s = Sym._coerce(o)
        if s is None:
            return NotImplemented
        return Sym("sub", s, self)

    def __mul__(self, o):
        s = Sym._coerce(o)
        if s is None:
            return NotImplemented
        return Sym("mul", self, s)

    __rmul__ = __mul__

    def __neg__(self):
        return Sym("sub", Sym("const", k=0), self)


def sym_leaves(width: int, n_periodic: int):
    """Leaf nodes for recording.  The LAST periodic column (p_last, a
    full-domain Lagrange selector) gets its own leaf kind — on device it
    is a separate (N, 8) input while the other periodics are passed as
    one-period tiles."""
    cur = [Sym("cur", k=i) for i in range(width)]
    nxt = [Sym("nxt", k=i) for i in range(width)]
    per = [Sym("per", k=i) for i in range(n_periodic - 1)]
    per.append(Sym("plast"))
    return cur, nxt, per


@dataclass
class CvmProgram:
    ops: _np.ndarray       # (I,) int32
    arg: _np.ndarray       # (I,) int32 — column/periodic/slot index
    imm: _np.ndarray       # (I, 8) uint32 — const limbs
    aidx: _np.ndarray      # (I,) int32 — alpha index for EMIT
    stack_size: int        # bucketed
    n_instr: int           # before padding
    n_slots: int = 0       # CSE slots (bucketed)
    levels: "Optional[LevelProgram]" = None   # leveled-executor schedule


_LEAF_OP = {"cur": OP_PUSH_CUR, "nxt": OP_PUSH_NXT, "per": OP_PUSH_PER,
            "plast": OP_PUSH_PLAST}
_BIN_OP = {"add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL}


def _emit_tree(root: Sym, out: List[Tuple[int, int, int, int]],
               alpha_ix: int, slot_of=None, materialized=None) -> int:
    """Iterative post-order flatten; returns max stack depth used.

    slot_of (id(node) -> slot index) marks shared subexpressions: the
    first emission appends STORE_SLOT + PUSH_SLOT after computing the
    value, later uses emit a single PUSH_SLOT."""
    max_sp = 0
    sp = 0
    # (node, state) state 0=expand, 1=emit op after children
    work = [(root, 0)]
    while work:
        node, state = work.pop()
        slot = slot_of.get(id(node)) if slot_of is not None else None
        if state == 0:
            if slot is not None and id(node) in materialized:
                out.append((OP_PUSH_SLOT, slot, 0, 0))
                sp += 1
                max_sp = max(max_sp, sp)
            elif node.kind in _LEAF_OP:
                out.append((_LEAF_OP[node.kind], node.k, 0, 0))
                sp += 1
                max_sp = max(max_sp, sp)
            elif node.kind == "const":
                out.append((OP_PUSH_CONST, 0, node.k, 0))
                sp += 1
                max_sp = max(max_sp, sp)
            else:
                work.append((node, 1))
                work.append((node.b, 0))
                work.append((node.a, 0))
        else:
            out.append((_BIN_OP[node.kind], 0, 0, 0))
            sp -= 1
            if slot is not None and id(node) not in materialized:
                out.append((OP_STORE_SLOT, slot, 0, 0))
                out.append((OP_PUSH_SLOT, slot, 0, 0))
                materialized.add(id(node))
    assert sp == 1
    out.append((OP_EMIT, 0, 0, alpha_ix))
    return max_sp


MAX_SLOTS = 64       # slot buffers cost (slots, N, 8) u32 on device


def _assign_slots(roots: List[Tuple[Sym, int]]) -> dict:
    """CSE: shared binop subtrees (by object identity — the AIR emitters
    reuse Sym objects for common subexpressions) get slots, largest
    savings first."""
    uses: Dict[int, int] = {}
    size: Dict[int, int] = {}
    node_by_id: Dict[int, Sym] = {}
    for expr, _ in roots:
        stack = [expr]
        while stack:
            n = stack.pop()
            k = id(n)
            uses[k] = uses.get(k, 0) + 1
            if uses[k] == 1:
                node_by_id[k] = n
                if n.kind in _BIN_OP:
                    stack.append(n.a)
                    stack.append(n.b)

    def tree_size(n: Sym, cap: int = 64) -> int:
        total = 0
        stack = [n]
        while stack and total < cap:
            m = stack.pop()
            total += 1
            if m.kind in _BIN_OP:
                stack.append(m.a)
                stack.append(m.b)
        return total

    cands = [(k, (uses[k] - 1) * tree_size(node_by_id[k]))
             for k in uses
             if uses[k] >= 2 and node_by_id[k].kind in _BIN_OP]
    cands = [c for c in cands if c[1] >= 2]
    cands.sort(key=lambda c: -c[1])
    return {k: i for i, (k, _) in enumerate(cands[:MAX_SLOTS])}


def compile_constraints(roots: List[Tuple[Sym, int]],
                        i_bucket: int = 512,
                        s_min: int = 16) -> CvmProgram:
    """roots: [(expression, alpha index)] -> bytecode arrays."""
    slot_of = _assign_slots(roots)
    materialized: set = set()
    raw: List[Tuple[int, int, int, int]] = []
    depth = 0
    for expr, aix in roots:
        depth = max(depth, _emit_tree(expr, raw, aix, slot_of,
                                      materialized))
    n_instr = len(raw)
    padded = ((n_instr + i_bucket - 1) // i_bucket) * i_bucket
    padded = max(padded, i_bucket)
    raw = raw + [(OP_NOP, 0, 0, 0)] * (padded - n_instr)

    S = s_min
    while S < depth + 1:
        S *= 2

    ops = _np.asarray([r[0] for r in raw], dtype=_np.int32)
    arg = _np.asarray([r[1] for r in raw], dtype=_np.int32)
    imm = _np.asarray(limb.from_ints([r[2] for r in raw]))
    aidx = _np.asarray([r[3] for r in raw], dtype=_np.int32)
    ns = len(slot_of)
    n_slots = 0
    if ns:
        n_slots = 8
        while n_slots < ns:
            n_slots *= 2
    prog = CvmProgram(ops, arg, imm, aidx, S, n_instr, n_slots)
    prog.levels = compile_levels(roots)
    return prog


# ---------------------------------------------------------------------------
# leveled executor: batched level-order schedule of the constraint DAG
# ---------------------------------------------------------------------------

SRC_SLOT, SRC_CUR, SRC_NXT, SRC_PER, SRC_PLAST, SRC_CONST = range(6)
_BIN_KINDS = ("add", "sub", "mul")

LEVEL_MAX_ROWS = 4096            # rows per chunk, at most
LEVEL_TABLE_BYTES = 192 << 20    # operand-table budget per chunk, unless
                                 # ZKL_CVM_TABLE_BYTES sets another


@dataclass
class LevelProgram:
    """Level-order schedule of the (rebalanced) constraint DAG.

    Single-use add/mul chains are first rebalanced into log-depth trees
    (associativity is exact mod p, so values — and proof bytes — are
    unchanged), which collapses the long sequential sum tails the AIR
    emitters produce.  levels[L] is then a list of
    (opkind, a_src, a_k, b_src, b_k, out_start) batches — at most one
    batch per opkind per level, each a set of INDEPENDENT ops executed
    as one batched limb op over a (K, C, 8) gather.  Outputs land at
    static contiguous positions (out_start, append order).  Root values
    are combined at the end: acc = sum_i alphas[root_aidx[i]] * value_i.
    """
    levels: list            # [[(kind, a_src, a_k, b_src, b_k, start)]]
    n_slots: int            # total binop outputs (append positions)
    root_src: _np.ndarray   # (R,) int32
    root_k: _np.ndarray     # (R,) int32
    root_aidx: _np.ndarray  # (R,) int32
    consts: _np.ndarray     # (n_const, 8) uint32 limb pool
    sig: str                # content hash — cache key of the index tensors


def _rebalance_roots(roots: List[Tuple[Sym, int]]) -> List[Tuple[Sym, int]]:
    """Rewrite single-use add/mul chains as balanced (log-depth) trees.

    Field add/mul are associative and commutative and every limb op
    returns the canonical representative, so any reassociation computes
    the SAME field element — proof bytes are unchanged.  Shared
    subexpressions (operand refcount >= 2) and roots stay materialized:
    a chain never expands past them, preserving the DAG's sharing."""
    uses: Dict[int, int] = {}
    node_by_id: Dict[int, Sym] = {}
    for r, _ in roots:
        uses[id(r)] = uses.get(id(r), 0) + 1   # pin roots (never folded)
        stack = [r]
        while stack:
            n = stack.pop()
            if id(n) not in node_by_id:
                node_by_id[id(n)] = n
                if n.kind in _BIN_KINDS:
                    stack.append(n.a)
                    stack.append(n.b)
    # count operand edges (each edge once, including repeats)
    for k, n in node_by_id.items():
        if n.kind in _BIN_KINDS:
            for ch in (n.a, n.b):
                uses[id(ch)] = uses.get(id(ch), 0) + 1

    def chain_terms(n: Sym) -> List[Sym]:
        if n.kind == "sub":
            return [n.a, n.b]
        terms: List[Sym] = []
        stack = [(n, True)]
        while stack:
            m, top = stack.pop()
            if m.kind == n.kind and (top or uses[id(m)] == 1):
                stack.append((m.b, False))
                stack.append((m.a, False))
            else:
                terms.append(m)
        # stack pops b-subtree first under LIFO; order is irrelevant
        # for correctness (commutative) but keep it deterministic
        return terms

    memo: Dict[int, Sym] = {}
    work = [(r, 0) for r, _ in roots]
    while work:
        n, state = work.pop()
        if id(n) in memo:
            continue
        if n.kind not in _BIN_KINDS:
            memo[id(n)] = n
            continue
        if state == 0:
            work.append((n, 1))
            for t in chain_terms(n):
                work.append((t, 0))
        else:
            terms = [memo[id(t)] for t in chain_terms(n)]
            if n.kind != "sub" and len(terms) > 2:
                while len(terms) > 1:
                    nxt = [Sym(n.kind, terms[i], terms[i + 1])
                           for i in range(0, len(terms) - 1, 2)]
                    if len(terms) % 2:
                        nxt.append(terms[-1])
                    terms = nxt
                memo[id(n)] = terms[0]
            else:
                memo[id(n)] = Sym(n.kind, terms[0], terms[1])
    return [(memo[id(r)], aix) for r, aix in roots]


def compile_levels(roots: List[Tuple[Sym, int]]) -> Optional[LevelProgram]:
    """Rebalance, then schedule the Sym DAG (shared nodes by object
    identity) into topological levels with append-order output
    positions.  Returns None for an empty program."""
    if not roots:
        return None
    roots = _rebalance_roots(roots)

    # 1. level of every unique node (iterative post-order)
    level: Dict[int, int] = {}
    node_by_id: Dict[int, Sym] = {}
    work = [(r, 0) for r, _ in roots]
    while work:
        n, state = work.pop()
        if state == 0:
            if id(n) in level:
                continue
            node_by_id[id(n)] = n
            if n.kind in _BIN_KINDS:
                work.append((n, 1))
                work.append((n.a, 0))
                work.append((n.b, 0))
            else:
                level[id(n)] = 0
        else:
            if id(n) not in level:
                level[id(n)] = 1 + max(level[id(n.a)], level[id(n.b)])

    # 2. const pool
    const_ix: Dict[int, int] = {}
    for k, n in node_by_id.items():
        if n.kind == "const" and n.k not in const_ix:
            const_ix[n.k] = len(const_ix)
    const_vals = [0] * len(const_ix)
    for v, i in const_ix.items():
        const_vals[i] = v

    # 3. schedule: batches in (level, add/sub/mul) order; every output
    # gets the next append position — static contiguous ranges, no reuse
    by_level = defaultdict(lambda: defaultdict(list))
    for k, n in node_by_id.items():
        if n.kind in _BIN_KINDS:
            by_level[level[k]][n.kind].append(k)
    slot_of_n: Dict[int, int] = {}
    n_slots = 0
    sched = []
    for L in sorted(by_level):
        lvl_ids = []
        for kind in _BIN_KINDS:
            ids = by_level[L].get(kind)
            if not ids:
                continue
            start = n_slots
            for k in ids:
                slot_of_n[k] = n_slots
                n_slots += 1
            lvl_ids.append((kind, ids, start))
        sched.append(lvl_ids)

    def src_of(n: Sym) -> Tuple[int, int]:
        if n.kind in _BIN_KINDS:
            return SRC_SLOT, slot_of_n[id(n)]
        if n.kind == "cur":
            return SRC_CUR, n.k
        if n.kind == "nxt":
            return SRC_NXT, n.k
        if n.kind == "per":
            return SRC_PER, n.k
        if n.kind == "plast":
            return SRC_PLAST, 0
        return SRC_CONST, const_ix[n.k]

    levels_out = []
    for lvl_ids in sched:
        lvl = []
        for kind, ids, start in lvl_ids:
            a_src = _np.empty(len(ids), _np.int32)
            a_k = _np.empty(len(ids), _np.int32)
            b_src = _np.empty(len(ids), _np.int32)
            b_k = _np.empty(len(ids), _np.int32)
            for i, k in enumerate(ids):
                n = node_by_id[k]
                a_src[i], a_k[i] = src_of(n.a)
                b_src[i], b_k[i] = src_of(n.b)
            lvl.append((kind, a_src, a_k, b_src, b_k, start))
        levels_out.append(lvl)

    root_src = _np.empty(len(roots), _np.int32)
    root_k = _np.empty(len(roots), _np.int32)
    root_aidx = _np.asarray([aix for _, aix in roots], _np.int32)
    for i, (r, _) in enumerate(roots):
        root_src[i], root_k[i] = src_of(r)
    consts = _np.asarray(limb.from_ints(const_vals)).reshape(-1, limb.NLIMB)

    h = hashlib.sha256()
    h.update(_np.int64(n_slots).tobytes())
    for lvl in levels_out:
        for kind, a_src, a_k, b_src, b_k, start in lvl:
            h.update(kind.encode())
            h.update(_np.int64(start).tobytes())
            for arr in (a_src, a_k, b_src, b_k):
                h.update(arr.tobytes())
        h.update(b"|")
    for arr in (root_src, root_k, root_aidx, consts):
        h.update(arr.tobytes())
    return LevelProgram(levels_out, n_slots, root_src, root_k, root_aidx,
                        consts, h.hexdigest())


_LEVEL_TENSORS: dict = {}


def _level_tensors(lp: LevelProgram, w: int, n_perp: int, device):
    """The schedule as index tensors on `device`: per batch the flat
    operand-table rows of both operands, then the roots' rows and alpha
    indices and the constant pool.  Uploaded once per (schedule, table
    layout, device): every segment of a run reuses them."""
    key = (lp.sig, w, n_perp, str(device))
    out = _LEVEL_TENSORS.get(key)
    if out is not None:
        return out
    n_const = lp.consts.shape[0]
    n_fixed = 2 * w + n_perp + 1 + n_const
    off = _np.zeros(6, _np.int64)
    off[[SRC_CUR, SRC_NXT, SRC_PER, SRC_PLAST, SRC_CONST, SRC_SLOT]] = [
        0, w, 2 * w, 2 * w + n_perp, 2 * w + n_perp + 1, n_fixed]

    def flat(src, k):
        return torch.from_numpy(off[src] + k.astype(_np.int64)).to(device)

    sched = [[(kind, flat(a_src, a_k), flat(b_src, b_k), n_fixed + start)
              for kind, a_src, a_k, b_src, b_k, start in lvl]
             for lvl in lp.levels]
    out = (sched, flat(lp.root_src, lp.root_k),
           torch.from_numpy(lp.root_aidx.astype(_np.int64)).to(device),
           torch.from_numpy(lp.consts.astype(_np.int32)).to(device))
    _LEVEL_TENSORS[key] = out
    return out


def level_chunk_rows(N: int, rows_total: int, period: int) -> int:
    """Rows per chunk of the leveled executor: the largest power of two
    up to LEVEL_MAX_ROWS whose (rows_total, C, 8) int32 operand table
    fits the budget (ZKL_CVM_TABLE_BYTES, read at call time; default
    LEVEL_TABLE_BYTES), but at least 1024 rows and one whole period."""
    budget = int(os.environ.get("ZKL_CVM_TABLE_BYTES",
                                str(LEVEL_TABLE_BYTES)))
    C = min(N, LEVEL_MAX_ROWS)
    while C > 1024 and rows_total * C * limb.NLIMB * 4 > budget:
        C //= 2
    C = max(C, period)               # a chunk holds whole periods
    assert N % C == 0 and C % period == 0
    return C


def execute_leveled(lp: LevelProgram, lde, per_p, p_last, alphas,
                    blowup: int):
    """Leveled executor: same contract as `execute`.

    Rows are processed in chunks of C rows of every segment at once,
    sized so that one segment's share of the unified operand table
    (cur | nxt | periodic | p_last | consts | one slot per binop, each a
    (C, 8) row block) stays under the table budget whatever N is
    (`level_chunk_rows`): a wave's table holds S such shares, so its
    chunks are as many as one segment's.  The budget moves no proof
    byte.  The table is allocated once; every slot is written (by its
    level's batched op, at its static position) before a later level
    gathers it, so chunks need no clearing."""
    from ..field import limb as tl

    lde4 = lde if lde.dim() == 4 else lde[None]
    al4 = alphas if alphas.dim() == 3 else alphas[None]
    S, w, N = lde4.shape[0], lde4.shape[1], lde4.shape[2]
    n_perp, period = per_p.shape[0], per_p.shape[1]
    dev = lde.device
    sched, root_flat, root_aidx, consts = _level_tensors(lp, w, n_perp, dev)
    n_const = consts.shape[0]
    n_fixed = 2 * w + n_perp + 1 + n_const
    rows_total = n_fixed + max(lp.n_slots, 1)

    C = level_chunk_rows(N, rows_total, period)

    U = torch.empty((rows_total, S, C, tl.NLIMB), dtype=tl.DTYPE,
                    device=dev)
    o_per, o_plast, o_const = 2 * w, 2 * w + n_perp, 2 * w + n_perp + 1
    U[o_const:n_fixed] = consts[:, None, None, :]
    U[o_per:o_plast] = per_p.repeat(1, C // period, 1)[:, None]
    rows = torch.arange(C, dtype=torch.int64, device=dev)
    al = al4[:, root_aidx].transpose(0, 1)[:, :, None, :]   # (R, S, 1, 8)
    ops = {"mul": tl.mul, "add": tl.add, "sub": tl.sub}
    accs = []
    for r0 in range(0, N, C):
        U[:w] = lde4[:, :, r0:r0 + C].transpose(0, 1)
        # the next row wraps within each segment
        U[w:o_per] = lde4.index_select(
            2, (rows + (r0 + blowup)) % N).transpose(0, 1)
        U[o_plast] = p_last[r0:r0 + C]
        for lvl in sched:
            for kind, a_idx, b_idx, start in lvl:
                U[start:start + a_idx.shape[0]] = ops[kind](U[a_idx],
                                                            U[b_idx])
        accs.append(tl.sum_mod(tl.mul(U[root_flat], al), 0))
    acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=1)
    return acc if lde.dim() == 4 else acc[0]


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def execute(prog: CvmProgram, lde, per_p, p_last, alphas, blowup: int):
    """Run the program over the whole evaluation domain: returns the
    (..., N, 8) accumulated sum_i alpha_i * C_i.

    lde (..., w, N, 8) column-major evaluations (a leading segment axis
    for a wave; a strided view is fine); per_p (n_perp, period, 8) one
    period of each short-periodic column; p_last (N, 8); alphas
    (..., n_constraints, 8), each segment's own.

    A CUDA tensor takes the leveled executor, a CPU tensor the stack
    machine (ZKL_CVM_LEVEL=1/0 overrides); both give identical limbs.
    The stack machine is a Python loop over the recorded instructions,
    each a batched limb op over all N rows (of every segment); `nxt`
    columns are rolls of `lde` by `blowup` within each segment,
    short-periodic columns are tiled from one period, constants stay
    (1, 8) and broadcast."""
    from ..field import limb as tl

    choice = os.environ.get("ZKL_CVM_LEVEL", "")
    if choice == "":
        choice = "1" if lde.device.type == "cuda" else "0"
    if prog.levels is not None and choice != "0":
        return execute_leveled(prog.levels, lde, per_p, p_last, alphas,
                               blowup)

    N = lde.shape[-2]
    reps = N // per_p.shape[1]
    imm = tl.from_numpy(prog.imm, lde.device)
    stack: list = []
    slots: dict = {}
    acc = tl.zeros(lde.shape[:-3] + (N,), lde.device)
    for i in range(prog.n_instr):
        op = int(prog.ops[i])
        a = int(prog.arg[i])
        if op == OP_NOP:
            continue
        if op == OP_PUSH_CUR:
            stack.append(lde[..., a, :, :])
        elif op == OP_PUSH_NXT:
            stack.append(torch.roll(lde[..., a, :, :], -blowup, -2))
        elif op == OP_PUSH_PER:
            stack.append(per_p[a].repeat(reps, 1))
        elif op == OP_PUSH_CONST:
            stack.append(imm[i][None])
        elif op == OP_PUSH_PLAST:
            stack.append(p_last)
        elif op == OP_STORE_SLOT:
            slots[a] = stack.pop()
        elif op == OP_PUSH_SLOT:
            stack.append(slots[a])
        elif op == OP_EMIT:
            top = stack.pop()
            acc = tl.add(acc, tl.mul(
                top, alphas[..., int(prog.aidx[i]), None, :]))
        else:
            top = stack.pop()
            sec = stack.pop()
            if op == OP_ADD:
                stack.append(tl.add(sec, top))
            elif op == OP_SUB:
                stack.append(tl.sub(sec, top))
            elif op == OP_MUL:
                stack.append(tl.mul(sec, top))
            else:
                raise ValueError(f"cvm: unknown opcode {op}")
    assert not stack
    return acc


def interpret(prog: CvmProgram, cur_rows, nxt_rows, per_rows,
              alphas: List[int]) -> int:
    """Host reference interpreter over a single row (ints, for tests).
    `per_rows` covers ALL periodic columns; the last entry is p_last."""
    stack: List[int] = []
    slots: Dict[int, int] = {}
    acc = 0
    n = prog.ops.shape[0]
    imm_ints = limb.to_ints(prog.imm)
    for i in range(n):
        op = int(prog.ops[i])
        a = int(prog.arg[i])
        if op == OP_NOP:
            continue
        elif op == OP_STORE_SLOT:
            slots[a] = stack.pop()
        elif op == OP_PUSH_SLOT:
            stack.append(slots[a])
        elif op == OP_PUSH_CUR:
            stack.append(cur_rows[a])
        elif op == OP_PUSH_NXT:
            stack.append(nxt_rows[a])
        elif op == OP_PUSH_PER:
            stack.append(per_rows[a])
        elif op == OP_PUSH_PLAST:
            stack.append(per_rows[-1])
        elif op == OP_PUSH_CONST:
            stack.append(int(imm_ints[i]))
        elif op == OP_ADD:
            b2 = stack.pop(); a2 = stack.pop()
            stack.append((a2 + b2) % P)
        elif op == OP_SUB:
            b2 = stack.pop(); a2 = stack.pop()
            stack.append((a2 - b2) % P)
        elif op == OP_MUL:
            b2 = stack.pop(); a2 = stack.pop()
            stack.append((a2 * b2) % P)
        elif op == OP_EMIT:
            v = stack.pop()
            acc = (acc + v * alphas[int(prog.aidx[i])]) % P
    assert not stack
    return acc
