"""Constraint bytecode VM: the AIR's generic transition constraints,
recorded once and executed over the whole evaluation domain.

Pipeline:
  record   — run the AIR's constraint emitters on `Sym` operands
             (pure-Python tree nodes; milliseconds)
  compile  — post-order flatten each constraint tree to PUSH/ADD/SUB/
             MUL/EMIT instructions; shared subexpressions get slots
  execute  — evaluates sum_i alpha_i * C_i over the domain
  interpret — host reference over a single row of Python ints (tests)

`execute` runs a CUDA tensor through the composition kernel
(prove/composition_cuda.py, csrc/composition.cu), which reads the
program's register form (`compile_registers`) as data, one thread per
row.  A CPU tensor takes one of the two plain PyTorch executors, which
share the recorded program and give the kernel's limbs:

  stack   — a Python loop over the instructions, each one batched limb
            op over all N rows (~4e3 small ops per segment).
  leveled — the same Sym DAG scheduled into topological LEVELS
            (`compile_levels`); each level is at most three BATCHED limb
            ops (one mul / add / sub over a (K, C, 8) gather from a
            unified operand table), so the program is ~tree-depth x 3
            large ops per row chunk.

ZKL_CVM_LEVEL=1/0 (read at call time) picks the leveled or the stack
executor for a CPU tensor (default: stack).  Both can be called directly
on any device (`execute_leveled`, `execute_stack`).
"""

from __future__ import annotations

import hashlib
import heapq
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
    regs: "Optional[RegProgram]" = None       # the kernel's register form


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
    prog.regs = compile_registers(prog)
    return prog


# ---------------------------------------------------------------------------
# register form: the stack program as three-address code (the kernel's)
# ---------------------------------------------------------------------------

# operand kinds (operand = kind << 24 | index)
RK_REG, RK_CUR, RK_NXT, RK_PER, RK_PLAST, RK_CONST = range(6)
# instructions (op, dst, a, b)
R_ADD, R_SUB, R_MUL, R_EMIT = range(4)
_R_BIN = {OP_ADD: R_ADD, OP_SUB: R_SUB, OP_MUL: R_MUL}
_R_LEAF = {OP_PUSH_CUR: RK_CUR, OP_PUSH_NXT: RK_NXT, OP_PUSH_PER: RK_PER,
           OP_PUSH_PLAST: RK_PLAST}


@dataclass
class RegProgram:
    """The stack program as three-address code over a per-row register
    file, which csrc/composition.cu interprets as data.

    code (I, 4) int32 rows (op, dst, a, b): R_ADD / R_SUB / R_MUL write
    register `dst` from operands a and b (both read before dst is
    written); R_EMIT adds alphas[dst] * a to the row's sum (b unused).
    An operand is kind << 24 | index: a register, a cur or nxt column, a
    short-periodic column, p_last (index 0) or an entry of `consts`, the
    program's distinct constants as (K, 4) little-endian 32-bit words.
    A register is free again once its value's last use has read it, so
    n_regs is the most values live at once: the stack's depth plus the
    live CSE slots, never the program's length."""
    code: _np.ndarray       # (I, 4) int32
    consts: _np.ndarray     # (K, 4) uint32 words
    n_regs: int
    sig: str                # content hash: cache key of the device copy


def _operand(kind: int, index: int) -> int:
    return (kind << 24) | index


def compile_registers(prog: CvmProgram) -> RegProgram:
    """Replay the stack program symbolically: a push leaves its leaf on
    the stack as an operand (no instruction), a binop takes the lowest
    free register, a CSE slot keeps its value's register until its last
    PUSH_SLOT has been consumed.  The instructions and their order are
    the stack program's, so every row computes the same field values."""
    n = prog.n_instr
    ops = [int(v) for v in prog.ops[:n]]
    arg = [int(v) for v in prog.arg[:n]]
    pushes: Dict[int, int] = defaultdict(int)
    for op, a in zip(ops, arg):
        if op == OP_PUSH_SLOT:
            pushes[a] += 1
    imm_words = _np.asarray(prog.imm[:n], _np.uint32)
    imm_words = imm_words[:, 0::2] | (imm_words[:, 1::2] << 16)
    const_ix: Dict[bytes, int] = {}
    consts: List[_np.ndarray] = []
    refs: Dict[int, int] = {}           # register -> live references
    free: List[int] = []
    slot_reg: Dict[int, int] = {}
    stack: List[int] = []
    code: List[Tuple[int, int, int, int]] = []
    n_regs = 0

    def release(opnd: int) -> None:
        if opnd >> 24 == RK_REG:
            r = opnd & 0xFFFFFF
            refs[r] -= 1
            if refs[r] == 0:
                del refs[r]
                heapq.heappush(free, r)

    for i, (op, a) in enumerate(zip(ops, arg)):
        if op == OP_NOP:
            continue
        if op in _R_LEAF:
            stack.append(_operand(_R_LEAF[op], a))
        elif op == OP_PUSH_CONST:
            key = imm_words[i].tobytes()
            if key not in const_ix:
                const_ix[key] = len(consts)
                consts.append(imm_words[i])
            stack.append(_operand(RK_CONST, const_ix[key]))
        elif op == OP_STORE_SLOT:
            v = stack.pop()
            assert v >> 24 == RK_REG, "cvm: a slot holds a binop's value"
            r = v & 0xFFFFFF
            slot_reg[a] = r
            refs[r] += pushes[a] - 1     # the popped entry -> later pushes
            if refs[r] == 0:
                del refs[r]
                heapq.heappush(free, r)
        elif op == OP_PUSH_SLOT:
            stack.append(_operand(RK_REG, slot_reg[a]))
        elif op == OP_EMIT:
            v = stack.pop()
            code.append((R_EMIT, int(prog.aidx[i]), v, 0))
            release(v)
        elif op in _R_BIN:
            b = stack.pop()
            x = stack.pop()
            release(x)
            release(b)
            if free:
                d = heapq.heappop(free)
            else:
                d, n_regs = n_regs, n_regs + 1
            refs[d] = 1
            code.append((_R_BIN[op], d, x, b))
            stack.append(_operand(RK_REG, d))
        else:
            raise ValueError(f"cvm: unknown opcode {op}")
    assert not stack and not refs
    code_a = _np.asarray(code, _np.int32).reshape(-1, 4)
    consts_a = (_np.stack(consts) if consts
                else _np.zeros((0, 4), _np.uint32)).astype(_np.uint32)
    h = hashlib.sha256()
    h.update(_np.int64(n_regs).tobytes())
    h.update(code_a.tobytes())
    h.update(consts_a.tobytes())
    return RegProgram(code_a, consts_a, n_regs, h.hexdigest())


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

    A CUDA tensor goes to the composition kernel (one launch); a CPU
    tensor to the stack executor, or to the leveled one with
    ZKL_CVM_LEVEL=1.  All three give identical limbs."""
    if lde.device.type == "cuda":
        from .composition_cuda import generic
        return generic(prog.regs, lde, per_p, p_last, alphas, blowup)
    if prog.levels is not None and os.environ.get("ZKL_CVM_LEVEL") == "1":
        return execute_leveled(prog.levels, lde, per_p, p_last, alphas,
                               blowup)
    return execute_stack(prog, lde, per_p, p_last, alphas, blowup)


def execute_stack(prog: CvmProgram, lde, per_p, p_last, alphas,
                  blowup: int):
    """The stack executor: same contract as `execute`, on any device.  A
    Python loop over the recorded instructions, each a batched limb op
    over all N rows (of every segment); `nxt` columns are rolls of `lde`
    by `blowup` within each segment, short-periodic columns are tiled
    from one period, constants stay (1, 8) and broadcast."""
    from ..field import limb as tl

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
