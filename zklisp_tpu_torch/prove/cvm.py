"""Constraint bytecode VM: the AIR's generic transition constraints,
recorded once and executed over the whole evaluation domain.

Pipeline:
  record   — run the AIR's constraint emitters on `Sym` operands
             (pure-Python tree nodes; milliseconds)
  compile  — post-order flatten each constraint tree to PUSH/ADD/SUB/
             MUL/EMIT instructions; shared subexpressions get slots
  execute  — a Python loop over the instructions; each is one batched
             limb op over all N rows (PyTorch, eager)
  interpret — host reference over a single row of Python ints (tests)

`execute` evaluates sum_i alpha_i * C_i.  It is one executor, the stack
machine; a level-scheduled executor (fewer, larger ops) is not ported
yet.
"""

from __future__ import annotations

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
    return CvmProgram(ops, arg, imm, aidx, S, n_instr, n_slots)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def execute(prog: CvmProgram, lde, per_p, p_last, alphas, blowup: int):
    """Run the bytecode over the whole evaluation domain: returns the
    (N, 8) accumulated sum_i alpha_i * C_i.

    lde (w, N, 8) column-major evaluations; per_p (n_perp, period, 8)
    one period of each short-periodic column; p_last (N, 8); alphas
    (n_constraints, 8).  The stack machine is a Python loop over the
    recorded instructions, each a batched limb op over all N rows; `nxt`
    columns are rolls of `lde` by `blowup`, short-periodic columns are
    tiled from one period, constants stay (1, 8) and broadcast."""
    from ..field import limb as tl

    N = lde.shape[1]
    reps = N // per_p.shape[1]
    imm = tl.from_numpy(prog.imm, lde.device)
    stack: list = []
    slots: dict = {}
    acc = tl.zeros((N,), lde.device)
    for i in range(prog.n_instr):
        op = int(prog.ops[i])
        a = int(prog.arg[i])
        if op == OP_NOP:
            continue
        if op == OP_PUSH_CUR:
            stack.append(lde[a])
        elif op == OP_PUSH_NXT:
            stack.append(torch.roll(lde[a], -blowup, 0))
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
            acc = tl.add(acc, tl.mul(top, alphas[int(prog.aidx[i])][None]))
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
