"""Unified execution trace builder.

Mirrors the reference trace construction exactly
(src/vm/trace/{mod,vm,ram,rom,poseidon}.rs): VM simulation filling
register/opcode/selector columns, Poseidon per-level permutation rows,
sorted-RAM table with grand products, and the t=3 ROM accumulator.

Host/device split (TPU-first): the *content* of the trace is control-flow
heavy and stays host-side (this module; the reference's Rust equivalent is
also host code).  Batched Poseidon round states for sponge/Merkle levels
and the ROM chain are computed through the same field routines the device
kernels use, so they can later be swapped for the C++/device fast path
without changing any semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..compiler import ops as O
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..crypto import poseidon as pos
from ..crypto.blake3 import blake3
from ..field import f128
from . import schedule
from .layout import (Columns, LayoutConfig, NR, POSEIDON_ROUNDS,
                     SPONGE_IDX_BITS, STEPS_PER_LEVEL_P2)
from .table import TraceTable

P = f128.P


class TraceError(Exception):
    pass


@dataclass(frozen=True)
class Segment:
    """Half-open row interval (zk-lisp-proof/src/segment.rs)."""
    r_start: int
    r_end: int

    def __post_init__(self):
        if self.r_start >= self.r_end:
            raise TraceError("segment requires r_start < r_end")


@dataclass(frozen=True)
class PrevState:
    state_out_hash: bytes


# ---------------------------------------------------------------------------
# Empty trace + schedule gates (mod.rs build_empty_trace)
# ---------------------------------------------------------------------------

def build_empty_trace(total_levels: int) -> TraceTable:
    cols = Columns.baseline()
    n_rows = total_levels * STEPS_PER_LEVEL_P2
    trace = TraceTable(cols.width(), n_rows)
    g_map = trace.cols[cols.g_map]
    g_final = trace.cols[cols.g_final]
    for row in range(n_rows):
        pos_ = row % STEPS_PER_LEVEL_P2
        if pos_ == schedule.pos_map():
            g_map[row] = 1
        if pos_ == schedule.pos_final():
            g_final[row] = 1
        if schedule.is_round_pos(pos_):
            trace.cols[cols.g_r_index(pos_ - 1)][row] = 1
    return trace


# ---------------------------------------------------------------------------
# Poseidon level fill (poseidon.rs apply_level_absorb)
# ---------------------------------------------------------------------------

def apply_level_absorb(trace: TraceTable, suite_id: bytes, level: int,
                       inputs: Sequence[int]) -> None:
    cols = Columns.baseline()
    steps = STEPS_PER_LEVEL_P2
    base = level * steps
    row_map = base + schedule.pos_map()
    suite = pos.get_poseidon_suite(suite_id)

    state0 = [inputs[i] if i < len(inputs) else 0 for i in range(10)]
    state0 += [suite.dom[0], suite.dom[1]]

    from .. import native
    if native.available():
        flat = native.poseidon12_levels(
            state0, _flat(suite.mds), _flat(suite.rc), 1, POSEIDON_ROUNDS)
        # reference layout (trace/poseidon.rs): map row and round row 1
        # both hold the initial state s_0; round row 1+j holds s_j; the
        # final row holds s_rounds.
        for i in range(12):
            trace.set(cols.lane_index(i), row_map, state0[i])
        for j in range(POSEIDON_ROUNDS):
            r = base + 1 + j
            for i in range(12):
                trace.set(cols.lane_index(i), r, flat[12 * j + i])
        s = flat[12 * POSEIDON_ROUNDS:12 * (POSEIDON_ROUNDS + 1)]
    else:
        for i in range(12):
            trace.set(cols.lane_index(i), row_map, state0[i])
        s = state0
        for j, rcj in enumerate(suite.rc[:POSEIDON_ROUNDS]):
            r = base + 1 + j
            for i, val in enumerate(s):
                trace.set(cols.lane_index(i), r, val)
            s3 = [(v * v % P) * v % P for v in s]
            s = [(sum(m * v for m, v in zip(row_m, s3)) + rcj[i]) % P
                 for i, row_m in enumerate(suite.mds)]

    row_fin = base + schedule.pos_final()
    for r in range(row_fin, base + steps):
        for i, v in enumerate(s):
            trace.set(cols.lane_index(i), r, v)


def _flat(rows) -> list:
    return [v for row in rows for v in row]


# ---------------------------------------------------------------------------
# VM fill (vm.rs VmTraceBuilder)
# ---------------------------------------------------------------------------

def _set_sel(trace: TraceTable, row: int, sel_start: int, idx: int) -> None:
    for i in range(NR):
        trace.set(sel_start + i, row, 0)
    trace.set(sel_start + idx, row, 1)


def op_to_one_hot(op: O.Op) -> List[int]:
    v = [0] * 17
    if isinstance(op, O.Const):
        v[0] = 1
    elif isinstance(op, O.Mov):
        v[1] = 1
    elif isinstance(op, O.Add):
        v[2] = 1
    elif isinstance(op, O.Sub):
        v[3] = 1
    elif isinstance(op, O.Mul):
        v[4] = 1
    elif isinstance(op, O.Neg):
        v[5] = 1
    elif isinstance(op, O.Eq):
        v[6] = 1
    elif isinstance(op, O.Select):
        v[7] = 1
    elif isinstance(op, (O.SAbsorbN, O.SSqueeze)):
        v[8] = 1
    elif isinstance(op, O.Assert):
        v[9] = 1
    elif isinstance(op, O.AssertBit):
        v[10] = 1
    elif isinstance(op, (O.AssertRange, O.AssertRangeLo, O.AssertRangeHi)):
        v[11] = 1
    elif isinstance(op, O.DivMod):
        v[12] = 1
    elif isinstance(op, O.DivMod128):
        v[13] = 1
    elif isinstance(op, O.MulWide):
        v[14] = 1
    elif isinstance(op, O.Load):
        v[15] = 1
    elif isinstance(op, O.Store):
        v[16] = 1
    return v


class VmSimState:
    """Cross-level VM simulator state at a level boundary (streamed
    segment builds restart _fill_vm mid-program from one of these)."""
    __slots__ = ("regs", "pending_regs", "merkle_acc", "mem",
                 "events_len")

    def __init__(self, regs, pending_regs, merkle_acc, mem, events_len):
        self.regs = regs
        self.pending_regs = pending_regs
        self.merkle_acc = merkle_acc
        self.mem = mem
        self.events_len = events_len


def initial_vm_regs(pi: pi_mod.PublicInputs) -> List[int]:
    regs = [0] * NR
    main_slots = pi_mod.encode_main_args_to_slots(pi.main_args)
    if len(main_slots) > NR:
        raise TraceError("too many main_args for VM register file")
    tail_start = NR - len(main_slots)
    for i, arg in enumerate(pi.secret_args):
        if i >= tail_start:
            break
        if arg.kind != "u64":
            raise TraceError(
                "non-u64 secret arg not yet supported for VM registers")
        regs[i] = int(arg.value)
    for j, val in enumerate(main_slots):
        regs[tail_start + j] = val
    return regs


def fill_pad_level_regs(trace, regs: List[int], lvl_from: int,
                        lvl_to: int) -> None:
    """Carry the final register file through pad levels.

    The reference zeroes registers on levels beyond the op count
    (vm.rs iterates only prog.ops), which makes its own serial
    prev_state chain check and the aggregation VM boundary chain fail
    whenever a segment starts inside the pad tail (op counts that are
    not a power of two with small max_segment_rows).  Carrying the file
    keeps the VM state hash continuous across the used->pad boundary;
    the register write rule is satisfied (no selectors fire on pad
    levels, so next == cur) — a deliberate completeness fix over the
    reference (PARITY.md)."""
    cols = Columns.baseline()
    for lvl in range(lvl_from, lvl_to):
        base = lvl * STEPS_PER_LEVEL_P2
        for r in range(base, base + STEPS_PER_LEVEL_P2):
            for i in range(NR):
                trace.set(cols.r_index(i), r, regs[i])


def _fill_vm(trace: TraceTable, prog: Program, pi: pi_mod.PublicInputs,
             mem: Dict[int, int],
             ram_events: List[Tuple[int, int, int, int]],
             lvl_start: int = 0, lvl_end: Optional[int] = None,
             state: Optional[VmSimState] = None,
             capture_at: Optional[set] = None,
             captures: Optional[dict] = None,
             pad_to_level: Optional[int] = None) -> None:
    cols = Columns.baseline()
    steps = STEPS_PER_LEVEL_P2

    if state is not None:
        regs = list(state.regs)
        pending_regs = list(state.pending_regs)
        merkle_last_out = state.merkle_acc
    else:
        assert lvl_start == 0, "mid-program start requires a VmSimState"
        regs = initial_vm_regs(pi)
        pending_regs = []
        merkle_last_out = 0

    suite_id = prog.program_id
    suite = pos.get_poseidon_suite(suite_id)

    op_cols = cols.op_columns()
    if lvl_end is None:
        lvl_end = len(prog.ops)

    def _snapshot() -> VmSimState:
        return VmSimState(list(regs), list(pending_regs), merkle_last_out,
                          dict(mem), len(ram_events))

    for lvl in range(lvl_start, lvl_end):
        op = prog.ops[lvl]
        if capture_at is not None and lvl in capture_at:
            captures[lvl] = _snapshot()
        next_regs = list(regs)

        if lvl == 0:
            trace.set(cols.pi_prog, schedule.pos_map(),
                      f128.be_from_le8(suite_id))

        base = lvl * steps
        row_map = base + schedule.pos_map()
        row_final = base + schedule.pos_final()

        trace.set(cols.lane_c0, row_map, suite.dom[0])
        trace.set(cols.lane_c1, row_map, suite.dom[1])
        trace.set(cols.pc, row_map, lvl)

        rom = op_to_one_hot(op)
        for k, bit in enumerate(rom):
            trace.set(cols.rom_op_index(k), row_map, bit)

        for i in range(NR):
            trace.set(cols.r_index(i), row_map, regs[i])
            trace.set(cols.sel_dst0_index(i), row_map, 0)
            trace.set(cols.sel_dst1_index(i), row_map, 0)
            trace.set(cols.sel_a_index(i), row_map, 0)
            trace.set(cols.sel_b_index(i), row_map, 0)
            trace.set(cols.sel_c_index(i), row_map, 0)
        trace.set(cols.imm, row_map, 0)
        trace.set(cols.eq_inv, row_map, 0)
        for c in op_cols:
            trace.set(c, row_map, 0)

        pose_active = 0

        if isinstance(op, O.Const):
            trace.set(cols.op_const, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            trace.set(cols.imm, row_map, op.imm)
            trace.set(cols.op_const, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            trace.set(cols.imm, row_final, op.imm)
            next_regs[op.dst] = op.imm
        elif isinstance(op, O.Mov):
            trace.set(cols.op_mov, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.src)
            trace.set(cols.op_mov, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.src)
            next_regs[op.dst] = regs[op.src]
        elif isinstance(op, O.Add):
            trace.set(cols.op_add, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            _set_sel(trace, row_map, cols.sel_b_start, op.b)
            trace.set(cols.op_add, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            _set_sel(trace, row_final, cols.sel_b_start, op.b)
            next_regs[op.dst] = (regs[op.a] + regs[op.b]) % P
        elif isinstance(op, O.Sub):
            trace.set(cols.op_sub, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            _set_sel(trace, row_map, cols.sel_b_start, op.b)
            trace.set(cols.op_sub, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            _set_sel(trace, row_final, cols.sel_b_start, op.b)
            next_regs[op.dst] = (regs[op.a] - regs[op.b]) % P
        elif isinstance(op, O.Mul):
            trace.set(cols.op_mul, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            _set_sel(trace, row_map, cols.sel_b_start, op.b)
            trace.set(cols.op_mul, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            _set_sel(trace, row_final, cols.sel_b_start, op.b)
            next_regs[op.dst] = (regs[op.a] * regs[op.b]) % P
        elif isinstance(op, O.Neg):
            trace.set(cols.op_neg, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            trace.set(cols.op_neg, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            next_regs[op.dst] = (-regs[op.a]) % P
        elif isinstance(op, O.Eq):
            trace.set(cols.op_eq, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            _set_sel(trace, row_map, cols.sel_b_start, op.b)
            trace.set(cols.op_eq, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            _set_sel(trace, row_final, cols.sel_b_start, op.b)
            diff = (regs[op.a] - regs[op.b]) % P
            w = 1 if diff == 0 else 0
            inv = f128.inv(diff) if diff != 0 else 0
            trace.set(cols.eq_inv, row_map, inv)
            trace.set(cols.eq_inv, row_final, inv)
            next_regs[op.dst] = w
        elif isinstance(op, O.Select):
            trace.set(cols.op_select, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_c_start, op.c)
            _set_sel(trace, row_map, cols.sel_a_start, op.a)
            _set_sel(trace, row_map, cols.sel_b_start, op.b)
            trace.set(cols.op_select, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_c_start, op.c)
            _set_sel(trace, row_final, cols.sel_a_start, op.a)
            _set_sel(trace, row_final, cols.sel_b_start, op.b)
            cond = regs[op.c]
            next_regs[op.dst] = (cond * regs[op.a]
                                 + (1 - cond) * regs[op.b]) % P
        elif isinstance(op, O.Assert):
            trace.set(cols.op_assert, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_c_start, op.c)
            trace.set(cols.op_assert, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_c_start, op.c)
            next_regs[op.dst] = 1
        elif isinstance(op, O.AssertBit):
            trace.set(cols.op_assert_bit, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_c_start, op.r)
            trace.set(cols.op_assert_bit, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_c_start, op.r)
            next_regs[op.dst] = 1
        elif isinstance(op, O.AssertRange):
            # 32-bit: stage=1 (imm=1), mode64=0 (eq_inv=0)
            for row in (row_map, row_final):
                trace.set(cols.op_assert_range, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst)
                _set_sel(trace, row, cols.sel_c_start, op.r)
                trace.set(cols.imm, row, 1)
                trace.set(cols.eq_inv, row, 0)
            n = regs[op.r]
            k = min(op.bits, 32)
            for i in range(32):
                bit_val = (n & 1) if i < k else 0
                trace.set(cols.gadget_b_index(i), row_map, bit_val)
                trace.set(cols.gadget_b_index(i), row_final, bit_val)
                if i < k:
                    n >>= 1
            next_regs[op.dst] = 1
        elif isinstance(op, O.AssertRangeLo):
            # stage 0 of 64-bit: stage=0 (imm=0), mode64=1 (eq_inv=1)
            for row in (row_map, row_final):
                trace.set(cols.op_assert_range, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst)
                _set_sel(trace, row, cols.sel_c_start, op.r)
                trace.set(cols.imm, row, 0)
                trace.set(cols.eq_inv, row, 1)
            x = regs[op.r]
            n = x
            for i in range(32):
                trace.set(cols.gadget_b_index(i), row_map, n & 1)
                trace.set(cols.gadget_b_index(i), row_final, n & 1)
                n >>= 1
            next_regs[op.dst] = x & 0xFFFFFFFF
        elif isinstance(op, O.AssertRangeHi):
            # stage 1 of 64-bit: stage=1 (imm=1), mode64=1 (eq_inv=1)
            for row in (row_map, row_final):
                trace.set(cols.op_assert_range, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst)
                _set_sel(trace, row, cols.sel_c_start, op.r)
                trace.set(cols.imm, row, 1)
                trace.set(cols.eq_inv, row, 1)
            n = regs[op.r] >> 32
            for i in range(32):
                trace.set(cols.gadget_b_index(i), row_map, n & 1)
                trace.set(cols.gadget_b_index(i), row_final, n & 1)
                n >>= 1
            next_regs[op.dst] = 1
        elif isinstance(op, O.DivMod):
            for row in (row_map, row_final):
                trace.set(cols.op_divmod, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst_q)
                _set_sel(trace, row, cols.sel_dst1_start, op.dst_r)
                _set_sel(trace, row, cols.sel_a_start, op.a)
                _set_sel(trace, row, cols.sel_b_start, op.b)
            av, bv = regs[op.a], regs[op.b]
            q = 0 if bv == 0 else av // bv
            r = av if bv == 0 else av % bv
            next_regs[op.dst_q] = q & 0xFFFFFFFFFFFFFFFF
            next_regs[op.dst_r] = r & 0xFFFFFFFFFFFFFFFF
            inv = f128.inv(bv & 0xFFFFFFFFFFFFFFFF) if bv != 0 else 0
            trace.set(cols.eq_inv, row_map, inv)
            trace.set(cols.eq_inv, row_final, inv)
        elif isinstance(op, O.MulWide):
            for row in (row_map, row_final):
                trace.set(cols.op_mulwide, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst_lo)
                _set_sel(trace, row, cols.sel_dst1_start, op.dst_hi)
                _set_sel(trace, row, cols.sel_a_start, op.a)
                _set_sel(trace, row, cols.sel_b_start, op.b)
            al = regs[op.a] & 0xFFFFFFFFFFFFFFFF
            bl = regs[op.b] & 0xFFFFFFFFFFFFFFFF
            prod = (al * bl) & ((1 << 128) - 1)
            next_regs[op.dst_lo] = prod & 0xFFFFFFFFFFFFFFFF
            next_regs[op.dst_hi] = prod >> 64
        elif isinstance(op, O.DivMod128):
            lo = regs[op.a_lo]
            for row in (row_map, row_final):
                trace.set(cols.op_div128, row, 1)
                _set_sel(trace, row, cols.sel_dst0_start, op.dst_q)
                _set_sel(trace, row, cols.sel_dst1_start, op.dst_r)
                _set_sel(trace, row, cols.sel_a_start, op.a_hi)
                _set_sel(trace, row, cols.sel_b_start, op.b)
                trace.set(cols.imm, row, lo)
            hi_u, lo_u, c_u = regs[op.a_hi], regs[op.a_lo], regs[op.b]
            num = ((hi_u << 64) | (lo_u & 0xFFFFFFFFFFFFFFFF)) & ((1 << 128) - 1)
            if c_u == 0:
                q, r = 0, num
            else:
                q, r = num // c_u, num % c_u
            next_regs[op.dst_q] = q & 0xFFFFFFFFFFFFFFFF
            next_regs[op.dst_r] = r & 0xFFFFFFFFFFFFFFFF
            inv = f128.inv(c_u & 0xFFFFFFFFFFFFFFFF) if c_u != 0 else 0
            trace.set(cols.eq_inv, row_map, inv)
            trace.set(cols.eq_inv, row_final, inv)
        elif isinstance(op, O.SSqueeze):
            trace.set(cols.op_sponge, row_map, 1)
            trace.set(cols.op_sponge, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            inputs = []
            lanes = list(pending_regs)
            for i, rr in enumerate(lanes):
                inputs.append(regs[rr])
                b0, b1, b2 = rr & 1, (rr >> 1) & 1, (rr >> 2) & 1
                for row in (row_map, row_final):
                    trace.set(cols.sel_s_b_index(i, 0), row, b0)
                    trace.set(cols.sel_s_b_index(i, 1), row, b1)
                    trace.set(cols.sel_s_b_index(i, 2), row, b2)
                    trace.set(cols.sel_s_active_index(i), row, 1)
            for lane in range(len(lanes), 10):
                for row in (row_map, row_final):
                    trace.set(cols.sel_s_active_index(lane), row, 0)
                    for b in range(SPONGE_IDX_BITS):
                        trace.set(cols.sel_s_b_index(lane, b), row, 0)
            pose_active = 1
            apply_level_absorb(trace, suite_id, lvl, inputs)
            out = trace.get(cols.lane_index(0), row_final)
            next_regs[op.dst] = out
            pending_regs.clear()
        elif isinstance(op, O.SAbsorbN):
            trace.set(cols.op_sponge, row_map, 1)
            trace.set(cols.op_sponge, row_final, 1)
            for i, rr in enumerate(op.regs):
                if i >= 10:
                    raise TraceError("sponge rate overflow")
                b0, b1, b2 = rr & 1, (rr >> 1) & 1, (rr >> 2) & 1
                for row in (row_map, row_final):
                    trace.set(cols.sel_s_b_index(i, 0), row, b0)
                    trace.set(cols.sel_s_b_index(i, 1), row, b1)
                    trace.set(cols.sel_s_b_index(i, 2), row, b2)
                    trace.set(cols.sel_s_active_index(i), row, 1)
                if len(pending_regs) >= 10:
                    raise TraceError("sponge rate overflow")
                pending_regs.append(rr)
            for lane in range(len(op.regs), 10):
                for row in (row_map, row_final):
                    trace.set(cols.sel_s_active_index(lane), row, 0)
                    for b in range(SPONGE_IDX_BITS):
                        trace.set(cols.sel_s_b_index(lane, b), row, 0)
            pose_active = 0
        elif isinstance(op, (O.MerkleStepFirst, O.MerkleStep,
                             O.MerkleStepLast)):
            for r in range(base, base + steps):
                trace.set(cols.merkle_g, r, 1)
            pose_active = 1

            if isinstance(op, O.MerkleStepFirst):
                leaf = regs[op.leaf_reg]
                trace.set(cols.merkle_first, row_map, 1)
                trace.set(cols.merkle_leaf, row_map, leaf)
                acc_prev = leaf
            else:
                # the most recent merkle level's output (carried state;
                # equals the reference's back-scan of merkle_g levels —
                # 0 when no merkle level precedes)
                acc_prev = merkle_last_out

            trace.set(cols.merkle_acc, row_map, acc_prev)
            for r in range(row_map + 1, row_final):
                trace.set(cols.merkle_acc, r, acc_prev)

            d = regs[op.dir_reg]
            s = regs[op.sib_reg]
            trace.set(cols.merkle_dir, row_map, d)
            trace.set(cols.merkle_sib, row_map, s)

            left = ((1 - d) * acc_prev + d * s) % P
            right = ((1 - d) * s + d * acc_prev) % P
            apply_level_absorb(trace, suite_id, lvl, [left, right])

            if isinstance(op, O.MerkleStepLast):
                trace.set(cols.merkle_last, row_final, 1)

            out = trace.get(cols.lane_l, row_final)
            for r in range(row_final, base + steps):
                trace.set(cols.merkle_acc, r, out)
            merkle_last_out = out
            if isinstance(op, O.MerkleStepLast):
                # ledger of computed chain roots: the AIR binds every
                # merkle_last acc to PublicInputs.merkle_root
                # (vm/air/merkle.rs root assertion), so the prove path
                # fail-fasts on a mismatch instead of burning a full
                # proving run (prover.check_merkle_root_binding)
                try:
                    if not hasattr(trace, "merkle_roots"):
                        trace.merkle_roots = []
                    trace.merkle_roots.append(out)
                except AttributeError:
                    pass   # slotted streaming sinks skip the ledger
        elif isinstance(op, O.Load):
            trace.set(cols.op_load, row_map, 1)
            _set_sel(trace, row_map, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_map, cols.sel_a_start, op.addr)
            trace.set(cols.op_load, row_final, 1)
            _set_sel(trace, row_final, cols.sel_dst0_start, op.dst)
            _set_sel(trace, row_final, cols.sel_a_start, op.addr)
            addr_v = regs[op.addr]
            loaded = mem.get(addr_v, 0)
            trace.set(cols.imm, row_map, loaded)
            trace.set(cols.imm, row_final, loaded)
            next_regs[op.dst] = loaded
            ram_events.append((addr_v, lvl, loaded, 0))
        elif isinstance(op, O.Store):
            trace.set(cols.op_store, row_map, 1)
            _set_sel(trace, row_map, cols.sel_a_start, op.addr)
            _set_sel(trace, row_map, cols.sel_b_start, op.src)
            trace.set(cols.op_store, row_final, 1)
            _set_sel(trace, row_final, cols.sel_a_start, op.addr)
            _set_sel(trace, row_final, cols.sel_b_start, op.src)
            addr_v = regs[op.addr]
            src_v = regs[op.src]
            mem[addr_v] = src_v
            ram_events.append((addr_v, lvl, src_v, 1))
        elif isinstance(op, O.End):
            pass
        else:
            raise TraceError(f"unknown op {op!r}")

        # rows map+1..=final keep pre-write regs; after final: next_regs
        for r in range(row_map + 1, row_final + 1):
            for i in range(NR):
                trace.set(cols.r_index(i), r, regs[i])
            trace.set(cols.pc, r, lvl)
        for r in range(row_final + 1, base + steps):
            for i in range(NR):
                trace.set(cols.r_index(i), r, next_regs[i])
            trace.set(cols.pc, r, lvl)
        for r in range(base, base + steps):
            trace.set(cols.pose_active, r, pose_active)

        regs = next_regs

    if capture_at is not None and lvl_end in capture_at:
        captures[lvl_end] = _snapshot()

    if pad_to_level is not None and pad_to_level > lvl_end:
        fill_pad_level_regs(trace, regs, lvl_end, pad_to_level)


# ---------------------------------------------------------------------------
# ROM linear encodings (utils.rs:143-275)
# ---------------------------------------------------------------------------

def rom_encode_columns(cols: Columns) -> List[int]:
    """The 59 column indices folded by the ROM linear encoder, in order."""
    idx = list(cols.op_columns())
    for i in range(NR):
        idx.append(cols.sel_dst0_index(i))
    for i in range(NR):
        idx.append(cols.sel_a_index(i))
    for i in range(NR):
        idx.append(cols.sel_b_index(i))
    for i in range(NR):
        idx.append(cols.sel_c_index(i))
    for i in range(NR):
        idx.append(cols.sel_dst1_index(i))
    return idx


def rom_linear_encode_row(row_vals: Sequence[int], cols: Columns,
                          weights: Sequence[int]) -> int:
    acc = 0
    for k, c in enumerate(rom_encode_columns(cols)):
        v = row_vals[c]
        if v:
            acc += v * weights[k]
    return acc % P


def rom_linear_encode_from_trace(trace: TraceTable, row: int, cols: Columns,
                                 weights: Sequence[int]) -> int:
    acc = 0
    for k, c in enumerate(rom_encode_columns(cols)):
        v = trace.get(c, row)
        if v:
            acc += v * weights[k]
    return acc % P


# ---------------------------------------------------------------------------
# RAM fill (ram.rs RamTraceBuilder)
# ---------------------------------------------------------------------------

def ram_compressor_coeffs(suite_id: bytes) -> Tuple[int, int, int]:
    fc = pos.program_field_commitment(suite_id)
    pi_be = fc[0]
    pi2 = pi_be * pi_be % P
    pi3 = pi2 * pi_be % P
    pi4 = pi2 * pi2 % P
    pi5 = pi4 * pi_be % P
    return (pi2 + 1) % P, (pi3 + pi_be) % P, (pi5 + 7) % P


def _fill_ram(trace: TraceTable, suite_id: bytes,
              ram_events: List[Tuple[int, int, int, int]]) -> None:
    cols = Columns.baseline()
    n = trace.length
    ram_events.sort(key=lambda e: (e[0], e[1]))

    event_rows: List[int] = []
    ev_iter = iter(ram_events)
    cur_ev = next(ev_iter, None)
    for row in range(n):
        pos_ = row % STEPS_PER_LEVEL_P2
        if schedule.is_pad_pos(pos_) and cur_ev is not None:
            trace.set(cols.ram_sorted, row, 1)
            trace.set(cols.ram_s_addr, row, cur_ev[0])
            trace.set(cols.ram_s_clk, row, cur_ev[1])
            trace.set(cols.ram_s_val, row, cur_ev[2])
            trace.set(cols.ram_s_is_write, row, cur_ev[3])
            event_rows.append(row)
            cur_ev = next(ev_iter, None)

    # mirror same-addr witness between event rows
    for i in range(len(ram_events) - 1):
        addr_cur, clk_cur, val_cur, w_cur = ram_events[i]
        if addr_cur != ram_events[i + 1][0]:
            continue
        row_cur, row_next = event_rows[i], event_rows[i + 1]
        for row in range(row_cur + 1, row_next):
            if trace.get(cols.ram_sorted, row) == 0:
                trace.set(cols.ram_s_addr, row, addr_cur)
                trace.set(cols.ram_s_clk, row, clk_cur)
                trace.set(cols.ram_s_val, row, val_cur)
                trace.set(cols.ram_s_is_write, row, w_cur)

    r1, r2, r3 = ram_compressor_coeffs(suite_id)

    gp_sorted = 0
    last_write = 0
    sorted_col = trace.cols[cols.ram_sorted]
    for row in range(n):
        if row > 0 and sorted_col[row - 1] == 1:
            prev = row - 1
            a = trace.get(cols.ram_s_addr, prev)
            c = trace.get(cols.ram_s_clk, prev)
            v = trace.get(cols.ram_s_val, prev)
            w = trace.get(cols.ram_s_is_write, prev)
            gp_sorted = (gp_sorted + a + r1 * c + r2 * v + r3 * w) % P
            a_n = trace.get(cols.ram_s_addr, row)
            if a_n == a:
                last_write = ((1 - w) * last_write + w * v) % P
            else:
                last_write = (w * v) % P
        trace.set(cols.ram_gp_sorted, row, gp_sorted)
        trace.set(cols.ram_s_last_write, row, last_write)

    # delta_clk gadget bits + same-addr inverse witness
    for row in range(n - 1):
        if sorted_col[row] == 1:
            a = trace.get(cols.ram_s_addr, row)
            a_n = trace.get(cols.ram_s_addr, row + 1)
            d_addr = (a_n - a) % P
            trace.set(cols.eq_inv, row, f128.inv(d_addr) if d_addr else 0)
            if sorted_col[row + 1] == 1 and a_n == a:
                clk = trace.get(cols.ram_s_clk, row)
                clk_n = trace.get(cols.ram_s_clk, row + 1)
                delta = max(clk_n - clk, 0)
                for i in range(32):
                    trace.set(cols.gadget_b_index(i), row, delta & 1)
                    delta >>= 1

    # unsorted grand product (updates after final rows of load/store levels)
    gp_uns = 0
    for row in range(n):
        if row > 0:
            prev = row - 1
            if prev % STEPS_PER_LEVEL_P2 == schedule.pos_final():
                is_load = trace.get(cols.op_load, prev) == 1
                is_store = trace.get(cols.op_store, prev) == 1
                if is_load or is_store:
                    a_ev = 0
                    b_ev = 0
                    for i in range(NR):
                        ri = trace.get(cols.r_index(i), prev)
                        a_ev += trace.get(cols.sel_a_index(i), prev) * ri
                        b_ev += trace.get(cols.sel_b_index(i), prev) * ri
                    a_ev %= P
                    b_ev %= P
                    w_ev = 1 if is_store else 0
                    val_ev = (w_ev * b_ev
                              + (1 - w_ev) * trace.get(cols.imm, prev)) % P
                    clk_ev = trace.get(cols.pc, prev)
                    gp_uns = (gp_uns + a_ev + r1 * clk_ev + r2 * val_ev
                              + r3 * w_ev) % P
        trace.set(cols.ram_gp_unsorted, row, gp_uns)


# ---------------------------------------------------------------------------
# ROM fill (rom.rs RomTraceBuilder)
# ---------------------------------------------------------------------------

def _fill_rom(trace: TraceTable, prog: Program, total_levels: int) -> None:
    cols = Columns.baseline()
    steps = STEPS_PER_LEVEL_P2
    suite_id = prog.program_id
    mds3, rc3 = pos.get_rom_suite(suite_id)
    w0 = pos.rom_weights_for_seed(pos.ROM_W_SEED_0)
    w1 = pos.rom_weights_for_seed(pos.ROM_W_SEED_1)

    # per-level linear encodings from the map rows
    encs = []
    for lvl in range(total_levels):
        row_map = lvl * steps + schedule.pos_map()
        encs.append(rom_linear_encode_from_trace(trace, row_map, cols, w0))
        encs.append(rom_linear_encode_from_trace(trace, row_map, cols, w1))

    from .. import native
    if native.available():
        flat = native.rom_chain(encs, _flat(mds3), _flat(rc3), total_levels,
                                POSEIDON_ROUNDS)
        per_level = 3 * (POSEIDON_ROUNDS + 1)
        for lvl in range(total_levels):
            base = lvl * steps
            off = per_level * lvl
            # map row and round row 1 both hold the initial state s_0;
            # round row 1+j holds s_j; final row holds s_rounds
            # (rom.rs RomTraceBuilder layout)
            for i in range(3):
                trace.set(cols.rom_s_index(i), base, flat[off + i])
            for j in range(POSEIDON_ROUNDS):
                r = base + 1 + j
                for i in range(3):
                    trace.set(cols.rom_s_index(i), r, flat[off + 3 * j + i])
            fin = off + 3 * POSEIDON_ROUNDS
            for i in range(3):
                trace.set(cols.rom_s_index(i),
                          base + schedule.pos_final(), flat[fin + i])
            for r in range(base + schedule.pos_final() + 1, base + steps):
                for i in range(3):
                    trace.set(cols.rom_s_index(i), r, flat[fin + i])
        return

    s0_prev = 0
    for lvl in range(total_levels):
        base = lvl * steps
        row_map = base + schedule.pos_map()
        row_final = base + schedule.pos_final()

        s1 = encs[2 * lvl]
        s2 = encs[2 * lvl + 1]

        trace.set(cols.rom_s_index(0), row_map, s0_prev)
        trace.set(cols.rom_s_index(1), row_map, s1)
        trace.set(cols.rom_s_index(2), row_map, s2)

        s = [s0_prev, s1, s2]
        for j, rc_row in enumerate(rc3[:POSEIDON_ROUNDS]):
            r = base + 1 + j
            trace.set(cols.rom_s_index(0), r, s[0])
            trace.set(cols.rom_s_index(1), r, s[1])
            trace.set(cols.rom_s_index(2), r, s[2])
            s3 = [(v * v % P) * v % P for v in s]
            s = [(mds3[i][0] * s3[0] + mds3[i][1] * s3[1]
                  + mds3[i][2] * s3[2] + rc_row[i]) % P for i in range(3)]
            rn = r + 1
            trace.set(cols.rom_s_index(0), rn, s[0])
            trace.set(cols.rom_s_index(1), rn, s[1])
            trace.set(cols.rom_s_index(2), rn, s[2])

        for r in range(row_final + 1, base + steps):
            trace.set(cols.rom_s_index(0), r, s[0])
            trace.set(cols.rom_s_index(1), r, s[1])
            trace.set(cols.rom_s_index(2), r, s[2])

        s0_prev = s[0]


# ---------------------------------------------------------------------------
# Offline ROM accumulator (romacc.rs)
# ---------------------------------------------------------------------------

def encode_map_row_for_op(row: List[int], cols: Columns, op: O.Op) -> None:
    for i in range(NR):
        row[cols.sel_dst0_index(i)] = 0
        row[cols.sel_dst1_index(i)] = 0
        row[cols.sel_a_index(i)] = 0
        row[cols.sel_b_index(i)] = 0
        row[cols.sel_c_index(i)] = 0
    for c in cols.op_columns():
        row[c] = 0

    if isinstance(op, O.Const):
        row[cols.op_const] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.imm] = op.imm
    elif isinstance(op, O.Mov):
        row[cols.op_mov] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.src)] = 1
    elif isinstance(op, O.Add):
        row[cols.op_add] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Sub):
        row[cols.op_sub] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Mul):
        row[cols.op_mul] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Neg):
        row[cols.op_neg] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.a)] = 1
    elif isinstance(op, O.Eq):
        row[cols.op_eq] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Select):
        row[cols.op_select] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.c)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Assert):
        row[cols.op_assert] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.c)] = 1
    elif isinstance(op, O.AssertBit):
        row[cols.op_assert_bit] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.r)] = 1
    elif isinstance(op, O.AssertRange):
        row[cols.op_assert_range] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.r)] = 1
        row[cols.imm] = 1
    elif isinstance(op, O.AssertRangeLo):
        row[cols.op_assert_range] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.r)] = 1
        row[cols.imm] = 0
        row[cols.eq_inv] = 1
    elif isinstance(op, O.AssertRangeHi):
        row[cols.op_assert_range] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_c_index(op.r)] = 1
        row[cols.imm] = 1
        row[cols.eq_inv] = 1
    elif isinstance(op, O.DivMod):
        row[cols.op_divmod] = 1
        row[cols.sel_dst0_index(op.dst_q)] = 1
        row[cols.sel_dst1_index(op.dst_r)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.DivMod128):
        row[cols.op_div128] = 1
        row[cols.sel_dst0_index(op.dst_q)] = 1
        row[cols.sel_dst1_index(op.dst_r)] = 1
        row[cols.sel_a_index(op.a_hi)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.MulWide):
        row[cols.op_mulwide] = 1
        row[cols.sel_dst0_index(op.dst_lo)] = 1
        row[cols.sel_dst1_index(op.dst_hi)] = 1
        row[cols.sel_a_index(op.a)] = 1
        row[cols.sel_b_index(op.b)] = 1
    elif isinstance(op, O.Load):
        row[cols.op_load] = 1
        row[cols.sel_dst0_index(op.dst)] = 1
        row[cols.sel_a_index(op.addr)] = 1
    elif isinstance(op, O.Store):
        row[cols.op_store] = 1
        row[cols.sel_a_index(op.addr)] = 1
        row[cols.sel_b_index(op.src)] = 1
    elif isinstance(op, (O.SAbsorbN, O.SSqueeze)):
        row[cols.op_sponge] = 1
    # Merkle ops and End: no ALU bits or selectors


def rom_acc_from_program(program: Program) -> Tuple[int, int, int]:
    """Host-side trusted ROM accumulator (romacc.rs:22-75)."""
    cols = Columns.baseline()
    suite_id = program.program_id
    mds3, rc3 = pos.get_rom_suite(suite_id)
    w0 = pos.rom_weights_for_seed(pos.ROM_W_SEED_0)
    w1 = pos.rom_weights_for_seed(pos.ROM_W_SEED_1)

    levels = len(program.ops)
    total_levels = max(1, 1 << (levels - 1).bit_length()) if levels else 1

    row = [0] * cols.width()
    s0_prev = s1_prev = s2_prev = 0
    for lvl in range(total_levels):
        for i in range(len(row)):
            row[i] = 0
        if lvl < levels:
            encode_map_row_for_op(row, cols, program.ops[lvl])
        enc0 = rom_linear_encode_row(row, cols, w0)
        enc1 = rom_linear_encode_row(row, cols, w1)
        s = pos.permute_3([s0_prev, enc0, enc1], mds3, rc3)
        s0_prev, s1_prev, s2_prev = s
    return s0_prev, s1_prev, s2_prev


# ---------------------------------------------------------------------------
# Full trace orchestration (mod.rs build_full_trace)
# ---------------------------------------------------------------------------

def build_trace(prog: Program, pi: pi_mod.PublicInputs) -> TraceTable:
    return build_full_trace(prog, pi)


def build_full_trace(prog: Program, pi: pi_mod.PublicInputs) -> TraceTable:
    levels = len(prog.ops)
    cols = Columns.baseline()
    total_levels = max(1, 1 << (levels - 1).bit_length()) if levels else 1
    trace = build_empty_trace(total_levels)

    # PC lanes for all levels (incl. padding levels)
    for lvl in range(total_levels):
        base = lvl * STEPS_PER_LEVEL_P2
        for r in range(base, base + STEPS_PER_LEVEL_P2):
            trace.set(cols.pc, r, lvl)

    # Poseidon domain tags on all map rows
    dom = pos.get_poseidon_suite(prog.program_id).dom
    for lvl in range(total_levels):
        row_map = lvl * STEPS_PER_LEVEL_P2 + schedule.pos_map()
        trace.set(cols.lane_c0, row_map, dom[0])
        trace.set(cols.lane_c1, row_map, dom[1])

    ram_events: List[Tuple[int, int, int, int]] = []
    mem: Dict[int, int] = {}

    _fill_vm(trace, prog, pi, mem, ram_events, pad_to_level=total_levels)
    _fill_ram(trace, prog.program_id, ram_events)
    _fill_rom(trace, prog, total_levels)
    return trace


# ---------------------------------------------------------------------------
# VM output / state hashes (utils.rs:277-344)
# ---------------------------------------------------------------------------

def vm_output_from_trace(trace: TraceTable,
                         cols: Optional[Columns] = None) -> Tuple[int, int]:
    cols = cols or Columns.baseline()
    steps = STEPS_PER_LEVEL_P2
    lvls = trace.length // steps
    for lvl in range(lvls - 1, -1, -1):
        row_fin = lvl * steps + schedule.pos_final()
        for i in range(NR):
            if trace.get(cols.sel_dst0_index(i), row_fin) == 1:
                return i, row_fin + 1
    return 0, schedule.pos_final() + 1


def vm_state_hash_row(trace: TraceTable, row: int,
                      cols: Optional[Columns] = None) -> bytes:
    cols = cols or Columns.baseline()
    n = trace.length
    if n == 0:
        return b"\x00" * 32
    row = min(row, n - 1)
    h = bytearray(b"zkl/vm/state-v1")
    for i in range(NR):
        h += trace.get(cols.r_index(i), row).to_bytes(16, "little")
    return blake3(bytes(h))


# ---------------------------------------------------------------------------
# Segment layouts / slicing (mod.rs SegmentLayout, slice helpers)
# ---------------------------------------------------------------------------

class SegmentLayout:
    """Segment-local column layout + mapping into the full baseline layout
    (mod.rs SegmentLayout::from_full_columns)."""

    def __init__(self, full_cols: Columns, cfg: LayoutConfig) -> None:
        self.cfg = cfg
        self.cols = Columns(cfg)
        seg_width = self.cols.width()
        seg_to_full = [-1] * seg_width
        c, f = self.cols, full_cols

        def m(seg_idx: int, full_idx: int) -> None:
            if seg_idx < seg_width:
                assert seg_to_full[seg_idx] == -1
                seg_to_full[seg_idx] = full_idx

        for i in range(12):
            m(c.lane_index(i), f.lane_index(i))
        m(c.g_map, f.g_map)
        m(c.g_final, f.g_final)
        for j in range(POSEIDON_ROUNDS):
            m(c.g_r_index(j), f.g_r_index(j))
        m(c.mask, f.mask)
        for i in range(NR):
            m(c.r_index(i), f.r_index(i))
        for cc, ff in zip(c.op_columns(), f.op_columns()):
            m(cc, ff)
        for i in range(NR):
            m(c.sel_dst0_index(i), f.sel_dst0_index(i))
            m(c.sel_a_index(i), f.sel_a_index(i))
            m(c.sel_b_index(i), f.sel_b_index(i))
            m(c.sel_c_index(i), f.sel_c_index(i))
            m(c.sel_dst1_index(i), f.sel_dst1_index(i))
        for lane in range(10):
            for bit in range(SPONGE_IDX_BITS):
                m(c.sel_s_b_index(lane, bit), f.sel_s_b_index(lane, bit))
            m(c.sel_s_active_index(lane), f.sel_s_active_index(lane))
        m(c.imm, f.imm)
        m(c.eq_inv, f.eq_inv)
        if cfg.ram:
            m(c.ram_sorted, f.ram_sorted)
            m(c.ram_s_addr, f.ram_s_addr)
            m(c.ram_s_clk, f.ram_s_clk)
            m(c.ram_s_val, f.ram_s_val)
            m(c.ram_s_is_write, f.ram_s_is_write)
            m(c.ram_s_last_write, f.ram_s_last_write)
            m(c.ram_gp_unsorted, f.ram_gp_unsorted)
            m(c.ram_gp_sorted, f.ram_gp_sorted)
        if cfg.merkle:
            m(c.merkle_g, f.merkle_g)
            m(c.merkle_dir, f.merkle_dir)
            m(c.merkle_sib, f.merkle_sib)
            m(c.merkle_acc, f.merkle_acc)
            m(c.merkle_first, f.merkle_first)
            m(c.merkle_last, f.merkle_last)
            m(c.merkle_leaf, f.merkle_leaf)
        m(c.pi_prog, f.pi_prog)
        m(c.pc, f.pc)
        if cfg.rom:
            for i in range(17):
                m(c.rom_op_index(i), f.rom_op_index(i))
        m(c.pose_active, f.pose_active)
        for i in range(32):
            m(c.gadget_b_index(i), f.gadget_b_index(i))
        if cfg.rom:
            for i in range(3):
                m(c.rom_s_index(i), f.rom_s_index(i))

        assert all(v != -1 for v in seg_to_full), "unmapped segment column"
        self.seg_to_full = seg_to_full


def slice_trace_segment_with_layout(full: TraceTable, segment: Segment,
                                    layout: SegmentLayout) -> TraceTable:
    return full.slice_rows(segment.r_start, segment.r_end,
                           layout.seg_to_full)


def build_segment_trace_with_state(full: TraceTable, segment: Segment,
                                   layout: SegmentLayout,
                                   prev_state: Optional[PrevState] = None
                                   ) -> Tuple[TraceTable, bytes, bytes]:
    """Slice a segment + boundary VM-state hashes (mod.rs:316-362)."""
    if segment.r_end > full.length:
        raise TraceError("segment out of bounds for provided full trace")
    if (segment.r_start % STEPS_PER_LEVEL_P2
            or segment.r_end % STEPS_PER_LEVEL_P2):
        raise TraceError("segment must be aligned to full levels")

    trace = slice_trace_segment_with_layout(full, segment, layout)
    return _with_state_hashes(trace, layout, prev_state)


def segment_from_window(window: TraceTable, layout: SegmentLayout,
                        prev_state: Optional[PrevState] = None
                        ) -> Tuple[TraceTable, bytes, bytes]:
    """build_segment_trace_with_state for a window-local full-layout
    table (streamed trace source): rows are already segment-local."""
    trace = window.slice_rows(0, window.length, layout.seg_to_full)
    return _with_state_hashes(trace, layout, prev_state)


def _with_state_hashes(trace: TraceTable, layout: SegmentLayout,
                       prev_state: Optional[PrevState]
                       ) -> Tuple[TraceTable, bytes, bytes]:
    state_in = vm_state_hash_row(trace, schedule.pos_map(), layout.cols)
    state_out = vm_state_hash_row(trace, trace.length - 1, layout.cols)
    if prev_state is not None and prev_state.state_out_hash != state_in:
        raise TraceError(
            "prev_state.state_out_hash must match segment state_in_hash")
    return trace, state_in, state_out
