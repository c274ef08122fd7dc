"""Streamed two-pass trace source for memory-lean multi-segment proving.

The full-trace path (build.py build_full_trace) materializes
next_pow2(#ops) * 32 rows x 219 columns of Python ints — gigabytes at
2^20+ rows.  The reference has the same limitation (prove.rs:995-999
builds the full trace once; its README defers streaming to a private
v2).  This module proves arbitrarily long traces with ONE segment of
rows resident at a time:

  pass 1 (simulate): run the VM simulator once against a ring sink that
      keeps only the current level's 32 rows, capturing the
      cross-level state (registers, sponge buffer, merkle accumulator,
      RAM image, event count) at every segment boundary, plus the full
      RAM event list and the per-level ROM chain states.
  pass 2 (materialize): build each segment's rows on demand — VM fill
      restarted from the boundary snapshot, RAM sorted-table/grand
      products reconstructed from event prefixes, ROM chain restarted
      from the boundary lane — yielding tables byte-identical to
      slicing the full trace (asserted by tests/test_stream.py).

Boundary public inputs (pc, RAM grand products, ROM lanes) come from
the same prefix data, so the prover never touches a full trace.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..compiler import ops as O
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..crypto import poseidon as pos
from ..field import f128
from . import build as tb
from . import schedule
from .layout import Columns, NR, POSEIDON_ROUNDS, STEPS_PER_LEVEL_P2
from .table import TraceTable

P = f128.P
_PAD_POSITIONS = [p for p in range(STEPS_PER_LEVEL_P2)
                  if schedule.is_pad_pos(p)]
_NPL = len(_PAD_POSITIONS)            # pad rows per level (event slots)


class _RingSink:
    """TraceTable-shaped sink for the simulation pass: stores only the
    current level's rows (the VM fill writes strictly level-locally and
    reads only within the level), drops everything older."""

    __slots__ = ("width", "length", "_buf", "_base", "_written")

    def __init__(self, width: int, length: int) -> None:
        self.width = width
        self.length = length
        self._buf = [[0] * STEPS_PER_LEVEL_P2 for _ in range(width)]
        self._base = 0
        self._written: List[Tuple[int, int]] = []

    def _slot(self, row: int) -> int:
        base = (row // STEPS_PER_LEVEL_P2) * STEPS_PER_LEVEL_P2
        if base != self._base:
            assert base > self._base, "ring sink requires level order"
            self._base = base
            for c, s in self._written:
                self._buf[c][s] = 0
            self._written.clear()
        return row - base

    def set(self, col: int, row: int, v: int) -> None:
        s = self._slot(row)
        self._buf[col][s] = v
        self._written.append((col, s))

    def get(self, col: int, row: int) -> int:
        base = (row // STEPS_PER_LEVEL_P2) * STEPS_PER_LEVEL_P2
        if base != self._base:
            return 0
        return self._buf[col][row - base]


class _OffsetView:
    """Maps the builders' absolute full-trace rows into a window-local
    table; out-of-window writes are dropped."""

    __slots__ = ("t", "off")

    def __init__(self, table: TraceTable, off: int) -> None:
        self.t = table
        self.off = off

    @property
    def width(self) -> int:
        return self.t.width

    @property
    def length(self) -> int:
        return self.off + self.t.length

    def set(self, col: int, row: int, v: int) -> None:
        r = row - self.off
        if 0 <= r < self.t.length:
            self.t.set(col, r, v)

    def get(self, col: int, row: int) -> int:
        return self.t.get(col, row - self.off)


def _virtual_encs(prog: Program, total_levels: int) -> List[int]:
    """Per-level ROM linear encodings from ops (romacc.rs semantics —
    equal to encoding the real map rows)."""
    cols = Columns.baseline()
    w0 = pos.rom_weights_for_seed(pos.ROM_W_SEED_0)
    w1 = pos.rom_weights_for_seed(pos.ROM_W_SEED_1)
    row = [0] * cols.width()
    encs: List[int] = []
    for lvl in range(total_levels):
        for i in range(len(row)):
            row[i] = 0
        if lvl < len(prog.ops):
            tb.encode_map_row_for_op(row, cols, prog.ops[lvl])
        encs.append(tb.rom_linear_encode_row(row, cols, w0))
        encs.append(tb.rom_linear_encode_row(row, cols, w1))
    return encs


def _rom_window_states(prog: Program, encs: Sequence[int], lvl0: int,
                       lvl1: int, s0_init: int) -> List[int]:
    """Flat per-level (rounds+1)*3 chain states for levels [lvl0, lvl1)."""
    window = list(encs[2 * lvl0:2 * lvl1])
    mds3, rc3 = pos.get_rom_suite(prog.program_id)
    from .. import native
    if native.available():
        return native.rom_chain_from(window, tb._flat(mds3),
                                     tb._flat(rc3), lvl1 - lvl0,
                                     POSEIDON_ROUNDS, s0_init)
    flat: List[int] = []
    s0_prev = s0_init
    for k in range(lvl1 - lvl0):
        s = [s0_prev, window[2 * k], window[2 * k + 1]]
        for rc_row in rc3[:POSEIDON_ROUNDS]:
            flat.extend(s)
            s3 = [(v * v % P) * v % P for v in s]
            s = [(mds3[i][0] * s3[0] + mds3[i][1] * s3[1]
                  + mds3[i][2] * s3[2] + rc_row[i]) % P for i in range(3)]
        flat.extend(s)
        s0_prev = s[0]
    return flat


class StreamedTrace:
    """Two-pass streamed trace source (see module docstring)."""

    def __init__(self, prog: Program, pi: pi_mod.PublicInputs,
                 segments: Sequence[tb.Segment]) -> None:
        self.prog = prog
        self.pi = pi
        levels = len(prog.ops)
        self.total_levels = (max(1, 1 << (levels - 1).bit_length())
                             if levels else 1)
        self.n_rows = self.total_levels * STEPS_PER_LEVEL_P2
        cols = Columns.baseline()
        self.cols = cols

        boundary_lvls = {seg.r_start // STEPS_PER_LEVEL_P2
                         for seg in segments}
        boundary_lvls |= {seg.r_end // STEPS_PER_LEVEL_P2
                          for seg in segments}
        # captures beyond the last op level reuse the final state
        capture_at = {min(lv, levels) for lv in boundary_lvls}

        # ---- pass 1: simulate ------------------------------------------
        mem: Dict[int, int] = {}
        events: List[Tuple[int, int, int, int]] = []
        self.captures: Dict[int, tb.VmSimState] = {}
        sink = _RingSink(cols.width(), self.n_rows)
        tb._fill_vm(sink, prog, pi, mem, events,
                    capture_at=capture_at, captures=self.captures)
        self.events = events                    # original (level) order
        self.sorted_events = sorted(events, key=lambda e: (e[0], e[1]))
        # global row of the k-th sorted event (the k-th pad row)
        self.event_rows = [
            (k // _NPL) * STEPS_PER_LEVEL_P2 + _PAD_POSITIONS[k % _NPL]
            for k in range(len(self.sorted_events))]
        if self.event_rows and self.event_rows[-1] >= self.n_rows:
            raise tb.TraceError("RAM events exceed pad-row capacity")
        self.events_by_level = {e[1]: e for e in events}
        self.r1, self.r2, self.r3 = tb.ram_compressor_coeffs(
            prog.program_id)

        # ---- pass 1: ROM chain boundary lanes ---------------------------
        self.encs = _virtual_encs(prog, self.total_levels)
        flat = _rom_window_states(prog, self.encs, 0, self.total_levels, 0)
        per = 3 * (POSEIDON_ROUNDS + 1)
        # s at the map row of level l and at its final row
        self.rom_map = [tuple(flat[per * l:per * l + 3])
                        for l in range(self.total_levels)]
        self.rom_fin = [tuple(flat[per * l + 3 * POSEIDON_ROUNDS:
                                   per * l + 3 * (POSEIDON_ROUNDS + 1)])
                        for l in range(self.total_levels)]

    # ---- pass 2 ---------------------------------------------------------

    def _vm_state_at(self, lvl: int) -> tb.VmSimState:
        return self.captures[min(lvl, len(self.prog.ops))]

    def segment_table(self, seg: tb.Segment) -> TraceTable:
        cols = self.cols
        r0, r1_ = seg.r_start, seg.r_end
        if r0 % STEPS_PER_LEVEL_P2 or r1_ % STEPS_PER_LEVEL_P2 \
                or r1_ > self.n_rows:
            raise tb.TraceError("segment must be level-aligned in range")
        lvl0 = r0 // STEPS_PER_LEVEL_P2
        lvl1 = r1_ // STEPS_PER_LEVEL_P2
        t = TraceTable(cols.width(), r1_ - r0)

        # prefills (build_empty_trace + build_full_trace pc/domain tags)
        dom = pos.get_poseidon_suite(self.prog.program_id).dom
        g_map, g_final = t.cols[cols.g_map], t.cols[cols.g_final]
        pc_col = t.cols[cols.pc]
        for row in range(r1_ - r0):
            pos_ = row % STEPS_PER_LEVEL_P2
            if pos_ == schedule.pos_map():
                g_map[row] = 1
                t.set(cols.lane_c0, row, dom[0])
                t.set(cols.lane_c1, row, dom[1])
            if pos_ == schedule.pos_final():
                g_final[row] = 1
            if schedule.is_round_pos(pos_):
                t.cols[cols.g_r_index(pos_ - 1)][row] = 1
            pc_col[row] = lvl0 + row // STEPS_PER_LEVEL_P2

        # VM fill from the boundary snapshot
        view = _OffsetView(t, r0)
        st = self._vm_state_at(lvl0)
        n_ops = len(self.prog.ops)
        if lvl0 < n_ops:
            scratch_events: List[Tuple[int, int, int, int]] = []
            tb._fill_vm(view, self.prog, self.pi, dict(st.mem),
                        scratch_events, lvl_start=lvl0,
                        lvl_end=min(lvl1, n_ops), state=st,
                        pad_to_level=(lvl1 if lvl1 > n_ops else None))
        elif lvl1 > lvl0:
            # window entirely inside the pad tail: carry the final
            # register file (matches build_full_trace's pad fill)
            tb.fill_pad_level_regs(view, list(st.regs), lvl0, lvl1)
        self._fill_ram_window(t, r0, r1_)
        self._fill_rom_window(t, lvl0, lvl1)
        return t

    # RAM window fill: exact replica of build._fill_ram restricted to
    # rows [r0, r1), with prefix state computed from the event lists.
    def _fill_ram_window(self, t: TraceTable, r0: int, r1_: int) -> None:
        cols = self.cols
        E, R = self.sorted_events, self.event_rows
        ne = len(E)
        r1c, r2c, r3c = self.r1, self.r2, self.r3

        def row_after_vals(k: int) -> Tuple[int, int, int, int]:
            """(addr, clk, val, w) column values at row R[k]+1."""
            if k + 1 < ne and (R[k + 1] == R[k] + 1
                               or E[k + 1][0] == E[k][0]):
                return E[k + 1] if R[k + 1] == R[k] + 1 else E[k]
            return (0, 0, 0, 0)

        # sorted-table embedding + mirrors for window rows
        for k in range(ne):
            if R[k] >= r1_:
                break
            if R[k] >= r0:
                row = R[k] - r0
                t.set(cols.ram_sorted, row, 1)
                t.set(cols.ram_s_addr, row, E[k][0])
                t.set(cols.ram_s_clk, row, E[k][1])
                t.set(cols.ram_s_val, row, E[k][2])
                t.set(cols.ram_s_is_write, row, E[k][3])
            if k + 1 < ne and E[k][0] == E[k + 1][0]:
                for row in range(max(R[k] + 1, r0),
                                 min(R[k + 1], r1_)):
                    t.set(cols.ram_s_addr, row - r0, E[k][0])
                    t.set(cols.ram_s_clk, row - r0, E[k][1])
                    t.set(cols.ram_s_val, row - r0, E[k][2])
                    t.set(cols.ram_s_is_write, row - r0, E[k][3])

        # gp_sorted / last_write: prefix over events with R[k]+1 <= r0,
        # then roll across the window.  The update at row R[k]+1 uses
        # the NEXT row's addr column (event / mirror / 0).
        gp = 0
        lw = 0
        k0 = 0
        while k0 < ne and R[k0] + 1 <= r0:
            if R[k0] + 1 < self.n_rows:
                a, c, v, w = E[k0]
                gp = (gp + a + r1c * c + r2c * v + r3c * w) % P
                a_n = row_after_vals(k0)[0]
                lw = ((1 - w) * lw + w * v) % P if a_n == a \
                    else (w * v) % P
            k0 += 1
        k = k0
        for row in range(r0, r1_):
            while k < ne and R[k] + 1 < row:
                k += 1
            if k < ne and row == R[k] + 1:
                a, c, v, w = E[k]
                gp = (gp + a + r1c * c + r2c * v + r3c * w) % P
                a_n = row_after_vals(k)[0]
                lw = ((1 - w) * lw + w * v) % P if a_n == a \
                    else (w * v) % P
                k += 1
            t.set(cols.ram_gp_sorted, row - r0, gp)
            t.set(cols.ram_s_last_write, row - r0, lw)

        # eq_inv + delta_clk bits at sorted rows
        for k in range(ne):
            if R[k] >= r1_:
                break
            if R[k] < r0 or R[k] + 1 >= self.n_rows:
                continue
            a = E[k][0]
            nxt = row_after_vals(k)
            a_n = nxt[0]
            d_addr = (a_n - a) % P
            t.set(cols.eq_inv, R[k] - r0,
                  f128.inv(d_addr) if d_addr else 0)
            if k + 1 < ne and R[k + 1] == R[k] + 1 and a_n == a:
                delta = max(E[k + 1][1] - E[k][1], 0)
                for i in range(32):
                    t.set(cols.gadget_b_index(i), R[k] - r0, delta & 1)
                    delta >>= 1

        # unsorted grand product: contribution of a load/store level l
        # lands at rows > l*32 + pos_final
        fin = schedule.pos_final()
        gp_u = 0
        for addr, lvl, val, w in self.events:
            if lvl * STEPS_PER_LEVEL_P2 + fin < r0:
                gp_u = (gp_u + addr + r1c * lvl + r2c * val
                        + r3c * w) % P
        for row in range(r0, r1_):
            if row > 0:
                prev = row - 1
                if prev % STEPS_PER_LEVEL_P2 == fin:
                    ev = self.events_by_level.get(
                        prev // STEPS_PER_LEVEL_P2)
                    if ev is not None:
                        addr, lvl, val, w = ev
                        gp_u = (gp_u + addr + r1c * lvl + r2c * val
                                + r3c * w) % P
            t.set(cols.ram_gp_unsorted, row - r0, gp_u)

    def _fill_rom_window(self, t: TraceTable, lvl0: int,
                         lvl1: int) -> None:
        cols = self.cols
        steps = STEPS_PER_LEVEL_P2
        s0_init = self.rom_map[lvl0][0]
        flat = _rom_window_states(self.prog, self.encs, lvl0, lvl1,
                                  s0_init)
        per = 3 * (POSEIDON_ROUNDS + 1)
        for li in range(lvl1 - lvl0):
            base = li * steps
            off = per * li
            for i in range(3):
                t.set(cols.rom_s_index(i), base, flat[off + i])
            for j in range(POSEIDON_ROUNDS):
                r = base + 1 + j
                for i in range(3):
                    t.set(cols.rom_s_index(i), r, flat[off + 3 * j + i])
            fin = off + 3 * POSEIDON_ROUNDS
            for r in range(base + schedule.pos_final(), base + steps):
                for i in range(3):
                    t.set(cols.rom_s_index(i), r, flat[fin + i])

    # ---- boundary public inputs (airpi.segment_boundaries_from_full) ----

    def _gp_sorted_at(self, row: int) -> int:
        gp = 0
        for k, (a, c, v, w) in enumerate(self.sorted_events):
            if self.event_rows[k] + 1 > row \
                    or self.event_rows[k] + 1 >= self.n_rows:
                break
            gp = (gp + a + self.r1 * c + self.r2 * v + self.r3 * w) % P
        return gp

    def _gp_unsorted_at(self, row: int) -> int:
        fin = schedule.pos_final()
        gp = 0
        for addr, lvl, val, w in self.events:
            if lvl * STEPS_PER_LEVEL_P2 + fin < row:
                gp = (gp + addr + self.r1 * lvl + self.r2 * val
                      + self.r3 * w) % P
        return gp

    def boundaries(self, seg: tb.Segment):
        from ..air.airpi import SegmentBoundaries
        steps = STEPS_PER_LEVEL_P2
        lvl_first = seg.r_start // steps
        lvl_last = (seg.r_end - 1) // steps
        return SegmentBoundaries(
            pc_init=lvl_first,
            ram_gp_unsorted_in=self._gp_unsorted_at(seg.r_start),
            ram_gp_unsorted_out=self._gp_unsorted_at(seg.r_end - 1),
            ram_gp_sorted_in=self._gp_sorted_at(seg.r_start),
            ram_gp_sorted_out=self._gp_sorted_at(seg.r_end - 1),
            rom_s_in=self.rom_map[lvl_first],
            rom_s_out=self.rom_fin[lvl_last],
        )
