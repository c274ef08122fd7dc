"""AirPublicInputs construction from a concrete trace.

Ports build_air_pi_for_trace + compute_vm_usage_mask_for_trace
(src/prove.rs:292-423, 1289-1392) and segment boundary extraction
(src/prove.rs:1197-1287).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..core import pi as pi_mod
from ..field import f128
from ..trace import build as tb
from ..trace import schedule
from ..trace.layout import (Columns, STEPS_PER_LEVEL_P2, VM_USAGE_ASSERT,
                            VM_USAGE_ASSERT_BIT, VM_USAGE_ASSERT_RANGE,
                            VM_USAGE_DIV128, VM_USAGE_DIVMOD, VM_USAGE_EQ,
                            VM_USAGE_MULWIDE, VM_USAGE_RAM_DELTA_CLK,
                            VM_USAGE_SPONGE)
from ..trace.table import TraceTable
from .zk_air import AirPublicInputs


@dataclass
class SegmentBoundaries:
    pc_init: int = 0
    ram_gp_unsorted_in: int = 0
    ram_gp_unsorted_out: int = 0
    ram_gp_sorted_in: int = 0
    ram_gp_sorted_out: int = 0
    rom_s_in: Tuple[int, int, int] = (0, 0, 0)
    rom_s_out: Tuple[int, int, int] = (0, 0, 0)


def compute_vm_usage_mask(trace: TraceTable, cols: Columns
                          ) -> Tuple[int, int]:
    mask = 0
    ram_bits = 0
    n = trace.length
    for row in range(n):
        pos = row % STEPS_PER_LEVEL_P2
        at_final = pos == schedule.pos_final()
        if at_final:
            if trace.get(cols.op_assert, row) or trace.get(cols.op_select,
                                                           row):
                mask |= 1 << VM_USAGE_ASSERT
            if trace.get(cols.op_assert_bit, row):
                mask |= 1 << VM_USAGE_ASSERT_BIT
            if trace.get(cols.op_assert_range, row):
                mask |= 1 << VM_USAGE_ASSERT_RANGE
            if trace.get(cols.op_divmod, row):
                mask |= 1 << VM_USAGE_DIVMOD
            if trace.get(cols.op_mulwide, row):
                mask |= 1 << VM_USAGE_MULWIDE
            if trace.get(cols.op_div128, row):
                mask |= 1 << VM_USAGE_DIV128
            if trace.get(cols.op_eq, row):
                mask |= 1 << VM_USAGE_EQ
        if trace.get(cols.op_sponge, row):
            mask |= 1 << VM_USAGE_SPONGE
        if row + 1 < n and trace.get(cols.ram_sorted, row):
            if trace.get(cols.ram_sorted, row + 1):
                a = trace.get(cols.ram_s_addr, row)
                a_n = trace.get(cols.ram_s_addr, row + 1)
                if a == a_n:
                    mask |= 1 << VM_USAGE_RAM_DELTA_CLK
                    for i in range(32):
                        if trace.get(cols.gadget_b_index(i), row):
                            ram_bits |= 1 << i
    return mask, ram_bits


def boundaries_from_trace(trace: TraceTable,
                          cols: Columns) -> SegmentBoundaries:
    n = trace.length
    if n == 0:
        return SegmentBoundaries()
    last = n - 1
    steps = STEPS_PER_LEVEL_P2
    lvl_last = last // steps
    row_final_last = lvl_last * steps + schedule.pos_final()
    rom_in = tuple(trace.get(cols.rom_s_index(i), schedule.pos_map())
                   for i in range(3))
    rom_out = tuple(trace.get(cols.rom_s_index(i), row_final_last)
                    for i in range(3))
    return SegmentBoundaries(
        pc_init=trace.get(cols.pc, schedule.pos_map()),
        ram_gp_unsorted_in=trace.get(cols.ram_gp_unsorted, 0),
        ram_gp_unsorted_out=trace.get(cols.ram_gp_unsorted, last),
        ram_gp_sorted_in=trace.get(cols.ram_gp_sorted, 0),
        ram_gp_sorted_out=trace.get(cols.ram_gp_sorted, last),
        rom_s_in=rom_in,
        rom_s_out=rom_out,
    )


def segment_boundaries_from_full(full: TraceTable,
                                 segment: tb.Segment) -> SegmentBoundaries:
    """prove.rs compute_segment_boundary_bytes (field-level)."""
    cols = Columns.baseline()
    steps = STEPS_PER_LEVEL_P2
    r_start, r_end = segment.r_start, segment.r_end
    row_map_first = (r_start // steps) * steps + schedule.pos_map()
    lvl_last = (r_end - 1) // steps
    row_final_last = lvl_last * steps + schedule.pos_final()
    return SegmentBoundaries(
        pc_init=full.get(cols.pc, row_map_first),
        ram_gp_unsorted_in=full.get(cols.ram_gp_unsorted, r_start),
        ram_gp_unsorted_out=full.get(cols.ram_gp_unsorted, r_end - 1),
        ram_gp_sorted_in=full.get(cols.ram_gp_sorted, r_start),
        ram_gp_sorted_out=full.get(cols.ram_gp_sorted, r_end - 1),
        rom_s_in=tuple(full.get(cols.rom_s_index(i), row_map_first)
                       for i in range(3)),
        rom_s_out=tuple(full.get(cols.rom_s_index(i), row_final_last)
                        for i in range(3)),
    )


def build_air_pi_for_trace(pi: pi_mod.PublicInputs,
                           segment_feature_mask: int,
                           rom_acc: Tuple[int, int, int],
                           segment_cols: Optional[Columns],
                           segment_boundaries: Optional[SegmentBoundaries],
                           trace: TraceTable,
                           usage_override: Optional[Tuple[int, int]] = None
                           ) -> AirPublicInputs:
    import copy
    pi = copy.copy(pi)
    if pi.feature_mask & pi_mod.FM_VM:
        if pi.vm_out_row == 0 and pi.vm_out_reg == 0:
            cols = segment_cols or Columns.baseline()
            r, row = tb.vm_output_from_trace(trace, cols)
            pi.vm_out_reg = r
            pi.vm_out_row = row

    cols = segment_cols or Columns.baseline()
    assert trace.width == cols.width()
    if usage_override is not None:
        # uniform-segment mode: the FULL trace's usage (a superset of
        # any segment's) — extra gated constraints are trivially
        # satisfied where the op never appears, and every segment of a
        # program then shares one AIR structure (one set of compiled
        # device-prover executables instead of one per usage profile)
        vm_usage_mask, ram_delta_clk_bits = usage_override
    else:
        vm_usage_mask, ram_delta_clk_bits = compute_vm_usage_mask(trace,
                                                                  cols)

    if segment_cols is not None:
        effective_mask = segment_feature_mask
    elif segment_feature_mask != 0:
        effective_mask = segment_feature_mask
    else:
        effective_mask = pi.feature_mask

    b = segment_boundaries or boundaries_from_trace(trace, cols)

    return AirPublicInputs(
        core=pi,
        segment_feature_mask=effective_mask,
        rom_acc=tuple(rom_acc),
        pc_init=b.pc_init,
        ram_gp_unsorted_in=b.ram_gp_unsorted_in,
        ram_gp_unsorted_out=b.ram_gp_unsorted_out,
        ram_gp_sorted_in=b.ram_gp_sorted_in,
        ram_gp_sorted_out=b.ram_gp_sorted_out,
        rom_s_in=tuple(b.rom_s_in),
        rom_s_out=tuple(b.rom_s_out),
        vm_usage_mask=vm_usage_mask,
        ram_delta_clk_bits=ram_delta_clk_bits,
    )
