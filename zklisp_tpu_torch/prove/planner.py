"""Execution segment planner (src/segment_planner.rs).

Level-aligned segments bounded by max_segment_rows (default 4096 rows =
128 levels), respecting compiler block boundaries as partition hints, with
per-segment feature detection from the op ranges.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

from ..compiler import ops as O
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..trace.build import Segment
from ..trace.layout import STEPS_PER_LEVEL_P2
from .params import ProverOptions

MAX_SEGMENT_ROWS = 1 << 12


@dataclass(frozen=True)
class SegmentFeatures:
    vm: bool = False
    ram: bool = False
    sponge: bool = False
    merkle: bool = False

    @staticmethod
    def from_ops(ops) -> "SegmentFeatures":
        vm = ram = sponge = merkle = False
        for op in ops:
            if isinstance(op, (O.Const, O.Mov, O.Add, O.Sub, O.Mul, O.Neg,
                               O.Eq, O.Select, O.Assert, O.AssertBit,
                               O.AssertRange, O.AssertRangeLo,
                               O.AssertRangeHi, O.DivMod, O.MulWide,
                               O.DivMod128)):
                vm = True
            elif isinstance(op, (O.Load, O.Store)):
                vm = True
                ram = True
            elif isinstance(op, (O.SAbsorbN, O.SSqueeze)):
                vm = True
                sponge = True
            elif isinstance(op, (O.MerkleStepFirst, O.MerkleStep,
                                 O.MerkleStepLast)):
                merkle = True
        return SegmentFeatures(vm, ram, sponge, merkle)


def compute_segment_features_for_levels(program: Program, lvl_start: int,
                                        lvl_end: int) -> SegmentFeatures:
    base = len(program.ops)
    s, e = min(lvl_start, base), min(lvl_end, base)
    if s >= e:
        return SegmentFeatures()
    return SegmentFeatures.from_ops(program.ops[s:e])


def compute_segment_feature_mask(core_pi, seg: SegmentFeatures) -> int:
    base = core_pi.feature_mask
    mask = 0
    if base & pi_mod.FM_VM:
        mask |= pi_mod.FM_VM
    if base & pi_mod.FM_VM_EXPECT:
        mask |= pi_mod.FM_VM_EXPECT
    if (base & pi_mod.FM_RAM) and seg.ram:
        mask |= pi_mod.FM_RAM
    if (base & pi_mod.FM_MERKLE) and seg.merkle:
        mask |= pi_mod.FM_MERKLE
    if (base & pi_mod.FM_SPONGE) and seg.sponge:
        mask |= pi_mod.FM_SPONGE
    if (base & pi_mod.FM_POSEIDON) and (seg.sponge or seg.merkle):
        mask |= pi_mod.FM_POSEIDON
    return mask


def plan_segments(program: Program, pub_inputs, opts: ProverOptions
                  ) -> List[Segment]:
    base_levels = len(program.ops)
    total_levels = max(1, 1 << (base_levels - 1).bit_length()) \
        if base_levels else 1
    steps = STEPS_PER_LEVEL_P2
    n_rows_full = total_levels * steps

    max_rows = opts.max_segment_rows
    if max_rows is None:
        env = os.environ.get("ZKL_MAX_SEGMENT_ROWS")
        max_rows = int(env) if env else MAX_SEGMENT_ROWS

    if n_rows_full <= max_rows:
        return [Segment(0, n_rows_full)]

    max_levels_per_segment = max(max_rows // steps, 1)

    # level partition from block metadata
    ranges: List[Tuple[int, int]] = []
    if not program.blocks:
        if base_levels > 0:
            ranges.append((0, base_levels))
    else:
        block_ranges = []
        for b in program.blocks:
            if b.level_len == 0:
                continue
            end = b.level_start + b.level_len
            if end > base_levels:
                raise ValueError("block out of bounds for program levels")
            block_ranges.append((b.level_start, end))
        if not block_ranges:
            if base_levels > 0:
                ranges.append((0, base_levels))
        else:
            block_ranges.sort(key=lambda r: r[0])
            cursor = 0
            for bs, be in block_ranges:
                if cursor < bs:
                    ranges.append((cursor, bs))
                if ranges and bs <= ranges[-1][1]:
                    ranges[-1] = (ranges[-1][0], max(ranges[-1][1], be))
                else:
                    ranges.append((bs, be))
                cursor = ranges[-1][1]
            if cursor < base_levels:
                ranges.append((cursor, base_levels))

    if base_levels < total_levels:
        ranges.append((base_levels, total_levels))

    segments_levels: List[Tuple[int, int]] = []
    cur_start = None
    cur_end = 0
    for range_start, range_end in ranges:
        lvl = range_start
        while lvl < range_end:
            if cur_start is None:
                cur_start = lvl
                cur_end = lvl
            taken = cur_end - cur_start
            take = min(max_levels_per_segment - taken, range_end - lvl)
            cur_end += take
            lvl += take
            if cur_end - cur_start == max_levels_per_segment:
                segments_levels.append((cur_start, cur_end))
                cur_start = None
                cur_end = 0
    if cur_start is not None and cur_start < cur_end:
        segments_levels.append((cur_start, cur_end))

    segments = [Segment(s * steps, e * steps) for s, e in segments_levels]
    if segments and segments[-1].r_end != n_rows_full:
        raise ValueError("segments do not cover full trace length")
    return segments
