"""Backend-agnostic frontend helpers (zk-lisp-proof/src/frontend.rs).

run_vm: execute a program by building its proving trace and reading the
output cell (the reference's "running" is trace building, lib.rs:172-188).
preflight: evaluate the full AIR row-by-row per segment before proving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .air.airpi import build_air_pi_for_trace, segment_boundaries_from_full
from .air.preflight import PreflightViolation, run_preflight
from .air.zk_air import ZkLispAir
from .compiler.builder import Program
from .core import pi as pi_mod
from .prove import planner
from .prove.params import ProverOptions
from .trace import build as tb
from .trace.layout import Columns, LayoutConfig, STEPS_PER_LEVEL_P2

PREFLIGHT_OFF = "off"
PREFLIGHT_CONSOLE = "console"
PREFLIGHT_JSON = "json"


@dataclass
class VmRunResult:
    out_reg: int
    out_row: int
    value: int
    trace_len: int


def run_vm(program: Program, pub_inputs: pi_mod.PublicInputs) -> VmRunResult:
    trace = tb.build_trace(program, pub_inputs)
    out_reg, out_row = tb.vm_output_from_trace(trace)
    cols = Columns.baseline()
    value = trace.get(cols.r_index(out_reg), out_row)
    return VmRunResult(out_reg, out_row, value, trace.length)


class PreflightError(Exception):
    def __init__(self, violations: List[PreflightViolation]) -> None:
        super().__init__(
            "; ".join(v.detail or f"{v.kind}@{v.row}" for v in violations))
        self.violations = violations


def preflight(program: Program, pub_inputs: pi_mod.PublicInputs,
              opts: Optional[ProverOptions] = None,
              mode: str = PREFLIGHT_CONSOLE) -> None:
    """Per-segment preflight mirroring the prover's exact AIR wiring
    (src/lib.rs:191-292).  Raises PreflightError on the first violations;
    the exception message carries the console or JSON diagnostic report
    depending on `mode`.
    """
    opts = opts or ProverOptions()
    rom_acc = (tb.rom_acc_from_program(program)
               if any(pub_inputs.program_commitment) else (0, 0, 0))
    segments = planner.plan_segments(program, pub_inputs, opts)
    full = tb.build_trace(program, pub_inputs)
    full_cols = Columns.baseline()

    for seg in segments:
        lvl_start = seg.r_start // STEPS_PER_LEVEL_P2
        lvl_end = seg.r_end // STEPS_PER_LEVEL_P2
        seg_features = planner.compute_segment_features_for_levels(
            program, lvl_start, lvl_end)
        base_mask = pub_inputs.feature_mask
        seg_mask = planner.compute_segment_feature_mask(pub_inputs,
                                                        seg_features)
        use_seg = seg_mask != 0 and seg_mask != base_mask
        eff_mask = seg_mask if use_seg else base_mask
        rom_enabled = any(pub_inputs.program_id)
        cfg = LayoutConfig(
            vm=bool(eff_mask & pi_mod.FM_VM),
            ram=bool(eff_mask & pi_mod.FM_RAM),
            sponge=bool(eff_mask & pi_mod.FM_SPONGE),
            merkle=bool(eff_mask & pi_mod.FM_MERKLE),
            rom=rom_enabled)
        layout = tb.SegmentLayout(full_cols, cfg)
        seg_trace, _, _ = tb.build_segment_trace_with_state(
            full, seg, layout, None)
        boundaries = segment_boundaries_from_full(full, seg)
        air_pi = build_air_pi_for_trace(pub_inputs, eff_mask, rom_acc,
                                        layout.cols, boundaries, seg_trace)
        air = ZkLispAir(seg_trace.width, seg_trace.length, air_pi)
        violations = run_preflight(air, seg_trace)
        if violations:
            from .air import preflight as pf
            if mode == PREFLIGHT_JSON:
                report = pf.report_json(air, seg_trace, violations)
            else:
                report = pf.report_console(air, seg_trace, violations)
            err = PreflightError(violations)
            err.report = report
            raise err
