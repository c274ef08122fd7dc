"""Preflight: host-side row-by-row constraint checking.

Mirrors the reference preflight (src/preflight.rs): instantiate the real
AIR, evaluate every transition on the trace domain and report the first
non-zero constraint with a row/constraint-index diagnostic.  Also checks
boundary assertions directly against trace cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..field.felt import Felt
from ..trace.table import TraceTable
from .zk_air import ZkLispAir


@dataclass
class PreflightViolation:
    kind: str            # "transition" | "assertion"
    row: int
    index: int           # constraint index or assertion index
    value: int
    detail: str = ""


def constraint_identity(air: ZkLispAir, index: int) -> str:
    """Module-resolved identity for a transition constraint index
    (reference preflight.rs:73-528 reports the violating module, not a
    bare index).  Returns e.g. 'merkle[5] (merkle #448, deg 3)'."""
    cmap = debug_constraint_map(air)
    if not (0 <= index < len(cmap)):
        return f"#{index} (unknown)"
    module, deg, _cycles = cmap[index]
    # index within the module block
    local = 0
    for k in range(index):
        if cmap[k][0] == module:
            local += 1
    return f"{module}[{local}] (#{index}, deg {deg})"


def expected_poseidon_next(air: ZkLispAir, trace: TraceTable,
                           row: int) -> Optional[List[int]]:
    """The t=12 Poseidon round output the AIR expects at `row + 1`,
    recomputed host-side from the current lanes — the reference
    preflight's 'expected next state' detail (preflight.rs:73-528).
    Only meaningful on active round rows; returns None elsewhere."""
    pos = row % 32
    if not (1 <= pos <= 27):        # rounds occupy level rows 1..27
        return None
    c = air.cols
    if trace.get(c.pose_active, row) != 1:
        return None
    from ..field.f128 import P
    j = pos - 1
    s = [trace.get(c.lane_index(i), row) for i in range(12)]
    s3 = [(v * v % P) * v % P for v in s]
    rc = air.poseidon_rc[j]
    mds = air.poseidon_mds
    return [(sum(mds[i][k] * s3[k] for k in range(12)) + rc[i]) % P
            for i in range(12)]


def report_console(air: ZkLispAir, trace: TraceTable,
                   violations) -> str:
    """Rich console diagnostic (reference preflight.rs table report):
    for each violation, the level/position, the module-resolved
    constraint identity, and a snapshot of registers, lanes, RAM
    columns and the expected Poseidon next-state at the failing row."""
    lines = []
    c = air.cols
    for v in violations:
        lvl, pos = divmod(v.row, 32)
        ident = (constraint_identity(air, v.index)
                 if v.kind == "transition" else f"assertion col {v.index}")
        lines.append(f"VIOLATION {v.kind} row={v.row} (level {lvl} "
                     f"pos {pos}) constraint={ident} value={v.value}")
        row = trace.row(min(v.row, trace.length - 1))
        regs = " ".join(f"r{i}={row[c.r_index(i)]}" for i in range(8))
        lines.append(f"  regs: {regs}")
        lanes = " ".join(str(row[c.lane_index(i)]) for i in range(4))
        lines.append(f"  lanes[0..4): {lanes}")
        lines.append(f"  pc={row[c.pc]} pose_active={row[c.pose_active]} "
                     f"imm={row[c.imm]} eq_inv={row[c.eq_inv]}")
        exp = expected_poseidon_next(air, trace, v.row)
        if exp is not None:
            got = [trace.get(c.lane_index(i),
                             min(v.row + 1, trace.length - 1))
                   for i in range(12)]
            diffs = [i for i in range(12) if exp[i] != got[i]]
            lines.append(f"  poseidon expected-next lanes[0..2): "
                         f"{exp[0]} {exp[1]} (mismatched lanes: "
                         f"{diffs if diffs else 'none'})")
        if hasattr(c, "ram_sorted"):
            lines.append(
                f"  ram: sorted={row[c.ram_sorted]} "
                f"addr={row[c.ram_s_addr]} clk={row[c.ram_s_clk]} "
                f"val={row[c.ram_s_val]} w={row[c.ram_s_is_write]} "
                f"gp_u={row[c.ram_gp_unsorted]} gp_s={row[c.ram_gp_sorted]}")
    return "\n".join(lines)


def report_json(air: ZkLispAir, trace: TraceTable, violations) -> str:
    import json
    out = []
    for v in violations:
        lvl, pos = divmod(v.row, 32)
        row = trace.row(min(v.row, trace.length - 1))
        c = air.cols
        rec = {
            "kind": v.kind, "row": v.row, "level": lvl, "pos": pos,
            "index": v.index,
            "constraint": (constraint_identity(air, v.index)
                           if v.kind == "transition" else None),
            "value": str(v.value),
            "regs": [str(row[c.r_index(i)]) for i in range(8)],
            "pc": str(row[c.pc]),
        }
        exp = expected_poseidon_next(air, trace, v.row)
        if exp is not None:
            rec["poseidon_expected_next"] = [str(x) for x in exp]
        out.append(rec)
    return json.dumps({"violations": out})


def run_preflight(air: ZkLispAir, trace: TraceTable,
                  max_violations: int = 5) -> List[PreflightViolation]:
    """Evaluate all constraints on the trace domain; return violations."""
    n = trace.length
    violations: List[PreflightViolation] = []

    for col, step, val in air.get_assertions():
        got = trace.get(col, step)
        if got != val:
            violations.append(PreflightViolation(
                "assertion", step, col, got,
                f"expected {val} at col {col} step {step}"))
            if len(violations) >= max_violations:
                return violations

    for row in range(n - 1):
        cur = [Felt(v) for v in trace.row(row)]
        nxt = [Felt(v) for v in trace.row(row + 1)]
        periodic = air.periodic_values_at_row(row)
        res = air.evaluate_transition(cur, nxt, periodic)
        for i, v in enumerate(res):
            if v.v != 0:
                violations.append(PreflightViolation(
                    "transition", row, i, v.v,
                    f"constraint {constraint_identity(air, i)} "
                    f"nonzero at row {row}"))
                if len(violations) >= max_violations:
                    return violations
    return violations


def debug_constraint_map(air: ZkLispAir) -> list:
    """Constraint index -> (module, degree) map (vm/air/debug.rs analog).

    Reconstructs the module boundaries from the same feature/usage gating
    as evaluate_transition so a failing index can be attributed.
    """
    out = []
    f = air.features

    def block(module, count):
        start = len(out)
        for k in range(count):
            d = air.degrees[start + k]
            out.append((module, d.base, d.cycles))

    from ..trace.layout import (NR, POSEIDON_ROUNDS, SPONGE_IDX_BITS,
                                VM_USAGE_SPONGE)
    mask = air.vm_usage_mask
    sponge_used = bool(mask & (1 << VM_USAGE_SPONGE))
    if f.poseidon:
        block("poseidon.rounds", POSEIDON_ROUNDS * 12)
        block("poseidon.hold", 12)
        if f.vm and f.sponge and sponge_used:
            block("poseidon.vm_binding", 10)
    if f.vm:
        n_ctrl = (5 * NR) + 5 + NR
        if f.sponge and sponge_used:
            n_ctrl += 10 * (SPONGE_IDX_BITS + 1)
        n_ctrl += 1 + 17 + 1 + 17 + 2
        block("ctrl", n_ctrl)
        n_alu = 2 * NR
        from ..trace.layout import (VM_USAGE_ASSERT, VM_USAGE_ASSERT_BIT,
                                    VM_USAGE_ASSERT_RANGE, VM_USAGE_DIV128,
                                    VM_USAGE_DIVMOD, VM_USAGE_EQ,
                                    VM_USAGE_MULWIDE)
        if mask & (1 << VM_USAGE_EQ):
            n_alu += 2
        if mask & (1 << VM_USAGE_DIVMOD):
            n_alu += 2
        if mask & (1 << VM_USAGE_ASSERT):
            n_alu += 1
        if mask & (1 << VM_USAGE_ASSERT_BIT):
            n_alu += 1
        if mask & (1 << VM_USAGE_ASSERT_RANGE):
            n_alu += 33
        if mask & (1 << VM_USAGE_MULWIDE):
            n_alu += 1
        if mask & (1 << VM_USAGE_DIV128):
            n_alu += 2
        block("alu", n_alu)
    if f.ram:
        from ..trace.layout import VM_USAGE_RAM_DELTA_CLK
        n_ram = 7
        if mask & (1 << VM_USAGE_RAM_DELTA_CLK):
            n_ram += bin(air.ram_delta_clk_bits).count("1") + 1
        block("ram", n_ram)
    if f.merkle:
        block("merkle", 7)
    if air.rom_enabled and any(air.pub.core.program_commitment):
        block("rom", POSEIDON_ROUNDS * 3 + 3 + 2)
    while len(out) < len(air.degrees):
        out.append(("pad", 1, ()))
    return out
