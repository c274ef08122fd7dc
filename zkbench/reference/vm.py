"""The zk-lisp VM, interpreted plainly, for the benchmark's reference.

Eight registers of field elements, all zero at the start of a program
without arguments; RAM is a map from address to value (unwritten cells
read 0); a sponge op absorbs up to ten registers and its squeeze is lane
0 of one Poseidon2 permutation (zk-lisp-compiler/src/builder.rs for the
ops, vm/trace/poseidon.rs for the sponge).  Every op is one level of 32
trace rows; levels after the last op carry the final registers.

`run` takes the compiled program as plain (op name, fields) pairs, which
is what the prover was given, and returns the register file at every
segment edge, so that the reference can work out each segment's boundary
state hash: BLAKE3 of b"zkl/vm/state-v1" and the eight registers as 16
little-endian bytes each.
"""

from __future__ import annotations

from . import poseidon2
from .blake3 import blake3

P = poseidon2.P
NR = 8
ROWS_PER_LEVEL = 32


class VmError(Exception):
    pass


def state_hash(regs) -> bytes:
    return blake3(b"zkl/vm/state-v1"
                  + b"".join(int(r).to_bytes(16, "little") for r in regs))


def _step(op, f, regs, mem, pending, sid):
    """Registers after one op (a new list)."""
    nxt = list(regs)
    if op == "Const":
        nxt[f["dst"]] = f["imm"] % P
    elif op == "Mov":
        nxt[f["dst"]] = regs[f["src"]]
    elif op == "Add":
        nxt[f["dst"]] = (regs[f["a"]] + regs[f["b"]]) % P
    elif op == "Sub":
        nxt[f["dst"]] = (regs[f["a"]] - regs[f["b"]]) % P
    elif op == "Mul":
        nxt[f["dst"]] = regs[f["a"]] * regs[f["b"]] % P
    elif op == "Neg":
        nxt[f["dst"]] = -regs[f["a"]] % P
    elif op == "Eq":
        nxt[f["dst"]] = int(regs[f["a"]] == regs[f["b"]])
    elif op == "Select":
        c = regs[f["c"]]
        nxt[f["dst"]] = (c * regs[f["a"]] + (1 - c) * regs[f["b"]]) % P
    elif op == "AssertRangeLo":
        x = regs[f["r"]]
        if x >= 1 << 64:
            raise VmError(f"range check fails on {x}")
        nxt[f["dst"]] = x & 0xFFFFFFFF
    elif op == "AssertRangeHi":
        nxt[f["dst"]] = 1
    elif op == "Load":
        nxt[f["dst"]] = mem.get(regs[f["addr"]], 0)
    elif op == "Store":
        mem[regs[f["addr"]]] = regs[f["src"]]
    elif op == "SAbsorbN":
        pending.extend(f["regs"])
        if len(pending) > 10:
            raise VmError("sponge rate overflow")
    elif op == "SSqueeze":
        nxt[f["dst"]] = poseidon2.absorb(sid, [regs[r] for r in pending])
        pending.clear()
    elif op != "End":
        raise VmError(f"op {op} is not modelled by the reference")
    return nxt


def run(ops, sid: bytes, segment_rows: int):
    """(register file at each segment edge, levels in the trace).

    Edge k is the file before level k * L, L = segment_rows / 32; the
    trace has next_pow2(len(ops)) levels, and the last edge is the file
    after the last level."""
    levels = 1 << max(0, (len(ops) - 1).bit_length())
    per_seg = segment_rows // ROWS_PER_LEVEL
    if per_seg < 1 or levels % per_seg:
        raise VmError(f"{levels} levels do not split into segments of "
                      f"{per_seg}")
    regs, mem, pending = [0] * NR, {}, []
    edges = [list(regs)]
    for lvl in range(levels):
        if lvl < len(ops):
            name, fields = ops[lvl]
            regs = _step(name, fields, regs, mem, pending, sid)
        if (lvl + 1) % per_seg == 0:
            edges.append(list(regs))
    return edges, levels
