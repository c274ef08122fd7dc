"""VM instruction set and canonical bytecode encoding.

Reimplements the reference ISA (zk-lisp-compiler/src/builder.rs:25-158) and
its canonical byte encoding with opcode tags 0x01-0x1C
(builder.rs:493-652).  The Blake3 hash of the canonical bytes is the
program commitment (builder.rs:654-662), so the encoding here must match
the reference byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..crypto.blake3 import blake3


@dataclass(frozen=True)
class Op:
    pass


@dataclass(frozen=True)
class Const(Op):
    dst: int
    imm: int          # u64


@dataclass(frozen=True)
class Mov(Op):
    dst: int
    src: int


@dataclass(frozen=True)
class Add(Op):
    dst: int
    a: int
    b: int


@dataclass(frozen=True)
class Sub(Op):
    dst: int
    a: int
    b: int


@dataclass(frozen=True)
class Mul(Op):
    dst: int
    a: int
    b: int


@dataclass(frozen=True)
class Neg(Op):
    dst: int
    a: int


@dataclass(frozen=True)
class Eq(Op):
    dst: int
    a: int
    b: int


@dataclass(frozen=True)
class Select(Op):
    dst: int
    c: int
    a: int
    b: int


@dataclass(frozen=True)
class Assert(Op):
    dst: int
    c: int


@dataclass(frozen=True)
class AssertBit(Op):
    dst: int
    r: int


@dataclass(frozen=True)
class AssertRange(Op):
    dst: int
    r: int
    bits: int


@dataclass(frozen=True)
class AssertRangeLo(Op):
    dst: int
    r: int


@dataclass(frozen=True)
class AssertRangeHi(Op):
    dst: int
    r: int


@dataclass(frozen=True)
class DivMod(Op):
    dst_q: int
    dst_r: int
    a: int
    b: int


@dataclass(frozen=True)
class DivMod128(Op):
    a_hi: int
    a_lo: int
    b: int
    dst_q: int
    dst_r: int


@dataclass(frozen=True)
class MulWide(Op):
    dst_hi: int
    dst_lo: int
    a: int
    b: int


@dataclass(frozen=True)
class Load(Op):
    dst: int
    addr: int


@dataclass(frozen=True)
class Store(Op):
    addr: int
    src: int


@dataclass(frozen=True)
class SAbsorbN(Op):
    regs: Tuple[int, ...]


@dataclass(frozen=True)
class SSqueeze(Op):
    dst: int


@dataclass(frozen=True)
class MerkleStepFirst(Op):
    leaf_reg: int
    dir_reg: int
    sib_reg: int


@dataclass(frozen=True)
class MerkleStep(Op):
    dir_reg: int
    sib_reg: int


@dataclass(frozen=True)
class MerkleStepLast(Op):
    dir_reg: int
    sib_reg: int


@dataclass(frozen=True)
class End(Op):
    pass


def encode_ops(ops: List[Op]) -> bytes:
    """Canonical bytecode (builder.rs `encode_ops`, tags 0x01-0x1C)."""
    out = bytearray()
    for op in ops:
        if isinstance(op, Const):
            out.append(0x01)
            out.append(op.dst)
            out += int(op.imm).to_bytes(8, "little")
        elif isinstance(op, Mov):
            out += bytes((0x02, op.dst, op.src))
        elif isinstance(op, Add):
            out += bytes((0x03, op.dst, op.a, op.b))
        elif isinstance(op, Sub):
            out += bytes((0x04, op.dst, op.a, op.b))
        elif isinstance(op, Mul):
            out += bytes((0x05, op.dst, op.a, op.b))
        elif isinstance(op, Neg):
            out += bytes((0x06, op.dst, op.a))
        elif isinstance(op, Eq):
            out += bytes((0x07, op.dst, op.a, op.b))
        elif isinstance(op, Select):
            out += bytes((0x08, op.dst, op.c, op.a, op.b))
        elif isinstance(op, End):
            out.append(0x0C)
        elif isinstance(op, Assert):
            out += bytes((0x0D, op.dst, op.c))
        elif isinstance(op, SSqueeze):
            out += bytes((0x0F, op.dst))
        elif isinstance(op, SAbsorbN):
            out += bytes((0x10, len(op.regs), *op.regs))
        elif isinstance(op, MerkleStepFirst):
            out += bytes((0x11, op.leaf_reg, op.dir_reg, op.sib_reg))
        elif isinstance(op, MerkleStep):
            out += bytes((0x12, op.dir_reg, op.sib_reg))
        elif isinstance(op, MerkleStepLast):
            out += bytes((0x13, op.dir_reg, op.sib_reg))
        elif isinstance(op, AssertBit):
            out += bytes((0x14, op.dst, op.r))
        elif isinstance(op, AssertRange):
            out += bytes((0x15, op.dst, op.r, op.bits))
        elif isinstance(op, AssertRangeLo):
            out += bytes((0x16, op.dst, op.r))
        elif isinstance(op, AssertRangeHi):
            out += bytes((0x17, op.dst, op.r))
        elif isinstance(op, DivMod):
            out += bytes((0x18, op.dst_q, op.dst_r, op.a, op.b))
        elif isinstance(op, MulWide):
            out += bytes((0x19, op.dst_hi, op.dst_lo, op.a, op.b))
        elif isinstance(op, DivMod128):
            out += bytes((0x1A, op.a_hi, op.a_lo, op.b, op.dst_q, op.dst_r))
        elif isinstance(op, Load):
            out += bytes((0x1B, op.dst, op.addr))
        elif isinstance(op, Store):
            out += bytes((0x1C, op.addr, op.src))
        else:
            raise TypeError(f"unknown op {op!r}")
    return bytes(out)


def program_commitment(bytecode: bytes) -> bytes:
    return blake3(bytecode)


def touched_regs(op: Op):
    """Registers referenced by an op (builder.rs `push` reg tracking)."""
    if isinstance(op, Const):
        return (op.dst,)
    if isinstance(op, Mov):
        return (op.dst, op.src)
    if isinstance(op, (Add, Sub, Mul, Eq)):
        return (op.dst, op.a, op.b)
    if isinstance(op, Neg):
        return (op.dst, op.a)
    if isinstance(op, Select):
        return (op.dst, op.c, op.a, op.b)
    if isinstance(op, Assert):
        return (op.dst, op.c)
    if isinstance(op, AssertBit):
        return (op.dst, op.r)
    if isinstance(op, (AssertRange, AssertRangeLo, AssertRangeHi)):
        return (op.dst, op.r)
    if isinstance(op, Load):
        return (op.dst, op.addr)
    if isinstance(op, Store):
        return (op.addr, op.src)
    if isinstance(op, SAbsorbN):
        return tuple(op.regs)
    if isinstance(op, DivMod):
        return (op.dst_q, op.dst_r, op.a, op.b)
    if isinstance(op, DivMod128):
        return (op.a_hi, op.a_lo, op.b, op.dst_q, op.dst_r)
    if isinstance(op, MulWide):
        return (op.dst_hi, op.dst_lo, op.a, op.b)
    if isinstance(op, SSqueeze):
        return (op.dst,)
    if isinstance(op, MerkleStepFirst):
        return (op.leaf_reg, op.dir_reg, op.sib_reg)
    if isinstance(op, (MerkleStep, MerkleStepLast)):
        return (op.dir_reg, op.sib_reg)
    return ()
