"""Public inputs and feature flags (reference: zk-lisp-proof/src/pi.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from ..compiler import ops as O
from ..compiler.builder import CompilerMetrics, Program
from ..crypto.blake3 import blake3

FM_POSEIDON = 1 << 0
FM_VM = 1 << 1
FM_VM_EXPECT = 1 << 4
FM_SPONGE = 1 << 5
FM_MERKLE = 1 << 6
FM_RAM = 1 << 7


@dataclass(frozen=True)
class VmArg:
    """Typed VM argument: kind in {"u64", "u128", "bytes32"}."""
    kind: str
    value: Union[int, bytes]

    @staticmethod
    def u64(v: int) -> "VmArg":
        assert 0 <= v < (1 << 64)
        return VmArg("u64", v)

    @staticmethod
    def u128(v: int) -> "VmArg":
        assert 0 <= v < (1 << 128)
        return VmArg("u128", v)

    @staticmethod
    def bytes32(b: bytes) -> "VmArg":
        assert len(b) == 32
        return VmArg("bytes32", bytes(b))


class PiError(Exception):
    pass


@dataclass
class PublicInputs:
    program_id: bytes = b"\x00" * 32
    program_commitment: bytes = b"\x00" * 32
    merkle_root: bytes = b"\x00" * 32
    public_args: List[VmArg] = field(default_factory=list)
    main_args: List[VmArg] = field(default_factory=list)
    secret_args: List[VmArg] = field(default_factory=list)
    vm_out_reg: int = 0
    vm_out_row: int = 0
    vm_expected_bytes: bytes = b"\x00" * 32
    feature_mask: int = 0
    compiler_stats: CompilerMetrics = field(default_factory=CompilerMetrics)

    def validate_flags(self) -> None:
        if self.program_id == b"\x00" * 32:
            raise PiError("program_id must be non-zero")
        if self.program_commitment == b"\x00" * 32:
            raise PiError("program_commitment must be non-zero")
        if (self.feature_mask & FM_VM_EXPECT) and not (self.feature_mask & FM_VM):
            raise PiError("FM_VM_EXPECT requires FM_VM")

    def digest(self) -> bytes:
        """Blake3 digest with domain `zkl/pi/v1` (pi.rs:113-147)."""
        h = bytearray()
        h += b"zkl/pi/v1"
        h += self.program_id
        h += self.program_commitment
        h += self.merkle_root
        h += self.feature_mask.to_bytes(8, "little")
        h += len(self.main_args).to_bytes(4, "little")
        for arg in self.main_args:
            if arg.kind == "u64":
                h += b"\x00" + int(arg.value).to_bytes(8, "little")
            elif arg.kind == "u128":
                h += b"\x01" + int(arg.value).to_bytes(16, "little")
            else:
                h += b"\x02" + arg.value
        return blake3(bytes(h))


class PublicInputsBuilder:
    def __init__(self, program: Program) -> None:
        self.pi = PublicInputs(
            program_id=program.program_id,
            program_commitment=program.program_id,
            compiler_stats=program.compiler_metrics,
        )
        self._infer_features(program)

    def _infer_features(self, program: Program) -> None:
        vm = False
        pose = False
        mask = self.pi.feature_mask
        for op in program.ops:
            if isinstance(op, (O.Const, O.Mov, O.Add, O.Sub, O.Mul, O.Neg,
                               O.Eq, O.Select, O.Assert, O.AssertBit,
                               O.AssertRange, O.AssertRangeLo,
                               O.AssertRangeHi, O.DivMod, O.MulWide,
                               O.DivMod128)):
                vm = True
            elif isinstance(op, (O.Load, O.Store)):
                vm = True
                mask |= FM_RAM
            elif isinstance(op, (O.SAbsorbN, O.SSqueeze)):
                vm = True
                pose = True
                mask |= FM_SPONGE
            elif isinstance(op, (O.MerkleStepFirst, O.MerkleStep,
                                 O.MerkleStepLast)):
                pose = True
                mask |= FM_MERKLE
        if vm:
            mask |= FM_VM
        if pose:
            mask |= FM_POSEIDON
        self.pi.feature_mask = mask

    def with_public_args(self, args: List[VmArg]) -> "PublicInputsBuilder":
        self.pi.public_args = list(args)
        return self

    def with_main_args(self, args: List[VmArg]) -> "PublicInputsBuilder":
        self.pi.main_args = list(args)
        return self

    def with_secret_args(self, args: List[VmArg]) -> "PublicInputsBuilder":
        self.pi.secret_args = list(args)
        self.pi.feature_mask |= FM_VM
        return self

    def with_merkle_root(self, root: Union[int, bytes]) -> "PublicInputsBuilder":
        """Bind the expected Merkle root (pi.rs:71; tests/merkle.rs:135
        be_to_bytes32 layout: field element LE in bytes 0..16, rest 0).

        Accepts a field element int (the common case — e.g. the result
        of crypto.poseidon.merkle_root_from_path) or raw 32 bytes."""
        if isinstance(root, int):
            root = int(root).to_bytes(16, "little") + b"\x00" * 16
        assert len(root) == 32
        self.pi.merkle_root = bytes(root)
        return self

    def with_expect(self, expected: bytes) -> "PublicInputsBuilder":
        assert len(expected) == 32
        self.pi.vm_expected_bytes = bytes(expected)
        self.pi.feature_mask |= FM_VM | FM_VM_EXPECT
        return self

    def build(self) -> PublicInputs:
        self.pi.validate_flags()
        return self.pi


def encode_vmarg_to_elements(arg: VmArg, out: List[int]) -> None:
    """utils.rs encode_vmarg_to_elements."""
    from ..field import f128
    if arg.kind == "u64":
        out.append(int(arg.value))
    elif arg.kind == "u128":
        out.append(f128.from_u128(int(arg.value)))
    else:
        b = arg.value
        out.append(f128.from_le_bytes16(b[0:16]))
        out.append(f128.from_le_bytes16(b[16:32]))


def encode_main_args_to_slots(args: List[VmArg]) -> List[int]:
    out: List[int] = []
    for a in args:
        encode_vmarg_to_elements(a, out)
    return out
