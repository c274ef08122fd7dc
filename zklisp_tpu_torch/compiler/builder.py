"""Program builder, metrics, type schemas and program container.

Mirrors the reference's ProgramBuilder (zk-lisp-compiler/src/builder.rs),
CompilerMetrics (metrics.rs) and TypeSchemas (schema.rs).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from . import ops as O
from .errors import CompileError


@dataclass
class CompilerMetrics:
    cur_live: int = 0
    peak_live: int = 0
    reuse_dst: int = 0
    su_reorders: int = 0
    balanced_chains: int = 0
    mov_elided: int = 0

    def to_dict(self) -> dict:
        return {
            "peak_live": self.peak_live,
            "reuse_dst": self.reuse_dst,
            "su_reorders": self.su_reorders,
            "balanced_chains": self.balanced_chains,
            "mov_elided": self.mov_elided,
        }


@dataclass(frozen=True)
class BlockMeta:
    level_start: int
    level_len: int


# --- type schemas (schema.rs) ----------------------------------------------

U64, U128, BYTES32 = "u64", "u128", "bytes32"
ROLE_CONST, ROLE_LET = "const", "let"


@dataclass(frozen=True)
class FnTypeSchema:
    name: str
    args: Tuple[Tuple[str, str], ...]   # (role, type)
    ret: str


@dataclass(frozen=True)
class LetTypeSchema:
    owner: Optional[str]
    name: str
    ty: str


@dataclass
class TypeSchemas:
    fns: Dict[str, FnTypeSchema] = dc_field(default_factory=dict)
    # owner ("" == global) -> name -> schema
    lets: Dict[str, Dict[str, LetTypeSchema]] = dc_field(default_factory=dict)

    def get_let_schema(self, owner: Optional[str], name: str):
        return self.lets.get(owner or "", {}).get(name)


@dataclass
class Program:
    program_id: bytes
    commitment: bytes
    ops: List[O.Op]
    reg_count: int
    compiler_metrics: CompilerMetrics
    type_schemas: TypeSchemas
    blocks: List[BlockMeta]
    out_reg: int = 0
    out_row: int = 0

    @property
    def bytecode(self) -> bytes:
        return O.encode_ops(self.ops)


class ProgramBuilder:
    """Accumulates ops, tracks register usage and block metadata."""

    def __init__(self) -> None:
        self.ops: List[O.Op] = []
        self.reg_max = 0
        self.type_schemas = TypeSchemas()
        self.fn_decls: Dict[str, int] = {}
        self.let_names: set[str] = set()
        self.blocks: List[BlockMeta] = []

    def push(self, op: O.Op) -> None:
        if isinstance(op, O.Mov) and op.dst == op.src:
            return  # redundant move elided (builder.rs:191-196)
        for r in O.touched_regs(op):
            self.reg_max = max(self.reg_max, min(r + 1, 255))
        self.ops.append(op)

    def current_level(self) -> int:
        return len(self.ops)

    def push_block(self, level_start: int, level_end: int) -> None:
        if level_start >= level_end:
            raise CompileError("block: level_start must be < level_end")
        if level_end > self.current_level():
            raise CompileError(
                "block: level_end must not exceed current program length")
        self.blocks.append(BlockMeta(level_start, level_end - level_start))

    def add_fn_decl(self, name: str, arity: int) -> None:
        self.fn_decls[name] = arity

    def add_let_name(self, name: str) -> None:
        self.let_names.add(name)

    def add_fn_schema(self, schema: FnTypeSchema) -> None:
        self.type_schemas.fns[schema.name] = schema

    def add_let_schema(self, schema: LetTypeSchema) -> None:
        owner_key = schema.owner or ""
        scope = self.type_schemas.lets.get(owner_key)
        if scope is not None and schema.name in scope:
            if scope[schema.name].ty != schema.ty:
                raise CompileError(
                    f"typed-let: conflicting type for '{schema.name}'")
            return
        if schema.owner is not None:
            g = self.type_schemas.lets.get("", {})
            if schema.name in g and g[schema.name].ty != schema.ty:
                raise CompileError(
                    f"typed-let: conflicting type for '{schema.name}'")
        else:
            for owner, scope2 in self.type_schemas.lets.items():
                if not owner:
                    continue
                if schema.name in scope2 and scope2[schema.name].ty != schema.ty:
                    raise CompileError(
                        f"typed-let: conflicting type for '{schema.name}'")
        self.type_schemas.lets.setdefault(owner_key, {})[schema.name] = schema

    def finalize(self, metrics: CompilerMetrics) -> Program:
        for name, schema in self.type_schemas.fns.items():
            arity = self.fn_decls.get(name)
            if arity is None:
                raise CompileError(
                    f"typed-fn: no function definition found for '{name}'")
            if arity != len(schema.args):
                raise CompileError(
                    f"typed-fn: function '{name}' is defined with {arity} args "
                    f"but schema declares {len(schema.args)}")
        for scope in self.type_schemas.lets.values():
            for name in scope:
                if name not in self.let_names:
                    raise CompileError(
                        f"typed-let: no let binding found for '{name}'")
        if not self.blocks and self.ops:
            self.blocks.append(BlockMeta(0, len(self.ops)))

        bytecode = O.encode_ops(self.ops)
        commitment = O.program_commitment(bytecode)
        return Program(
            program_id=commitment,
            commitment=commitment,
            ops=self.ops,
            reg_count=self.reg_max,
            compiler_metrics=metrics,
            type_schemas=self.type_schemas,
            blocks=self.blocks,
        )
