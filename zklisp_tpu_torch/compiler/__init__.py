"""Backend-agnostic compiler for the zk-lisp DSL (TPU framework port surface).

Public API mirrors the reference crate `zk-lisp-compiler`
(zk-lisp-compiler/src/lib.rs): `compile_str`, `compile_entry`,
`Program`, `CompilerMetrics`, plus the op types in `ops`.
"""

from __future__ import annotations

from typing import List, Sequence

from . import lower as _lower
from . import ops
from .builder import (BlockMeta, CompilerMetrics, FnTypeSchema,
                      LetTypeSchema, Program, ProgramBuilder, TypeSchemas)
from .errors import (CompileError, LexError, ParseError, RecursionError_,
                     RegOverflow, UnknownSymbol)
from .reader import Ast, intlit, is_int, is_sym, lex, parse, sym
from ..crypto.blake3 import blake3


def compile_str(src: str) -> Program:
    """Compile all top-level forms (lib.rs `compile_str`)."""
    toks = lex(src)
    forms = parse(toks)

    metrics = CompilerMetrics()
    builder = ProgramBuilder()
    cx = _lower.LowerCtx(builder, metrics)
    for f in forms:
        _lower.lower_top(cx, f)

    builder.push(ops.End())
    program = builder.finalize(metrics)
    program.program_id = blake3(src.encode())
    return program


def compile_entry(src: str, args: Sequence[int]) -> Program:
    """Compile and call `(main a0..aN)`, result normalized to r0
    (lib.rs `compile_entry`)."""
    toks = lex(src)
    forms = parse(toks)

    main_arity = None
    for f in forms:
        if (isinstance(f, list) and f and is_sym(f[0], "def")
                and len(f) > 1 and isinstance(f[1], list) and f[1]
                and is_sym(f[1][0], "main")):
            main_arity = len(f[1]) - 1
    if main_arity is None:
        raise CompileError("main: not found")
    if main_arity != len(args):
        raise CompileError(
            f"main expects {main_arity} args (got {len(args)})")

    call_ast = [sym("main")] + [intlit(int(v)) for v in args]

    metrics = CompilerMetrics()
    builder = ProgramBuilder()
    cx = _lower.LowerCtx(builder, metrics)
    for f in forms:
        _lower.lower_top(cx, f)

    res = _lower.lower_expr(cx, call_ast)
    res = cx.into_owned(res)
    res_reg = res.reg()
    if res_reg != 0:
        cx.emit_mov(0, res_reg)

    builder.push(ops.End())
    program = builder.finalize(metrics)
    program.program_id = blake3(src.encode())
    return program
