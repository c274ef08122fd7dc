"""Lowering: AST -> VM ops.

Faithful reimplementation of the reference lowering pipeline
(zk-lisp-compiler/src/lower/): environment of register/immediate bindings,
8-register free-list allocator with Owned/Borrowed/Imm ownership, function
inlining with recursion guard, Sethi-Ullman evaluation reordering,
balanced +/* chains, constant folding, and all gadget lowerings
(safe arithmetic, divmod, mulwide, assertions, sponge hash, Merkle,
RAM/stack, hex literals, loops with full unrolling, deftype sugar).

The emitted op stream must match the reference op-for-op so that program
commitments and ROM accumulators agree.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import ops as O
from .builder import (CompilerMetrics, FnTypeSchema, LetTypeSchema,
                      ProgramBuilder)
from .errors import (CompileError, RecursionError_, RegOverflow,
                     UnknownSymbol)
from .reader import Ast, intlit, is_int, is_str, is_sym, sym
from ..crypto.blake3 import blake3

NR = 8
STACK_BASE = 1_000_000

U64_MAX = (1 << 64) - 1


# --- value model -----------------------------------------------------------

class RVal:
    __slots__ = ("kind", "val")

    def __init__(self, kind: str, val: int) -> None:
        self.kind = kind  # "owned" | "borrowed" | "imm"
        self.val = val

    def as_imm(self) -> Optional[int]:
        return self.val if self.kind == "imm" else None

    def reg(self) -> int:
        if self.kind == "imm":
            raise CompileError(
                "internal: immediate used where register required")
        return self.val

    def __repr__(self) -> str:
        return f"RVal({self.kind},{self.val})"


def owned(r: int) -> RVal:
    return RVal("owned", r)


def borrowed(r: int) -> RVal:
    return RVal("borrowed", r)


def imm(v: int) -> RVal:
    return RVal("imm", v)


# binding: ("reg", r) | ("imm", v)


class LowerCtx:
    def __init__(self, builder: ProgramBuilder, metrics: CompilerMetrics):
        self.builder = builder
        self.metrics = metrics
        self.vars: Dict[str, tuple] = {}
        self.funs: Dict[str, Tuple[List[str], Ast]] = {}
        self.call_stack: List[str] = []
        self.sp_reg: Optional[int] = None
        self.const_ints: Dict[str, int] = {}
        self.free: List[int] = list(range(NR))
        self.ctx_stack: List[str] = []

    # -- registers --

    def alloc(self) -> int:
        if not self.free:
            raise RegOverflow(" -> ".join(self.ctx_stack) or "(root)")
        r = self.free.pop()
        self.metrics.cur_live += 1
        if self.metrics.cur_live > self.metrics.peak_live:
            self.metrics.peak_live = self.metrics.cur_live
        return r

    def free_reg(self, r: int) -> None:
        self.free.append(r)
        if self.metrics.cur_live > 0:
            self.metrics.cur_live -= 1

    def emit_mov(self, dst: int, src: int) -> None:
        if dst == src:
            self.metrics.mov_elided += 1
            return
        self.builder.push(O.Mov(dst, src))

    def map_var(self, name: str, binding: tuple) -> None:
        self.vars[name] = binding

    def get_binding(self, name: str) -> tuple:
        b = self.vars.get(name)
        if b is None:
            raise UnknownSymbol(name)
        return b

    def define_fun(self, name: str, params: List[str], body: Ast) -> None:
        self.builder.add_fn_decl(name, len(params))
        self.funs[name] = (params, body)

    def get_fun(self, name: str):
        return self.funs.get(name)

    def into_owned(self, v: RVal) -> RVal:
        if v.kind == "owned":
            return v
        if v.kind == "borrowed":
            dst = self.alloc()
            self.emit_mov(dst, v.val)
            return owned(dst)
        dst = self.alloc()
        self.builder.push(O.Const(dst, v.val))
        return owned(dst)

    def free_if_owned(self, v: RVal) -> None:
        if v.kind == "owned":
            self.free_reg(v.val)


# --- helpers ---------------------------------------------------------------

def implicit_begin(forms: List[Ast]) -> Ast:
    if len(forms) == 1:
        return forms[0]
    return [sym("begin")] + list(forms)


def contains_symbol(ast: Ast, name: str) -> bool:
    if is_sym(ast, name):
        return True
    if isinstance(ast, list):
        return any(contains_symbol(a, name) for a in ast)
    return False


def is_pure_arith(ast: Ast) -> bool:
    if isinstance(ast, tuple):
        return ast[0] in ("int", "sym")
    if isinstance(ast, list) and ast:
        head = ast[0]
        if not is_sym(head):
            return False
        h = head[1]
        if h in ("+", "-", "*", "neg", "=", "select", "if", "let"):
            return all(is_pure_arith(a) for a in ast[1:])
        return False
    return False


def su_number(ast: Ast) -> int:
    if isinstance(ast, tuple):
        return 1
    if isinstance(ast, list) and ast:
        head = ast[0]
        if not is_sym(head):
            return 1
        if len(ast) < 3:
            return 1
        sl, sr = su_number(ast[1]), su_number(ast[2])
        if head[1] in ("+", "-", "*"):
            return sl + 1 if sl == sr else max(sl, sr)
        return 1
    return 1


def ast_size(ast: Ast) -> int:
    if isinstance(ast, list):
        return 1 + sum(ast_size(a) for a in ast)
    return 1


def balance_chain(op: str, items: List[Ast]) -> Ast:
    flat: List[Ast] = []

    def flatten(nodes):
        for nde in nodes:
            if (isinstance(nde, list) and nde and is_sym(nde[0], op)
                    and len(nde) >= 3):
                flatten(nde[1:])
            else:
                flat.append(nde)

    def build(v: List[Ast]) -> Ast:
        if len(v) == 1:
            return v[0]
        mid = len(v) // 2
        return [sym(op), build(v[:mid]), build(v[mid:])]

    flatten(items)
    return build(flat)


# --- top-level -------------------------------------------------------------

def lower_top(cx: LowerCtx, ast: Ast) -> None:
    if isinstance(ast, list) and ast:
        head = ast[0]
        if is_sym(head, "def"):
            return lower_def(cx, ast[1:])
        if is_sym(head, "deftype"):
            return lower_deftype(cx, ast[1:])
        if is_sym(head, "typed-fn"):
            return lower_typed_fn(cx, ast[1:])
        if is_sym(head, "typed-let"):
            schema = parse_typed_let(None, ast[1:])
            cx.builder.add_let_schema(schema)
            return
    v = lower_expr(cx, ast)
    cx.free_if_owned(v)


_SPECIAL_FORMS = {}


def lower_expr(cx: LowerCtx, ast: Ast) -> RVal:
    if isinstance(ast, tuple):
        tag, val = ast
        if tag == "int":
            return imm(val)
        if tag == "str":
            raise CompileError("string literal outside macro")
        # symbol
        b = cx.get_binding(val)
        return borrowed(b[1]) if b[0] == "reg" else imm(b[1])

    if isinstance(ast, list) and ast:
        head = ast[0]
        if is_sym(head):
            s = head[1]
            tail = ast[1:]
            fn = _SPECIAL_FORMS.get(s)
            if fn is not None:
                return fn(cx, tail)
            return lower_call(cx, s, tail)
        raise CompileError("expr")
    raise CompileError("expr")


def lower_def(cx: LowerCtx, rest: List[Ast]) -> None:
    if not rest:
        raise CompileError("def")
    h = rest[0]
    if isinstance(h, list) and h:
        if not is_sym(h[0]):
            raise CompileError("def: name")
        fname = h[0][1]
        params = []
        for p in h[1:]:
            if not is_sym(p):
                raise CompileError("def: param")
            params.append(p[1])
        if len(rest) < 2:
            raise CompileError("def: body")
        body = implicit_begin(rest[1:])
        collect_let_names(body, cx.builder)
        collect_typed_lets(fname, body, cx.builder)
        cx.define_fun(fname, params, body)
        return
    if is_sym(h):
        name = h[1]
        if len(rest) < 2:
            raise CompileError("def: body")
        body = implicit_begin(rest[1:])
        collect_let_names(body, cx.builder)
        collect_typed_lets(name, body, cx.builder)
        if is_int(body):
            cx.const_ints[name] = body[1]
            cx.map_var(name, ("imm", body[1]))
        cx.define_fun(name, [], body)
        return
    raise CompileError("def")


def lower_let(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if not rest:
        raise CompileError("let")
    binds = rest[0]
    if not isinstance(binds, list):
        raise CompileError("let: binds")

    saved: List[Tuple[str, Optional[tuple], Optional[int], bool]] = []
    for b in binds:
        if not (isinstance(b, list) and len(b) == 2):
            raise CompileError("let: pair")
        if not is_sym(b[0]):
            raise CompileError("let: name")
        name = b[0][1]
        cx.builder.add_let_name(name)
        v = lower_expr(cx, b[1])
        prior = cx.vars.get(name)
        if v.kind == "imm":
            saved.append((name, prior, None, False))
            cx.map_var(name, ("imm", v.val))
        elif v.kind == "borrowed":
            saved.append((name, prior, v.val, False))
            cx.map_var(name, ("reg", v.val))
        else:
            saved.append((name, prior, v.val, True))
            cx.map_var(name, ("reg", v.val))

    if len(rest) < 2:
        raise CompileError("let: body")
    res = lower_expr(cx, implicit_begin(rest[1:]))
    res_reg = res.val if res.kind in ("owned", "borrowed") else None

    for name, prior, reg_opt, was_owned in reversed(saved):
        cx.vars.pop(name, None)
        if prior is not None:
            cx.vars[name] = prior
        elif was_owned and reg_opt is not None and res_reg != reg_opt:
            cx.free_reg(reg_opt)
    return res


def lower_bin(cx: LowerCtx, rest: List[Ast], op: str) -> RVal:
    if len(rest) != 2:
        raise CompileError("bin")

    su_l, su_r = su_number(rest[0]), su_number(rest[1])
    size_l, size_r = ast_size(rest[0]), ast_size(rest[1])
    both_pure = is_pure_arith(rest[0]) and is_pure_arith(rest[1])

    if not both_pure:
        eval_left_first = True
    elif su_l != su_r:
        eval_left_first = su_l > su_r
    else:
        eval_left_first = size_l >= size_r

    if both_pure and not eval_left_first:
        cx.metrics.su_reorders += 1

    if eval_left_first:
        left = lower_expr(cx, rest[0])
        right = lower_expr(cx, rest[1])
    else:
        right = lower_expr(cx, rest[1])
        left = lower_expr(cx, rest[0])

    ai, bi = left.as_imm(), right.as_imm()
    if ai is not None and bi is not None:
        if op == "+":
            if ai + bi <= U64_MAX:
                return imm(ai + bi)
        elif op == "-":
            if ai >= bi:
                return imm(ai - bi)
        else:
            if ai * bi <= U64_MAX:
                return imm(ai * bi)

    # materialize in evaluation order (matches reference temp-reg order)
    if eval_left_first:
        left = cx.into_owned(left)
        right = cx.into_owned(right)
    else:
        right = cx.into_owned(right)
        left = cx.into_owned(left)

    a_val, b_val = left, right

    if op in ("+", "*"):
        if a_val.kind == "owned":
            dst, reused = a_val.val, True
        elif b_val.kind == "owned":
            dst, reused = b_val.val, True
        else:
            dst, reused = cx.alloc(), False
    else:
        if a_val.kind == "owned":
            dst, reused = a_val.val, True
        else:
            dst, reused = cx.alloc(), False

    a_r, b_r = a_val.reg(), b_val.reg()
    if op == "+":
        cx.builder.push(O.Add(dst, a_r, b_r))
    elif op == "-":
        cx.builder.push(O.Sub(dst, a_r, b_r))
    else:
        cx.builder.push(O.Mul(dst, a_r, b_r))

    if reused:
        cx.metrics.reuse_dst += 1
        if dst == a_r:
            cx.free_if_owned(b_val)
        else:
            cx.free_if_owned(a_val)
    else:
        cx.free_if_owned(a_val)
        cx.free_if_owned(b_val)
    return owned(dst)


def lower_plus(cx: LowerCtx, tail: List[Ast]) -> RVal:
    if len(tail) != 2:
        cx.metrics.balanced_chains += 1
        return lower_expr(cx, balance_chain("+", tail))
    return lower_bin(cx, tail, "+")


def lower_minus(cx: LowerCtx, tail: List[Ast]) -> RVal:
    return lower_bin(cx, tail, "-")


def lower_times(cx: LowerCtx, tail: List[Ast]) -> RVal:
    if len(tail) != 2:
        cx.metrics.balanced_chains += 1
        return lower_expr(cx, balance_chain("*", tail))
    return lower_bin(cx, tail, "*")


def lower_call(cx: LowerCtx, name: str, args: List[Ast]) -> RVal:
    cx.ctx_stack.append("call")
    try:
        fn = cx.get_fun(name)
        if fn is None:
            raise UnknownSymbol(name)
        params, body = fn
        if name in cx.call_stack:
            raise RecursionError_(name)
        cx.call_stack.append(name)
        if len(params) != len(args):
            raise CompileError(f"call: {name} expects {len(params)} args")

        argv = [lower_expr(cx, a) for a in args]

        saved: List[Tuple[str, Optional[tuple], Optional[int], bool]] = []
        for p, v in zip(params, argv):
            prev = cx.vars.get(p)
            if v.kind == "imm":
                saved.append((p, prev, None, False))
                cx.map_var(p, ("imm", v.val))
            elif v.kind == "borrowed":
                saved.append((p, prev, v.val, False))
                cx.map_var(p, ("reg", v.val))
            else:
                saved.append((p, prev, v.val, True))
                cx.map_var(p, ("reg", v.val))

        res = lower_expr(cx, body)
        res_reg = res.val if res.kind in ("owned", "borrowed") else None

        for p, prior, reg_opt, was_owned in reversed(saved):
            cx.vars.pop(p, None)
            if prior is not None:
                cx.vars[p] = prior
            elif was_owned and reg_opt is not None and res_reg != reg_opt:
                cx.free_reg(reg_opt)

        cx.call_stack.pop()
        return res
    finally:
        cx.ctx_stack.pop()


def lower_deftype(cx: LowerCtx, rest: List[Ast]) -> None:
    if not rest:
        raise CompileError("deftype")
    if not is_sym(rest[0]):
        raise CompileError("deftype: name")
    tname = rest[0][1]

    def extract_member(ast: Ast):
        if not (isinstance(ast, list) and len(ast) == 2):
            return None
        if not is_sym(ast[0], "quote"):
            return None
        inner = ast[1]
        if not (isinstance(inner, list) and inner and is_sym(inner[0], "member")):
            return None
        return inner

    member_form = None
    if len(rest) > 1:
        member_form = extract_member(rest[1])
    if member_form is None and len(rest) > 2:
        member_form = extract_member(rest[2])
    if member_form is None:
        raise CompileError("deftype: member must be quoted")

    variants = []
    for it in member_form[1:]:
        if not is_sym(it):
            raise CompileError("deftype: member item")
        variants.append(it[1])
    if not member_form[1:]:
        raise CompileError("deftype: member empty")

    for i, v in enumerate(variants):
        cx.define_fun(f"{tname}:{v}", [], intlit(i))

    x = sym("x")
    terms = [[sym("-"), x, intlit(i)] for i in range(len(variants))]
    if not terms:
        prod: Ast = intlit(0)
    else:
        prod = terms[0]
        for t in terms[1:]:
            prod = [sym("*"), prod, t]
    is_pred = [sym("="), prod, intlit(0)]
    cx.define_fun(f"{tname}:is", ["x"], is_pred)
    cx.define_fun(f"{tname}:assert", ["x"], [sym("assert"), is_pred])


def lower_begin(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if not rest:
        raise CompileError("begin")
    for it in rest[:-1]:
        v = lower_expr(cx, it)
        cx.free_if_owned(v)
    return lower_expr(cx, rest[-1])


def lower_block(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if not rest:
        raise CompileError("block")
    lvl_start = cx.builder.current_level()
    res = lower_begin(cx, rest)
    lvl_end = cx.builder.current_level()
    if lvl_end > lvl_start:
        cx.builder.push_block(lvl_start, lvl_end)
    return res


def lower_secret_arg(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("secret-arg")
    if not is_int(rest[0]):
        raise CompileError("secret-arg: index must be integer literal")
    idx = rest[0][1]
    if idx >= NR:
        raise CompileError("secret-arg: index out of range for register file")
    return borrowed(idx)


# --- operators (lower/operators.rs) ---------------------------------------

def lower_if(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 3:
        raise CompileError("if")
    c = lower_expr(cx, rest[0])
    t = lower_expr(cx, rest[1])
    e = lower_expr(cx, rest[2])
    cv = c.as_imm()
    if cv is not None:
        if cv == 0:
            cx.free_if_owned(t)
            return e
        if cv == 1:
            cx.free_if_owned(e)
            return t
        raise CompileError("if: cond must be boolean (0/1)")
    c = cx.into_owned(c)
    t = cx.into_owned(t)
    e = cx.into_owned(e)
    dst = cx.alloc()
    cx.builder.push(O.Select(dst, c.reg(), t.reg(), e.reg()))
    cx.free_if_owned(c)
    cx.free_if_owned(t)
    cx.free_if_owned(e)
    return owned(dst)


def lower_when(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("when")
    try:
        if len(rest) < 2:
            raise CompileError("when: expected cond and body")
        expanded = [sym("if"), rest[0], implicit_begin(rest[1:]), intlit(0)]
        return lower_expr(cx, expanded)
    finally:
        cx.ctx_stack.pop()


def lower_eq(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("=")
    a = lower_expr(cx, rest[0])
    b = lower_expr(cx, rest[1])
    ai, bi = a.as_imm(), b.as_imm()
    if ai is not None and bi is not None:
        return imm(1 if ai == bi else 0)
    a = cx.into_owned(a)
    b = cx.into_owned(b)
    dst = cx.alloc()
    cx.builder.push(O.Eq(dst, a.reg(), b.reg()))
    cx.free_if_owned(a)
    cx.free_if_owned(b)
    return owned(dst)


def lower_neg(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("neg")
    a = lower_expr(cx, rest[0])
    ai = a.as_imm()
    if ai is not None and ai == 0:
        return imm(0)
    a = cx.into_owned(a)
    dst = a.val if a.kind == "owned" else cx.alloc()
    cx.builder.push(O.Neg(dst, a.reg()))
    if a.kind != "owned":
        cx.free_if_owned(a)
    return owned(dst)


def lower_select(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 3:
        raise CompileError("select")
    c = lower_expr(cx, rest[0])
    a = lower_expr(cx, rest[1])
    b = lower_expr(cx, rest[2])
    cv = c.as_imm()
    if cv is not None:
        if cv == 0:
            cx.free_if_owned(a)
            return b
        if cv == 1:
            cx.free_if_owned(b)
            return a
        raise CompileError("select: cond must be boolean (0/1)")
    c = cx.into_owned(c)
    a = cx.into_owned(a)
    b = cx.into_owned(b)
    dst = cx.alloc()
    cx.builder.push(O.Select(dst, c.reg(), a.reg(), b.reg()))
    cx.free_if_owned(c)
    cx.free_if_owned(a)
    cx.free_if_owned(b)
    return owned(dst)


def lower_in_set(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("in-set")
    x = lower_expr(cx, rest[0])
    x = cx.into_owned(x)
    if not isinstance(rest[1], list):
        raise CompileError("in-set: expects list")
    set_list = rest[1]
    if not set_list:
        raise CompileError("in-set: empty set")

    r_prod: Optional[int] = None
    for it in set_list:
        si = lower_expr(cx, it)
        si = cx.into_owned(si)
        r_diff = cx.alloc()
        cx.builder.push(O.Sub(r_diff, x.reg(), si.reg()))
        cx.free_if_owned(si)
        if r_prod is None:
            r_prod = r_diff
        else:
            r_mul = cx.alloc()
            cx.builder.push(O.Mul(r_mul, r_prod, r_diff))
            cx.free_reg(r_prod)
            cx.free_reg(r_diff)
            r_prod = r_mul

    r_zero = cx.alloc()
    cx.builder.push(O.Const(r_zero, 0))
    r_eq = cx.alloc()
    cx.builder.push(O.Eq(r_eq, r_prod, r_zero))
    cx.free_reg(r_zero)
    cx.free_reg(r_prod)
    r_out = cx.alloc()
    cx.builder.push(O.Assert(r_out, r_eq))
    cx.free_reg(r_eq)
    if x.kind == "owned":
        cx.free_reg(x.val)
    return owned(r_out)


# --- assertions (lower/assert.rs) -----------------------------------------

def lower_assert(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("assert")
    c = lower_expr(cx, rest[0])
    cv = c.as_imm()
    if cv is not None:
        if cv == 1:
            return imm(1)
        raise CompileError("assert: constant false")
    c = cx.into_owned(c)
    dst = cx.alloc()
    cx.builder.push(O.Assert(dst, c.reg()))
    cx.free_if_owned(c)
    return owned(dst)


def lower_assert_bit(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("assert-bit")
    x = lower_expr(cx, rest[0])
    xv = x.as_imm()
    if xv is not None:
        if xv in (0, 1):
            return imm(1)
        raise CompileError("assert-bit: constant not a bit")
    x = cx.into_owned(x)
    dst = cx.alloc()
    cx.builder.push(O.AssertBit(dst, x.reg()))
    cx.free_if_owned(x)
    return owned(dst)


def lower_assert_range(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("assert-range")
    if not is_int(rest[1]):
        raise CompileError("assert-range: bits must be integer")
    bits = rest[1][1]
    x = lower_expr(cx, rest[0])
    if bits == 32:
        xv = x.as_imm()
        if xv is not None:
            if xv < (1 << 32):
                return imm(1)
            raise CompileError("assert-range: constant out of range")
        x = cx.into_owned(x)
        dst = cx.alloc()
        cx.builder.push(O.AssertRange(dst, x.reg(), 32))
        cx.free_if_owned(x)
        return owned(dst)
    if bits == 64:
        if x.as_imm() is not None:
            return imm(1)
        x = cx.into_owned(x)
        dst = cx.alloc()
        cx.builder.push(O.AssertRangeLo(dst, x.reg()))
        cx.builder.push(O.AssertRangeHi(dst, x.reg()))
        cx.free_if_owned(x)
        return owned(dst)
    raise CompileError("assert-range: bits must be 32 or 64")


def lower_bit_pred(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("bit?")
    x = lower_expr(cx, rest[0])
    xv = x.as_imm()
    if xv is not None:
        return imm(1 if xv in (0, 1) else 0)
    x = cx.into_owned(x)
    one = cx.alloc()
    cx.builder.push(O.Const(one, 1))
    xm1 = cx.alloc()
    cx.builder.push(O.Sub(xm1, x.reg(), one))
    t = cx.alloc()
    cx.builder.push(O.Mul(t, x.reg(), xm1))
    z = cx.alloc()
    cx.builder.push(O.Const(z, 0))
    eq_r = cx.alloc()
    cx.builder.push(O.Eq(eq_r, t, z))
    cx.free_reg(one)
    cx.free_reg(xm1)
    cx.free_reg(t)
    cx.free_reg(z)
    # NOTE: the reference leaks the Owned x here (bits.rs does not free it);
    # we mirror exactly for op-stream parity.
    return owned(eq_r)


# --- hash / merkle (lower/hash.rs, lower/merkle.rs) -----------------------

def lower_hash2(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("hash2")
    a = lower_expr(cx, rest[0])
    b = lower_expr(cx, rest[1])
    if a.as_imm() is not None:
        a = cx.into_owned(a)
    if b.as_imm() is not None:
        b = cx.into_owned(b)
    cx.builder.push(O.SAbsorbN((a.reg(), b.reg())))
    dst = cx.alloc()
    cx.builder.push(O.SSqueeze(dst))
    cx.free_if_owned(a)
    cx.free_if_owned(b)
    return owned(dst)


def _pair_dir_sib(p: Ast):
    if not (isinstance(p, list) and len(p) == 2):
        raise CompileError("merkle-verify: pair")
    return p[0], p[1]


def lower_merkle_verify(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("merkle-verify")
    leaf = lower_expr(cx, rest[0])
    if leaf.as_imm() is not None:
        leaf = cx.into_owned(leaf)
    leaf_r = leaf.reg()

    if not isinstance(rest[1], list):
        raise CompileError("merkle-verify: path")
    pairs = rest[1]
    if not pairs:
        raise CompileError("merkle-verify: empty path")

    d_ast, s_ast = _pair_dir_sib(pairs[0])
    d = cx.into_owned(lower_expr(cx, d_ast))
    s = cx.into_owned(lower_expr(cx, s_ast))
    cx.builder.push(O.MerkleStepFirst(leaf_r, d.reg(), s.reg()))
    cx.free_if_owned(leaf)
    cx.free_if_owned(d)
    cx.free_if_owned(s)

    for p in pairs[1:len(pairs) - 1]:
        d_ast, s_ast = _pair_dir_sib(p)
        d = lower_expr(cx, d_ast)
        if d.as_imm() is not None:
            d = cx.into_owned(d)
        s = lower_expr(cx, s_ast)
        if s.as_imm() is not None:
            s = cx.into_owned(s)
        cx.builder.push(O.MerkleStep(d.reg(), s.reg()))
        cx.free_if_owned(d)
        cx.free_if_owned(s)

    if len(pairs) >= 2:
        d_ast, s_ast = _pair_dir_sib(pairs[-1])
        d = lower_expr(cx, d_ast)
        if d.as_imm() is not None:
            d = cx.into_owned(d)
        s = lower_expr(cx, s_ast)
        if s.as_imm() is not None:
            s = cx.into_owned(s)
        cx.builder.push(O.MerkleStepLast(d.reg(), s.reg()))
        cx.free_if_owned(d)
        cx.free_if_owned(s)
    return imm(0)


def _parse_dir_sib_pair(cx: LowerCtx, pair: Ast) -> Tuple[int, int]:
    if not (isinstance(pair, list) and len(pair) == 2):
        raise CompileError("path: pair")
    d = cx.into_owned(lower_expr(cx, pair[0]))
    s = cx.into_owned(lower_expr(cx, pair[1]))
    return d.reg(), s.reg()


def lower_load_ca(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("load-ca")
    leaf = cx.into_owned(lower_expr(cx, rest[0]))
    if not isinstance(rest[1], list):
        raise CompileError("load-ca: path")
    path = rest[1]
    if not path:
        raise CompileError("load-ca: empty path")

    d0, s0 = _parse_dir_sib_pair(cx, path[0])
    cx.builder.push(O.MerkleStepFirst(leaf.reg(), d0, s0))
    cx.free_reg(d0)
    cx.free_reg(s0)
    for pair in path[1:len(path) - 1]:
        d, s = _parse_dir_sib_pair(cx, pair)
        cx.builder.push(O.MerkleStep(d, s))
        cx.free_reg(d)
        cx.free_reg(s)
    if len(path) > 1:
        d, s = _parse_dir_sib_pair(cx, path[-1])
        cx.builder.push(O.MerkleStepLast(d, s))
        cx.free_reg(d)
        cx.free_reg(s)
    return leaf


def lower_store_ca(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("store-ca")
    leaf = cx.into_owned(lower_expr(cx, rest[0]))
    if not isinstance(rest[1], list):
        raise CompileError("store-ca: path")
    path = rest[1]
    if not path:
        raise CompileError("store-ca: empty path")
    d0, s0 = _parse_dir_sib_pair(cx, path[0])
    cx.builder.push(O.MerkleStepFirst(leaf.reg(), d0, s0))
    cx.free_reg(d0)
    cx.free_reg(s0)
    for pair in path[1:]:
        d, s = _parse_dir_sib_pair(cx, pair)
        cx.builder.push(O.MerkleStep(d, s))
        cx.free_reg(d)
        cx.free_reg(s)
    cx.free_reg(leaf.reg())
    return imm(0)


# --- ALU gadgets (lower/alu.rs) -------------------------------------------

def _assert_range_bits_for_reg(cx: LowerCtx, r: int, bits: int) -> None:
    cx.ctx_stack.append("assert-range-bits")
    try:
        if bits == 32:
            dst = cx.alloc()
            cx.builder.push(O.AssertRange(dst, r, 32))
            cx.free_reg(dst)
        elif bits == 64:
            dst = cx.alloc()
            cx.builder.push(O.AssertRangeLo(dst, r))
            cx.builder.push(O.AssertRangeHi(dst, r))
            cx.free_reg(dst)
        else:
            raise CompileError("assert-range: bits must be 32 or 64")
    finally:
        cx.ctx_stack.pop()


def lower_safe_add(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("safe-add")
    try:
        if len(rest) != 2:
            raise CompileError("safe-add")
        av = lower_expr(cx, rest[0])
        bv = lower_expr(cx, rest[1])
        ai, bi = av.as_imm(), bv.as_imm()
        if ai is not None and bi is not None and ai + bi <= U64_MAX:
            return imm(ai + bi)
        a = cx.into_owned(av)
        b = cx.into_owned(bv)
        a_r, b_r = a.reg(), b.reg()
        _assert_range_bits_for_reg(cx, a_r, 64)
        _assert_range_bits_for_reg(cx, b_r, 64)
        cx.builder.push(O.Add(a_r, a_r, b_r))
        _assert_range_bits_for_reg(cx, a_r, 64)
        cx.free_if_owned(b)
        return owned(a_r)
    finally:
        cx.ctx_stack.pop()


def lower_safe_sub(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("safe-sub")
    try:
        if len(rest) != 2:
            raise CompileError("safe-sub")
        av = lower_expr(cx, rest[0])
        bv = lower_expr(cx, rest[1])
        ai, bi = av.as_imm(), bv.as_imm()
        if ai is not None and bi is not None and ai >= bi:
            return imm(ai - bi)
        a = cx.into_owned(av)
        b = cx.into_owned(bv)
        a_r, b_r = a.reg(), b.reg()
        _assert_range_bits_for_reg(cx, a_r, 64)
        _assert_range_bits_for_reg(cx, b_r, 64)
        cx.builder.push(O.Sub(a_r, a_r, b_r))
        _assert_range_bits_for_reg(cx, a_r, 64)
        cx.free_if_owned(b)
        return owned(a_r)
    finally:
        cx.ctx_stack.pop()


def lower_safe_mul(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("safe-mul")
    try:
        if len(rest) != 2:
            raise CompileError("safe-mul")
        av = lower_expr(cx, rest[0])
        bv = lower_expr(cx, rest[1])
        ai, bi = av.as_imm(), bv.as_imm()
        if ai is not None and bi is not None and ai * bi <= U64_MAX:
            return imm(ai * bi)
        a = cx.into_owned(av)
        b = cx.into_owned(bv)
        a_r, b_r = a.reg(), b.reg()
        _assert_range_bits_for_reg(cx, a_r, 32)
        _assert_range_bits_for_reg(cx, b_r, 32)
        cx.builder.push(O.Mul(a_r, a_r, b_r))
        _assert_range_bits_for_reg(cx, a_r, 64)
        cx.free_if_owned(b)
        return owned(a_r)
    finally:
        cx.ctx_stack.pop()


def _assert_nonzero(cx: LowerCtx, r: int) -> None:
    """Emit b != 0 check: eq0 = (r == 0); assert(1 - eq0)."""
    zero_b = cx.alloc()
    cx.builder.push(O.Const(zero_b, 0))
    eq_b0 = cx.alloc()
    cx.builder.push(O.Eq(eq_b0, r, zero_b))
    cx.free_reg(zero_b)
    one_b = cx.alloc()
    cx.builder.push(O.Const(one_b, 1))
    cond_b = cx.alloc()
    cx.builder.push(O.Sub(cond_b, one_b, eq_b0))
    cx.free_reg(one_b)
    assert_r = cx.alloc()
    cx.builder.push(O.Assert(assert_r, cond_b))
    cx.free_reg(eq_b0)
    cx.free_reg(cond_b)
    cx.free_reg(assert_r)


def _lower_divmod_common(cx: LowerCtx, rest: List[Ast], want_q: bool) -> RVal:
    if len(rest) != 2:
        raise CompileError("divmod-q" if want_q else "divmod-r")
    av = lower_expr(cx, rest[0])
    bv = lower_expr(cx, rest[1])
    a = cx.into_owned(av)
    b = cx.into_owned(bv)
    a_r, b_r = a.reg(), b.reg()
    _assert_range_bits_for_reg(cx, a_r, 64)
    _assert_range_bits_for_reg(cx, b_r, 64)
    _assert_nonzero(cx, b_r)

    rq = cx.alloc()
    rr = cx.alloc()
    cx.builder.push(O.DivMod(rq, rr, a_r, b_r))

    qmulb = cx.alloc()
    cx.builder.push(O.Mul(qmulb, rq, b_r))
    _assert_range_bits_for_reg(cx, rr, 64)

    sum1 = cx.alloc()
    cx.builder.push(O.Add(sum1, qmulb, rr))
    eq_r = cx.alloc()
    cx.builder.push(O.Eq(eq_r, sum1, a_r))
    assert_eq = cx.alloc()
    cx.builder.push(O.Assert(assert_eq, eq_r))
    cx.free_reg(sum1)
    cx.free_reg(eq_r)
    cx.free_reg(assert_eq)
    cx.free_reg(qmulb)

    t = cx.alloc()
    cx.builder.push(O.Sub(t, b_r, rr))
    _assert_range_bits_for_reg(cx, t, 64)

    zero = cx.alloc()
    cx.builder.push(O.Const(zero, 0))
    eq_t0 = cx.alloc()
    cx.builder.push(O.Eq(eq_t0, t, zero))
    cx.free_reg(zero)
    one = cx.alloc()
    cx.builder.push(O.Const(one, 1))
    cond = cx.alloc()
    cx.builder.push(O.Sub(cond, one, eq_t0))
    cx.free_reg(one)
    assert_ok = cx.alloc()
    cx.builder.push(O.Assert(assert_ok, cond))
    cx.free_reg(eq_t0)
    cx.free_reg(cond)
    cx.free_reg(assert_ok)
    if want_q:
        cx.free_reg(rr)
        cx.free_reg(t)
        cx.free_if_owned(a)
        cx.free_if_owned(b)
        return owned(rq)
    cx.free_reg(t)
    cx.free_reg(rq)
    cx.free_if_owned(a)
    cx.free_if_owned(b)
    return owned(rr)


def lower_divmod_q(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("divmod-q")
    try:
        return _lower_divmod_common(cx, rest, True)
    finally:
        cx.ctx_stack.pop()


def lower_divmod_r(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("divmod-r")
    try:
        return _lower_divmod_common(cx, rest, False)
    finally:
        cx.ctx_stack.pop()


def _lower_mulwide(cx: LowerCtx, rest: List[Ast], want_hi: bool) -> RVal:
    if len(rest) != 2:
        raise CompileError("mulwide-hi" if want_hi else "mulwide-lo")
    a = cx.into_owned(lower_expr(cx, rest[0]))
    b = cx.into_owned(lower_expr(cx, rest[1]))
    a_r, b_r = a.reg(), b.reg()
    _assert_range_bits_for_reg(cx, a_r, 64)
    _assert_range_bits_for_reg(cx, b_r, 64)
    rhi = cx.alloc()
    rlo = cx.alloc()
    cx.builder.push(O.MulWide(rhi, rlo, a_r, b_r))
    cx.free_if_owned(a)
    cx.free_if_owned(b)
    _assert_range_bits_for_reg(cx, rhi, 64)
    _assert_range_bits_for_reg(cx, rlo, 64)
    if want_hi:
        cx.free_reg(rlo)
        return owned(rhi)
    cx.free_reg(rhi)
    return owned(rlo)


def lower_mulwide_hi(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("mulwide-hi")
    try:
        return _lower_mulwide(cx, rest, True)
    finally:
        cx.ctx_stack.pop()


def lower_mulwide_lo(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("mulwide-lo")
    try:
        return _lower_mulwide(cx, rest, False)
    finally:
        cx.ctx_stack.pop()


def lower_muldiv_floor(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("muldiv")
    try:
        if len(rest) != 3:
            raise CompileError("muldiv")
        a = cx.into_owned(lower_expr(cx, rest[0]))
        b = cx.into_owned(lower_expr(cx, rest[1]))
        c = cx.into_owned(lower_expr(cx, rest[2]))
        a_r, b_r, c_r = a.reg(), b.reg(), c.reg()
        _assert_range_bits_for_reg(cx, a_r, 64)
        _assert_range_bits_for_reg(cx, b_r, 64)
        _assert_range_bits_for_reg(cx, c_r, 64)
        rhi = cx.alloc()
        rlo = cx.alloc()
        cx.builder.push(O.MulWide(rhi, rlo, a_r, b_r))
        cx.free_if_owned(a)
        cx.free_if_owned(b)
        rq = cx.alloc()
        rr = cx.alloc()
        cx.builder.push(O.DivMod128(rhi, rlo, c_r, rq, rr))
        _assert_range_bits_for_reg(cx, rq, 64)
        _assert_range_bits_for_reg(cx, rr, 64)
        cx.free_if_owned(c)
        cx.free_reg(rhi)
        cx.free_reg(rlo)
        cx.free_reg(rr)
        return owned(rq)
    finally:
        cx.ctx_stack.pop()


# --- RAM / stack (lower/store.rs, lower/ram.rs) ---------------------------

def lower_load(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("load")
    addr = cx.into_owned(lower_expr(cx, rest[0]))
    dst = cx.alloc()
    cx.builder.push(O.Load(dst, addr.reg()))
    cx.free_if_owned(addr)
    return owned(dst)


def lower_store(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 2:
        raise CompileError("store")
    addr_v = lower_expr(cx, rest[0])
    val_v = lower_expr(cx, rest[1])
    if addr_v.kind == "imm":
        addr_v = cx.into_owned(addr_v)
    if val_v.kind == "imm":
        val_v = cx.into_owned(val_v)
    cx.builder.push(O.Store(addr_v.reg(), val_v.reg()))
    cx.free_if_owned(addr_v)
    cx.free_if_owned(val_v)
    return imm(0)


def _ensure_sp(cx: LowerCtx) -> int:
    if cx.sp_reg is not None:
        return cx.sp_reg
    r = cx.alloc()
    cx.builder.push(O.Const(r, 0))
    cx.sp_reg = r
    return r


def lower_push(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("push")
    v = cx.into_owned(lower_expr(cx, rest[0]))
    r_base = cx.alloc()
    cx.builder.push(O.Const(r_base, STACK_BASE))
    r_addr = cx.alloc()
    sp = _ensure_sp(cx)
    cx.builder.push(O.Add(r_addr, r_base, sp))
    cx.builder.push(O.Store(r_addr, v.reg()))
    cx.free_reg(r_addr)
    cx.free_reg(r_base)
    cx.free_if_owned(v)
    r_one = cx.alloc()
    cx.builder.push(O.Const(r_one, 1))
    sp = _ensure_sp(cx)
    cx.builder.push(O.Add(sp, sp, r_one))
    cx.free_reg(r_one)
    return imm(0)


def lower_pop(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if rest:
        raise CompileError("pop")
    r_one = cx.alloc()
    cx.builder.push(O.Const(r_one, 1))
    sp = _ensure_sp(cx)
    cx.builder.push(O.Sub(sp, sp, r_one))
    cx.free_reg(r_one)
    r_base = cx.alloc()
    cx.builder.push(O.Const(r_base, STACK_BASE))
    r_addr = cx.alloc()
    sp = _ensure_sp(cx)
    cx.builder.push(O.Add(r_addr, r_base, sp))
    r_dst = cx.alloc()
    cx.builder.push(O.Load(r_dst, r_addr))
    cx.free_reg(r_addr)
    cx.free_reg(r_base)
    return owned(r_dst)


def lower_push_star(cx: LowerCtx, rest: List[Ast]) -> RVal:
    for it in rest:
        lower_push(cx, [it])
    return imm(0)


def lower_pop_star(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("pop*")
    if not is_int(rest[0]):
        raise CompileError("pop*: count must be integer literal")
    n = rest[0][1]
    if n == 0:
        raise CompileError("pop*: count must be >= 1")
    last: Optional[RVal] = None
    for _ in range(n):
        v = lower_pop(cx, [])
        if last is not None:
            cx.free_if_owned(last)
        last = v
    return last


# --- hex literal (lower/hex.rs) -------------------------------------------

def lower_hex_to_bytes32(cx: LowerCtx, rest: List[Ast]) -> RVal:
    if len(rest) != 1:
        raise CompileError("hex-to-bytes32")
    if not is_str(rest[0]):
        raise CompileError("hex-to-bytes32: expects string literal")
    s = rest[0][1]
    hex_str = s[2:] if s.startswith("0x") else s
    try:
        decoded = bytes.fromhex(hex_str)
    except ValueError:
        raise CompileError("hex-to-bytes32: invalid hex")
    if len(decoded) > 32:
        raise CompileError("hex-to-bytes32: length > 32")
    buf = decoded + b"\x00" * (32 - len(decoded))

    def c_hash(lo: int, hi: int) -> int:
        r_lo = cx.alloc()
        cx.builder.push(O.Const(r_lo, lo))
        r_hi = cx.alloc()
        cx.builder.push(O.Const(r_hi, hi))
        cx.builder.push(O.SAbsorbN((r_lo, r_hi)))
        r_c = cx.alloc()
        cx.builder.push(O.SSqueeze(r_c))
        cx.free_reg(r_lo)
        cx.free_reg(r_hi)
        return r_c

    lo0 = int.from_bytes(buf[0:8], "little")
    hi0 = int.from_bytes(buf[8:16], "little")
    r_c0 = c_hash(lo0, hi0)
    lo1 = int.from_bytes(buf[16:24], "little")
    hi1 = int.from_bytes(buf[24:32], "little")
    r_c1 = c_hash(lo1, hi1)

    r_payload = cx.alloc()
    cx.builder.push(O.SAbsorbN((r_c0, r_c1)))
    cx.builder.push(O.SSqueeze(r_payload))
    cx.free_reg(r_c0)
    cx.free_reg(r_c1)

    tag8 = int.from_bytes(blake3(b"zkl/bytes32")[0:8], "little")
    r_tag = cx.alloc()
    cx.builder.push(O.Const(r_tag, tag8))
    r_len = cx.alloc()
    cx.builder.push(O.Const(r_len, len(decoded)))
    r_t0 = cx.alloc()
    cx.builder.push(O.SAbsorbN((r_tag, r_len)))
    cx.builder.push(O.SSqueeze(r_t0))
    cx.free_reg(r_tag)
    cx.free_reg(r_len)

    r_digest = cx.alloc()
    cx.builder.push(O.SAbsorbN((r_t0, r_payload)))
    cx.builder.push(O.SSqueeze(r_digest))
    cx.free_reg(r_t0)
    cx.free_reg(r_payload)
    return owned(r_digest)


# --- loops (lower/iter.rs) -------------------------------------------------

def lower_loop(cx: LowerCtx, rest: List[Ast]) -> RVal:
    cx.ctx_stack.append("loop")
    try:
        if len(rest) < 3:
            raise CompileError("loop")
        if not is_sym(rest[0], ":max"):
            raise CompileError("loop: expected :max keyword")
        if is_int(rest[1]):
            max_n = rest[1][1]
        elif is_sym(rest[1]):
            name = rest[1][1]
            b = cx.vars.get(name)
            if b is not None and b[0] == "imm":
                max_n = b[1]
            elif name in cx.const_ints:
                max_n = cx.const_ints[name]
            else:
                raise CompileError(
                    "loop: :max must be integer literal or constant")
        else:
            raise CompileError("loop: :max must be integer literal or constant")
        if max_n == 0:
            raise CompileError("loop: :max must be >= 1")

        binds_ast = rest[2]
        if not isinstance(binds_ast, list):
            raise CompileError("loop: expected binding list")
        if not binds_ast:
            raise CompileError("loop: empty binding list")

        bind_names, bind_inits = [], []
        for b in binds_ast:
            if not (isinstance(b, list) and len(b) == 2 and is_sym(b[0])):
                raise CompileError("loop: binding pair")
            bind_names.append(b[0][1])
            bind_inits.append(b[1])

        if len(rest) < 4:
            raise CompileError("loop: missing body")
        body_forms = rest[3:]

        has_recur, recur_args = False, None
        last = body_forms[-1]
        if isinstance(last, list) and last and is_sym(last[0], "recur"):
            args = last[1:]
            if len(args) != len(bind_names):
                raise CompileError("recur: arity must match loop bindings")
            for prefix_form in body_forms[:-1]:
                if contains_symbol(prefix_form, "recur"):
                    raise CompileError(
                        "recur: only allowed in tail position of loop body")
            has_recur, recur_args = True, list(args)

        if not has_recur:
            bind_pairs = [[sym(n), init]
                          for n, init in zip(bind_names, bind_inits)]
            expanded = [sym("block"),
                        [sym("let"), bind_pairs, implicit_begin(body_forms)]]
            return lower_expr(cx, expanded)

        prefix = body_forms[:-1]
        lvl_start = cx.builder.current_level()

        states = []  # (name, prior, reg)
        for name, init_ast in zip(bind_names, bind_inits):
            v = cx.into_owned(lower_expr(cx, init_ast))
            prior = cx.vars.get(name)
            cx.map_var(name, ("reg", v.val))
            states.append([name, prior, v.val])

        loop_result: Optional[RVal] = None
        for it in range(max_n):
            last_val: Optional[RVal] = None
            if prefix:
                for idx, form in enumerate(prefix):
                    v = lower_expr(cx, form)
                    if idx + 1 < len(prefix):
                        cx.free_if_owned(v)
                    else:
                        last_val = v
            if last_val is None:
                last_val = imm(0)
            if it + 1 == max_n:
                loop_result = last_val
                break
            cx.free_if_owned(last_val)

            for idx, expr in enumerate(recur_args):
                v = cx.into_owned(lower_expr(cx, expr))
                st = states[idx]
                old_r = st[2]
                cx.map_var(st[0], ("reg", v.val))
                st[2] = v.val
                if old_r != v.val:
                    cx.free_reg(old_r)

        res = loop_result if loop_result is not None else imm(0)
        res_reg = res.val if res.kind in ("owned", "borrowed") else None

        for name, prior, reg in reversed(states):
            cx.vars.pop(name, None)
            if prior is not None:
                cx.vars[name] = prior
            elif reg != res_reg:
                cx.free_reg(reg)

        lvl_end = cx.builder.current_level()
        if lvl_end > lvl_start:
            cx.builder.push_block(lvl_start, lvl_end)
        return res
    finally:
        cx.ctx_stack.pop()


# --- type schemas ----------------------------------------------------------

def _parse_scalar_type(s: str) -> str:
    if s in ("u64", "u128", "bytes32"):
        return s
    raise CompileError(f"typed-fn: unknown type '{s}'")


def parse_typed_let(owner: Optional[str], rest: List[Ast]) -> LetTypeSchema:
    if len(rest) != 2:
        raise CompileError("typed-let")
    if not is_sym(rest[0]):
        raise CompileError("typed-let: name")
    name = rest[0][1]
    t = rest[1]
    if is_sym(t):
        ty_sym = t[1]
    elif isinstance(t, list) and len(t) == 2 and is_sym(t[1]):
        ty_sym = t[1][1]
    else:
        raise CompileError("typed-let: type")
    return LetTypeSchema(owner, name, _parse_scalar_type(ty_sym))


def lower_typed_fn(cx: LowerCtx, rest: List[Ast]) -> None:
    if len(rest) != 4:
        raise CompileError("typed-fn")
    if not is_sym(rest[0]):
        raise CompileError("typed-fn: name")
    name = rest[0][1]
    if not isinstance(rest[1], list):
        raise CompileError("typed-fn: args")
    args = []
    for a in rest[1]:
        if is_sym(a):
            args.append(("const", _parse_scalar_type(a[1])))
        elif isinstance(a, list) and len(a) == 2:
            if not is_sym(a[0]):
                raise CompileError("typed-fn: arg role must be symbol")
            if not is_sym(a[1]):
                raise CompileError("typed-fn: arg type must be symbol")
            role = a[0][1]
            if role not in ("const", "let"):
                raise CompileError(f"typed-fn: unknown arg role '{role}'")
            args.append((role, _parse_scalar_type(a[1][1])))
        else:
            raise CompileError("typed-fn: arg spec must be type or (role type)")
    if not is_sym(rest[2], "->"):
        raise CompileError("typed-fn: expected '->'")
    if not is_sym(rest[3]):
        raise CompileError("typed-fn: return type")
    cx.builder.add_fn_schema(
        FnTypeSchema(name, tuple(args), _parse_scalar_type(rest[3][1])))


def collect_let_names(ast: Ast, builder: ProgramBuilder) -> None:
    if isinstance(ast, list) and ast:
        if is_sym(ast[0], "let") and len(ast) > 1 and isinstance(ast[1], list):
            for b in ast[1]:
                if (isinstance(b, list) and len(b) == 2 and is_sym(b[0])):
                    builder.add_let_name(b[0][1])
        for sub in ast[1:]:
            collect_let_names(sub, builder)


def collect_typed_lets(owner: str, ast: Ast, builder: ProgramBuilder) -> None:
    if isinstance(ast, list) and ast:
        if is_sym(ast[0], "typed-let"):
            builder.add_let_schema(parse_typed_let(owner, ast[1:]))
        for sub in ast[1:]:
            collect_typed_lets(owner, sub, builder)


def _lower_typed_let_expr(cx: LowerCtx, rest: List[Ast]) -> RVal:
    # typed-let inside expressions is schema-only; runtime no-op.
    return imm(0)


def _lower_recur_error(cx: LowerCtx, rest: List[Ast]) -> RVal:
    raise CompileError("recur outside loop")


_SPECIAL_FORMS.update({
    "+": lower_plus,
    "-": lower_minus,
    "*": lower_times,
    "=": lower_eq,
    "if": lower_if,
    "when": lower_when,
    "let": lower_let,
    "neg": lower_neg,
    "hash2": lower_hash2,
    "merkle-verify": lower_merkle_verify,
    "load-ca": lower_load_ca,
    "store-ca": lower_store_ca,
    "select": lower_select,
    "assert": lower_assert,
    "bit?": lower_bit_pred,
    "assert-bit": lower_assert_bit,
    "assert-range": lower_assert_range,
    "safe-add": lower_safe_add,
    "safe-sub": lower_safe_sub,
    "safe-mul": lower_safe_mul,
    "divmod-q": lower_divmod_q,
    "divmod-r": lower_divmod_r,
    "mulwide-hi": lower_mulwide_hi,
    "mulwide-lo": lower_mulwide_lo,
    "muldiv": lower_muldiv_floor,
    "in-set": lower_in_set,
    "load": lower_load,
    "store": lower_store,
    "push": lower_push,
    "pop": lower_pop,
    "push*": lower_push_star,
    "pop*": lower_pop_star,
    "hex-to-bytes32": lower_hex_to_bytes32,
    "secret-arg": lower_secret_arg,
    "typed-let": _lower_typed_let_expr,
    "begin": lower_begin,
    "block": lower_block,
    "loop": lower_loop,
    "recur": _lower_recur_error,
})
