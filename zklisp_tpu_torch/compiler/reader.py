"""Lexer and parser for the zk-lisp DSL.

Mirrors zk-lisp-compiler/src/lib.rs:259-491: line comments with `;`,
string literals with escapes (\\" \\\\ \\n \\r \\t \\xNN), unsigned
integer literals, symbols, `'x` -> (quote x), MAX_TOKENS=200_000 and
parse depth limit 1024.

AST representation: atoms are tuples ("int", v) / ("sym", s) / ("str", s);
lists are Python lists of AST nodes.
"""

from __future__ import annotations

from typing import List, Tuple, Union

from .errors import CompileError, LexError, ParseError

MAX_TOKENS = 200_000
MAX_PARSE_DEPTH = 1_024

Ast = Union[Tuple[str, object], list]

LPAREN, RPAREN, QUOTE, EOF = "(", ")", "'", "eof"

_SYM_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_+-*=<>:")
_SYM_CONT = _SYM_START | set("0123456789/:?")


def is_sym_start(c: str) -> bool:
    return c in _SYM_START


def is_sym_continue(c: str) -> bool:
    return c in _SYM_CONT


def lex(src: str) -> List[tuple]:
    out: List[tuple] = []
    i, n = 0, len(src)
    while i < n:
        ch = src[i]
        if ch == "(":
            out.append(("lparen",)); i += 1
        elif ch == ")":
            out.append(("rparen",)); i += 1
        elif ch == "'":
            out.append(("quote",)); i += 1
        elif ch == ";":
            while i < n and src[i] != "\n":
                i += 1
        elif ch == '"':
            i += 1
            buf = []
            while True:
                if i >= n:
                    raise ParseError("parse: unexpected EOF")
                c2 = src[i]
                if c2 == '"':
                    i += 1
                    break
                if c2 == "\\":
                    i += 1
                    if i >= n:
                        raise ParseError("parse: unexpected EOF")
                    e = src[i]
                    if e == '"':
                        buf.append('"'); i += 1
                    elif e == "\\":
                        buf.append("\\"); i += 1
                    elif e == "n":
                        buf.append("\n"); i += 1
                    elif e == "r":
                        buf.append("\r"); i += 1
                    elif e == "t":
                        buf.append("\t"); i += 1
                    elif e == "x":
                        i += 1
                        if i + 1 >= n:
                            raise ParseError("parse: unexpected EOF")
                        try:
                            val = int(src[i:i + 2], 16)
                        except ValueError:
                            raise LexError(src[i], i)
                        buf.append(chr(val))
                        i += 2
                    else:
                        raise LexError(e, i)
                else:
                    buf.append(c2)
                    i += 1
            out.append(("str", "".join(buf)))
        elif ch in " \n\r\t":
            i += 1
        elif ch.isdigit():
            j = i
            while j < n and src[j].isdigit():
                j += 1
            v = int(src[i:j])
            if v >= 1 << 64:
                raise LexError(ch, i)
            out.append(("int", v))
            i = j
        elif is_sym_start(ch):
            j = i
            while j < n and is_sym_continue(src[j]):
                j += 1
            out.append(("sym", src[i:j]))
            i = j
        else:
            raise LexError(ch, i)

    if len(out) > MAX_TOKENS:
        raise CompileError("limit: too many tokens")
    out.append(("eof",))
    return out


def parse(tokens: List[tuple]) -> List[Ast]:
    pos = [0]

    def peek():
        return tokens[pos[0]]

    def pop():
        t = tokens[pos[0]]
        pos[0] += 1
        return t

    def parse_one(depth: int) -> Ast:
        if depth > MAX_PARSE_DEPTH:
            raise CompileError("limit: parse depth exceeded")
        t = pop()
        tag = t[0]
        if tag == "lparen":
            items: list = []
            while True:
                nxt = peek()[0]
                if nxt == "rparen":
                    pop()
                    break
                if nxt == "eof":
                    raise ParseError("parse: unexpected EOF")
                items.append(parse_one(depth + 1))
            return items
        if tag == "quote":
            return [("sym", "quote"), parse_one(depth + 1)]
        if tag == "rparen":
            raise ParseError("parse: unmatched ')'")
        if tag == "eof":
            raise ParseError("parse: unexpected EOF")
        return t  # int / sym / str atom

    forms: List[Ast] = []
    while peek()[0] != "eof":
        forms.append(parse_one(0))
    return forms


# --- AST helpers -----------------------------------------------------------

def is_sym(ast: Ast, name: str | None = None) -> bool:
    return (isinstance(ast, tuple) and ast[0] == "sym"
            and (name is None or ast[1] == name))


def is_int(ast: Ast) -> bool:
    return isinstance(ast, tuple) and ast[0] == "int"


def is_str(ast: Ast) -> bool:
    return isinstance(ast, tuple) and ast[0] == "str"


def sym(name: str) -> Ast:
    return ("sym", name)


def intlit(v: int) -> Ast:
    return ("int", v)
