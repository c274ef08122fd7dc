"""Compiler error types (mirrors zk-lisp-compiler/src/lib.rs Error enum)."""


class CompileError(Exception):
    """Generic compile error (InvalidForm and friends)."""


class LexError(CompileError):
    def __init__(self, ch: str, pos: int) -> None:
        super().__init__(f"lex: invalid char '{ch}' at {pos}")


class ParseError(CompileError):
    pass


class UnknownSymbol(CompileError):
    def __init__(self, name: str) -> None:
        super().__init__(f"lower: unknown symbol '{name}'")
        self.name = name


class RegOverflow(CompileError):
    def __init__(self, context: str) -> None:
        super().__init__(f"lower: regs exhausted (need 1, have 0) in {context}")


class RecursionError_(CompileError):
    def __init__(self, name: str) -> None:
        super().__init__(f"lower: recursion detected in call '{name}'")
