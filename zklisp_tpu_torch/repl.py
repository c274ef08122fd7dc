"""Interactive REPL (zk-lisp-cli/src/repl.rs).

Session accumulates definitions; expressions evaluate through the VM
trace.  Commands: :load :prove :verify :env :cost :help :quit, with
paren-balanced multi-line input.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

from . import frontend
from .agg import aggregate as agg
from .compiler import CompileError, compile_str, reader
from .core.pi import PublicInputsBuilder
from .prove.params import ProverOptions

HELP = """\
Commands:
  :help              show this help
  :load FILE         load definitions from a file into the session
  :save PATH         write session definitions to a file
  :env               list session definitions
  :docs              list defined names with doc comments (;; lines)
  :reset             clear the session
  :cost EXPR         estimate proving cost (levels / rows) for EXPR
  :prove EXPR        prove EXPR with the session definitions
  :verify            verify the last :prove artifact
  :quit              exit
Anything else is evaluated as a zk-lisp expression."""


def _extract_def_kinds(src: str) -> dict:
    """name -> 'fn' | 'var' for every (def ...) in src (repl.rs:779)."""
    kinds = {}
    i = 0
    while True:
        i = src.find("(def", i)
        if i < 0:
            break
        j = i + 4
        while j < len(src) and src[j].isspace():
            j += 1
        if j >= len(src):
            break
        if src[j] == "(":
            kind = "fn"
            j += 1
            while j < len(src) and src[j].isspace():
                j += 1
        else:
            kind = "var"
        start = j
        while j < len(src) and not src[j].isspace() and src[j] != ")":
            j += 1
        if j > start:
            kinds[src[start:j]] = kind
        i = j
    return kinds


def _extract_docs(src: str) -> dict:
    """Doc-comment blocks: ';;' lines preceding a (def ...) (repl.rs:826)."""
    docs = {}
    pending: List[str] = []
    for raw in src.splitlines():
        line = raw.lstrip()
        if line.startswith(";;"):
            pending.append(line.lstrip(";").lstrip())
            continue
        if not line:
            if pending:
                pending.append("")
            continue
        if line.startswith("(def "):
            if pending:
                names = list(_extract_def_kinds(raw))
                if names:
                    text = "\n".join(pending).strip()
                    if text:
                        docs[names[0]] = text
                pending.clear()
        else:
            pending.clear()
    return docs


def _print_cost(prog, rows: int, out) -> None:
    """Cost + compiler-metrics report (repl.rs:373-396, compute_cost
    repl.rs:944): per-op-class counts over the compiled program."""
    from .compiler import ops as O
    absorb_calls = absorb_elems = squeezes = merkle = 0
    for op in prog.ops:
        if isinstance(op, O.SAbsorbN):
            absorb_calls += 1
            absorb_elems += len(op.regs)
        elif isinstance(op, O.SSqueeze):
            squeezes += 1
        elif isinstance(op, (O.MerkleStepFirst, O.MerkleStep,
                             O.MerkleStepLast)):
            merkle += 1
    print(f"cost: rows={rows}, ops={len(prog.ops)}, "
          f"sponge_absorb_calls={absorb_calls}, "
          f"sponge_absorb_elems={absorb_elems}, "
          f"squeeze_calls={squeezes}, merkle_steps={merkle}",
          file=out)
    m = prog.compiler_metrics
    print(f"metrics: peak_live={m.peak_live} "
          f"reuse_dst={m.reuse_dst} su_reorders={m.su_reorders} "
          f"balanced_chains={m.balanced_chains} "
          f"mov_elided={m.mov_elided}", file=out)


class ReplSession:
    def __init__(self, device=None) -> None:
        self.defs: List[str] = []
        self.last_proof = None  # (proof, digest, rc_pi)
        self.device = device    # where :prove runs (default: the card)

    def source_with(self, expr: str) -> str:
        return "\n".join(self.defs + [expr])

    def handle(self, line: str, out=sys.stdout) -> None:
        line = line.strip()
        if not line:
            return
        if line.startswith(";"):
            # comment-only input: keep it in the session so ';;' doc
            # blocks attach to the next definition (:docs)
            self.defs.append(line)
            return
        if line in (":quit", ":q", ":exit"):
            raise EOFError
        if line in (":help", ":h"):
            print(HELP, file=out)
            return
        if line == ":env":
            for i, d in enumerate(self.defs):
                first = d.strip().splitlines()[0]
                print(f"  [{i}] {first}", file=out)
            if not self.defs:
                print("  (empty)", file=out)
            return
        if line == ":reset":
            # repl.rs:224-231: drop session definitions and docs
            self.defs.clear()
            self.last_proof = None
            print("session reset", file=out)
            return
        if line == ":docs":
            # repl.rs:233-277: list defined names with kind + doc block
            names = _extract_def_kinds("\n".join(self.defs))
            if not names:
                print("(none)", file=out)
                return
            docs = _extract_docs("\n".join(self.defs))
            for name in sorted(names):
                print(f"{names[name]}: {name}", file=out)
                if name in docs:
                    print("docs:", file=out)
                    print(docs[name], file=out)
                else:
                    print("docs: (none)", file=out)
                print(file=out)
            return
        if line.startswith(":save "):
            # repl.rs:280-323: write session definitions to a file
            path = line[6:].strip()
            if not path:
                print("error: usage: :save PATH", file=out)
                return
            if "." not in path.rsplit("/", 1)[-1]:
                path += ".zlisp"
            with open(path, "w") as f:
                f.write("\n\n".join(d.strip() for d in self.defs) + "\n")
            print(f"saved {len(self.defs)} definition(s) to {path}",
                  file=out)
            return
        if line.startswith(":load "):
            path = line[6:].strip()
            with open(path) as f:
                self.defs.append(f.read())
            print(f"loaded {path}", file=out)
            return
        if line.startswith(":cost "):
            # repl.rs:362-396 / compute_cost (repl.rs:944): run the VM
            # for the true trace length, then per-op-class cost counts
            # plus compiler metrics.
            expr = line[6:]
            from .compiler import compile_entry
            wrapped = self.source_with(f"(def (--repl-cost--) {expr})"
                                       f"\n(def (main) (--repl-cost--))")
            prog = compile_entry(wrapped, [])
            pi = PublicInputsBuilder(prog).build()
            _print_cost(prog, frontend.run_vm(prog, pi).trace_len, out)
            return
        if line.startswith(":prove "):
            # repl.rs:324-460: wrap the expression into a main entry
            # (compile_entry) so the result materializes into r0
            expr = line[7:]
            from .compiler import compile_entry
            wrapped = self.source_with(
                f"(def (--repl-expr--) {expr})"
                f"\n(def (main) (--repl-expr--))")
            prog = compile_entry(wrapped, [])
            pi = PublicInputsBuilder(prog).build()
            # repl.rs:364-396: report cost + compiler metrics before
            # proving (rows from a VM run)
            _print_cost(prog, frontend.run_vm(prog, pi).trace_len, out)
            opts = ProverOptions(queries=16, blowup=8, grind=0,
                                 min_security_bits=0)
            t0 = time.time()
            proof, digest, rc_pi = agg.prove_chain(prog, pi, opts,
                                                   device=self.device)
            self.last_proof = (proof, digest, rc_pi)
            print(f"proved in {time.time() - t0:.1f}s; "
                  f"digest=0x{digest.hex()}", file=out)
            return
        if line == ":verify":
            if self.last_proof is None:
                print("nothing proved yet", file=out)
                return
            proof, _, rc_pi = self.last_proof
            agg.verify_agg(proof, rc_pi)
            print("verified OK", file=out)
            return
        if line.startswith("(def") or line.startswith("(typed-") \
                or line.startswith("(deftype"):
            # definition: validate then add to session
            compile_str(self.source_with("(def (repl-probe-zz) 0)")
                        if False else "\n".join(self.defs + [line]))
            self.defs.append(line)
            print("ok", file=out)
            return
        # expression: wrap into (def (main) EXPR) so the result is
        # materialized into r0 even when it constant-folds
        # (repl.rs wraps sessions the same way)
        from .compiler import compile_entry
        wrapped = self.source_with(f"(def (--repl-expr--) {line})"
                                   f"\n(def (main) (--repl-expr--))")
        prog = compile_entry(wrapped, [])
        pi = PublicInputsBuilder(prog).build()
        res = frontend.run_vm(prog, pi)
        print(res.value, file=out)


def _paren_balance(s: str) -> int:
    bal = 0
    in_str = False
    i = 0
    while i < len(s):
        c = s[i]
        if in_str:
            if c == "\\":
                i += 1
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == ";":
            while i < len(s) and s[i] != "\n":
                i += 1
        elif c == "(":
            bal += 1
        elif c == ")":
            bal -= 1
        i += 1
    return bal


def run_repl(device=None) -> None:
    session = ReplSession(device)
    print("zklisp-tpu-torch REPL — :help for commands")
    buf = ""
    while True:
        try:
            prompt = "... " if buf else ">>> "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            return
        buf = (buf + "\n" + line) if buf else line
        if _paren_balance(buf) > 0:
            continue
        try:
            session.handle(buf)
        except EOFError:
            return
        except (CompileError, Exception) as e:  # noqa: BLE001
            print(f"error: {e}")
        buf = ""
