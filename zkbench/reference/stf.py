"""What each benchmark program computes, from its source's own meaning
(not from the compiled code), for the benchmark's reference.

zk-lisp unrolls `(loop :max N bindings body recur)` into N passes
(zk-lisp-compiler lower/iter.rs:166-230): every pass evaluates the body,
the first N - 1 then evaluate the recur form, which rebinds in order (a
later binding sees the new value of an earlier one), and the loop's
value is the body of the last pass.  `result(kind, params, sid)` is the
value `main` returns:

- "rollup" (examples/rollup-bench.zlisp): ACCTS accounts funded with
  `balance`; a table of BATCH transfers from account f to account t, f
  starting at 0 and t at 3, each advancing by one modulo ACCTS; the
  apply loop's recur applies the first BATCH - 1 of them, each debiting
  amount + fee (asserted not to underflow), crediting amount and adding
  the fee to the fees; the digest loop's recur folds the balances of
  accounts 0 .. ACCTS - 2 into a chain from 12345 by the two-input
  hash; main returns hash(fees, digest).
- "fib" (examples/fib-2pow16.zlisp): N - 1 rebinding steps a := b,
  b := a + b; main returns a.
"""

from __future__ import annotations

from . import poseidon2

P = poseidon2.P


def loop(n: int, state, body, recur):
    """The value of an unrolled zk-lisp loop of n passes."""
    value = None
    for k in range(n):
        value = body(state)
        if k < n - 1:
            state = recur(state)
    return value


def rollup(p: dict, sid: bytes) -> int:
    n, batch = p["ACCTS"], p["BATCH"]
    bal = [p["balance"]] * n
    txs = [(i % n, (3 + i) % n) for i in range(batch)]

    def apply(state):
        i, fees = state
        f, t = txs[i]
        debit = p["amount"] + p["fee"]
        if bal[f] < debit:
            raise ValueError("a transfer underflows its sender")
        bal[f] -= debit
        bal[t] += p["amount"]
        return i + 1, fees + p["fee"]

    fees = loop(batch, (0, 0), lambda s: s[1], apply)
    digest = loop(n, (0, 12345), lambda s: s[1],
                  lambda s: (s[0] + 1, poseidon2.hash2(sid, s[1],
                                                       bal[s[0]] % P)))
    return poseidon2.hash2(sid, fees % P, digest)


def fib(p: dict, sid: bytes) -> int:
    return loop(p["N"], (p["a"] % P, p["b"] % P), lambda s: s[0],
                lambda s: (s[1], (s[1] + s[1]) % P))


KINDS = {"rollup": rollup, "fib": fib}


def result(kind: str, params: dict, sid: bytes) -> int:
    return KINDS[kind](params, sid)
