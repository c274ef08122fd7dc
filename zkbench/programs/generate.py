"""The one generator of the benchmark's jobs: a frozen program text with
its size knob and its data drawn from the seed.

A configuration's `program` names a template (a frozen copy of the
upstream example under zkbench/programs/), the knob that scales it
(`{"pattern": "(def BATCH {})", "frozen": 15}`: the text that holds the
knob's value in the template) and the data items, each a pattern, the
value the template holds, and the range [lo, hi) a seed draws it from.
The ranges are chosen so that no drawn value can make an operation fail
(rollup-bench: balance >= 2^30 > BATCH * (amount + fee) for any BATCH
up to 2^9, so no safe-sub underflows).

The seed changes data, never shape: every job of a cell has the same op
count and so the same trace rows and segments.  The knob is calibrated
once from the template, as the port's rollup calibration does
(zklisp_tpu_torch/workload.py): the largest value whose program has at
most rows / 32 ops, 32 trace rows being one op.
"""

from __future__ import annotations

import random
from pathlib import Path

ROWS_PER_OP = 32
ROOT = Path(__file__).resolve().parents[2]


class GenError(Exception):
    pass


def _sub(text: str, pattern: str, old, new) -> str:
    before = pattern.format(old)
    if text.count(before) != 1:
        raise GenError(f"{before!r} occurs {text.count(before)} times "
                       "in the template")
    return text.replace(before, pattern.format(new))


def template(program: dict, root: Path = ROOT) -> str:
    return (Path(root) / program["template"]).read_text()


def render(program: dict, text: str, knob: int, data: dict) -> str:
    """The template with the knob and every data item set."""
    k = program["knob"]
    text = _sub(text, k["pattern"], k["frozen"], knob)
    for name, item in program["data"].items():
        text = _sub(text, item["pattern"], item["frozen"], data[name])
    return text


def draw(program: dict, seed: int, job: int) -> dict:
    """The data of job number `job` (-1: the warm-up job) of a run."""
    rng = random.Random(f"zkbench:{seed}:{job}")
    return {name: rng.randrange(item["range"][0], item["range"][1])
            for name, item in sorted(program["data"].items())}


def frozen_data(program: dict) -> dict:
    return {n: item["frozen"] for n, item in program["data"].items()}


def calibrate(program: dict, rows: int, op_count, text: str) -> int:
    """Largest knob value whose program has at most rows / 32 ops;
    `op_count(source) -> int` compiles a source."""
    limit, data = rows // ROWS_PER_OP, frozen_data(program)

    def fits(k: int) -> bool:
        return op_count(render(program, text, k, data)) <= limit

    hi = 1                      # doubling first: big knobs compile slowly
    while hi <= limit and fits(hi):
        hi *= 2
    lo, hi, best = hi // 2 + 1, min(hi - 1, limit), hi // 2 or None
    while lo <= hi:
        mid = (lo + hi) // 2
        if fits(mid):
            best, lo = mid, mid + 1
        else:
            hi = mid - 1
    if best is None:
        raise GenError(f"no program of this template fits {rows} rows")
    return best


def trace_rows(n_ops: int) -> int:
    """Rows of the trace of a program of n_ops ops: a power of two."""
    return ROWS_PER_OP * (1 << max(0, (n_ops - 1).bit_length()))


class Jobs:
    """The jobs of one run of a cell: job k's source and what the
    reference needs to know of it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, op_count,
                 root: Path = ROOT) -> None:
        self.program = cfg["program"]
        self.text = template(self.program, root)
        self.seed = seed
        self.knob = calibrate(self.program, traffic["rows"], op_count,
                              self.text)
        self.semantics = cfg["semantics"]
        self.constants = dict(cfg.get("constants", {}))

    def job(self, k: int) -> dict:
        data = draw(self.program, self.seed, k)
        params = dict(self.constants, **data)
        params[self.program["knob"]["name"]] = self.knob
        return {"source": render(self.program, self.text, self.knob, data),
                "kind": self.semantics, "params": params}
