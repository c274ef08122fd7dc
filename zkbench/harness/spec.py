"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout names the cells; everything
that belongs to one configuration, traffic mix, per-layer metric or
kernel lies in a file of its own, which `Spec` finds by that name:

    configs     the configuration's `file` in BENCHMARK.json
    traffic     <dir>/traffic/<traffic>.json
    metrics     <dir>/metrics/<metric name>.py, a module with read(ctx)
    work        <dir>/work/<kernel>.py, the kernel's least time

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; none of this code needs an edit.  `dirs` lets a
test add a folder of its own to the search.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(Exception):
    pass


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, bench: dict | None = None, root: Path = ROOT,
                 dirs: tuple = ()) -> None:
        self.root = Path(root)
        if bench is None:
            bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = bench
        self.dirs = tuple(Path(d) for d in dirs) + (BENCH_DIR,)

    def _find(self, kind: str, name: str, ext: str) -> Path:
        for d in self.dirs:
            p = d / kind / (name + ext)
            if p.is_file():
                return p
        raise SpecError(f"no {kind} file for {name!r}")

    @staticmethod
    def _by_name(entries, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise SpecError(f"no {what} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._by_name(self.bench["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._by_name(self.bench["configs"], name, "config")
        cfg = json.loads((self.root / entry["file"]).read_text())
        cfg.setdefault("name", name)
        return cfg

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def metric(self, name: str):
        """The module whose read(ctx) gives the per-layer metric."""
        return _load_module(self._find("metrics", name, ".py"),
                            "zkbench_metric_" + name.replace(".", "_"))

    def work(self, kernel: str):
        return _load_module(self._find("work", kernel, ".py"),
                            "zkbench_work_" + kernel)

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])]
