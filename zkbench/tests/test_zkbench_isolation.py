"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the port: it is plain
Python, NumPy and PyTorch."""

import ast
import subprocess
import sys
from pathlib import Path

from zkbench.harness.spec import ROOT

BENCH = ROOT / "zkbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "zklisp_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    mods = ["zkbench.run", "zkbench.control", "zkbench.harness.job",
            "zkbench.harness.devtrace", "zkbench.harness.readings",
            "zkbench.harness.spec", "zkbench.programs.generate",
            "zkbench.reference.judge"]
    code = "\n".join(f"import {m}" for m in mods)
    code += ("\nfrom zkbench.harness.spec import Spec\ns = Spec()\n"
             "[s.metric(m['name']) for m in s.bench['per_layer']]\n"
             "[s.work(k) for k in ('poseidon12', 'digit_dot')]\n")
    loaded = _loaded(code)
    assert "zklisp_tpu_torch" in loaded           # the system under test
    assert not loaded & FORBIDDEN


def test_the_whole_name_is_compared(monkeypatch):
    from zkbench import run
    fake = type(sys)("fake")
    for name in list(sys.modules):
        if name.split(".", 1)[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "zklisp_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "zklisp_tpu_torch.fake", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "zklisp_tpu.prove", fake)
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    assert run.forbidden_modules() == ["jax", "zklisp_tpu"]


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import zkbench.reference.judge")
    assert not loaded & (FORBIDDEN | {"zklisp_tpu_torch"})


def test_the_reference_imports_only_itself_stdlib_numpy_and_torch():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for name in names:
                top = name.split(".", 1)[0]
                assert (top in sys.stdlib_module_names
                        or top in ("__future__", "numpy", "torch")), \
                    f"{path.name} imports {name}"
