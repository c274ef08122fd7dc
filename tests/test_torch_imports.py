"""The port (zklisp_tpu_torch, chip_smoke.py) imports torch and numpy,
never jax and nothing of zklisp_tpu."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zklisp_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        if os.path.basename(d) in ("build", "__pycache__"):
            continue
        files += [os.path.join(d, n) for n in sorted(names)
                  if n.endswith(".py")]
    return sorted(files)


def _module_names():
    out = []
    for f in _port_files():
        rel = os.path.relpath(f, ROOT)
        if not rel.startswith("zklisp_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[:-9]
        out.append(mod)
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zklisp_tpu")


@pytest.mark.parametrize(
    "path", [os.path.relpath(f, ROOT) for f in _port_files()])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_jax():
    """Import every module of the port in a fresh process: none of them
    pulls jax (or the JAX package) into sys.modules."""
    mods = _module_names()
    assert len(mods) > 30
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zklisp_tpu')]\n"
        "assert not bad, bad\n"
        "print('imported', len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"imported {len(mods)}" in res.stdout


def test_default_device_raises_without_a_card():
    """With the default device and no GPU the entry points raise; they
    run on the CPU only with device='cpu'."""
    import torch

    from zklisp_tpu_torch import convert, device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        device.resolve(None)
    assert device.resolve("cpu").type == "cpu"
    import numpy as np
    with pytest.raises(RuntimeError):
        convert.limbs_to_torch(np.zeros((2, 8), np.uint32))
