"""Build-at-first-use of the port's hand-written CUDA kernels.

Each kernel is one source under csrc/ with a plain C launch function.
`KernelLibrary(name)` compiles csrc/<name>.cu with nvcc for sm_90a into
the git-ignored zklisp_tpu_torch/build/lib<name>.so (when missing or
older than the source) and loads it with ctypes.  The build writes a
temporary file and renames it into place under a file lock, so processes
that start together (the multi-process prover's workers) build once and
never load a half-written library.  A build or load that fails raises:
no caller falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return exe


class KernelLibrary:
    """One kernel source and its shared library."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.source = os.path.join(_PKG, "csrc", name + ".cu")
        self.lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.build_info = {"seconds": None, "log": ""}
        self._lock = threading.Lock()
        self._lib = None

    def build_command(self, out: str | None = None) -> list:
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", out or self.lib_path, self.source]

    def _stale(self) -> bool:
        return (not os.path.exists(self.lib_path)
                or os.path.getmtime(self.lib_path)
                < os.path.getmtime(self.source))

    def _build(self) -> None:
        """nvcc into a temporary file, renamed over the library, while
        holding the library's lock file (another process may be building
        it: once the lock is ours, the library may be fresh already)."""
        with open(self.lib_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not self._stale():
                return
            tmp = os.path.join(BUILD_DIR,
                               f"lib{self.name}.{os.getpid()}.tmp.so")
            t0 = time.time()
            try:
                res = subprocess.run(self.build_command(tmp),
                                     capture_output=True, text=True,
                                     timeout=600)
                self.build_info["seconds"] = time.time() - t0
                self.build_info["log"] = (res.stdout + res.stderr).strip()
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {self.name}.cu:\n"
                                       + self.build_info["log"])
                os.replace(tmp, self.lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    def load(self, declare) -> ctypes.CDLL:
        """Build when needed, load, and run `declare(lib)` once to set the
        launch function's argtypes; raises when either step fails."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            os.makedirs(BUILD_DIR, exist_ok=True)
            if self._stale():
                self._build()
            lib = ctypes.CDLL(self.lib_path)
            declare(lib)
            self._lib = lib
            return lib
