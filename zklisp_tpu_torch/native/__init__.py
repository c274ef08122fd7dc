"""ctypes loader for the native f128 host kernels.

Compiles native/f128_native.cpp with g++ on first use into the package's
git-ignored build directory (zklisp_tpu_torch/build/).  Callers check
`available()` and use the pure-Python path when the toolchain or
platform is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "f128_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(BUILD_DIR, "f128_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build(dst: str = _SO) -> bool:
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", dst,
             _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


_SYMBOLS = ("f128_mul_batch", "f128_add_batch", "rom_chain",
            "rom_chain_from", "poseidon12_levels", "poseidon12_batch")


def _open(path: str = _SO):
    """CDLL-open `path` and check every required symbol is exported."""
    try:
        lib = ctypes.CDLL(path)
        for name in _SYMBOLS:
            getattr(lib, name)
        return lib
    except (OSError, AttributeError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        lib = _open()
        if lib is None:
            # A stale or foreign-platform binary (e.g. restored from git
            # with a fresh mtime) lacks newer symbols.  dlopen caches by
            # path, so rebuild under a unique temp name, load that, and
            # install it as the canonical .so for the next process.
            tmp = _SO + ".rebuild.%d" % os.getpid()
            if not _build(tmp):
                return None
            lib = _open(tmp)
            if lib is None:
                return None
            try:
                os.replace(tmp, _SO)
            except OSError:
                pass
        lib.f128_mul_batch.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_size_t]
        lib.f128_add_batch.argtypes = lib.f128_mul_batch.argtypes
        lib.rom_chain.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_size_t, ctypes.c_char_p]
        lib.rom_chain_from.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_size_t, ctypes.c_char_p,
                                       ctypes.c_char_p]
        lib.poseidon12_levels.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_size_t,
                                          ctypes.c_size_t, ctypes.c_char_p]
        lib.poseidon12_batch.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_size_t, ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    if os.environ.get("ZKL_NO_NATIVE"):
        return False
    return _load() is not None


def _pack(vals: Sequence[int]) -> bytes:
    return b"".join(int(v).to_bytes(16, "little") for v in vals)


def _unpack(buf: bytes) -> List[int]:
    return [int.from_bytes(buf[i:i + 16], "little")
            for i in range(0, len(buf), 16)]


def mul_batch(a: Sequence[int], b: Sequence[int]) -> List[int]:
    lib = _load()
    n = len(a)
    out = ctypes.create_string_buffer(16 * n)
    lib.f128_mul_batch(_pack(a), _pack(b), out, n)
    return _unpack(out.raw)


def rom_chain(enc_pairs: Sequence[int], mds3_flat: Sequence[int],
              rc3_flat: Sequence[int], levels: int,
              rounds: int) -> List[int]:
    """Returns levels*(rounds+1)*3 state values (flat)."""
    lib = _load()
    out = ctypes.create_string_buffer(16 * 3 * (rounds + 1) * levels)
    lib.rom_chain(_pack(enc_pairs), _pack(mds3_flat), _pack(rc3_flat),
                  levels, rounds, out)
    return _unpack(out.raw)


def rom_chain_from(enc_pairs: Sequence[int], mds3_flat: Sequence[int],
                   rc3_flat: Sequence[int], levels: int, rounds: int,
                   s0_init: int) -> List[int]:
    """rom_chain with a caller-provided starting s0 lane."""
    lib = _load()
    out = ctypes.create_string_buffer(16 * 3 * (rounds + 1) * levels)
    lib.rom_chain_from(_pack(enc_pairs), _pack(mds3_flat),
                       _pack(rc3_flat), levels, rounds,
                       _pack([s0_init]), out)
    return _unpack(out.raw)


def poseidon12_levels(inputs_flat: Sequence[int], mds_flat: Sequence[int],
                      rc_flat: Sequence[int], levels: int,
                      rounds: int) -> List[int]:
    """Returns levels*(rounds+1)*12 state values (flat)."""
    lib = _load()
    out = ctypes.create_string_buffer(16 * 12 * (rounds + 1) * levels)
    lib.poseidon12_levels(_pack(inputs_flat), _pack(mds_flat),
                          _pack(rc_flat), levels, rounds, out)
    return _unpack(out.raw)


def poseidon12_batch(inputs_flat: Sequence[int], mds_flat: Sequence[int],
                     rc_flat: Sequence[int], batch: int,
                     rounds: int) -> List[int]:
    """batch*12 input states -> batch*12 final states (flat)."""
    lib = _load()
    out = ctypes.create_string_buffer(16 * 12 * batch)
    lib.poseidon12_batch(_pack(inputs_flat), _pack(mds_flat),
                         _pack(rc_flat), batch, rounds, out)
    return _unpack(out.raw)


def poseidon12_batch_raw(inputs: bytes, mds: bytes, rc: bytes,
                         batch: int, rounds: int) -> bytes:
    """Raw-bytes variant (16-byte LE elements): batch*12 states in/out."""
    lib = _load()
    out = ctypes.create_string_buffer(16 * 12 * batch)
    lib.poseidon12_batch(inputs, mds, rc, batch, rounds, out)
    return out.raw
