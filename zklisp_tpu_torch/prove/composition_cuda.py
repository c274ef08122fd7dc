"""The constraint composition on the card: the wrappers of
csrc/composition.cu and their launch counts.

Two entry points, each one launch, both into the (..., N, 8) int32 sum
that `stark_device.quotient_comp` takes:

  generic  the recorded generic constraints (prove/cvm.py), interpreted
           from their register form (`cvm.compile_registers`); called by
           `cvm.execute` for a CUDA tensor.
  scan     the Poseidon 27x12 and ROM 27x3 round blocks, added into the
           generic sum; called by `composition_device.eval_scan_blocks`
           for a CUDA tensor.

The plain PyTorch versions are the executors in prove/cvm.py
(`execute_stack`, `execute_leveled`) and composition_device's
`eval_scan_blocks_plain`; a CPU tensor takes them, a CUDA tensor the
kernel or an error: there is no fallback.  Each wrapper reads the LDE
through its strides (the wave's strided sub-domain view, no copy) and
checks what the kernel cannot take.  The bound and the design are in the
note at the top of the source.

The library is built with nvcc for sm_90a from the source in this
package at first use, into the git-ignored zklisp_tpu_torch/build/, and
loaded with ctypes (cuda_build.KernelLibrary).
"""

from __future__ import annotations

import ctypes

import numpy as _np
import torch

from ..cuda_build import KernelLibrary
from ..field import limb

_KERNEL = KernelLibrary("composition")
build_info = _KERNEL.build_info

ROUNDS = 27                 # csrc/composition.cu: ZKL_ROUNDS
GENERIC_THREADS = 128       # rows per block of the generic kernel, at most
SMEM_MAX = 227 * 1024       # dynamic shared memory a block may have

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _declare(lib) -> None:
    lib.composition_generic_launch.argtypes = [
        _P, _L, _L, _L, _I, _I, _I, _P, _I, _P, _P, _L, _P, _I, _P, _I, _I,
        _P, _P]
    lib.composition_generic_launch.restype = _I
    lib.composition_scan_launch.argtypes = [
        _P, _L, _L, _L, _I, _I, _I, _P, _I, _P, _L, _P, _P, _I, _P, _P]
    lib.composition_scan_launch.restype = _I


def load():
    """Build (when missing or older than the source) and load the kernel
    library; raises when it cannot be built or loaded."""
    return _KERNEL.load(_declare)


def generic_threads(n_regs: int) -> int:
    """Rows per block of the generic kernel: 128, halved while the block's
    register file (n_regs x 16 B a row) would not fit in shared memory."""
    t = GENERIC_THREADS
    while t > 32 and n_regs * t * 16 > SMEM_MAX:
        t //= 2
    if n_regs * t * 16 > SMEM_MAX:
        raise ValueError(f"composition: {n_regs} registers a row do not fit "
                         "in shared memory")
    return t


_DEVICE_CACHE: dict = {}


def _cached(key, make):
    out = _DEVICE_CACHE.get(key)
    if out is None:
        out = make()
        _DEVICE_CACHE[key] = out
    return out


def program_tensors(rp, device):
    """(code (I, 4) int32, consts (K, 4) int32 words) of a register
    program on `device`, uploaded once per program content and device."""
    def make():
        consts = rp.consts.astype(_np.uint32).view(_np.int32)
        return (torch.from_numpy(_np.ascontiguousarray(rp.code)).to(device),
                torch.from_numpy(_np.ascontiguousarray(consts)).to(device))
    return _cached(("program", rp.sig, str(device)), make)


def _lde_view(lde):
    """(lde as (S, w, N, 8), its strides in int32 elements), checked."""
    if lde.device.type != "cuda":
        raise ValueError(f"composition: unsupported device {lde.device}")
    if lde.dtype != torch.int32:
        raise TypeError(f"composition: expected int32, got {lde.dtype}")
    if lde.dim() not in (3, 4) or lde.shape[-1] != limb.NLIMB:
        raise ValueError(f"composition: expected (S, w, N, 8) or (w, N, 8),"
                         f" got {tuple(lde.shape)}")
    l4 = lde if lde.dim() == 4 else lde[None]
    st = l4.stride()
    if st[3] != 1 or any(v % 4 for v in st[:3]) or l4.data_ptr() % 16:
        raise ValueError("composition: each value's 8 digits must be "
                         "contiguous and 16-byte aligned")
    return l4, st[:3]


def _alphas(alphas, S: int):
    """(alphas (.., nc, 8) contiguous, segment stride in int32 elements)."""
    a = alphas.contiguous()
    if a.dim() == 2:
        return a, 0
    if a.dim() != 3 or a.shape[0] != S:
        raise ValueError(f"composition: alphas {tuple(alphas.shape)} for "
                         f"{S} segments")
    return a, a.stride(0)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"composition {what} launch failed: CUDA error "
                           f"{err}")


def generic(rp, lde, per_p, p_last, alphas, blowup: int):
    """sum_i alpha_i * C_i of the generic constraints over every row of
    every segment: one launch of composition_generic_kernel (counted in
    `generic.launches`).  Same contract as
    `cvm.execute`: lde (S, w, N, 8) or (w, N, 8), any strides with each
    value's digits contiguous; per_p (n_perp, period, 8); p_last (N, 8);
    alphas (S, nc, 8) or (nc, 8).  Returns (S, N, 8) or (N, 8)."""
    l4, (sS, sW, sN) = _lde_view(lde)
    S, N = l4.shape[0], l4.shape[2]
    dev = l4.device
    lib = load()
    code, consts = program_tensors(rp, dev)
    per = per_p.contiguous()
    pl = p_last.contiguous()
    al, aS = _alphas(alphas, S)
    out = torch.empty((S, N, limb.NLIMB), dtype=torch.int32, device=dev)
    threads = generic_threads(rp.n_regs)
    with torch.cuda.device(dev):
        err = lib.composition_generic_launch(
            l4.data_ptr(), sS, sW, sN, S, N, blowup, per.data_ptr(),
            per.shape[1], pl.data_ptr(), al.data_ptr(), aS, code.data_ptr(),
            code.shape[0], consts.data_ptr(), rp.n_regs, threads,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(err, "generic")
    generic.launches += 1
    return out if lde.dim() == 4 else out[0]


generic.launches = 0     # kernel launches since the last reset


def scan_tables(air, specs, device):
    """(tab (558, 8) int32 digits: Poseidon MDS, Poseidon rc, ROM MDS,
    ROM rc; meta (18,) int32: the Poseidon and ROM alpha offsets, -1 for
    a block `specs` leaves out, then pose_active, the 12 lanes and the 3
    ROM lanes) of an AIR on `device`, uploaded once per content and
    device."""
    offs = dict(specs)
    if set(offs) - {"poseidon", "rom"} or not offs:
        raise ValueError(f"composition: scan specs {specs}")
    c = air.cols
    meta = ([offs.get("poseidon", -1), offs.get("rom", -1), c.pose_active]
            + [c.lane_index(i) for i in range(12)]
            + [c.rom_s_index(i) for i in range(3)])
    vals = [v for row in air.poseidon_mds for v in row]
    vals += [v for row in air.poseidon_rc for v in row]
    vals += [v for row in air.rom_mds for v in row]
    vals += [v for row in air.rom_rc for v in row]
    assert len(vals) == 144 + ROUNDS * 12 + 9 + ROUNDS * 3, len(vals)
    return _cached(("scan", tuple(vals), tuple(meta), str(device)), lambda: (
        limb.from_ints(vals, device).contiguous(),
        torch.tensor(meta, dtype=torch.int32, device=device)))


def scan(air, specs, lde, shift: int, gates, alphas, acc=None):
    """acc + the Poseidon / ROM round-block terms of `specs` ((kind, alpha
    offset) pairs) over every row of every segment: one launch of
    composition_scan_kernel (counted in `scan.launches`), which adds into
    `acc` in place when given (the generic sum) and returns it, else into
    a new tensor.  lde and alphas as in `generic`; gates (27, period, 8)
    one period of each round gate; shift: the next row's offset."""
    l4, (sS, sW, sN) = _lde_view(lde)
    S, N = l4.shape[0], l4.shape[2]
    dev = l4.device
    lib = load()
    tab, meta = scan_tables(air, specs, dev)
    g = gates.contiguous()
    if tuple(g.shape[:1]) != (ROUNDS,) or N % g.shape[1]:
        raise ValueError(f"composition: gates {tuple(gates.shape)} for "
                         f"{N} rows")
    al, aS = _alphas(alphas, S)
    if acc is None:
        out, accumulate = torch.empty((S, N, limb.NLIMB), dtype=torch.int32,
                                      device=dev), 0
    else:
        out = acc if acc.dim() == 3 else acc[None]
        if tuple(out.shape) != (S, N, limb.NLIMB) or not out.is_contiguous():
            raise ValueError(f"composition: acc {tuple(acc.shape)}")
        accumulate = 1
    with torch.cuda.device(dev):
        err = lib.composition_scan_launch(
            l4.data_ptr(), sS, sW, sN, S, N, shift, g.data_ptr(), g.shape[1],
            al.data_ptr(), aS, tab.data_ptr(), meta.data_ptr(), accumulate,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(err, "scan")
    scan.launches += 1
    if acc is not None:
        return acc
    return out if lde.dim() == 4 else out[0]


scan.launches = 0        # kernel launches since the last reset
