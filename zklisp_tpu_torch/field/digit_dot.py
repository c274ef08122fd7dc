"""Exact product of 8-bit digit planes: the hand-written CUDA kernel, its
wrapper, its plain PyTorch version and its launch counter.

    C[m, n] = sum_k A[m, k] * Wt[n, k]     A (M, K), Wt (N, K) 8-bit,
                                           C (M, N) int32

Replaces the Pallas probe kernel of the JAX package
(scripts/exp_pallas_int8_dot.py, `kernel` inside `make`): one dot of
8-bit planes with 32-bit accumulation inside a kernel — the product
inside every `field_matmul` of field/mxu.py.  The kernel is
csrc/digit_dot.cu, built for Hopper: a producer warp feeds a ring of
shared-memory stages with TMA loads guarded by mbarriers, two consumer
warpgroups run `wgmma.mma_async` on the integer tensor cores (u8 x u8,
or s8 x s8 for int8 operands), and the sums leave through shared memory
as coalesced 16-byte stores.  It is bound by operations at the NTT
shapes and by bytes at the DEEP shape; see the note at the top of the
source.  Its build needs nothing beyond nvcc: the TMA descriptors come
from the driver through `cudaGetDriverEntryPoint`, and the first launch
of each tile on a device sets the kernel's dynamic shared-memory limit
(up to 193 KB).

The weights come TRANSPOSED, (N, K) with K contiguous: 8-bit `wgmma`
reads both operands along K, and every caller's weights are constants it
lays out once.  The callers keep K * 255^2 < 2^31, so signed 32-bit
accumulation is exact.

`digit_dot` takes the plain version only for a CPU tensor.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as _F

from ..cuda_build import KernelLibrary

_KERNEL = KernelLibrary("digit_dot")
SOURCE = _KERNEL.source
build_info = _KERNEL.build_info

K_ALIGN = 32          # the mma's depth: K is zero-padded to a multiple
                      # (which also makes each row 16-byte aligned, as the
                      # TMA unit needs)
MAX_K = (1 << 31) // (255 * 255)     # 33,025: K * 255^2 < 2^31


def _declare(lib) -> None:
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.digit_dot_launch.argtypes = [ptr, ptr, ptr, num, num, num, num, ptr]
    lib.digit_dot_launch.restype = num
    # the port's first kernel, kept in the source as a yardstick for
    # chip_smoke.py; the wrapper never calls it
    lib.digit_dot_launch_mma_sync.argtypes = [ptr, ptr, ptr, num, num, num,
                                              num, ptr]
    lib.digit_dot_launch_mma_sync.restype = num


def load():
    """Build (when missing or older than the source) and load the kernel
    library; raises when it cannot be built or loaded."""
    return _KERNEL.load(_declare)


def digit_dot_plain(a, wt):
    """The same function in plain PyTorch, on either device: a float64
    matrix product.  It is exact: every digit is below 2^8 in magnitude
    and K <= MAX_K, so every partial sum stays below 2^31 < 2^53 and
    float64 holds each one without rounding.  (PyTorch has no integer
    matrix product on CUDA, and its int64 one on the CPU is ~50x slower
    than this.)"""
    return (a.to(torch.float64) @ wt.to(torch.float64).T).to(torch.int32)


def _check(a, wt) -> bool:
    """Validate the operands; returns whether they are signed."""
    if a.dim() != 2 or wt.dim() != 2 or a.shape[1] != wt.shape[1]:
        raise ValueError(f"digit_dot: expected (M, K) and (N, K), got "
                         f"{tuple(a.shape)} and {tuple(wt.shape)}")
    if a.dtype != wt.dtype or a.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"digit_dot: expected two uint8 or two int8 "
                        f"operands, got {a.dtype} and {wt.dtype}")
    if a.device != wt.device:
        raise ValueError(f"digit_dot: operands on {a.device} and "
                         f"{wt.device}")
    if not 0 < a.shape[1] <= MAX_K:
        raise ValueError(f"digit_dot: K = {a.shape[1]} is outside 1.."
                         f"{MAX_K}, the 32-bit accumulation bound")
    if max(a.shape[0], wt.shape[0]) >= 1 << 31:
        raise ValueError("digit_dot: M and N must fit 32-bit integers")
    return a.dtype == torch.int8


def operands(a, wt):
    """The operands as the kernel takes them: K zero-padded to a multiple
    of K_ALIGN, rows contiguous, base addresses 16-byte aligned (copied
    when not).  Returns (a, wt, padded K)."""
    K = a.shape[1]
    pad = -K % K_ALIGN
    if pad:
        a = _F.pad(a, (0, pad))
        wt = _F.pad(wt, (0, pad))
    a = a.contiguous()
    wt = wt.contiguous()
    if a.data_ptr() % 16:
        a = a.clone()
    if wt.data_ptr() % 16:
        wt = wt.clone()
    return a, wt, K + pad


def launch_error(err: int) -> str:
    """What a non-zero return of the C launch functions means."""
    if err < 0:
        return f"cuTensorMapEncodeTiled failed: CUresult {-err}"
    return f"CUDA error {err}"


def digit_dot(a, wt):
    """C = A @ Wt^T, exact, int32: a (M, K) and wt (N, K) of one 8-bit
    dtype (uint8 digits, or int8).

    CUDA tensors: one launch of the digit_dot kernel (counted in
    `digit_dot.launches`; K is zero-padded to a multiple of 32 first).
    CPU tensors: the plain version."""
    signed = _check(a, wt)
    if a.device.type == "cpu":
        return digit_dot_plain(a, wt)
    if a.device.type != "cuda":
        raise ValueError(f"digit_dot: unsupported device {a.device}")
    M, K = a.shape
    N = wt.shape[0]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out                       # nothing to launch, nothing counted
    lib = load()
    a, wt, k_padded = operands(a, wt)
    if digit_dot.shape_log is not None:
        digit_dot.shape_log.append((M, K, N))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.digit_dot_launch(a.data_ptr(), wt.data_ptr(),
                                   out.data_ptr(), M, N, k_padded,
                                   int(signed), stream)
    if err != 0:
        raise RuntimeError(f"digit_dot launch failed: {launch_error(err)}")
    digit_dot.launches += 1
    return out


digit_dot.launches = 0        # kernel launches since the last reset
digit_dot.shape_log = None    # set to a list to record each launch's (M, K, N)
