"""Poseidon2 t=12 permutation: the hand-written CUDA kernel, its wrapper,
its plain PyTorch version and its launch counter.

Replaces the Pallas kernel of the JAX package
(zklisp_tpu/crypto/poseidon_pallas.py: `_permute_fn` and its inner
`kernel`, VPU and MXU-MDS lowerings alike — one function, one output).
The kernel is csrc/poseidon12.cu: a team of 12 threads carries one state
(thread k holds lane k and computes MDS row k), lanes are four 32-bit words,
products and sums are PTX carry chains, each MDS row is reduced once.  It
is bound by integer multiply-adds at large batches and by one state's
serial rounds at small ones; see the note at the top of the source.

`permute12` takes the plain version only for a CPU tensor.  For a CUDA
tensor it launches the kernel or raises: there is no fallback.

The library is built with nvcc for sm_90a from the source in this
package at first use, into the git-ignored zklisp_tpu_torch/build/, and
loaded with ctypes (cuda_build.KernelLibrary).
"""

from __future__ import annotations

import ctypes

import torch

from ..cuda_build import KernelLibrary
from ..field import limb
from . import poseidon as pos
from . import poseidon_host as _ph

_KERNEL = KernelLibrary("poseidon12")
SOURCE = _KERNEL.source
LIB_PATH = _KERNEL.lib_path
build_info = _KERNEL.build_info


def _declare(lib) -> None:
    # poseidon12_launch: the team kernel (the wrapper's); the other entry is
    # the port's first kernel, kept as a yardstick for chip_smoke.py
    for fn in (lib.poseidon12_launch, lib.poseidon12_launch_one_thread):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int


def load():
    """Build (when missing or older than the source) and load the kernel
    library; raises when it cannot be built or loaded."""
    return _KERNEL.load(_declare)


_SUITE_CACHE: dict = {}


def suite_tensors(suite_id: bytes, rounds: int, device):
    """(mds (12,12,8), rc (rounds,12,8), dom (2,8)) int32 tensors on
    `device`, cached per (suite, rounds, device)."""
    key = (bytes(suite_id), rounds, str(device))
    out = _SUITE_CACHE.get(key)
    if out is None:
        mds, rc, dom = _ph._suite_arrays(bytes(suite_id), rounds)
        out = tuple(limb.from_numpy(a, device).contiguous()
                    for a in (mds, rc, dom))
        _SUITE_CACHE[key] = out
    return out


def permute12_plain(states, suite_id: bytes, rounds: int | None = None):
    """The same function in plain PyTorch: states (..., 12, 8) int32 ->
    (..., 12, 8) after `rounds` rounds of x^3, MDS and round constant."""
    rounds = rounds if rounds is not None else pos.POSEIDON_ROUNDS
    mds, rc, _ = suite_tensors(suite_id, rounds, states.device)
    s = states
    for r in range(rounds):
        s3 = limb.cube(s)
        # out[..., i] = sum_j mds[i, j] * s3[..., j]  + rc[r, i]
        y = limb.dot(mds, s3[..., None, :, :])
        s = limb.add(y, rc[r])
    return s


def permute12(states, suite_id: bytes, rounds: int | None = None):
    """Full Poseidon2 t=12 permutation of (..., 12, 8) int32 states.

    CUDA tensor: one launch of the poseidon12 kernel (counted in
    `permute12.launches`).  CPU tensor: the plain version."""
    rounds = rounds if rounds is not None else pos.POSEIDON_ROUNDS
    if states.device.type == "cpu":
        return permute12_plain(states, suite_id, rounds)
    if states.device.type != "cuda":
        raise ValueError(f"permute12: unsupported device {states.device}")
    if states.dtype != torch.int32:
        raise TypeError(f"permute12: expected int32, got {states.dtype}")
    if states.dim() < 2 or tuple(states.shape[-2:]) != (12, limb.NLIMB):
        raise ValueError(f"permute12: expected (..., 12, 8), got "
                         f"{tuple(states.shape)}")
    lib = load()
    x = states.contiguous()
    mds, rc, _ = suite_tensors(suite_id, rounds, x.device)
    out = torch.empty_like(x)
    batch = x.numel() // (12 * limb.NLIMB)
    if batch == 0:
        return out                       # nothing to launch, nothing counted
    if permute12.batch_log is not None:
        permute12.batch_log.append(batch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.poseidon12_launch(x.data_ptr(), out.data_ptr(),
                                    mds.data_ptr(), rc.data_ptr(),
                                    batch, rounds, stream)
    if err != 0:
        raise RuntimeError(f"poseidon12 launch failed: CUDA error {err}")
    permute12.launches += 1
    return out


permute12.launches = 0        # kernel launches since the last reset
permute12.batch_log = None    # set to a list to record each launch's batch
