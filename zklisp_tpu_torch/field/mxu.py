"""Field-element matrix products as digit-plane integer products, and the
four-step NTT built on them (counterpart of the JAX package's
field/mxu.py; same outputs bit for bit).

A product  out[b, i] = sum_j A[b, j] * W[j, i]  over f128 with a CONSTANT
W lowers to integer products over limb columns:

  out_cols[b, i*16 + k] = sum_{j, l} a[b, j*8 + l] * Wm[j*8 + l, i*16 + k]
  Wm[j*8 + l, i*16 + k] = limb_{k-l}(W[j, i])        (0 <= k-l < 8)

16-bit limbs split into 8-bit halves make every factor an 8-bit digit;
the four products (lo*lo, lo*hi, hi*lo, hi*hi) recombine with byte
shifts into 16-bit-weighted columns below 2^32, which `limb._reduce_cols`
folds back to canonical elements.  All four products are ONE call of
`digit_dot` — the integer tensor-core kernel on a CUDA tensor — with
[a_lo; a_hi] stacked along M and [w_lo | w_hi] along N.

Accumulation bound: J*8 terms * 255^2 < 2^31 requires J <= 4096.

Used by field/ntt.py (four-step NTT) and prove/stark_device.py (DEEP).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as _np
import torch

from . import f128, limb
from . import limb_host as _lh
from .digit_dot import digit_dot

K16 = 16  # output column count per element (products reach column 14)
MAX_J = 4096
_COLS_BOUND = sum(((1 << 32) - 1) << (16 * k) for k in range(K16))

_DEVICE_TABLES: dict = {}


def wmat_from_ints(W_ints: Sequence[Sequence[int]]) -> _np.ndarray:
    """(J, K) field constants -> (J*8, K*16) uint16 limb-convolution
    matrix (host; call once per constant matrix and cache)."""
    lim = _np.asarray(_lh.from_ints([list(r) for r in W_ints]))
    J, K = lim.shape[0], lim.shape[1]
    assert J <= MAX_J, "accumulation bound"
    Wm = _np.zeros((J, 8, K, K16), dtype=_np.uint16)
    for l in range(8):
        Wm[:, l, :, l:l + 8] = lim
    return Wm.reshape(J * 8, K * K16)


def wmat_planes(Wm: _np.ndarray) -> Tuple[_np.ndarray, _np.ndarray]:
    """Split a uint16 weight matrix into (lo8, hi8) uint8 planes."""
    return ((Wm & 0xFF).astype(_np.uint8), (Wm >> 8).astype(_np.uint8))


def stack_planes(w_lo: _np.ndarray, w_hi: _np.ndarray, device):
    """(J*8, K*16) uint8 planes -> the (2*K*16, J*8) uint8 tensor
    `field_matmul` takes: [w_lo | w_hi] transposed, so each output
    column's digits lie along the contraction axis as `digit_dot` reads
    them."""
    wt = _np.ascontiguousarray(_np.concatenate([w_lo, w_hi], axis=1).T)
    return torch.from_numpy(wt).to(device)


def field_matmul(a_limbs, wt):
    """a_limbs (..., J, 8) int32 limbs x constant planes `wt` (from
    `stack_planes`, (2*K*16, J*8) uint8) -> (..., K, 8) canonical field
    elements.  Leading dims are batch; a_limbs may be a strided view (the
    byte split writes the contiguous digit planes).  Safe for J <= 4096."""
    lead = tuple(a_limbs.shape[:-2])
    J = a_limbs.shape[-2]
    if wt.shape[1] != J * limb.NLIMB or J > MAX_J:
        raise ValueError(f"field_matmul: {tuple(a_limbs.shape)} limbs "
                         f"against {tuple(wt.shape)} planes")
    ncol = wt.shape[0] // 2
    K = ncol // K16
    M = 1
    for s in lead:
        M *= s
    # torch.uint8 has no wide arithmetic: split in int32, store as bytes
    a2 = torch.empty((2, M, J * limb.NLIMB), dtype=torch.uint8,
                     device=a_limbs.device)
    a2[0].view(a_limbs.shape).copy_(a_limbs & 0xFF)
    a2[1].view(a_limbs.shape).copy_(a_limbs >> 8)
    c = digit_dot(a2.view(2 * M, J * limb.NLIMB), wt)
    del a2
    c = c.view(2, M, 2, K, K16)          # [a half, row, w half, elem, col]
    # value = ll + (lh+hl)*2^8 + hh*2^16; byte-split the *2^8 term so all
    # contributions stay below 2^32; the k+1 shift never drops a nonzero
    # column (products reach column 14 < 15).
    mid = c[0, :, 1].to(torch.int64) + c[1, :, 0]
    cols = c[0, :, 0] + ((mid & 0xFF) << 8)
    cols[..., 1:] += ((mid >> 8) + c[1, :, 1])[..., :K16 - 1]
    del c, mid
    return limb._reduce_cols(cols, _COLS_BOUND).reshape(
        lead + (K, limb.NLIMB))


# ---------------------------------------------------------------------------
# four-step NTT tables (host-built, uploaded once per device)
# ---------------------------------------------------------------------------

def _split_n(n: int) -> Tuple[int, int]:
    """n = n1 * n2 with n1 >= n2, both powers of two, n1 <= 256."""
    log = n.bit_length() - 1
    l1 = min((log + 1) // 2, 8)
    # keep n1 (the first-stage DFT size) <= 256 for the J-bound and
    # weight-matrix size; n2 grows with n
    n1 = 1 << l1
    return n1, n // n1


def _root(n: int, inverse: bool) -> int:
    w = f128.get_root_of_unity(n)
    return f128.inv(w) if inverse else w


@lru_cache(maxsize=None)
def _dft_wmat(m: int, inverse: bool):
    """uint8 planes of the m-point DFT matrix D[j, k] = w_m^(jk)."""
    pows = _lh.to_ints(_lh.powers_np(_root(m, inverse), m))
    jk = _np.outer(_np.arange(m), _np.arange(m)) % m
    return wmat_planes(wmat_from_ints(pows[jk].tolist()))


@lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool) -> _np.ndarray:
    """(n2, n1, 8) limb array tw[j2, k1] = w_n^(j2*k1)."""
    n1, n2 = _split_n(n)
    pows = _np.asarray(_lh.powers_np(_root(n, inverse), n))
    e = _np.outer(_np.arange(n2), _np.arange(n1))        # < n always
    return pows[e].astype(_np.uint32)


def _on_device(key, device, make):
    k = key + (str(device),)
    t = _DEVICE_TABLES.get(k)
    if t is None:
        t = make()
        _DEVICE_TABLES[k] = t
    return t


def dft_planes(m: int, inverse: bool, device):
    """The m-point DFT's stacked planes on `device` (cached)."""
    return _on_device(("dft", m, inverse), device,
                      lambda: stack_planes(*_dft_wmat(m, inverse), device))


def twiddles(n: int, inverse: bool, device):
    """The four-step twiddle table on `device` (cached)."""
    return _on_device(("tw", n, inverse), device,
                      lambda: limb.from_numpy(_twiddles(n, inverse), device))


def ntt_four_step(x, inverse: bool = False, _scale: bool = True):
    """(..., n, 8) -> exact NTT/iNTT via digit-plane matrix stages.

    Output matches the radix-2 `ntt.ntt` bit for bit (same math, natural
    order); iNTT includes the n^-1 scale.  For n > 256*256 the second
    stage recurses (unscaled), so weight matrices stay <= 256-point.
    """
    lead = tuple(x.shape[:-2])
    n = x.shape[-2]
    dev = x.device
    n1, n2 = _split_n(n)

    # x[j] with j = j1*n2 + j2 -> (j1, j2); step 1 DFTs along j1:
    # A_T[j2, k1] = sum_j1 x[j1, j2] * w^(n2*j1*k1)  (D symmetric)
    x_t = x.reshape(lead + (n1, n2, limb.NLIMB)).transpose(-3, -2)
    a_t = field_matmul(x_t, dft_planes(n1, inverse, dev))
    t_t = limb.mul(a_t, twiddles(n, inverse, dev))       # (..., n2, n1, 8)
    del a_t
    # step 3 DFTs along j2: R[k1, k2] = sum_j2 T[k1, j2] * w^(n1*j2*k2)
    t_m = t_t.transpose(-3, -2)                          # (..., n1, n2, 8)
    if n2 <= 256:
        r = field_matmul(t_m, dft_planes(n2, inverse, dev))
    else:
        r = ntt_four_step(t_m, inverse, _scale=False)
    # output index k = k2*n1 + k1
    out = r.transpose(-3, -2).reshape(lead + (n, limb.NLIMB))
    if inverse and _scale:
        out = limb.mul(out, limb.from_ints([f128.inv(n % f128.P)], dev))
    return out
