"""NTT / iNTT / coset LDE over f128 limb tensors (PyTorch).

Transforms of n >= MXU_NTT_MIN points run as the four-step digit-plane
matrix NTT of field/mxu.py (through the `digit_dot` kernel on the card);
ZKL_NO_MXU_NTT=1 forces radix-2 for every size (A/B kill switch, read at
call time).  Same exact outputs either way.

Radix-2 is iterative decimation-in-time: one bit-reversal gather up
front, then log2(n) butterfly stages, each a reshape + slice + one
batched limb multiply.  Every function is batched over leading axes: x
is (..., n, 8), so a whole block of trace columns transforms at once.

Twiddle and coset-offset tables are built on the host (log-doubling on
the numpy limb path) and uploaded once per (size, device).

Coset LDE = scale coefficients by offset^i, zero-pad to blowup*n,
forward NTT.  The coset offset is the f128 multiplicative generator 3.
"""

from __future__ import annotations

import os

import numpy as _np
import torch
import torch.nn.functional as _F

from . import f128, limb, mxu
from . import limb_host as _lh
from . import ntt_host as _nh

DEFAULT_COSET_OFFSET = f128.GENERATOR  # 3

# Transforms at or above this size take the four-step matrix path; small
# ones stay radix-2 (their matrix tiles would be mostly padding).
MXU_NTT_MIN = 512

_TABLES: dict = {}


def _four_step(n: int) -> bool:
    return n >= MXU_NTT_MIN and not os.environ.get("ZKL_NO_MXU_NTT")


def _cached(key, device, make):
    k = key + (str(device),)
    t = _TABLES.get(k)
    if t is None:
        t = limb.from_numpy(make(), device)
        _TABLES[k] = t
    return t


def powers_table(log_n: int, device, inverse: bool = False):
    """[w^0, w^1, ..., w^(2^(log_n-1) - 1)] for the primitive 2^log_n
    root w (or its inverse)."""
    return _cached(("pows", log_n, inverse), device,
                   lambda: _nh.powers_table(log_n, _np, inverse=inverse))


def offset_powers(n: int, device, offset: int = DEFAULT_COSET_OFFSET):
    """Limb tensor [offset^0 .. offset^(n-1)]."""
    return _cached(("off", n, offset), device,
                   lambda: _lh.powers_np(offset, n))


def _bitrev(log_n: int, device):
    k = ("bitrev", log_n, str(device))
    t = _TABLES.get(k)
    if t is None:
        t = torch.from_numpy(
            _nh._bitrev_indices(log_n).astype(_np.int64)).to(device)
        _TABLES[k] = t
    return t


def _butterflies(x, pows):
    n = x.shape[-2]
    log_n = n.bit_length() - 1
    assert (1 << log_n) == n
    lead = x.shape[:-2]
    x = x.index_select(-2, _bitrev(log_n, x.device))
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        tw = pows[::n // m][:half]                    # (half, 8)
        a = x.reshape(lead + (n // m, m, limb.NLIMB))
        e = a[..., :half, :]
        t = limb.mul(a[..., half:, :], tw)
        x = torch.cat([limb.add(e, t), limb.sub(e, t)],
                      dim=-2).reshape(lead + (n, limb.NLIMB))
    return x


def ntt(x):
    """Forward NTT: coefficients -> evaluations over <w_n> (natural
    order).  x: (..., n, 8), n a power of two."""
    n = x.shape[-2]
    if n == 1:
        return x
    if _four_step(n):
        return mxu.ntt_four_step(x, inverse=False)
    return _butterflies(x, powers_table(n.bit_length() - 1, x.device))


def intt(y):
    """Inverse NTT: evaluations -> coefficients; scales by n^-1."""
    n = y.shape[-2]
    if n == 1:
        return y
    if _four_step(n):
        return mxu.ntt_four_step(y, inverse=True)
    x = _butterflies(y, powers_table(n.bit_length() - 1, y.device,
                                     inverse=True))
    return limb.mul(x, limb.from_ints([f128.inv(n % f128.P)], y.device))


def coset_evaluate(coeffs, blowup: int,
                   offset: int = DEFAULT_COSET_OFFSET):
    """Evaluate polynomials over the coset offset * <w_N>, N = blowup * n.

    coeffs: (..., n, 8); returns (..., N, 8) evaluations in natural
    domain order (x_i = offset * w_N^i)."""
    n = coeffs.shape[-2]
    scaled = limb.mul(coeffs, offset_powers(n, coeffs.device, offset))
    if blowup > 1:
        scaled = _F.pad(scaled, (0, 0, 0, n * (blowup - 1)))
    return ntt(scaled)


def coset_interpolate(evals, offset: int = DEFAULT_COSET_OFFSET):
    """Interpolate over the FULL coset domain (degree < N); the caller
    may truncate.  coeffs_i = intt(evals)_i * offset^-i."""
    N = evals.shape[-2]
    coeffs = intt(evals)
    return limb.mul(coeffs,
                    offset_powers(N, evals.device, f128.inv(offset)))
