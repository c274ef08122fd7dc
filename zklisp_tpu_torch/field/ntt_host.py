"""Radix-2 NTT / iNTT / coset LDE over f128 limb arrays: the numpy host
half (``xp=np``), used for host tables, twiddle tables and the FRI
remainder.  The PyTorch counterpart is field/ntt.py.

Iterative decimation-in-time with one bit-reversal gather up front and
log2(n) vectorized butterfly stages.  Coset LDE = scale coefficients by
offset^i, zero-pad to blowup*n, forward NTT; the coset offset is the
f128 multiplicative generator 3, matching winterfell's StarkDomain.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as _np

from . import f128
from . import limb_host as limb

DEFAULT_COSET_OFFSET = f128.GENERATOR  # 3


@lru_cache(maxsize=None)
def _host_root_pow2_powers(log_n: int, inverse: bool):
    """Host: w^(2^k) for k in 0..log_n-1, where w is the primitive 2^log_n
    root (or its inverse)."""
    w = f128.get_root_of_unity(1 << log_n)
    if inverse:
        w = f128.inv(w)
    out = []
    cur = w
    for _ in range(log_n):
        out.append(cur)
        cur = f128.mul(cur, cur)
    return out


def powers_table(log_n: int, xp, inverse: bool = False):
    """Device: [w^0, w^1, ..., w^(2^(log_n-1) - 1)] as a limb array.

    Built with log_n-1 doubling steps: p -> concat(p, p * w^len(p)).
    """
    n_half = 1 << max(log_n - 1, 0)
    if n_half == 0:
        n_half = 1
    pows2 = _host_root_pow2_powers(log_n, inverse)
    p = limb.ones((1,), _np)
    p = xp.asarray(p)
    ln = 1
    k = 0
    while ln < n_half:
        step = limb.from_ints([pow(
            f128.inv(f128.get_root_of_unity(1 << log_n))
            if inverse else f128.get_root_of_unity(1 << log_n),
            ln, f128.P)])
        step = xp.asarray(step)
        p = xp.concatenate([p, limb.mul(p, step, xp)], axis=0)
        ln *= 2
        k += 1
    return p


@lru_cache(maxsize=None)
def _bitrev_indices(log_n: int):
    n = 1 << log_n
    idx = _np.arange(n, dtype=_np.int32)
    rev = _np.zeros(n, dtype=_np.int32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _take(x, idx, xp):
    if xp is _np:
        return x[idx]
    return xp.take(x, xp.asarray(idx), axis=0)


def ntt(x, xp, pows=None):
    """Forward NTT: coefficients -> evaluations over <w_n> (natural order).

    x: (n, 8) limb array, n a power of two.
    pows: optional precomputed powers_table(log_n, xp) to reuse.
    """
    n = x.shape[0]
    log_n = n.bit_length() - 1
    assert (1 << log_n) == n
    if n == 1:
        return x
    if pows is None:
        pows = powers_table(log_n, xp)

    x = _take(x, _bitrev_indices(log_n), xp)
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        stride = n // m
        tw = pows[::stride][:half]                    # (half, 8)
        a = x.reshape(n // m, m, limb.NLIMB)
        e = a[:, :half]
        o = a[:, half:]
        t = limb.mul(o, tw[None, :, :], xp)
        x = xp.concatenate(
            [limb.add(e, t, xp), limb.sub(e, t, xp)], axis=1
        ).reshape(n, limb.NLIMB)
    return x


def intt(y, xp, pows_inv=None):
    """Inverse NTT: evaluations -> coefficients; scales by n^-1."""
    n = y.shape[0]
    log_n = n.bit_length() - 1
    assert (1 << log_n) == n
    if n == 1:
        return y
    if pows_inv is None:
        pows_inv = powers_table(log_n, xp, inverse=True)

    x = _take(y, _bitrev_indices(log_n), xp)
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        stride = n // m
        tw = pows_inv[::stride][:half]
        a = x.reshape(n // m, m, limb.NLIMB)
        e = a[:, :half]
        o = a[:, half:]
        t = limb.mul(o, tw[None, :, :], xp)
        x = xp.concatenate(
            [limb.add(e, t, xp), limb.sub(e, t, xp)], axis=1
        ).reshape(n, limb.NLIMB)

    n_inv = xp.asarray(limb.from_ints([f128.inv(n % f128.P)]))
    return limb.mul(x, n_inv, xp)


@lru_cache(maxsize=None)
def _host_offset_powers(n: int, offset: int):
    out = [1] * n
    cur = 1
    for i in range(1, n):
        cur = f128.mul(cur, offset)
        out[i] = cur
    return out


def offset_powers(n: int, xp, offset: int = DEFAULT_COSET_OFFSET):
    """Limb array [offset^0 .. offset^(n-1)]."""
    return xp.asarray(limb.from_ints(_host_offset_powers(n, offset)))


def coset_evaluate(coeffs, blowup: int, xp,
                   offset: int = DEFAULT_COSET_OFFSET, pows=None):
    """Evaluate polynomial over the coset offset * <w_N>, N = blowup * n.

    Equivalent to winterfell's LDE: returns (N, 8) evaluations in natural
    domain order (x_i = offset * w_N^i).
    """
    n = coeffs.shape[0]
    N = n * blowup
    scale = offset_powers(n, xp, offset)
    scaled = limb.mul(coeffs, scale, xp)
    if blowup > 1:
        pad = limb.zeros((N - n,), xp)
        scaled = xp.concatenate([scaled, pad], axis=0)
    return ntt(scaled, xp, pows=pows)


def coset_interpolate(evals, blowup: int, xp,
                      offset: int = DEFAULT_COSET_OFFSET):
    """Inverse of coset_evaluate restricted to degree < N/blowup... NOTE:
    interpolates over the FULL coset domain (degree < N), then the caller
    may truncate.  coeffs_i = intt(evals)_i * offset^-i."""
    N = evals.shape[0]
    coeffs = intt(evals, xp)
    inv_off = f128.inv(offset)
    scale = offset_powers(N, xp, inv_off)
    return limb.mul(coeffs, scale, xp)


def eval_poly_at(coeffs_int, x: int) -> int:
    """Host Horner evaluation (Python ints) for tests and query checks."""
    acc = 0
    for c in reversed(coeffs_int):
        acc = (acc * x + c) % f128.P
    return acc
