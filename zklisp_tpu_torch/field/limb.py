"""Vectorized f128 arithmetic over 16-bit limbs on PyTorch tensors.

Representation at every public function: an f128 element is 8
little-endian 16-bit limbs in a ``torch.int32`` tensor of shape (..., 8),
value = sum(limb[i] << (16*i)) — the layout `limb_host.to_ints` reads.

The modulus is p = 2^128 - 45*2^40 + 1; reduction folds 2^128 = C (mod p)
with C = 45*2^40 - 1, then one conditional subtract.  Every result is
canonical (< p), so it equals the numpy host path limb for limb.

PyTorch has no unsigned 32-bit `+`, `>>` or `>` on the CPU, and a
16x16-bit product reaches 2^32 - 2^17 + 1, so the arithmetic widens to
``int64`` inside each op and narrows to ``int32`` at the end.  In int64
nothing wraps: product columns stay below 2^47, and the packed-bit carry
resolution of `_normalize_cols` reads back only bits 0..K+1.  Native
u32/u64 arithmetic lives only inside the CUDA kernel
(csrc/poseidon12.cu).

These are the plain versions: tens of small tensor ops per field
multiply.  Callers chunk large operands (the column-wise product of a
whole LDE would otherwise materialize gigabytes of int64 temporaries).
"""

from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as _F

from . import f128
from . import limb_host as _host

NLIMB = 8
LIMB_BITS = 16
LIMB_MASK = 0xFFFF
DTYPE = torch.int32

_C_INT = f128.C128
C_LIMBS = tuple((_C_INT >> (16 * i)) & 0xFFFF for i in range(3))
P_LIMBS = tuple((f128.P >> (16 * i)) & 0xFFFF for i in range(NLIMB))
# two's complement of p over 8 columns, +1 pre-added at column 0
_P_COMPL = tuple([(0xFFFF - P_LIMBS[0]) + 1]
                 + [0xFFFF - v for v in P_LIMBS[1:]])

_CONST_CACHE: dict = {}


def _const(values, device) -> torch.Tensor:
    """Small int64 constant vector on `device` (cached per device)."""
    key = (tuple(values), str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.tensor(list(values), dtype=torch.int64, device=device)
        _CONST_CACHE[key] = t
    return t


# ---------------------------------------------------------------------------
# conversions (host boundary)
# ---------------------------------------------------------------------------

def from_numpy(arr, device) -> torch.Tensor:
    """numpy limb array (any integer dtype, digits < 2^16) -> int32
    tensor on `device`."""
    a = _np.ascontiguousarray(_np.asarray(arr).astype(_np.int32))
    return torch.from_numpy(a).to(device)


def to_numpy_u32(t: torch.Tensor) -> _np.ndarray:
    return t.detach().cpu().numpy().astype(_np.uint32)


def from_ints(values, device) -> torch.Tensor:
    """Python ints (nested lists OK) -> limb tensor of shape (..., 8)."""
    return from_numpy(_host.from_ints(values), device)


def to_ints(t: torch.Tensor):
    """Limb tensor -> numpy object array of Python ints (host only)."""
    return _host.to_ints(to_numpy_u32(t))


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMB,), dtype=DTYPE, device=device)


def ones(shape, device) -> torch.Tensor:
    z = zeros(shape, device)
    z[..., 0] = 1
    return z


def from_i64(values: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^63) -> limb tensor (no reduction)."""
    v = values.to(torch.int64)
    shifts = _const([0, 16, 32, 48], v.device)
    low = ((v[..., None] >> shifts) & LIMB_MASK).to(DTYPE)
    return _F.pad(low, (0, 4))


# ---------------------------------------------------------------------------
# column arithmetic (int64 inside)
# ---------------------------------------------------------------------------

def _place(cols, offset: int, width: int):
    """Zero-pad columns to `width`, shifted up by `offset` (x 2^16off)."""
    return _F.pad(cols, (offset, width - offset - cols.shape[-1]))


def _narrow(cols):
    """(..., K) int64 columns < 2^47 -> (..., K+1) columns < 2^32, value
    preserved: each column keeps its low 16 bits and hands the rest to
    its upper neighbour."""
    K = cols.shape[-1]
    return (_place(cols & LIMB_MASK, 0, K + 1)
            + _place(cols >> 16, 1, K + 1))


def _normalize_cols(cols):
    """(..., K) int64 columns in [0, 2^32) -> canonical 16-bit digits
    (..., K+2), value preserved exactly.

    One split pass brings every column into [0, 2^17-2], where the
    per-column carry is a single bit with DISJOINT generate/propagate
    flags; the full carry ripple is then resolved in O(1) tensor ops via
    the packed-bit adder identity  C = ((G<<1) + P) ^ P.  The packed
    words are int64, so K + 2 <= 62 and nothing wraps.
    """
    K = cols.shape[-1]
    assert K + 2 <= 62, "bit-packed carry resolution needs K+2 <= 62"
    t = _place(cols & LIMB_MASK, 0, K + 2) + _place(cols >> 16, 1, K + 2)
    w = torch.arange(K + 2, dtype=torch.int64, device=cols.device)
    G = ((t >> 16) << w).sum(-1)
    Pm = (((t & LIMB_MASK) == LIMB_MASK).to(torch.int64) << w).sum(-1)
    C = ((G << 1) + Pm) ^ Pm                             # carry-in bits
    cbits = (C[..., None] >> w) & 1
    return (t + cbits) & LIMB_MASK


def _fold_cols(digits):
    """Canonical digits (..., K), K > 8: value -> lo + (value>>128) * C.

    Returns columns (..., max(8, K-8+3) + 1), each < 2^32."""
    K = digits.shape[-1]
    hi = digits[..., NLIMB:]
    kh = K - NLIMB
    W = max(NLIMB, kh + 3)
    acc = _place(digits[..., :NLIMB], 0, W)
    for l, cv in enumerate(C_LIMBS):
        acc[..., l:l + kh] += hi * cv
    return _narrow(acc)                   # sums reach 3*2^32: re-split


def _ndigits(bound: int) -> int:
    return max(1, (bound.bit_length() + 15) // 16)


def _finish9(d):
    """d (..., 9) canonical digits with d[8] in {0, 1} and, when d[8] is
    1, a low part small enough that adding C cannot carry: fold the top
    bit and subtract p if needed, in ONE normalization."""
    lo = d[..., :NLIMB]
    top = d[..., NLIMB:NLIMB + 1] > 0
    c_vec = _const(list(C_LIMBS) + [0] * (NLIMB - 3), d.device)
    pc_vec = _const(_P_COMPL, d.device)
    nt = _normalize_cols(lo + torch.where(top, c_vec, pc_vec))
    take = top | (nt[..., NLIMB:NLIMB + 1] > 0)
    return torch.where(take, nt[..., :NLIMB], lo)


def _cond_sub_cols(d):
    """d (..., 8) canonical digits, value < 2^128: subtract p if >= p."""
    nt = _normalize_cols(d + _const(_P_COMPL, d.device))
    ge = nt[..., NLIMB:NLIMB + 1] > 0
    return torch.where(ge, nt[..., :NLIMB], d)


def _reduce_cols(cols, bound: int):
    """(..., K) int64 columns < 2^32 with value <= `bound` -> canonical
    (..., 8) int32 limbs."""
    d = _normalize_cols(cols)[..., :_ndigits(bound)]
    while d.shape[-1] > NLIMB + 1:
        bound = (bound >> 128) * _C_INT + min(bound, (1 << 128) - 1)
        d = _normalize_cols(_fold_cols(d))[..., :_ndigits(bound)]
    if d.shape[-1] > NLIMB:
        if bound >= 2 * f128.P:
            # top digit may exceed 1, or the low part is too large for
            # _finish9: one more fold leaves a top digit <= 1 and, when
            # it is 1, a low part < 2^63
            d = _normalize_cols(_fold_cols(d))[..., :NLIMB + 1]
        return _finish9(d).to(DTYPE)
    if d.shape[-1] < NLIMB:
        d = _place(d, 0, NLIMB)
    return _cond_sub_cols(d).to(DTYPE)


def _conv_cols(a, b):
    """Schoolbook product columns: a (..., Ka), b (..., 8) int64 16-bit
    digits -> (..., Ka+8) columns, each < 2^35 (8 terms of < 2^32)."""
    Ka = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    cols = torch.zeros(shape + (Ka + NLIMB,), dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMB):
        cols[..., i:i + Ka] += a * b[..., i:i + 1]
    return cols


# ---------------------------------------------------------------------------
# field ops
# ---------------------------------------------------------------------------

def add(a, b):
    cols = a.to(torch.int64) + b.to(torch.int64)
    # value < 2p: both candidates (v, v - p + 2^128) in one normalization
    both = torch.stack([cols, cols + _const(_P_COMPL, cols.device)])
    nt = _normalize_cols(both)
    ge = nt[1][..., NLIMB:NLIMB + 1] > 0
    return torch.where(ge, nt[1][..., :NLIMB], nt[0][..., :NLIMB]).to(DTYPE)


def sub(a, b):
    a64 = a.to(torch.int64)
    nb = LIMB_MASK - b.to(torch.int64)
    one0 = _const([1] + [0] * (NLIMB - 1), a.device)
    c1 = a64 + nb + one0                      # a - b + 2^128
    c2 = c1 + _const(P_LIMBS, a.device)       # a - b + p + 2^128
    nt = _normalize_cols(torch.stack([c1, c2]))
    ge = nt[0][..., NLIMB:NLIMB + 1] > 0      # a >= b
    return torch.where(ge, nt[0][..., :NLIMB], nt[1][..., :NLIMB]).to(DTYPE)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    """Full 128x128 -> 256-bit schoolbook product + fold reduction."""
    cols = _conv_cols(a.to(torch.int64), b.to(torch.int64))
    return _reduce_cols(_narrow(cols), (f128.P - 1) ** 2)


def sqr(a):
    return mul(a, a)


def cube(a):
    """a^3 mod p with one fewer full reduction than mul(mul(a,a),a): the
    square is kept as exact 16 base-2^16 digits and convolved directly
    with a's limbs; a single reduction folds the ~2^384 product."""
    a64 = a.to(torch.int64)
    d2 = _normalize_cols(_narrow(_conv_cols(a64, a64)))[..., :16]
    cols3 = _conv_cols(d2, a64)                       # (..., 24)
    return _reduce_cols(_narrow(cols3),
                        ((1 << 256) - 1) * ((1 << 128) - 1))


def dot(a, b):
    """Sum_j a[..., j, :] * b[..., j, :] with a SINGLE modular reduction.

    a, b: (..., J, 8) limb tensors (broadcastable), J <= 2048.  The
    256-bit product columns of all J products accumulate (< 2^46 each)
    before reducing once."""
    J = max(a.shape[-2], b.shape[-2])
    assert J <= 2048, "dot: accumulate bound exceeded; split the sum"
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    cols = torch.zeros(shape + (2 * NLIMB,), dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMB):
        cols[..., i:i + NLIMB] += (a64[..., i:i + 1] * b64).sum(-2)
    return _reduce_cols(_narrow(cols), J * (f128.P - 1) ** 2)


def sum_mod(a, axis: int):
    """Sum field elements along `axis` with ONE reduction (axis length
    <= 65536 keeps every digit column below 2^32)."""
    n = a.shape[axis]
    assert n <= 65536, "sum_mod: digit-column overflow; split the sum"
    cols = a.sum(dim=axis, dtype=torch.int64)
    return _reduce_cols(cols, n * (f128.P - 1))


def mul_small(a, k: int):
    """Multiply by a small uint (< 2^16) constant."""
    assert 0 <= k < (1 << 16)
    return _reduce_cols(a.to(torch.int64) * k, (f128.P - 1) * max(k, 1))


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def select(cond, a, b):
    """cond ? a : b  (cond shape = a.shape[:-1])."""
    return torch.where(cond[..., None], a, b)


def exp_int(a, e: int):
    """a ** e for a static Python int exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        return ones(a.shape[:-1], a.device)
    return result


def inv(a):
    """Fermat inverse a^(p-2); zero maps to zero.  A handful of elements
    are inverted on the host (one round trip instead of ~250 dependent
    field multiplies of a tiny tensor)."""
    if a.numel() <= 64 * NLIMB:
        vals = [f128.inv(int(v)) if int(v) else 0
                for v in to_ints(a).reshape(-1)]
        return from_ints(vals, a.device).reshape(a.shape)
    return exp_int(a, f128.P - 2)


def batch_inv_tree(a):
    """Batch inversion along axis 0 for power-of-two n, in log depth.

    A product tree (pairwise down, distribute up) does ~3n muls in
    log2(n) vectorized steps plus ONE inversion.  Zeros map to zeros."""
    n = a.shape[0]
    assert n & (n - 1) == 0, "batch_inv_tree: n must be a power of two"
    zero_mask = is_zero(a)
    safe = select(zero_mask, ones(a.shape[:-1], a.device), a)

    levels = [safe]
    cur = safe
    while cur.shape[0] > 1:
        cur = mul(cur[0::2], cur[1::2])
        levels.append(cur)
    inv_cur = inv(cur)                           # (1, ..., 8)
    for lvl in reversed(levels[:-1]):
        inv_left = mul(inv_cur, lvl[1::2])
        inv_right = mul(inv_cur, lvl[0::2])
        inv_cur = torch.stack([inv_left, inv_right], dim=1).reshape(
            lvl.shape)
    return select(zero_mask, torch.zeros_like(a), inv_cur)
