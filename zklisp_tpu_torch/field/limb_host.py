"""f128 arithmetic over 16-bit limbs: the numpy host half.

Representation: an f128 element is 8 little-endian 16-bit limbs stored in a
uint32 array of shape (..., 8):   value = sum(limb[i] << (16*i)).

The host modules (coin, commitments, multiproofs, AIR tables, trace
conversion) call these functions with ``xp=np``; the PyTorch counterpart
used by the device prover is field/limb.py.  Products accumulate in
uint64 columns.  The modulus is p = 2^128 - 45*2^40 + 1 (winterfell
f128); reduction uses 2^128 = C (mod p) with C = 45*2^40 - 1, folded
until the value fits 128 bits, plus a final conditional subtract.
"""

from __future__ import annotations

import numpy as _np

from . import f128

NLIMB = 8
LIMB_BITS = 16
LIMB_MASK = 0xFFFF

# C = 45*2^40 - 1  (2^128 mod p), as 16-bit limbs (3 limbs, 46 bits)
_C_INT = f128.C128
C_LIMBS = tuple((_C_INT >> (16 * i)) & 0xFFFF for i in range(3))

# p as 8 limbs
P_LIMBS = tuple((f128.P >> (16 * i)) & 0xFFFF for i in range(NLIMB))


# ---------------------------------------------------------------------------
# Host-side conversions (numpy only; used at the device boundary)
# ---------------------------------------------------------------------------

def from_ints(values, xp=_np):
    """Python ints (nested lists OK) -> limb array of shape (..., 8).

    Hot at the host->device boundary (a full 2^16-row trace is ~14M
    elements), so the limb split runs as one bulk little-endian byte
    pack (int.to_bytes is C-level) instead of a per-element Python
    shift loop — ~25x faster on full-trace conversions."""
    obj = _np.asarray(values, dtype=object)
    flat = obj.reshape(-1).tolist()
    try:
        buf = b"".join(v.to_bytes(16, "little") for v in flat)
        arr = _np.frombuffer(buf, dtype=_np.uint16).astype(
            _np.uint32).reshape(-1, NLIMB)
    except (OverflowError, TypeError, AttributeError):
        # negative / non-int inputs: the original per-element path
        arr = _np.asarray(
            [[(int(v) >> (16 * i)) & 0xFFFF for i in range(NLIMB)]
             for v in flat],
            dtype=_np.uint32,
        )
    arr = arr.reshape(obj.shape + (NLIMB,))
    return xp.asarray(arr) if xp is not _np else arr


def from_int_cols(cols, dtype=_np.uint32):
    """List of equal-length Python-int columns -> (C, n, NLIMB) array.

    The trace-table fast path: columns whose values fit in uint64
    (selectors, gates, bit witnesses — most of the 219 columns) convert
    through ONE C-level np.asarray + vectorized shifts; only full-width
    columns (Poseidon lanes, registers holding digests, grand products)
    pay the per-element byte pack."""
    n = len(cols[0]) if cols else 0
    out = _np.zeros((len(cols), n, NLIMB), dtype=dtype)
    for ci, col in enumerate(cols):
        try:
            a = _np.asarray(col, dtype=_np.uint64)
        except (OverflowError, TypeError):
            try:
                buf = b"".join(v.to_bytes(16, "little") for v in col)
                out[ci] = _np.frombuffer(buf, dtype=_np.uint16).reshape(
                    n, NLIMB)
            except (OverflowError, TypeError, AttributeError):
                out[ci] = from_ints(col)
        else:
            for i in range(4):
                out[ci, :, i] = ((a >> (16 * i)) & 0xFFFF).astype(dtype)
    return out


def to_ints(limbs):
    """Limb array -> nested list of Python ints (host only)."""
    a = _np.asarray(limbs, dtype=_np.uint64)
    flat = a.reshape(-1, NLIMB)
    out = []
    for row in flat:
        v = 0
        for i in range(NLIMB):
            v |= int(row[i]) << (16 * i)
        out.append(v)
    shape = a.shape[:-1]
    res = _np.empty(shape, dtype=object)
    res.reshape(-1)[:] = out
    return res


def zeros(shape, xp=_np):
    return xp.zeros(tuple(shape) + (NLIMB,), dtype=xp.uint32)


def ones(shape, xp=_np):
    z = _np.zeros(tuple(shape) + (NLIMB,), dtype=_np.uint32)
    z[..., 0] = 1
    return xp.asarray(z) if xp is not _np else z


def from_u64(values, xp):
    """uint64-convertible array of small ints -> limb array (no reduction).

    Values must be < 2^64 (always < p).  Works inside jit when `values`
    is a traced uint32/uint64 array; uses only 32-bit-safe ops.
    """
    v = xp.asarray(values)
    lo = v.astype(xp.uint32)
    hi = (v >> 32).astype(xp.uint32)
    limbs = [
        lo & LIMB_MASK, (lo >> 16) & LIMB_MASK,
        hi & LIMB_MASK, (hi >> 16) & LIMB_MASK,
    ]
    z = xp.zeros_like(limbs[0])
    return xp.stack(limbs + [z, z, z, z], axis=-1)


# ---------------------------------------------------------------------------
# Core arithmetic (xp is numpy)
# ---------------------------------------------------------------------------

def _carry_propagate(cols, xp):
    """Propagate carries over a list of uint32 columns (each < 2^32-ish).

    Returns list of 16-bit limbs, same length, plus final carry column.
    """
    out = []
    carry = xp.zeros_like(cols[0])
    for c in cols:
        s = c + carry
        out.append(s & LIMB_MASK)
        carry = s >> 16
    return out, carry


def _ge(a_limbs, b_limbs, xp):
    """a >= b for limb lists (lexicographic from most significant limb)."""
    n = len(a_limbs)
    gt = xp.zeros_like(a_limbs[0]) > 0
    eq_acc = a_limbs[0] == a_limbs[0]
    for i in range(n - 1, -1, -1):
        gt = gt | (eq_acc & (a_limbs[i] > b_limbs[i]))
        eq_acc = eq_acc & (a_limbs[i] == b_limbs[i])
    return gt | eq_acc


def _sub_limbs(a_limbs, b_limbs, xp):
    """a - b assuming a >= b; returns 16-bit limb list."""
    out = []
    borrow = xp.zeros_like(a_limbs[0])
    for i in range(len(a_limbs)):
        d = (a_limbs[i] | xp.uint32(1 << 17)) - b_limbs[i] - borrow
        out.append(d & LIMB_MASK)
        borrow = 1 - ((d >> 17) & 1)
    return out

def _split(x, xp):
    return [x[..., i] for i in range(x.shape[-1])]


def _join(limbs, xp):
    return xp.stack(limbs, axis=-1)


def _cond_sub_p(limbs, xp):
    """limbs (8x16-bit, value < 2^128): subtract p if >= p."""
    p = [xp.uint32(v) + xp.zeros_like(limbs[0]) for v in P_LIMBS]
    ge = _ge(limbs, p, xp)
    sub = _sub_limbs(limbs, p, xp)
    return [xp.where(ge, s, a) for s, a in zip(sub, limbs)]


def add(a, b, xp):
    a, b = _np.broadcast_arrays(a, b)
    cols = a.astype(_np.uint64) + b
    return _reduce_cols_u64(cols)


def neg(a, xp):
    al = _split(a, xp)
    p = [xp.uint32(v) + xp.zeros_like(al[0]) for v in P_LIMBS]
    res = _sub_limbs(p, al, xp)
    # a == 0 -> result 0 (p - 0 = p ≡ 0, must canonicalize)
    is_zero = al[0] == al[0]
    for l in al:
        is_zero = is_zero & (l == 0)
    return _join([xp.where(is_zero, xp.zeros_like(r), r) for r in res], xp)


def sub(a, b, xp):
    return add(a, neg(b, xp), xp)


def _mul_numpy_u64(a, b):
    """Host fast path: uint64 accumulators (8 vector ops instead of 64).

    Only valid off-device — the TPU path must stay uint32 (limb products
    are exact in u32; column sums here need u64 headroom).
    """
    A = a.astype(_np.uint64)
    B = b.astype(_np.uint64)
    shape = A.shape[:-1]
    cols = _np.zeros(shape + (16,), dtype=_np.uint64)
    for i in range(NLIMB):
        cols[..., i:i + NLIMB] += A[..., i:i + 1] * B
    return _reduce_cols_u64(cols)


def _reduce_cols_u64(cols):
    """Carry-propagate u64 columns (< 2^48) into 16-bit limbs + reduce."""
    out = []
    carry = _np.zeros(cols.shape[:-1], dtype=_np.uint64)
    for k in range(cols.shape[-1]):
        s = cols[..., k] + carry
        out.append((s & LIMB_MASK).astype(_np.uint32))
        carry = s >> 16
    # residual carry can exceed 16 bits; split into two limbs
    out.append((carry & LIMB_MASK).astype(_np.uint32))
    out.append((carry >> 16).astype(_np.uint32))
    return _reduce_wide(out, _np)


def _dot_numpy_u64(a, b):
    J = a.shape[-2]
    A = _np.asarray(a, dtype=_np.uint64)
    B = _np.asarray(b, dtype=_np.uint64)
    A, B = _np.broadcast_arrays(A, B)
    shape = A.shape[:-2]
    cols = _np.zeros(shape + (16,), dtype=_np.uint64)
    # u64 bound: J * 8 * (2^32) -> J <= 2^29; sum over J inside einsum
    for i in range(NLIMB):
        cols[..., i:i + NLIMB] += _np.einsum(
            "...j,...jk->...k", A[..., i], B)
    return _reduce_cols_u64(cols)


def mul(a, b, xp):
    """Full 128x128 -> 256-bit schoolbook product + fold reduction."""
    a, b = _np.broadcast_arrays(a, b)
    return _mul_numpy_u64(a, b)


def _reduce_wide_numpy(wide_limbs):
    """Host fast path for _reduce_wide using u64 column folds."""
    limbs = [l.astype(_np.uint64) for l in wide_limbs]
    shape = limbs[0].shape
    while len(limbs) > NLIMB:
        lo = limbs[:NLIMB]
        hi = limbs[NLIMB:]
        cols = _np.zeros(shape + (len(hi) + 3,), dtype=_np.uint64)
        H = _np.stack(hi, axis=-1)
        for t, cv in enumerate(C_LIMBS):
            cols[..., t:t + len(hi)] += H * _np.uint64(cv)
        for i in range(min(NLIMB, cols.shape[-1])):
            cols[..., i] += lo[i]
        # lo tail beyond cols width (when len(hi)+3 < 8) — widen
        if cols.shape[-1] < NLIMB:
            extra = _np.zeros(shape + (NLIMB - cols.shape[-1],),
                              dtype=_np.uint64)
            cols = _np.concatenate([cols, extra], axis=-1)
            for i in range(NLIMB):
                if i >= len(hi) + 3:
                    cols[..., i] += lo[i]
        limbs = []
        carry = _np.zeros(shape, dtype=_np.uint64)
        for k in range(cols.shape[-1]):
            s = cols[..., k] + carry
            limbs.append(s & LIMB_MASK)
            carry = s >> 16
        limbs.append(carry & LIMB_MASK)
        limbs.append(carry >> 16)
        # trim top zero limbs to guarantee progress
        while len(limbs) > NLIMB and not limbs[-1].any():
            limbs.pop()
    limbs = [l.astype(_np.uint32) for l in limbs]
    limbs = _cond_sub_p(limbs, _np)
    return _join(limbs, _np)


def _reduce_wide(wide_limbs, xp):
    """Reduce a wide value (list of 16-bit limbs, any length) mod p.

    Repeatedly folds hi * C + lo using 2^128 ≡ C (mod p) until the value
    fits in 128 bits, then one conditional subtract of p.
    """
    return _reduce_wide_numpy(wide_limbs)


def cube(a, xp):
    """a^3 mod p."""
    return _mul_numpy_u64(_mul_numpy_u64(a, a), a)


def sqr(a, xp):
    return mul(a, a, xp)


def dot(a, b, xp):
    """Sum_j a[..., j, :] * b[..., j, :] with a SINGLE modular reduction.

    a, b: (..., J, 8) limb arrays.  Accumulates the 256-bit product
    columns of all J products before reducing once."""
    return _dot_numpy_u64(a, b)


def sum_mod(a, axis: int, xp):
    """Sum field elements along `axis` with ONE reduction (axis lengths
    <= 65536)."""
    n = a.shape[axis]
    assert n <= 65536, "sum_mod: digit-column overflow; split the sum"
    cols = a.sum(axis=axis, dtype=_np.uint64)
    limbs = []
    carry = _np.zeros(cols.shape[:-1], dtype=_np.uint64)
    for k in range(NLIMB):
        s = cols[..., k] + carry
        limbs.append((s & LIMB_MASK).astype(_np.uint64))
        carry = s >> 16
    limbs.extend([carry & LIMB_MASK, carry >> 16])
    limbs = [l.astype(_np.uint32) for l in limbs]
    return _reduce_wide(limbs, _np)


def powers_np(z: int, n: int) -> _np.ndarray:
    """[z^0 .. z^(n-1)] as an (n, 8) uint32 limb array.

    Log-doubling on vectorized host limb math: log2(n) broadcast muls
    instead of the n sequential Python field muls the OOD stage paid
    per z-point (2 points x 4096 rows x 16 segments was ~131k scalar
    muls per proving round)."""
    from . import f128 as _f
    out = _np.asarray(from_ints([1]), dtype=_np.uint32)
    zk = z % _f.P
    while out.shape[0] < n:
        blk = mul(out, _np.asarray(from_ints([zk]), dtype=_np.uint32),
                  _np)
        out = _np.concatenate([out, blk.astype(_np.uint32)], axis=0)
        zk = _f.mul(zk, zk)
    return out[:n]


def mul_small(a, k, xp):
    """Multiply by a small uint (< 2^16) constant."""
    al = _split(a, xp)
    ku = xp.uint32(k)
    lo_cols = [(l * ku) & LIMB_MASK for l in al] + [xp.zeros_like(al[0])]
    hi_cols = [xp.zeros_like(al[0])] + [(l * ku) >> 16 for l in al]
    cols = [l + h for l, h in zip(lo_cols, hi_cols)]
    limbs, carry = _carry_propagate(cols, xp)
    # value < p * 2^16 < 2^144: 9 limbs + small carry; widen to 16 limbs
    wide = limbs + [carry] + [xp.zeros_like(carry)] * (16 - len(limbs) - 1)
    return _reduce_wide(wide, xp)


def is_zero(a, xp):
    al = _split(a, xp)
    z = al[0] == 0
    for l in al[1:]:
        z = z & (l == 0)
    return z


def eq(a, b, xp):
    al, bl = _split(a, xp), _split(b, xp)
    e = al[0] == bl[0]
    for x, y in zip(al[1:], bl[1:]):
        e = e & (x == y)
    return e


def select(cond, a, b, xp):
    """cond ? a : b  (cond shape = a.shape[:-1])."""
    return xp.where(cond[..., None], a, b)


def exp_int(a, e: int, xp):
    """a ** e for a static Python int exponent (square-and-multiply)."""
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base, xp)
        e >>= 1
        if e:
            base = mul(base, base, xp)
    if result is None:
        return ones(a.shape[:-1], xp)
    return result


def inv(a, xp):
    """Fermat inverse a^(p-2); zero maps to zero."""
    return exp_int(a, f128.P - 2, xp)


def batch_inv(a, xp):
    """Batch inversion along axis 0 of a (n, ..., 8) limb array.

    Uses a Montgomery product ladder: ~3 muls per element plus ONE
    field exponentiation, vs. one exponentiation per element for inv().
    Zeros map to zeros (winterfell convention).
    """
    n = a.shape[0]
    one = ones(a.shape[1:-1], xp)
    zero_mask = is_zero(a, xp)
    safe = select(zero_mask, ones(a.shape[:-1], xp), a, xp)

    # prefix products
    prefixes = [one]
    acc = one
    for i in range(n):
        acc = mul(acc, safe[i], xp)
        prefixes.append(acc)
    total_inv = inv(acc, xp)

    outs = [None] * n
    acc = total_inv
    for i in range(n - 1, -1, -1):
        outs[i] = mul(acc, prefixes[i], xp)
        acc = mul(acc, safe[i], xp)
    out = xp.stack(outs, axis=0)
    return select(zero_mask, zeros(a.shape[:-1], xp), out, xp)


def batch_inv_tree(a, xp):
    """Batch inversion along axis 0 for power-of-two n, in log depth.

    A product tree (pairwise down, distribute up) does ~3n muls in
    log2(n) vectorized steps plus ONE Fermat exponentiation — the ladder
    in batch_inv is sequential in n and unusable on device for large
    batches.  Zeros map to zeros (winterfell convention)."""
    n = a.shape[0]
    assert n & (n - 1) == 0, "batch_inv_tree: n must be a power of two"
    zero_mask = is_zero(a, xp)
    safe = select(zero_mask, ones(a.shape[:-1], xp), a, xp)

    levels = [safe]
    cur = safe
    while cur.shape[0] > 1:
        cur = mul(cur[0::2], cur[1::2], xp)
        levels.append(cur)
    inv_cur = inv(cur, xp)                       # (1, ..., 8)
    for lvl in reversed(levels[:-1]):
        inv_left = mul(inv_cur, lvl[1::2], xp)
        inv_right = mul(inv_cur, lvl[0::2], xp)
        stacked = xp.stack([inv_left, inv_right], axis=1)
        inv_cur = stacked.reshape(lvl.shape)
    return select(zero_mask, zeros(a.shape[:-1], xp), inv_cur, xp)
