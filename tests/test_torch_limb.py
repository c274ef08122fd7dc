"""zklisp_tpu_torch.field.limb against the JAX package's numpy limb path.

Integer field arithmetic: every comparison is exact (tolerance 0), limb
for limb."""

import numpy as np
import pytest
import torch

from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.field import limb as T

P = f128.P
EDGE = [0, 1, P - 1, P - 2, 2, (1 << 128) % P, (1 << 64) - 1, 1 << 64,
        P >> 1, (P >> 1) + 1]


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    v = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]
    v[:len(EDGE)] = EDGE
    return v


@pytest.fixture(scope="module")
def ab():
    a = _vals(240, 1)
    b = list(reversed(_vals(240, 2)))
    b[2] = P - 1            # (P-1) op (P-1)
    b[0] = 0                # 0 op 0
    an, bn = L.from_ints(a), L.from_ints(b)
    return an, bn, convert.limbs_to_torch(an, "cpu"), \
        convert.limbs_to_torch(bn, "cpu")


def _same(ref, got):
    assert got.dtype == torch.int32
    out = convert.to_numpy_u32(got)
    assert out.shape == np.asarray(ref).shape
    assert np.array_equal(np.asarray(ref).astype(np.uint32), out)


BINARY = {
    "add": (lambda a, b: L.add(a, b, np), T.add),
    "sub": (lambda a, b: L.sub(a, b, np), T.sub),
    "mul": (lambda a, b: L.mul(a, b, np), T.mul),
    "mul_broadcast": (lambda a, b: L.mul(a, b[3:4], np),
                      lambda a, b: T.mul(a, b[3:4])),
    "dot": (lambda a, b: L.dot(a.reshape(8, 30, 8), b.reshape(8, 30, 8), np),
            lambda a, b: T.dot(a.reshape(8, 30, 8), b.reshape(8, 30, 8))),
    "dot_broadcast": (
        lambda a, b: L.dot(a.reshape(8, 1, 30, 8),
                           b.reshape(1, 8, 30, 8), np),
        lambda a, b: T.dot(a.reshape(8, 1, 30, 8), b.reshape(1, 8, 30, 8))),
}
UNARY = {
    "neg": (lambda a: L.neg(a, np), T.neg),
    "cube": (lambda a: L.cube(a, np), T.cube),
    "sqr": (lambda a: L.sqr(a, np), T.sqr),
    "mul_small_max": (lambda a: L.mul_small(a, 65535, np),
                      lambda a: T.mul_small(a, 65535)),
    "mul_small_3": (lambda a: L.mul_small(a, 3, np),
                    lambda a: T.mul_small(a, 3)),
    "sum_mod_axis1": (lambda a: L.sum_mod(a.reshape(8, 30, 8), 1, np),
                      lambda a: T.sum_mod(a.reshape(8, 30, 8), 1)),
    "sum_mod_axis0": (lambda a: L.sum_mod(a, 0, np),
                      lambda a: T.sum_mod(a, 0)),
    "exp_int": (lambda a: L.exp_int(a, 0x1234567, np),
                lambda a: T.exp_int(a, 0x1234567)),
    "exp_int_zero": (lambda a: L.exp_int(a, 0, np),
                     lambda a: T.exp_int(a, 0)),
    "inv_small": (lambda a: L.inv(a[:12], np), lambda a: T.inv(a[:12])),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_op_equals_numpy(ab, op):
    an, bn, at, bt = ab
    ref_fn, got_fn = BINARY[op]
    _same(ref_fn(an, bn), got_fn(at, bt))


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_op_equals_numpy(ab, op):
    an, _, at, _ = ab
    ref_fn, got_fn = UNARY[op]
    _same(ref_fn(an), got_fn(at))


def test_accumulator_bounds_at_maximum():
    """All operands p - 1 at the largest supported widths: dot over
    J = 2048 terms and sum_mod over 65536 rows."""
    big = np.broadcast_to(L.from_ints([P - 1]), (2048, 8))
    bt = convert.limbs_to_torch(big, "cpu")
    _same(L.dot(big[None], big[None], np), T.dot(bt[None], bt[None]))
    big = np.broadcast_to(L.from_ints([P - 1]), (65536, 8))
    _same(L.sum_mod(big, 0, np),
          T.sum_mod(convert.limbs_to_torch(big, "cpu"), 0))


def test_batch_inv_tree(ab):
    an = ab[0][:128].copy()
    an[7] = 0                      # a zero inside the batch maps to zero
    _same(L.batch_inv_tree(an, np),
          T.batch_inv_tree(convert.limbs_to_torch(an, "cpu")))


def test_eq_select_is_zero(ab):
    an, bn, at, bt = ab
    bn2 = bn.copy()
    bn2[::3] = an[::3]
    bt2 = convert.limbs_to_torch(bn2, "cpu")
    cond = T.eq(at, bt2)
    assert np.array_equal(cond.numpy(), L.eq(an, bn2, np))
    _same(L.select(L.eq(an, bn2, np), an, bn, np), T.select(cond, at, bt))
    assert np.array_equal(T.is_zero(at).numpy(), L.is_zero(an, np))


def test_int_round_trip_and_from_i64():
    vals = _vals(40, 5)
    t = T.from_ints(vals, "cpu")
    assert t.dtype == torch.int32 and tuple(t.shape) == (40, 8)
    assert [int(v) for v in T.to_ints(t)] == vals
    assert [int(v) for v in L.to_ints(convert.to_numpy_u32(t))] == vals
    small = np.asarray([0, 1, 65535, 65536, (1 << 62) - 1], dtype=np.uint64)
    _same(L.from_u64(small, np),
          T.from_i64(torch.from_numpy(small.astype(np.int64))))
    assert int(T.to_ints(T.ones((), "cpu"))) == 1
    assert not T.zeros((3,), "cpu").any()
