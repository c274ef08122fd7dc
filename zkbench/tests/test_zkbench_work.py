"""The kernel work counts on known shapes."""

import pytest

from zkbench.harness.spec import Spec

SPEC = Spec()


def test_poseidon12_counts_the_definitions_products():
    w = SPEC.work("poseidon12")
    assert w.PRODUCTS_PER_ROUND == 168          # 12 cubes x 2 + 12 x 12
    assert w.OPS_PER_PRODUCT == 512             # 16 x 16 digits, mul + add
    # one state, 27 rounds
    assert w.ops(1, 27) == 27 * 168 * 512
    # 2^20 states: operations bound, 1.23 ms at 1,979 TOP/s
    t = w.least_seconds([1 << 20], 27)
    assert t == pytest.approx((1 << 20) * 27 * 168 * 512 / 1.979e15)
    assert t == pytest.approx(1.2305e-3, rel=1e-3)
    # launches add
    assert w.least_seconds([1 << 19, 1 << 19], 27) == pytest.approx(t)
    # bytes: 384 per state, far below the operations bound
    assert w.nbytes(1) == 384
    assert w.nbytes(1 << 20) / w.PEAK_BYTES < t / 5


def test_digit_dot_counts_ops_or_bytes():
    w = SPEC.work("digit_dot")
    # the wave's main NTT shape is bound by operations: 2.2310 ms
    m, k, n = 131584, 2048, 8192
    assert w.least_seconds([(m, k, n)]) == pytest.approx(
        2 * m * k * n / 1.979e15)
    assert w.least_seconds([(m, k, n)]) == pytest.approx(2.2310e-3,
                                                         rel=1e-3)
    # a thin product is bound by bytes
    m, k, n = 1 << 20, 32, 16
    assert w.least_seconds([(m, k, n)]) == pytest.approx(
        (m * k + k * n + 4 * m * n) / 3.35e12)
    assert w.least_seconds([]) == 0
