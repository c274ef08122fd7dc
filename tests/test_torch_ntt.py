"""zklisp_tpu_torch.field.ntt against the JAX package's numpy radix-2
NTT, n = 64, blowup 8.  Exact equality (tolerance 0)."""

import numpy as np
import pytest

from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu.field import ntt as N
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.field import ntt as TN

P = f128.P
C, n, BLOWUP = 3, 64, 8


@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(0)
    x = L.from_ints([[int.from_bytes(rng.bytes(16), "little") % P
                      for _ in range(n)] for _ in range(C)])
    return x, convert.limbs_to_torch(x, "cpu")


def _same(ref, got):
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          convert.to_numpy_u32(got))


CASES = {
    "ntt": (lambda c: N.ntt(c, np), TN.ntt),
    "intt": (lambda c: N.intt(c, np), TN.intt),
    "coset_evaluate": (lambda c: N.coset_evaluate(c, BLOWUP, np),
                       lambda t: TN.coset_evaluate(t, BLOWUP)),
    "coset_evaluate_blowup1": (lambda c: N.coset_evaluate(c, 1, np),
                               lambda t: TN.coset_evaluate(t, 1)),
    "coset_interpolate": (lambda c: N.coset_interpolate(c, BLOWUP, np),
                          TN.coset_interpolate),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_batched_over_columns(cols, name):
    x, xt = cols
    ref_fn, got_fn = CASES[name]
    got = got_fn(xt)                       # all columns in one call
    for c in range(C):
        _same(ref_fn(x[c]), got[c])


def test_tables_and_round_trip(cols):
    x, xt = cols
    _same(N.offset_powers(n, np), TN.offset_powers(n, "cpu"))
    _same(N.powers_table(6, np), TN.powers_table(6, "cpu"))
    _same(N.powers_table(6, np, inverse=True),
          TN.powers_table(6, "cpu", inverse=True))
    _same(x, TN.intt(TN.ntt(xt)))
    lde = TN.coset_evaluate(xt, BLOWUP)
    _same(x, TN.coset_interpolate(lde)[:, :n])


def test_lde_columns_chunked(cols):
    from zklisp_tpu_torch.prove.stark_device import lde_columns
    x, xt = cols
    polys, lde = lde_columns(xt, BLOWUP, col_chunk=2)
    for c in range(C):
        poly = N.intt(x[c], np)
        _same(poly, polys[c])
        _same(N.coset_evaluate(poly, BLOWUP, np), lde[c])
