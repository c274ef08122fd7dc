"""zklisp_tpu_torch.field.{digit_dot, mxu} and the four-step dispatch of
field.ntt against the JAX package's field/mxu.py (CPU JAX) and the port's
own radix-2 NTT.  Inputs come from numpy seeds; every comparison is exact
(tolerance 0).  On the CPU `digit_dot` is its plain version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu.field import mxu as M
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.field import digit_dot as TD
from zklisp_tpu_torch.field import limb as TL
from zklisp_tpu_torch.field import mxu as TM
from zklisp_tpu_torch.field import ntt as TN

P = f128.P


def _rand_ints(rng, shape):
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]
    return np.asarray(vals, dtype=object).reshape(shape)


def _limbs(ints):
    return np.asarray(L.from_ints(ints.tolist()), dtype=np.uint32)


def _same(ref, got):
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          convert.to_numpy_u32(got))


# --- weight matrices and tables --------------------------------------------

@pytest.mark.parametrize("J,K", [(1, 1), (7, 5), (64, 3)])
def test_wmat_from_ints_and_planes(J, K):
    W = _rand_ints(np.random.default_rng(J * 100 + K), (J, K))
    W[0, 0] = P - 1
    ref = M.wmat_from_ints(W.tolist())
    got = TM.wmat_from_ints(W.tolist())
    assert got.dtype == ref.dtype and np.array_equal(ref, got)
    for r, g in zip(M.wmat_planes(ref), TM.wmat_planes(got)):
        assert g.dtype == np.uint8 and np.array_equal(r, g)


@pytest.mark.parametrize("m,inverse", [(16, False), (32, True), (64, False)])
def test_dft_planes_equal(m, inverse):
    for r, g in zip(M._dft_wmat(m, inverse), TM._dft_wmat(m, inverse)):
        assert np.array_equal(r, g)
    # and the stacked device form is [w_lo | w_hi] transposed
    lo, hi = M._dft_wmat(m, inverse)
    wt = convert.wmat_planes_to_torch(lo, hi, "cpu")
    assert wt.dtype == torch.uint8 and tuple(wt.shape) == (2 * m * 16, m * 8)
    assert np.array_equal(wt.numpy(), np.concatenate([lo, hi], 1).T)
    assert torch.equal(wt, TM.dft_planes(m, inverse, "cpu"))


@pytest.mark.parametrize("n,inverse", [(512, False), (1024, True),
                                       (4096, False)])
def test_twiddles_and_split_equal(n, inverse):
    assert TM._split_n(n) == M._split_n(n)
    assert np.array_equal(M._twiddles(n, inverse), TM._twiddles(n, inverse))
    _same(M._twiddles(n, inverse), TM.twiddles(n, inverse, "cpu"))


# --- digit_dot ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8])
def test_digit_dot_plain_at_the_probe(dtype):
    """The probe's shape and data (seed 0, digits below 128): equal to
    the numpy int64 product."""
    rng = np.random.default_rng(0)
    w8 = rng.integers(0, 128, size=(192, 96), dtype=np.uint8)
    x8 = rng.integers(0, 128, size=(96, 512), dtype=np.uint8)
    want = w8.astype(np.int64) @ x8.astype(np.int64)
    a = torch.from_numpy(w8).to(dtype)
    wt = torch.from_numpy(np.ascontiguousarray(x8.T)).to(dtype)
    for fn in (TD.digit_dot_plain, TD.digit_dot):   # CPU: the same thing
        got = fn(a, wt)
        assert got.dtype == torch.int32 and tuple(got.shape) == (192, 512)
        assert np.array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("M_,K,N", [(1, 100, 16), (77, 45, 19),
                                    (40, 4096, 8), (3, 32768, 2)])
def test_digit_dot_plain_edges(M_, K, N):
    """Ragged shapes and the accumulation edge (all-255 digits)."""
    rng = np.random.default_rng(K)
    a = rng.integers(0, 256, size=(M_, K), dtype=np.uint8)
    wt = rng.integers(0, 256, size=(N, K), dtype=np.uint8)
    a[0] = 255
    wt[0] = 255
    want = a.astype(np.int64) @ wt.astype(np.int64).T
    assert want.max() < 1 << 31
    got = TD.digit_dot(torch.from_numpy(a), torch.from_numpy(wt))
    assert np.array_equal(got.numpy().astype(np.int64), want)


def test_digit_dot_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(TypeError):
        TD.digit_dot(a, a.to(torch.int8))
    with pytest.raises(TypeError):
        TD.digit_dot(a.to(torch.int32), a.to(torch.int32))
    with pytest.raises(ValueError):
        TD.digit_dot(a, torch.zeros((4, 64), dtype=torch.uint8))
    big = torch.zeros((1, TD.MAX_K + 1), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TD.digit_dot(big, big)
    assert TD.digit_dot.launches == 0     # a CPU call launches no kernel


# --- field_matmul ------------------------------------------------------------

@pytest.mark.parametrize("J", [8, 64, 220])
@pytest.mark.parametrize("K", [1, 64])
@pytest.mark.parametrize("fill", ["random", "zero", "p-1"])
def test_field_matmul_equals_jax(J, K, fill):
    rng = np.random.default_rng(J * 1000 + K)
    W = _rand_ints(rng, (J, K))
    B = 5
    if fill == "random":
        a = _rand_ints(rng, (B, J))
    else:
        v = 0 if fill == "zero" else P - 1
        a = np.full((B, J), v, dtype=object)
        if fill == "p-1":
            W[:] = P - 1
    w_lo, w_hi = M.wmat_planes(M.wmat_from_ints(W.tolist()))
    ref = np.asarray(jax.jit(lambda *t: M.field_matmul(*t, jnp))(
        jnp.asarray(_limbs(a)), jnp.asarray(w_lo), jnp.asarray(w_hi)))
    got = TM.field_matmul(convert.limbs_to_torch(_limbs(a), "cpu"),
                          convert.wmat_planes_to_torch(w_lo, w_hi, "cpu"))
    _same(ref, got)
    if K == 1:                       # and against host integers
        want = [sum(int(x) * int(w[0]) for x, w in zip(row, W)) % P
                for row in a]
        assert [int(v) for v in TL.to_ints(got)[:, 0]] == want


def test_field_matmul_takes_a_strided_view():
    rng = np.random.default_rng(9)
    W = _rand_ints(rng, (6, 2))
    a = convert.limbs_to_torch(_limbs(_rand_ints(rng, (6, 4))), "cpu")
    wt = TM.stack_planes(*TM.wmat_planes(TM.wmat_from_ints(W.tolist())),
                         "cpu")
    view = a.transpose(0, 1)                       # (4, 6, 8), strided
    assert not view.is_contiguous()
    assert torch.equal(TM.field_matmul(view, wt),
                       TM.field_matmul(view.contiguous(), wt))


# --- four-step NTT -----------------------------------------------------------

@pytest.fixture(scope="module")
def columns():
    rng = np.random.default_rng(1)
    out = {}
    for n in (512, 1024, 4096):
        x = _limbs(_rand_ints(rng, (3, n)))
        out[n] = (x, convert.limbs_to_torch(x, "cpu"))
    return out


def _radix2(xt, inverse):
    n = xt.shape[-2]
    y = TN._butterflies(xt, TN.powers_table(n.bit_length() - 1, "cpu",
                                            inverse=inverse))
    if inverse:
        y = TL.mul(y, TL.from_ints([f128.inv(n)], "cpu"))
    return y


@pytest.mark.parametrize("n", [512, 1024, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_four_step_equals_jax_and_radix2(columns, n, inverse):
    x, xt = columns[n]
    got = TM.ntt_four_step(xt, inverse)            # 3 columns in one call
    # under jit, as the JAX prover runs it (eager JAX compiles every op
    # of the on-device twiddle build separately: ~10x slower here)
    ref = jax.jit(lambda a: M.ntt_four_step(a, jnp, inverse))
    _same(ref(jnp.asarray(x)), got)
    assert torch.equal(got, _radix2(xt, inverse))


@pytest.mark.parametrize("name", ["ntt", "intt"])
def test_ntt_dispatch_honours_the_switch(columns, monkeypatch, name):
    """n >= MXU_NTT_MIN goes through field_matmul unless ZKL_NO_MXU_NTT
    is set; smaller transforms never do; same limbs either way."""
    calls = []
    real = TM.field_matmul
    monkeypatch.setattr(TM, "field_matmul",
                        lambda a, wt: calls.append(a.shape) or real(a, wt))
    fn = getattr(TN, name)
    x, xt = columns[512]
    monkeypatch.delenv("ZKL_NO_MXU_NTT", raising=False)
    four = fn(xt)
    assert len(calls) == 2
    fn(xt[:, :256])
    assert len(calls) == 2                          # below MXU_NTT_MIN
    monkeypatch.setenv("ZKL_NO_MXU_NTT", "1")
    two = fn(xt)
    assert len(calls) == 2                          # radix-2
    assert torch.equal(four, two)
    assert torch.equal(two, _radix2(xt, name == "intt"))


@pytest.mark.slow
def test_ntt_four_step_recursion_above_65536():
    """n = 2^17: the second stage recurses; equals radix-2."""
    rng = np.random.default_rng(2)
    n = 1 << 17
    raw = rng.integers(0, 1 << 16, size=(1, n, 8), dtype=np.int64)
    raw[..., 7] = np.minimum(raw[..., 7], 0xFFFE)
    xt = torch.from_numpy(raw.astype(np.int32))
    for inverse in (False, True):
        assert torch.equal(TM.ntt_four_step(xt, inverse),
                           _radix2(xt, inverse))
