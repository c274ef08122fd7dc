"""zklisp_tpu_torch Poseidon (plain permutation, sponge, row hashing,
Merkle tree) against the JAX package on the same seeded inputs.

Integer field arithmetic: exact equality of every limb (tolerance 0).
On the CPU the wrapper `permute12` runs the kernel's plain version."""

import numpy as np
import pytest

from zklisp_tpu.crypto import poseidon as pos
from zklisp_tpu.crypto import poseidon_jax as pj
from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.crypto import poseidon_cuda as pc
from zklisp_tpu_torch.crypto import poseidon_torch as pt

P = f128.P


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]
    return L.from_ints(vals).reshape(tuple(shape) + (8,))


def _t(a):
    return convert.limbs_to_torch(a, "cpu")


def _same(ref, got):
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          convert.to_numpy_u32(got))


@pytest.mark.parametrize("rounds", [8, 27])
@pytest.mark.parametrize("batch", [1, 5, 263])
def test_permute12_plain_matches_jax_package(batch, rounds):
    st = _rand((batch, 12), seed=batch)
    if batch >= 5:
        st[0] = 0
        st[1] = L.from_ints([P - 1])[0]
    ref = pj.permute12_batch(st, pos.HASHER_SUITE_ID, np, rounds)
    _same(ref, pc.permute12_plain(_t(st), pos.HASHER_SUITE_ID, rounds))
    # the wrapper takes the plain version for a CPU tensor
    _same(ref, pc.permute12(_t(st), pos.HASHER_SUITE_ID, rounds))


def test_permute12_leading_dims_and_suite():
    st = _rand((2, 3, 12), seed=42)
    suite = bytes(range(32))
    ref = pj.permute12_batch(st, suite, np, 27)
    out = pt.permute12_batch(_t(st), suite, 27)
    assert tuple(out.shape) == st.shape
    _same(ref, out)


def test_suite_tables_convert():
    mds, rc, dom = pj._suite_arrays(pos.HASHER_SUITE_ID, 8)
    got = pc.suite_tensors(pos.HASHER_SUITE_ID, 8, "cpu")
    for ref, t, via in zip((mds, rc, dom), got,
                           convert.suite_to_torch(mds, rc, dom, "cpu")):
        _same(ref, t)
        _same(ref, via)


def test_permute12_plain_matches_pallas_interpret():
    """One case against the TPU kernel itself, run in interpret mode as
    the JAX package's own tests run it on the CPU."""
    import jax.numpy as jnp

    from zklisp_tpu.crypto import poseidon_pallas as pp
    st = _rand((5, 12), seed=9)
    out = pp.permute12(jnp.asarray(st), pos.HASHER_SUITE_ID, 8,
                       interpret=True)
    _same(np.asarray(out),
          pc.permute12_plain(_t(st), pos.HASHER_SUITE_ID, 8))


def test_launch_counter_untouched_on_cpu():
    before = pc.permute12.launches
    pc.permute12(_t(_rand((2, 12), seed=3)), pos.HASHER_SUITE_ID, 8)
    assert pc.permute12.launches == before


@pytest.mark.parametrize("chunks", [1, 9, 10, 23])
def test_sponge_fes(chunks):
    fes = _rand((7, chunks), seed=chunks)
    ref = pj.sponge_fes(fes, b"zkl/winter/hash/merge", np)
    _same(ref, pt.sponge_fes(_t(fes), b"zkl/winter/hash/merge"))


def test_hash_rows_partitioned_with_remainder_chunk():
    rows = _rand((6, 219), seed=11)           # 13 chunks of 16 + one of 11
    _same(pj.hash_rows_partitioned(rows, 16, np),
          pt.hash_rows_partitioned(_t(rows), 16))
    _same(pj.hash_rows_partitioned(rows[:, :8], 8, np),
          pt.hash_rows_partitioned(_t(rows[:, :8]), 8))
    _same(pj.hash_rows(rows[:, :7], np), pt.hash_rows(_t(rows[:, :7])))


def test_merkle_tree_and_column_commit():
    from zklisp_tpu_torch.prove import kernels
    leaves = _rand((32,), seed=5)
    ref = pj.merkle_tree(leaves, np)
    got = pt.merkle_tree(_t(leaves))
    assert len(ref) == len(got) == 6
    for a, b in zip(ref, got):
        _same(a, b)
    cols = _rand((5, 16), seed=6)             # column-major (C, N, 8)
    rows = np.transpose(cols, (1, 0, 2))
    ref = pj.merkle_tree(pj.hash_rows_partitioned(rows, 2, np), np)
    got = kernels.commit_cols(_t(cols), 2, row_chunk=4)
    for a, b in zip(ref, got):
        _same(a, b)
    _same(ref[-1], kernels.commit_rows(_t(rows), 2)[-1])
