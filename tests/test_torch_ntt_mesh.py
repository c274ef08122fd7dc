"""zklisp_tpu_torch.parallel.ntt_mesh (the four-step NTT and coset LDE
split over the shards of a mesh) against the JAX package's
parallel/ntt_mesh.py on the conftest's virtual CPU devices, and against
the port's one-device `ntt.ntt` / `ntt.coset_evaluate`.  The port's
meshes repeat the CPU (C shards of one device).  Inputs are random field
elements from a numpy seed; exact equality (tolerance 0), limb for
limb.  C = 2, 4, 8 shards and N = 2^8 ... 2^12 points; the inner NTTs of
R >= 512 points take the four-step matrix path (digit_dot's plain
version on the CPU)."""

import jax
import numpy as np
import pytest

from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu.parallel import mesh_prover as j_mesh
from zklisp_tpu.parallel import ntt_mesh as j_nm
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.field import ntt as TN
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.parallel import ntt_mesh as t_nm

P = f128.P


def _limbs(rng, shape):
    vals = [int.from_bytes(rng.bytes(16), "little") % P
            for _ in range(int(np.prod(shape)))]
    return np.asarray(L.from_ints(vals)).reshape(shape + (8,))


def _same(ref, got):
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          convert.to_numpy_u32(got))


def _meshes(C):
    assert len(jax.devices()) >= C, "the conftest gives 8 CPU devices"
    return j_mesh.default_mesh(C), t_mesh.Mesh(["cpu"] * C)


@pytest.mark.parametrize("N,C", [(256, 2), (1024, 4), (4096, 8),
                                 (4096, 2)])
def test_twiddles_dk1_equal_jax(N, C):
    R = N // C
    assert np.array_equal(np.asarray(j_nm._twiddles_dk1(N, R, C)),
                          t_nm._twiddles_dk1(N, R, C))


# Each JAX reference is one compile of its shard_map body (~15-20 s on
# the CPU), so two go through JAX — one transform on 2 shards, and the
# LDE of a batch of 3 on 8 shards (which runs `ntt_sharded_batch`) — and
# every other case holds the port's sharded transform against its
# one-device `ntt.ntt` (tests/test_torch_ntt.py holds that against JAX).

def test_ntt_sharded_equals_jax_and_ntt():
    rng = np.random.default_rng(256)
    x = _limbs(rng, (256,))
    jmesh, tmesh = _meshes(2)
    xt = convert.limbs_to_torch(x, "cpu")
    got = t_nm.ntt_sharded(xt, tmesh)
    _same(jax.jit(lambda v: j_nm.ntt_sharded(v, jmesh))(x), got)
    _same(convert.to_numpy_u32(TN.ntt(xt)), got)


def test_lde_columns_sharded_equals_jax_and_coset_evaluate():
    rng = np.random.default_rng(64)
    polys = _limbs(rng, (3, 64))
    jmesh, tmesh = _meshes(8)
    pt = convert.limbs_to_torch(polys, "cpu")
    got = t_nm.lde_columns_sharded(pt, 8, tmesh)
    assert tuple(got.shape) == (3, 512, 8)
    _same(jax.jit(lambda v: j_nm.lde_columns_sharded(v, 8, jmesh))(polys),
          got)
    _same(convert.to_numpy_u32(TN.coset_evaluate(pt, 8)), got)


@pytest.mark.parametrize("N,C,B", [(1024, 4, 3), (4096, 8, 2),
                                   (4096, 2, 1), (2048, 4, 2)])
def test_ntt_sharded_batch_equals_ntt(N, C, B):
    """Batches on 2, 4 and 8 shards, the inner transform radix-2 (R <
    512) or four-step (R >= 512)."""
    rng = np.random.default_rng(7 * N + C)
    xs = convert.limbs_to_torch(_limbs(rng, (B, N)), "cpu")
    _same(convert.to_numpy_u32(TN.ntt(xs)),
          t_nm.ntt_sharded_batch(xs, t_mesh.Mesh(["cpu"] * C)))


@pytest.mark.parametrize("n,blowup,C", [(512, 8, 2), (256, 16, 4)])
def test_lde_columns_sharded_equals_coset_evaluate(n, blowup, C):
    rng = np.random.default_rng(n * blowup + C)
    pt = convert.limbs_to_torch(_limbs(rng, (2, n)), "cpu")
    _same(convert.to_numpy_u32(TN.coset_evaluate(pt, blowup)),
          t_nm.lde_columns_sharded(pt, blowup, t_mesh.Mesh(["cpu"] * C)))
