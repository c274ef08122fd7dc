"""The FRI commit phase of zklisp_tpu_torch.prove.stark_device with the
coin on the device (`fri_layers_chain`: no read-back inside the loop, one
copy of the roots, host coin replayed afterwards) against the per-layer
loop with the host coin (`fri_layers_loop`) and against the JAX package's
fused chain (`_fri_chain_fn`, CPU JAX).  Exact equality (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu.prove import stark_device as sd
from zklisp_tpu.prove.coin import RandomCoin
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.prove import coin as t_coin
from zklisp_tpu_torch.prove import stark_device as t_sd

SEED_ELEMENTS = [3, 1, 4, 1, 5, 9, 2, 6]


def _deep(n: int) -> np.ndarray:
    raw = np.random.default_rng(n).integers(0, 1 << 16, size=(n, 8),
                                            dtype=np.int64)
    raw[:, 7] = np.minimum(raw[:, 7], 0xFFFE)             # canonical
    return raw.astype(np.uint32)


def _run(fn, n: int, num_layers: int):
    coin = t_coin.RandomCoin(SEED_ELEMENTS)
    coin.reseed(bytes(range(32)))
    comms, layers, last = fn(convert.limbs_to_torch(_deep(n), "cpu"), coin,
                             num_layers)
    return coin, comms, layers, last


@pytest.mark.parametrize("n,num_layers", [(64, 3), (256, 5), (1024, 0)])
def test_chain_equals_loop(n, num_layers):
    c_loop, comms_l, layers_l, last_l = _run(t_sd.fri_layers_loop, n,
                                             num_layers)
    c_chain, comms_c, layers_c, last_c = _run(t_sd.fri_layers_chain, n,
                                              num_layers)
    assert len(comms_c) == len(comms_l) == num_layers
    assert [c.root for c in comms_c] == [c.root for c in comms_l]
    for a, b in zip(layers_c, layers_l):
        assert torch.equal(a, b)
    for ca, cb in zip(comms_c, comms_l):
        assert len(ca.levels) == len(cb.levels)
        for a, b in zip(ca.levels, cb.levels):
            assert torch.equal(a, b)
    assert torch.equal(last_c, last_l)                    # the remainder
    assert tuple(last_c.shape) == (n >> num_layers, 8)
    # the host coin after the replay is where the loop left it: what
    # follows FRI (grind, query positions) reads the seed only
    assert c_chain.seed == c_loop.seed
    assert c_chain.check_leading_zeros(7) == c_loop.check_leading_zeros(7)
    assert (c_chain.draw_integers(8, n, 5)
            == c_loop.draw_integers(8, n, 5))
    # sibling paths open the same way from either commitment list
    if num_layers:
        pos = [[0, (n >> (d + 1)) - 1] for d in range(num_layers)]
        assert (t_sd.open_paths_multi(comms_c, pos)
                == t_sd.open_paths_multi(comms_l, pos))


def test_chain_equals_the_jax_chain():
    """Roots, layers and remainder against the JAX package's fused chain
    on the same DEEP layer and coin seed."""
    n, num_layers = 64, 3
    coin, comms, layers, last = _run(t_sd.fri_layers_chain, n, num_layers)
    ref_coin = RandomCoin(SEED_ELEMENTS)
    ref_coin.reseed(bytes(range(32)))
    tabs = [sd._x0_tables(n >> d) for d in range(num_layers)]
    seed_fe = f128.fold_bytes32_to_fe(ref_coin.seed)
    r_layers, r_levels, r_roots, r_last = sd._fri_chain_fn(n, num_layers)(
        jnp.asarray(_deep(n)), jnp.asarray(L.from_ints([seed_fe]))[0],
        tuple(jnp.asarray(t[0]) for t in tabs),
        tuple(jnp.asarray(t[1]) for t in tabs))
    roots = [int(v) for v in L.to_ints(np.asarray(r_roots))]
    assert [c.root_fe for c in comms] == roots
    for a, b in zip(r_layers, layers):
        assert np.array_equal(np.asarray(a), convert.to_numpy_u32(b))
    for lv_ref, comm in zip(r_levels, comms):
        for a, b in zip(lv_ref, comm.levels):
            assert np.array_equal(np.asarray(a), convert.to_numpy_u32(b))
    assert np.array_equal(np.asarray(r_last), convert.to_numpy_u32(last))
    for r in roots:
        ref_coin.reseed(f128.fe_to_bytes_fold(r))
    assert coin.seed == ref_coin.seed
