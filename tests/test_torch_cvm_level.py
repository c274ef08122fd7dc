"""The leveled constraint executor of zklisp_tpu_torch.prove.cvm against
the JAX package's (prove/cvm.py), on the AIR of tests/test_cvm_level.py
and on a random DAG with heavy sharing.  The schedules are compared array
for array, the executors limb for limb (tolerance 0); the port's stack
executor is the third party."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zklisp_tpu.field import f128, limb
from zklisp_tpu.prove import cvm
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.prove import cvm as t_cvm

P = f128.P
SRC, ARGS = "(def (main a b) (+ (* a a) b))", [3, 4]
BLOWUP = 8


def _rand_limbs(rng, shape):
    raw = rng.integers(0, 1 << 16, size=tuple(shape) + (8,), dtype=np.int64)
    raw[..., 7] = np.minimum(raw[..., 7], 0xFFFE)         # canonical
    return raw.astype(np.uint32)


def _air(pkg: str):
    """The recorded program of the small AIR, in one package."""
    import importlib
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    prog_c = mod("compiler").compile_entry(SRC, ARGS)
    pi_mod = mod("core.pi")
    pi = (pi_mod.PublicInputsBuilder(prog_c)
          .with_main_args([pi_mod.VmArg.u64(3), pi_mod.VmArg.u64(4)])
          .build())
    tb = mod("trace.build")
    trace = tb.build_trace(prog_c, pi)
    air_pi = mod("air.airpi").build_air_pi_for_trace(
        pi, pi.feature_mask, tb.rom_acc_from_program(prog_c), None, None,
        trace)
    air = mod("air.zk_air").ZkLispAir(trace.width, trace.length, air_pi)
    n_per = len(air.periodic_lde_period(BLOWUP))
    prog, _ = mod("prove.stark_device")._record_cvm(air, n_per + 1)
    return air, trace, prog


@pytest.fixture(scope="module")
def programs():
    air, trace, ref = _air("zklisp_tpu")
    _, _, got = _air("zklisp_tpu_torch")
    assert ref.n_instr and ref.levels is not None
    return air, trace, ref, got


@pytest.fixture(scope="module")
def small_lde(programs):
    air, trace, _, _ = programs
    rng = np.random.default_rng(3)
    w, N = air.trace_width, trace.length * BLOWUP
    per_p = np.asarray(limb.from_ints(air.periodic_lde_period(BLOWUP)),
                       dtype=np.uint32)
    return (_rand_limbs(rng, (w, N)), per_p, _rand_limbs(rng, (N,)),
            _rand_limbs(rng, (air.num_transition_constraints(),)))


def _levels_equal(a, b):
    assert a.sig == b.sig and a.n_slots == b.n_slots
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert len(la) == len(lb)
        for ba, bb in zip(la, lb):
            assert ba[0] == bb[0] and ba[5] == bb[5]
            for x, y in zip(ba[1:5], bb[1:5]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    for name in ("root_src", "root_k", "root_aidx", "consts"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("what", ["bytecode", "levels", "converted"])
def test_compile_levels_equals_jax(programs, what):
    _, _, ref, got = programs
    if what == "bytecode":
        assert got.n_instr == ref.n_instr
        for name in ("ops", "arg", "imm", "aidx"):
            assert np.array_equal(getattr(ref, name), getattr(got, name))
    elif what == "levels":
        _levels_equal(ref.levels, got.levels)
    else:
        _levels_equal(ref.levels,
                      convert.level_program_from_arrays(ref.levels))


@pytest.mark.parametrize("schedule", ["port", "converted"])
def test_execute_leveled_equals_stack_and_jax(programs, small_lde,
                                              schedule):
    _, _, ref, got = programs
    lde, per_p, p_last, alphas = small_lde
    T = lambda a: convert.limbs_to_torch(a, "cpu")
    lp = (got.levels if schedule == "port"
          else convert.level_program_from_arrays(ref.levels))
    acc = t_cvm.execute_leveled(lp, T(lde), T(per_p), T(p_last), T(alphas),
                                BLOWUP)
    stack = t_cvm.execute(got, T(lde), T(per_p), T(p_last), T(alphas),
                          BLOWUP)                  # CPU default: stack
    assert torch.equal(acc, stack)
    want = cvm.execute_leveled(
        ref.levels, jnp.asarray(lde), jnp.asarray(per_p),
        jnp.asarray(p_last), jnp.asarray(alphas), BLOWUP)
    assert np.array_equal(np.asarray(want), convert.to_numpy_u32(acc))


@pytest.mark.parametrize("choice,leveled", [("", False), ("1", True),
                                            ("0", False)])
def test_execute_dispatch(programs, small_lde, monkeypatch, choice,
                          leveled):
    """CPU tensors take the stack executor unless ZKL_CVM_LEVEL=1."""
    _, _, _, got = programs
    T = lambda a: convert.limbs_to_torch(a, "cpu")
    calls = []
    real = t_cvm.execute_leveled
    monkeypatch.setattr(t_cvm, "execute_leveled",
                        lambda *a: calls.append(1) or real(*a))
    if choice:
        monkeypatch.setenv("ZKL_CVM_LEVEL", choice)
    else:
        monkeypatch.delenv("ZKL_CVM_LEVEL", raising=False)
    lde, per_p, p_last, alphas = small_lde
    t_cvm.execute(got, T(lde), T(per_p), T(p_last), T(alphas), BLOWUP)
    assert bool(calls) == leveled


def _random_dag(mod, seed, width, n_per, n_roots, n_nodes):
    """Pool-based random DAG (tests/test_cvm_level.py): every new binop
    draws operands from the whole pool, so sharing and deep reuse chains
    arise naturally.  The same seed gives the same DAG in both packages."""
    rng = np.random.default_rng(seed)
    fe = lambda: ((int(rng.integers(0, 2**63)) << 64)
                  | int(rng.integers(0, 2**63))) % P
    cur, nxt, per = mod.sym_leaves(width, n_per)
    pool = cur + nxt + per + [mod.Sym("const", k=fe()) for _ in range(4)]
    kinds = ["add", "sub", "mul"]
    for _ in range(n_nodes):
        a = pool[int(rng.integers(len(pool)))]
        b = pool[int(rng.integers(len(pool)))]
        pool.append(mod.Sym(kinds[int(rng.integers(3))], a, b))
    return [(pool[len(pool) - 1 - int(rng.integers(n_nodes // 2))], i)
            for i in range(n_roots)]


def test_random_dag_multi_chunk():
    """N = 8192 takes two row chunks of 4096, nxt rows wrap around the
    domain and cross the chunk boundary, and 300 shared nodes exercise
    the append positions: leveled == stack == host interpreter."""
    width, n_per, N, period, blowup = 4, 3, 8192, 16, 32
    ref = cvm.compile_constraints(_random_dag(cvm, 11, width, n_per, 24,
                                              300))
    got = t_cvm.compile_constraints(_random_dag(t_cvm, 11, width, n_per,
                                                24, 300))
    _levels_equal(ref.levels, got.levels)
    rng = np.random.default_rng(5)
    lde, per_p = _rand_limbs(rng, (width, N)), _rand_limbs(
        rng, (n_per - 1, period))
    p_last, alphas = _rand_limbs(rng, (N,)), _rand_limbs(rng, (24,))
    T = lambda a: convert.limbs_to_torch(a, "cpu")
    acc = t_cvm.execute_leveled(got.levels, T(lde), T(per_p), T(p_last),
                                T(alphas), blowup)
    assert tuple(acc.shape) == (N, 8)
    assert torch.equal(acc, t_cvm.execute(got, T(lde), T(per_p), T(p_last),
                                          T(alphas), blowup))
    ints = lambda a: limb.to_ints(a)
    acc_i, lde_i, per_i, pl_i = (ints(convert.to_numpy_u32(acc)), ints(lde),
                                 ints(per_p), ints(p_last))
    al = [int(a) for a in ints(alphas)]
    for r in (0, 4095, 4096, N - blowup, N - 1):
        want = t_cvm.interpret(
            got, [int(lde_i[c, r]) for c in range(width)],
            [int(lde_i[c, (r + blowup) % N]) for c in range(width)],
            [int(per_i[c, r % period]) for c in range(n_per - 1)]
            + [int(pl_i[r])], al)
        assert int(acc_i[r]) == want
