"""The port's constraint composition (Poseidon/ROM scan blocks + the cvm
stack executor) against the JAX package: `cvm.interpret` row by row and
`eval_composition_device(..., np)` over a whole domain.

The tiny program of tests/test_device_prover.py gives the AIR; the domain
is one period (256 points at blowup 8) of seeded random column values —
the executors must agree on ANY inputs, valid trace or not.  Exact
equality (tolerance 0)."""

import numpy as np
import pytest
import torch

from zklisp_tpu.air.airpi import build_air_pi_for_trace
from zklisp_tpu.air.zk_air import ZkLispAir
from zklisp_tpu.compiler import compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder, VmArg
from zklisp_tpu.field import f128
from zklisp_tpu.field import limb as L
from zklisp_tpu.field.felt import FVec
from zklisp_tpu.prove import cvm as jcvm
from zklisp_tpu.prove.composition_device import (collect_generic,
                                                 eval_composition_device)
from zklisp_tpu.trace import build as tb
from zklisp_tpu_torch import convert
from zklisp_tpu_torch.air import airpi as t_airpi
from zklisp_tpu_torch.air import zk_air as t_zk_air
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.prove import composition_device as t_comp
from zklisp_tpu_torch.prove import cvm as t_cvm
from zklisp_tpu_torch.prove import stark_device as t_sd
from zklisp_tpu_torch.trace import build as t_tb

SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (push (load 3))
    (hash2 (pop) s)))
(main)
"""
P = f128.P
BLOWUP = 8
N = 32 * BLOWUP            # one period of the cycle-32 selectors


@pytest.fixture(scope="module")
def world():
    # reference AIR (JAX package, host modules)
    prog = compile_str(SRC)
    pi = PublicInputsBuilder(prog).with_secret_args([VmArg.u64(41)]).build()
    trace = tb.build_trace(prog, pi)
    air_pi = build_air_pi_for_trace(pi, pi.feature_mask,
                                    tb.rom_acc_from_program(prog),
                                    None, None, trace)
    air = ZkLispAir(trace.width, trace.length, air_pi)
    # the port's AIR from its own copies of the host modules
    t_prog = t_compile_str(SRC)
    tpi = (t_pi.PublicInputsBuilder(t_prog)
           .with_secret_args([t_pi.VmArg.u64(41)]).build())
    t_trace = t_tb.build_trace(t_prog, tpi)
    t_air_pi = t_airpi.build_air_pi_for_trace(
        tpi, tpi.feature_mask, t_tb.rom_acc_from_program(t_prog),
        None, None, t_trace)
    t_air = t_zk_air.ZkLispAir(t_trace.width, t_trace.length, t_air_pi)
    assert t_prog.commitment == prog.commitment
    assert t_air_pi.to_elements() == air_pi.to_elements()

    w = trace.width
    rng = np.random.default_rng(3)
    lde = L.from_ints([[int.from_bytes(rng.bytes(16), "little") % P
                        for _ in range(N)] for _ in range(w)])
    periodic = [FVec(p.a[:N], np) for p in air.periodic_lde(BLOWUP, np)]
    alphas = [int.from_bytes(rng.bytes(16), "little") % P
              for _ in range(air.num_transition_constraints())]
    return dict(air=air, t_air=t_air, lde=lde, periodic=periodic,
                alphas=alphas, w=w)


def _port_inputs(world):
    lde_t = convert.limbs_to_torch(world["lde"], "cpu")
    per = np.stack([p.a for p in world["periodic"]])
    per_p = convert.limbs_to_torch(per[:-1], "cpu")      # one period each
    p_last = convert.limbs_to_torch(per[-1], "cpu")
    alphas_t = convert.limbs_to_torch(L.from_ints(world["alphas"]), "cpu")
    return lde_t, per_p, p_last, alphas_t


def test_recorded_program_equals_jax_package(world):
    """Same bytecode from the port's copy of the recorder."""
    n_per = len(world["periodic"])
    cur, nxt, per = jcvm.sym_leaves(world["w"], n_per)
    generic, specs = collect_generic(world["air"], cur, nxt, per)
    ref = jcvm.compile_constraints(generic)
    prog, t_specs = t_sd._record_cvm(world["t_air"], n_per)
    assert tuple(specs) == t_specs
    assert prog.n_instr == ref.n_instr and prog.n_slots == ref.n_slots
    for name in ("ops", "arg", "imm", "aidx"):
        assert np.array_equal(getattr(prog, name), getattr(ref, name))


def test_cvm_executor_matches_interpret(world):
    """The torch stack executor vs the JAX package's row interpreter (and
    the port's copy of it) on sampled rows."""
    n_per = len(world["periodic"])
    prog, _ = t_sd._record_cvm(world["t_air"], n_per)
    lde_t, per_p, p_last, alphas_t = _port_inputs(world)
    acc = t_cvm.execute(prog, lde_t, per_p, p_last, alphas_t, BLOWUP)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (N, 8)
    got = [int(v) for v in L.to_ints(convert.to_numpy_u32(acc))]

    cur, nxt, per = jcvm.sym_leaves(world["w"], n_per)
    generic, _ = collect_generic(world["air"], cur, nxt, per)
    ref_prog = jcvm.compile_constraints(generic)
    cols = L.to_ints(world["lde"])
    pers = [L.to_ints(p.a) for p in world["periodic"]]
    for row in (0, 1, 7, 31, 100, N - BLOWUP, N - 1):
        cur_r = [int(cols[c][row]) for c in range(world["w"])]
        nxt_r = [int(cols[c][(row + BLOWUP) % N])
                 for c in range(world["w"])]
        per_r = [int(p[row]) for p in pers]
        ref = jcvm.interpret(ref_prog, cur_r, nxt_r, per_r,
                             world["alphas"])
        assert got[row] == ref
        assert got[row] == t_cvm.interpret(prog, cur_r, nxt_r, per_r,
                                           world["alphas"])


def test_scan_blocks_plus_cvm_match_eval_composition(world):
    """scan blocks + cvm executor == eval_composition_device(..., np)."""
    air = world["air"]
    lde = world["lde"]
    cur = [FVec(lde[c], np) for c in range(world["w"])]
    nxt = [FVec(np.roll(lde[c], -BLOWUP, axis=0), np)
           for c in range(world["w"])]
    ref = eval_composition_device(air, cur, nxt, world["periodic"],
                                  world["alphas"], np)

    n_per = len(world["periodic"])
    prog, specs = t_sd._record_cvm(world["t_air"], n_per)
    assert {k for k, _ in specs} == {"poseidon", "rom"}
    lde_t, per_p, p_last, alphas_t = _port_inputs(world)
    scan = t_comp.eval_scan_blocks(world["t_air"], lde_t, BLOWUP,
                                   per_p[1:1 + 27], alphas_t, specs)
    gen = t_cvm.execute(prog, lde_t, per_p, p_last, alphas_t, BLOWUP)
    from zklisp_tpu_torch.field import limb as T
    total = T.add(scan, gen)
    assert np.array_equal(ref.a.astype(np.uint32),
                          convert.to_numpy_u32(total))

    # the scan blocks alone against the JAX package's numpy scan blocks
    from zklisp_tpu.prove.composition_device import eval_scan_blocks
    ref_scan = eval_scan_blocks(air, cur, nxt, world["periodic"],
                                np.asarray(L.from_ints(world["alphas"])),
                                specs, np)
    assert np.array_equal(ref_scan.a.astype(np.uint32),
                          convert.to_numpy_u32(scan))
