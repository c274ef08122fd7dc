"""The port's mesh (zklisp_tpu_torch.parallel.mesh_prover with a `Mesh`)
on the CPU, byte for byte (tolerance 0): against the port's one-device
wave and against the JAX package.

A port mesh of C shards repeats the CPU, as the JAX tests use the
conftest's virtual CPU devices.  test_torch_wave.py's four-segment
program (128 rows per segment, queries 8, blowup 8, grind 0) is proved
in one wave of 4: on one device (through `prove_program` with ZKL_MESH=1,
which on one device proves as if the switch were unset), on 2 shards
with ZKL_MESH_CHAIN=1 and on 4 shards; every StepProof must be the one-device wave's, and the first
segment (on the first shard, with the initial-state boundary) and the
last (on the last shard) the JAX host prover's (`prove_segment` with its
uniform mode forced on, as on its device paths; test_torch_wave.py holds
the whole one-device wave against JAX host `prove_program` at the full
hasher).  As the JAX package's multi-process dry run does (4 rounds
there), the whole file weakens the Fiat-Shamir/Merkle hasher, to one
round (ZKL_POSEIDON_HASHER_ROUNDS, read by both packages at call time),
which takes a third off each proof's CPU time.  Also: the chain check on
4 shards against JAX's, `_pad_wave` and `default_wave_width` against
JAX's for meshes of 1, 2, 4 and 8, the sharded-LDE branch that no wave
reaches in either package, and ZKL_MESH's routing."""

import types

import pytest
import torch

from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.parallel import mesh_prover as j_mesh
from zklisp_tpu.prove import planner as j_planner
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu.trace import build as j_tb
from zklisp_tpu.trace.build import TraceError as JTraceError
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.parallel import ntt_mesh as t_nm
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import planner as t_planner
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.trace import build as t_tb

# test_torch_wave.py's program: four 128-row segments
SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (store 4 (+ s 1))
    (+ (load 3) (load 4))))
(main)
"""
SECRET = 41
KW = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
          max_segment_rows=128)
N_SEG = 4


def _port_program(**kw):
    prog = t_compile_str(SRC)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    return prog, pub, t_params.ProverOptions(**dict(KW, **kw))


def _cpu_mesh(k):
    return t_mesh.Mesh(["cpu"] * k)


def _jax_segments(indices):
    """JAX host `prove_segment` of each segment of `indices`, uniform
    mode: their StepProof bytes."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        prog = j_compile_str(SRC)
        pub = (JPIBuilder(prog).with_secret_args([JVmArg.u64(SECRET)])
               .build())
        opts = JProverOptions(**KW)
        segs = j_planner.plan_segments(prog, pub, opts)
        full = j_tb.build_trace(prog, pub)
        rom_acc = j_tb.rom_acc_from_program(prog)
        out = []
        for i in indices:
            step, _ = j_prover.prove_segment(
                pub.program_id, rom_acc, i, len(segs), segs[i], full, prog,
                pub, opts.to_proof_options(), opts.min_security_bits, None)
            out.append(step.to_bytes())
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module", autouse=True)
def hasher_rounds():
    mp = pytest.MonkeyPatch()
    mp.setenv("ZKL_POSEIDON_HASHER_ROUNDS", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def runs():
    """The one-device wave (`prove_program` under ZKL_MESH=1 and
    ZKL_WAVE=4 on the CPU), 2 shards under ZKL_MESH_CHAIN=1, 4 shards,
    each with the stage generators it ran ((device, slots) per shard),
    and the JAX host proofs of the first and the last segment."""
    mp = pytest.MonkeyPatch()
    real = t_mesh._wave_stages
    out = {}
    try:
        for k in ("ZKL_UNIFORM_SEGMENTS", "ZKL_WAVE", "ZKL_MESH_CHAIN",
                  "ZKL_MESH"):
            mp.delenv(k, raising=False)
        for name, mesh, env in (("wave", None, {"ZKL_MESH": "1",
                                                "ZKL_WAVE": str(N_SEG)}),
                                ("mesh2_chain", _cpu_mesh(2),
                                 {"ZKL_MESH_CHAIN": "1"}),
                                ("mesh4", _cpu_mesh(4), {})):
            shards = []

            def spy(preps, S_real, dev, staged, lde_mesh, shards=shards):
                shards.append((str(dev), len(preps), S_real))
                return real(preps, S_real, dev, staged, lde_mesh)

            mp.setattr(t_mesh, "_wave_stages", spy)
            for k, v in env.items():
                mp.setenv(k, v)
            prog, pub, opts = _port_program()
            if mesh is None:
                steps = t_prover.prove_program(prog, pub, opts,
                                               device="cpu")
            else:
                steps = t_mesh.prove_program_mesh(prog, pub, opts,
                                                  mesh=mesh, device="cpu",
                                                  wave=N_SEG)
            out[name] = ([s.to_bytes() for s in steps], shards)
            for k in env:
                mp.delenv(k)
    finally:
        mp.undo()
    out["jax_first"], out["jax_last"] = _jax_segments([0, N_SEG - 1])
    return out


def test_the_meshes_ran_sharded(runs):
    assert runs["wave"][1] == [("cpu", 4, 4)]
    assert runs["mesh2_chain"][1] == [("cpu", 2, 2)] * 2
    assert runs["mesh4"][1] == [("cpu", 1, 1)] * 4


@pytest.mark.parametrize("name", ["mesh2_chain", "mesh4"])
@pytest.mark.parametrize("i", range(N_SEG))
def test_mesh_bytes_equal_one_device_wave(runs, name, i):
    assert len(runs[name][0]) == N_SEG
    assert runs[name][0][i] == runs["wave"][0][i]


@pytest.mark.parametrize("name", ["wave", "mesh2_chain", "mesh4"])
def test_first_segment_equals_jax(runs, name):
    assert runs[name][0][0] == runs["jax_first"]


@pytest.mark.parametrize("name", ["wave", "mesh2_chain", "mesh4"])
def test_last_segment_equals_jax(runs, name):
    assert runs[name][0][N_SEG - 1] == runs["jax_last"]


def _boundaries():
    """Every segment's boundary dict, from the port's host prep."""
    prog, pub, opts = _port_program()
    segs = t_planner.plan_segments(prog, pub, opts)
    full = t_tb.build_trace(prog, pub)
    rom_acc = t_tb.rom_acc_from_program(prog)
    return [t_mesh._SegPrep(i, len(segs), s, full, prog, pub,
                            opts.to_proof_options(), 0, pub.program_id,
                            rom_acc).boundary
            for i, s in enumerate(segs)]


def test_chain_check_on_four_shards_counts_like_jax():
    """The chain holds on 4 shards in both packages; with two boundaries
    doctored (edges that cross shards) both raise with the same count,
    and with three segments on 4 shards (one pad row, masked) too."""
    bounds = _boundaries()
    jmesh, tmesh = j_mesh.default_mesh(4), _cpu_mesh(4)

    def preps(bs):
        return [types.SimpleNamespace(boundary=dict(b)) for b in bs]

    t_mesh._chain_check_mesh(preps(bounds), tmesh)
    j_mesh._chain_check_mesh(preps(bounds), jmesh)
    for bs, count in ((bounds, 2), (bounds[:3], 2)):
        broken = preps(bs)
        broken[1].boundary["state_in_hash"] = bytes(32)
        broken[2].boundary["state_in_hash"] = b"\x01" * 32
        msgs = []
        for check, mesh, err in ((t_mesh._chain_check_mesh, tmesh,
                                  t_tb.TraceError),
                                 (j_mesh._chain_check_mesh, jmesh,
                                  JTraceError)):
            with pytest.raises(err) as e:
                check(broken, mesh)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        assert msgs[0].startswith(f"mesh chain check: {count} segment")


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_pad_wave_equals_jax(k):
    jmesh, tmesh = j_mesh.default_mesh(k), _cpu_mesh(k)
    for n_real in (1, 3, 5):
        preps = list(range(n_real))
        for width in (0, 1, 3, 8):
            assert (t_mesh._pad_wave(preps, tmesh, width)
                    == j_mesh._pad_wave(preps, jmesh, width))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n,w,blowup,n_seg,wave_bytes", [
    (4096, 212, 16, 16, None), (4096, 212, 16, 16, "3e9"),
    (1024, 219, 8, 10, "2e9"), (128, 250, 8, 3, None),
    (4096, 212, 16, 1, "5e10")])
def test_default_wave_width_equals_jax(monkeypatch, k, n, w, blowup, n_seg,
                                       wave_bytes):
    monkeypatch.delenv("ZKL_WAVE", raising=False)
    if wave_bytes is None:
        monkeypatch.delenv("ZKL_WAVE_BYTES", raising=False)
    else:
        monkeypatch.setenv("ZKL_WAVE_BYTES", wave_bytes)
    got = t_mesh.default_wave_width(_cpu_mesh(k), n, w, blowup, n_seg)
    assert got == j_mesh.default_wave_width(j_mesh.default_mesh(k), n, w,
                                            blowup, n_seg)
    assert got % k == 0


def test_one_segment_wave_takes_no_sharded_lde(monkeypatch):
    """Fault of both packages: `_pad_wave` pads every wave to at least the
    mesh size, so the sharded-LDE branch (S == 1 on a mesh of several
    devices) is never taken — not even by a one-segment program with
    ZKL_MESH_NTT_MIN=0."""
    for k in (2, 4, 8):
        for width in (0, 1, 8):
            assert len(j_mesh._pad_wave([0], j_mesh.default_mesh(k),
                                        width)) >= 2
    monkeypatch.setenv("ZKL_MESH_NTT_MIN", "0")
    seen = []

    class Stop(Exception):
        pass

    def spy(preps, S_real, dev, staged, lde_mesh):
        seen.append((len(preps), lde_mesh))
        raise Stop

    monkeypatch.setattr(t_mesh, "_wave_stages", spy)
    prog, pub, opts = _port_program(max_segment_rows=512)
    assert len(t_planner.plan_segments(prog, pub, opts)) == 1
    with pytest.raises(Stop):
        t_mesh.prove_program_mesh(prog, pub, opts, mesh=_cpu_mesh(2),
                                  wave=1)
    assert seen == [(1, None)]


def test_sharded_lde_branch_gives_the_same_bytes(monkeypatch, runs):
    """The branch itself, reached by taking `_pad_wave`'s padding away: a
    wave of one segment on 2 shards runs its LDE through
    `ntt_mesh.lde_columns_sharded` and proves the one-device bytes."""
    monkeypatch.setenv("ZKL_MESH_NTT_MIN", "0")
    monkeypatch.setattr(t_mesh, "_pad_wave",
                        lambda preps, mesh, width: list(preps))
    calls = []
    real = t_nm.lde_columns_sharded

    def spy(polys, blowup, mesh):
        calls.append((tuple(polys.shape), mesh.size))
        return real(polys, blowup, mesh)

    monkeypatch.setattr(t_nm, "lde_columns_sharded", spy)
    prog, pub, opts = _port_program()
    steps = t_mesh.prove_program_mesh(prog, pub, opts, mesh=_cpu_mesh(2),
                                      wave=1, segment_subset=[3])
    assert len(calls) == 1 and calls[0][1] == 2
    assert steps[0].to_bytes() == runs["wave"][0][3]


def test_zkl_mesh_on_one_device_proves_as_unset(monkeypatch, runs):
    """ZKL_MESH=1 with one device: the JAX package proves as if the switch
    were unset; so does the port.  The fixture's one-device wave was
    proved under ZKL_MESH=1 (the parent raised NotImplementedError), as
    one wave on the one device, with the meshes' bytes and JAX's; and
    prove_program makes the same call to the wave prover with the switch
    set as unset."""
    assert runs["wave"][1] == [("cpu", 4, 4)]
    assert runs["wave"][0] == runs["mesh4"][0]
    calls = []

    def fake(program, pub_inputs, opts, **kw):
        calls.append(kw)
        return ["wave"]

    monkeypatch.setattr(t_mesh, "prove_program_mesh", fake)
    prog, pub, opts = _port_program()
    for v in ("1", ""):
        monkeypatch.setenv("ZKL_MESH", v)
        assert t_prover.prove_program(prog, pub, opts, device="cpu") == [
            "wave"]
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0]["device"] == torch.device("cpu")


def test_zkl_mesh_routes_to_the_mesh_with_several_devices(monkeypatch):
    """With two cards visible (simulated), ZKL_MESH=1 sends the program to
    `prove_program_mesh` on the default mesh of both; unset, it does
    not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert t_mesh.default_mesh().devices == (torch.device("cuda", 0),
                                             torch.device("cuda", 1))
    calls = []

    def fake(program, pub_inputs, opts, **kw):
        calls.append(kw)
        return ["mesh"]

    monkeypatch.setattr(t_mesh, "prove_program_mesh", fake)
    monkeypatch.setenv("ZKL_MESH", "1")
    prog, pub, opts = _port_program()
    assert t_prover.prove_program(prog, pub, opts) == ["mesh"]
    assert calls[0]["mesh"].devices == (torch.device("cuda", 0),
                                        torch.device("cuda", 1))
    monkeypatch.setenv("ZKL_MESH", "0")
    assert t_prover.prove_program(prog, pub, opts) == ["mesh"]
    assert "mesh" not in calls[1]          # the one-device wave
