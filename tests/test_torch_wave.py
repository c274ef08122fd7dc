"""The wave prover of the port (`zklisp_tpu_torch.parallel.mesh_prover`)
on the CPU, byte for byte (tolerance 0), against the JAX package and
against the port's serial loop.

Uniform segments: one program of four 128-row segments (queries 8,
blowup 8, grind 0, no security floor), proved with waves of 3 — one full
wave and one wave of one segment padded to 3 — against the JAX host
`prove_program` with its `_uniform_segments` forced on (as on its device
paths), and the first two against the port's serial loop (ZKL_WAVE=0).
The JAX package's own slow tests hold its wave equal to its serial path,
so this holds the port's wave against the JAX wave without compiling it.
Per-segment masks (ZKL_UNIFORM_SEGMENTS=0, the JAX host default): the
exec_key grouping of the four segments equals the JAX package's, and a
two-segment program whose segments differ in width proves in two waves
with the JAX host's bytes.  Also `default_wave_width`,
`grind_many` and the chain check against the JAX package's, and
on_steps' early stop."""

import types

import pytest

from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.parallel import mesh_prover as j_mesh
from zklisp_tpu.prove import planner as j_planner
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove.coin import RandomCoin as JRandomCoin
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu.trace import build as j_tb
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import planner as t_planner
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.prove.coin import RandomCoin as TRandomCoin
from zklisp_tpu_torch.trace import build as t_tb

# four segments: 0-2 use RAM (feature mask 0x82), 3 does not (0x02)
SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (store 4 (+ s 1))
    (+ (load 3) (load 4))))
(main)
"""
# two segments: 0 uses RAM, 1 does not (tests/test_torch_agg.py's program)
SRC2 = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (+ (load 3) 1)))
(main)
"""
SECRET = 41
KW = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
          max_segment_rows=128)
WAVE = 3


def _port_program(src=SRC):
    prog = t_compile_str(src)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    return prog, pub


def _jax_program(src=SRC):
    prog = j_compile_str(src)
    pub = JPIBuilder(prog).with_secret_args([JVmArg.u64(SECRET)]).build()
    return prog, pub


def _wave(monkeypatch, src=SRC, wave=WAVE):
    """The port's wave on the CPU; returns (steps, sizes of the batches
    that on_steps saw)."""
    monkeypatch.delenv("ZKL_WAVE", raising=False)
    prog, pub = _port_program(src)
    batches = []
    steps = t_mesh.prove_program_mesh(
        prog, pub, t_params.ProverOptions(**KW), device="cpu", wave=wave,
        on_steps=lambda done: batches.append(len(done)))
    return steps, batches


@pytest.fixture(scope="module")
def uniform():
    """Uniform segments: the port's wave, the first two segments of its
    serial loop, and JAX host `prove_program` with its uniform mode
    forced on."""
    mp = pytest.MonkeyPatch()
    try:
        mp.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
        wave, batches = _wave(mp)
        mp.setenv("ZKL_WAVE", "0")
        prog, pub = _port_program()
        serial = t_prover.prove_program(
            prog, pub, t_params.ProverOptions(**KW), device="cpu",
            on_steps=lambda done: done[0].proof.pi.segment_index == 1)
        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        j_prog, j_pub = _jax_program()
        jax_steps = j_prover.prove_program(j_prog, j_pub,
                                           JProverOptions(**KW))
    finally:
        mp.undo()
    return {"wave": wave, "batches": batches, "serial": serial,
            "jax": jax_steps}


def test_one_full_and_one_padded_wave(uniform):
    assert len(uniform["wave"]) == 4
    assert uniform["batches"] == [3, 1]
    assert ([s.proof.pi.segment_index for s in uniform["wave"]]
            == [0, 1, 2, 3])


@pytest.mark.parametrize("i", range(4))
def test_wave_bytes_equal_jax(uniform, i):
    assert uniform["wave"][i].to_bytes() == uniform["jax"][i].to_bytes()


@pytest.mark.parametrize("i", range(2))
def test_serial_path_bytes_equal_wave(uniform, i):
    assert len(uniform["serial"]) == 2
    assert uniform["serial"][i].to_bytes() == uniform["wave"][i].to_bytes()


def test_wave_steps_verify(uniform):
    for s in uniform["wave"]:
        t_prover.verify_step(s)


def _preps(package):
    """The _SegPrep of every segment, in either package (host only)."""
    if package == "port":
        prog, pub = _port_program()
        mesh, planner, tb = t_mesh, t_planner, t_tb
        opts = t_params.ProverOptions(**KW)
    else:
        prog, pub = _jax_program()
        mesh, planner, tb = j_mesh, j_planner, j_tb
        opts = JProverOptions(**KW)
    segs = planner.plan_segments(prog, pub, opts)
    full = tb.build_trace(prog, pub)
    full.to_limbs16()
    rom_acc = tb.rom_acc_from_program(prog)
    return [mesh._SegPrep(i, len(segs), s, full, prog, pub,
                          opts.to_proof_options(), 0, pub.program_id,
                          rom_acc)
            for i, s in enumerate(segs)]


def _grouping(preps):
    """Segment indices grouped by exec_key, in first-seen order."""
    by_key: dict = {}
    for p in preps:
        by_key.setdefault(p.exec_key(), []).append(p.index)
    return list(by_key.values())


@pytest.mark.parametrize("uniform_env", [None, "0"])
def test_exec_key_grouping_equals_jax(monkeypatch, uniform_env):
    if uniform_env is None:
        monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    else:
        monkeypatch.setenv("ZKL_UNIFORM_SEGMENTS", uniform_env)
    port, jax_ = _preps("port"), _preps("jax")
    assert _grouping(port) == _grouping(jax_)
    assert ([p.structure_key() == port[0].structure_key() for p in port]
            == [p.structure_key() == jax_[0].structure_key()
                for p in jax_])
    # uniform: segment 0's extra boundary group does not split a wave;
    # per-segment masks: 3 drops the RAM columns, and 0 keeps its own key
    expected = ([[0, 1, 2, 3]] if uniform_env is None
                else [[0], [1, 2], [3]])
    assert _grouping(port) == expected


def test_per_segment_masks_equal_jax_host(monkeypatch):
    """ZKL_UNIFORM_SEGMENTS=0 on the two-segment program: the segments
    differ in width, so they prove in two waves (of one: the padded wave
    is the uniform run's); the bytes equal the JAX host
    `prove_program`."""
    monkeypatch.setenv("ZKL_UNIFORM_SEGMENTS", "0")
    steps, batches = _wave(monkeypatch, SRC2, wave=1)
    assert batches == [1, 1]
    j_prog, j_pub = _jax_program(SRC2)
    jax_steps = j_prover.prove_program(j_prog, j_pub, JProverOptions(**KW))
    widths = [s.proof.inner.context.trace_width for s in steps]
    assert widths == [s.proof.inner.context.trace_width for s in jax_steps]
    assert widths[0] > widths[1]
    assert [s.to_bytes() for s in steps] == [s.to_bytes()
                                             for s in jax_steps]


def test_on_steps_true_stops_after_that_wave(monkeypatch):
    """on_steps returning True ends the run after that wave: the
    two-segment program in waves of one, without the assembly thread."""
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    monkeypatch.setenv("ZKL_WAVE_OVERLAP", "0")
    prog, pub = _port_program(SRC2)
    seen = []
    steps = t_mesh.prove_program_mesh(
        prog, pub, t_params.ProverOptions(**KW), device="cpu", wave=1,
        on_steps=lambda done: seen.append(len(done)) or True)
    assert seen == [1]
    assert [s.proof.pi.segment_index for s in steps] == [0]
    t_prover.verify_step(steps[0])


@pytest.mark.parametrize("n,w,blowup,n_seg,wave_bytes", [
    (4096, 212, 16, 16, None), (4096, 212, 16, 16, "3e9"),
    (4096, 212, 16, 16, "1e11"), (1024, 219, 8, 10, "2e9"),
    (128, 250, 8, 4, None), (65536, 100, 4, 5, "1e10"),
    (4096, 212, 16, 1, "5e10")])
def test_default_wave_width_equals_jax(monkeypatch, n, w, blowup, n_seg,
                                       wave_bytes):
    monkeypatch.delenv("ZKL_WAVE", raising=False)
    if wave_bytes is None:
        monkeypatch.delenv("ZKL_WAVE_BYTES", raising=False)
    else:
        monkeypatch.setenv("ZKL_WAVE_BYTES", wave_bytes)
    got = t_mesh.default_wave_width(None, n, w, blowup, n_seg, "cpu")
    assert got == j_mesh.default_wave_width(None, n, w, blowup, n_seg)
    monkeypatch.setenv("ZKL_WAVE", "5")
    assert t_mesh.default_wave_width(None, n, w, blowup, n_seg, "cpu") == 5


def test_grind_many_equals_each_grind_and_jax():
    seeds = [[i + 1, 7 * i + 3] for i in range(3)]
    got = TRandomCoin.grind_many([TRandomCoin(s) for s in seeds], 8,
                                 device="cpu")
    assert got == [TRandomCoin(s).grind(8, device="cpu") for s in seeds]
    assert got == JRandomCoin.grind_many([JRandomCoin(s) for s in seeds],
                                         8)
    for s, nonce in zip(seeds, got):
        coin = TRandomCoin(s)
        assert coin.check_leading_zeros(nonce) >= 8
        assert all(coin.check_leading_zeros(v) < 8 for v in range(nonce))


def test_chain_check_raises_on_a_broken_chain():
    preps = _preps("port")
    t_mesh._chain_check_mesh(preps)                  # the real chain holds
    broken = [types.SimpleNamespace(boundary=dict(p.boundary))
              for p in preps]
    broken[2].boundary["state_in_hash"] = bytes(32)
    with pytest.raises(t_tb.TraceError, match="1 segment boundary"):
        t_mesh._chain_check_mesh(broken)


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("ZKL_WAVE", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    prog, pub = _port_program()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_mesh.prove_program_mesh(prog, pub, t_params.ProverOptions(**KW))
