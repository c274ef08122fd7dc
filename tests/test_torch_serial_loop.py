"""The rest of the port's serial loop on the CPU, against the JAX package,
tolerance 0: streamed chains with per-segment masks, parallel segment
proving (`max_concurrent_segments`) and `verify_proof`.

Per-segment masks (ZKL_UNIFORM_SEGMENTS=0, the JAX host default):
tests/test_torch_agg.py's two-segment program through the port's
`agg.prove_chain(device="cpu")` under ZKL_STREAM_TRACE=1 and the JAX
`prove_chain` under the same switch: every StepProof and the ZKLRC1
artifact equal.  In this mode a full trace gives the same bytes (every
segment scans its own usage), so the port's full-trace chain with
ZKL_WAVE=0 and `max_concurrent_segments=2` must equal them too.  With the
segment prover replaced by a stub, many threads: every segment proved
once, on_steps once per segment, an early stop skips the rest.

verify_proof: the port's and the JAX package's slow path both accept a
one-segment proof made by the port, and both reject it when one public
input (the main argument) changes."""

import sys

import pytest

from zklisp_tpu.agg import aggregate as j_agg
from zklisp_tpu.compiler import compile_entry as j_compile_entry
from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.prove import formats as j_formats
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove import stark as j_stark
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu_torch.agg import aggregate as t_agg
from zklisp_tpu_torch.compiler import compile_entry as t_compile_entry
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import planner as t_planner
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.prove import stark as t_stark

# tests/test_torch_agg.py's program: segment 0 uses RAM, segment 1 not
SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (+ (load 3) 1)))
(main)
"""
SECRET = 41
KW = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
          max_segment_rows=128)
# one segment of 128 rows, one public main argument
ONE_SEGMENT_SRC = """
(def (main a)
  (+ a 1))
"""


def _record_steps(mp, prover_mod):
    seen = []
    real = prover_mod.prove_program

    def wrapped(*a, **k):
        steps = real(*a, **k)
        seen.extend(steps)
        return steps

    mp.setattr(prover_mod, "prove_program", wrapped)
    return seen


def _port_program():
    prog = t_compile_str(SRC)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    return prog, pub


def _no_wave(*a, **k):
    raise AssertionError("the wave prover was reached")


@pytest.fixture(scope="module")
def chains():
    """Per-segment masks: the port's streamed chain, the JAX package's
    streamed chain, and the port's full-trace chain proved two segments
    at a time off the wave."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ZKL_UNIFORM_SEGMENTS", "0")
        mp.setenv("ZKL_STREAM_TRACE", "1")
        mp.delenv("ZKL_WAVE", raising=False)
        mp.setattr(t_mesh, "prove_program_mesh", _no_wave)
        real_prove = t_prover.prove_program
        t_prog, t_pub = _port_program()
        t_steps = _record_steps(mp, t_prover)
        t_chain = t_agg.prove_chain(t_prog, t_pub,
                                    t_params.ProverOptions(**KW),
                                    device="cpu")

        j_prog = j_compile_str(SRC)
        j_pub = (JPIBuilder(j_prog)
                 .with_secret_args([JVmArg.u64(SECRET)]).build())
        j_steps = _record_steps(mp, j_prover)
        j_chain = j_agg.prove_chain(j_prog, j_pub, JProverOptions(**KW))

        mp.setenv("ZKL_STREAM_TRACE", "0")
        mp.setenv("ZKL_WAVE", "0")
        mp.setattr(t_prover, "prove_program", real_prove)
        c_steps = _record_steps(mp, t_prover)
        c_chain = t_agg.prove_chain(
            t_prog, t_pub,
            t_params.ProverOptions(max_concurrent_segments=2, **KW),
            device="cpu")
    finally:
        mp.undo()
    return {"t": t_chain, "j": j_chain, "c": c_chain, "t_steps": t_steps,
            "j_steps": j_steps, "c_steps": c_steps}


def _artifact(agg_mod, chain):
    proof, _, agg_pi = chain
    return agg_mod.encode_artifact(proof, agg_pi)


@pytest.mark.parametrize("i", [0, 1])
def test_per_segment_streamed_step_bytes_equal_jax(chains, i):
    assert len(chains["t_steps"]) == len(chains["j_steps"]) == 2
    assert (chains["t_steps"][i].to_bytes()
            == chains["j_steps"][i].to_bytes())


def test_per_segment_streamed_artifact_equal_jax(chains):
    assert chains["t"][1] == chains["j"][1]
    assert _artifact(t_agg, chains["t"]) == _artifact(j_agg, chains["j"])


@pytest.mark.parametrize("i", [0, 1])
def test_concurrent_full_trace_step_bytes_equal_jax(chains, i):
    assert len(chains["c_steps"]) == 2
    assert (chains["c_steps"][i].to_bytes()
            == chains["j_steps"][i].to_bytes())


def test_concurrent_artifact_equal_jax(chains):
    assert _artifact(t_agg, chains["c"]) == _artifact(j_agg, chains["j"])


# ---------------------------------------------------------------------------
# parallel segment proving with a stub segment prover
# ---------------------------------------------------------------------------

def _stub_concurrent(monkeypatch, workers, stop_at=None):
    """`max_concurrent_segments=workers` over a full trace of 32-row
    segments with `prove_segment` replaced by a stub; returns (segment
    count, steps, the on_steps batches)."""
    monkeypatch.setenv("ZKL_STREAM_TRACE", "0")
    monkeypatch.setenv("ZKL_WAVE", "0")
    prog, pub = _port_program()
    opts = t_params.ProverOptions(**dict(KW, max_segment_rows=32,
                                         max_concurrent_segments=workers))
    n_seg = len(t_planner.plan_segments(prog, pub, opts))
    calls = []

    def stub(suite_id, rom_acc, i, n, seg, full_trace, program,
             pub_inputs, base_opts, min_bits, prev_state, device=None,
             staged=None, window=None):
        assert prev_state is None and n == n_seg
        calls.append(i)
        return ("step", i), b""

    batches = []

    def on_steps(batch):
        batches.append(batch)
        return stop_at is not None and batch[0][1] == stop_at

    monkeypatch.setattr(t_prover, "prove_segment", stub)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        steps = t_prover.prove_program(prog, pub, opts, device="cpu",
                                       on_steps=on_steps)
    finally:
        sys.setswitchinterval(old)
    assert sorted(calls) == sorted(set(calls)), "a segment proved twice"
    return n_seg, steps, batches


def test_concurrent_proves_every_segment_once(monkeypatch):
    n_seg, steps, batches = _stub_concurrent(monkeypatch, workers=16)
    assert n_seg >= 8
    assert steps == [("step", i) for i in range(n_seg)]
    assert sorted(b[0][1] for b in batches) == list(range(n_seg))
    assert all(len(b) == 1 for b in batches)


def test_concurrent_early_stop_skips_the_rest(monkeypatch):
    n_seg, steps, _ = _stub_concurrent(monkeypatch, workers=2, stop_at=0)
    assert n_seg > 1 and steps == [("step", 0)]


# ---------------------------------------------------------------------------
# verify_proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_segment():
    """A one-segment proof made by the port, and each package's program
    with the proof's public inputs and with the main argument changed."""
    prog = t_compile_entry(ONE_SEGMENT_SRC, [2])
    opts = t_params.ProverOptions(**dict(KW, max_segment_rows=None))

    def t_pub(a):
        return (t_pi.PublicInputsBuilder(prog)
                .with_main_args([t_pi.VmArg.u64(a)]).build())

    steps = t_prover.prove_program(prog, t_pub(2), opts, device="cpu")
    assert len(steps) == 1
    j_prog = j_compile_entry(ONE_SEGMENT_SRC, [2])

    def j_pub(a):
        return (JPIBuilder(j_prog)
                .with_main_args([JVmArg.u64(a)]).build())

    j_inner = j_formats.StepProof.from_bytes(
        steps[0].to_bytes()).proof.inner
    return {"port": (t_prover.verify_proof, steps[0].proof.inner, prog,
                     t_pub, t_stark.VerifyError),
            "jax": (j_prover.verify_proof, j_inner, j_prog, j_pub,
                    j_stark.VerifyError)}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_verify_proof_accepts_a_port_proof(one_segment, package):
    verify, inner, prog, pub, _ = one_segment[package]
    verify(inner, prog, pub(2))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_verify_proof_rejects_a_changed_public_input(one_segment, package):
    verify, inner, prog, pub, error = one_segment[package]
    with pytest.raises(error):
        verify(inner, prog, pub(3))
