"""The prover's switches, read at call time, against the JAX package on
the CPU (tolerance 0):

  ZKL_UNIFORM_SEGMENTS=0  per-segment feature masks: the port's StepProofs
                          equal the JAX package's host `prove_program`
                          (which trims segments the same way) on a
                          program whose two segments have different masks
  ZKL_PREFLIGHT=json      the row-wise constraint check refuses a tampered
                          segment trace with ProveError in both packages
  ZKL_CVM_TABLE_BYTES     the leveled constraint executor's table budget:
                          a budget that splits the rows into several
                          chunks gives the same proof bytes as the default
"""

import pytest

from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu.trace import build as j_tb
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.field import f128
from zklisp_tpu_torch.prove import cvm as t_cvm
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import planner as t_planner
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.trace import build as t_tb

# segment 0 uses RAM (feature mask 0x82), segment 1 does not (0x02)
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


def _port_program():
    prog = t_compile_str(SRC)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    return prog, pub


def _jax_program():
    prog = j_compile_str(SRC)
    pub = JPIBuilder(prog).with_secret_args([JVmArg.u64(SECRET)]).build()
    return prog, pub


def test_per_segment_masks_equal_jax_host(monkeypatch):
    # the serial loop, as in the JAX host path compared with (the wave's
    # per-segment masks: tests/test_torch_wave.py)
    monkeypatch.setenv("ZKL_WAVE", "0")
    prog, pub = _port_program()
    opts = t_params.ProverOptions(**KW)
    segs = t_planner.plan_segments(prog, pub, opts)
    assert len(segs) == 2
    # the two modes lay segment 1 out differently: uniform keeps the
    # program-wide mask, per-segment drops the RAM columns
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    uniform = [t_prover._segment_layout(prog, pub, s) for s in segs]
    monkeypatch.setenv("ZKL_UNIFORM_SEGMENTS", "0")
    trimmed = [t_prover._segment_layout(prog, pub, s) for s in segs]
    assert uniform[0][0] == uniform[1][0] == pub.feature_mask
    assert trimmed[0][0] == pub.feature_mask
    assert trimmed[1][0] != pub.feature_mask
    assert trimmed[1][1].cols.width() < uniform[1][1].cols.width()

    t_steps = t_prover.prove_program(prog, pub, opts, device="cpu")
    j_prog, j_pub = _jax_program()
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS")   # the JAX host default
    j_steps = j_prover.prove_program(j_prog, j_pub, JProverOptions(**KW))
    assert [s.proof.inner.context.trace_width for s in t_steps] == \
        [uniform[0][1].cols.width(), trimmed[1][1].cols.width()]
    assert [s.to_bytes() for s in t_steps] == \
        [s.to_bytes() for s in j_steps]
    for s in t_steps:
        t_prover.verify_step(s)


def _tamper(monkeypatch, tb_mod):
    """Every segment trace comes out with row 3 of every column bumped
    by one."""
    real = tb_mod.build_segment_trace_with_state

    def tampered(*a, **k):
        trace, s_in, s_out = real(*a, **k)
        for c in range(trace.width):
            trace.set(c, 3, (trace.get(c, 3) + 1) % f128.P)
        return trace, s_in, s_out

    monkeypatch.setattr(tb_mod, "build_segment_trace_with_state", tampered)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_preflight_json_refuses_a_tampered_trace(monkeypatch, package):
    monkeypatch.setenv("ZKL_PREFLIGHT", "json")
    if package == "port":
        prog, pub = _port_program()
        _tamper(monkeypatch, t_tb)
        with pytest.raises(t_prover.ProveError, match="preflight"):
            t_prover.prove_program(prog, pub, t_params.ProverOptions(**KW),
                                   device="cpu")
    else:
        prog, pub = _jax_program()
        _tamper(monkeypatch, j_tb)
        with pytest.raises(j_prover.ProveError, match="preflight"):
            j_prover.prove_program(prog, pub, JProverOptions(**KW))


def test_cvm_table_bytes_moves_no_proof_byte(monkeypatch):
    """One 256-row segment (N = 2048 at blowup 8) with the leveled
    executor forced on the CPU: the default budget takes all rows in one
    chunk, a 1 MB budget two chunks of 1024; the bytes are equal."""
    prog, pub = _port_program()
    opts = t_params.ProverOptions(**dict(KW, max_segment_rows=256))
    chunks = []
    real = t_cvm.level_chunk_rows

    def spy(N, rows_total, period):
        C = real(N, rows_total, period)
        chunks.append(N // C)
        return C

    monkeypatch.setattr(t_cvm, "level_chunk_rows", spy)
    monkeypatch.setenv("ZKL_CVM_LEVEL", "1")
    out = {}
    for budget in (None, 1 << 20):
        if budget is None:
            monkeypatch.delenv("ZKL_CVM_TABLE_BYTES", raising=False)
        else:
            monkeypatch.setenv("ZKL_CVM_TABLE_BYTES", str(budget))
        chunks.clear()
        steps = t_prover.prove_program(prog, pub, opts, device="cpu")
        assert len(steps) == 1
        out[budget] = (steps[0].to_bytes(), list(chunks))
    assert out[None][1] and set(out[None][1]) == {1}
    assert set(out[1 << 20][1]) == {2}
    assert out[None][0] == out[1 << 20][0]
