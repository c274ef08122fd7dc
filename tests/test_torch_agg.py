"""Aggregation on the CPU: the port's `agg.prove_chain(device="cpu")`
against the JAX package's `prove_chain`, byte for byte (tolerance 0).

One module-scoped chain: a program of two 128-row segments (queries 8,
blowup 8, grind 0, no security floor), built from a fixed secret.  The
port proves uniform segments (every segment keeps the program-wide
feature mask), which the JAX package does only on its device paths, so
the JAX side runs here with its `_uniform_segments` switch forced on.
Its two segments have different feature masks, so the mode matters.

Compared: each StepProof, the ZKLRC1 artifact, the aggregation proof over
the quadratic extension (`prove_agg` at queries 33, blowup 16, 128 bits:
`stark_ext`), and the restored host prover `stark.prove_trace` on the
aggregation trace.  Then the port's `verify_chain`, and a flipped
artifact byte."""

import pytest
import torch

from zklisp_tpu.agg import aggregate as j_agg
from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.prove import formats as j_formats
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove import stark as j_stark
from zklisp_tpu.prove.params import ProofOptions as JProofOptions
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu_torch.agg import aggregate as t_agg
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.prove import formats as t_formats
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.prove import stark as t_stark

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
KW128 = dict(queries=33, blowup=16, grind=0, min_security_bits=128,
             max_segment_rows=128)


def _record_steps(monkeypatch, prover_mod):
    """Wrap `prover_mod.prove_program` (prove_chain imports it at call
    time) so the chain's StepProofs can be compared."""
    seen = []
    real = prover_mod.prove_program

    def wrapped(*a, **k):
        steps = real(*a, **k)
        seen.extend(steps)
        return steps

    monkeypatch.setattr(prover_mod, "prove_program", wrapped)
    return seen


@pytest.fixture(scope="module")
def chains():
    mp = pytest.MonkeyPatch()
    try:
        t_prog = t_compile_str(SRC)
        t_pub = (t_pi.PublicInputsBuilder(t_prog)
                 .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
        t_steps = _record_steps(mp, t_prover)
        t_chain = t_agg.prove_chain(t_prog, t_pub,
                                    t_params.ProverOptions(**KW),
                                    device="cpu")
        timings = dict(t_agg.LAST_CHAIN_TIMINGS)

        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        j_prog = j_compile_str(SRC)
        j_pub = (JPIBuilder(j_prog)
                 .with_secret_args([JVmArg.u64(SECRET)]).build())
        j_steps = _record_steps(mp, j_prover)
        j_chain = j_agg.prove_chain(j_prog, j_pub, JProverOptions(**KW))
    finally:
        mp.undo()
    return {"t": t_chain, "j": j_chain, "t_steps": t_steps,
            "j_steps": j_steps, "timings": timings}


def test_uniform_segments_share_one_layout(chains):
    assert len(chains["t_steps"]) == 2
    assert chains["t"][2].children_count == 2
    assert (chains["t_steps"][0].proof.inner.context.trace_width
            == chains["t_steps"][1].proof.inner.context.trace_width)


@pytest.mark.parametrize("i", [0, 1])
def test_step_proof_bytes_equal_jax(chains, i):
    assert (chains["t_steps"][i].to_bytes()
            == chains["j_steps"][i].to_bytes())


def test_artifact_bytes_equal_jax(chains):
    t_proof, t_digest, t_pi_ = chains["t"]
    j_proof, j_digest, j_pi_ = chains["j"]
    assert t_digest == j_digest
    assert (t_agg.encode_artifact(t_proof, t_pi_)
            == j_agg.encode_artifact(j_proof, j_pi_))


def test_chain_timings_split(chains):
    tm = chains["timings"]
    assert set(tm) == {"steps_s", "agg_s", "agg_child_challenges_s",
                       "agg_child_batch_s", "agg_prove_s"}
    assert tm["agg_prove_s"] > 0 and tm["agg_child_batch_s"] > 0
    assert (tm["agg_child_challenges_s"] + tm["agg_child_batch_s"]
            + tm["agg_prove_s"]) <= tm["agg_s"]


def test_verify_chain_and_artifact_roundtrip(chains):
    proof, digest, agg_pi = chains["t"]
    opts = t_params.ProverOptions(**KW)
    t_agg.verify_chain([(proof, digest, agg_pi)], opts)
    proof2, pi2 = t_agg.decode_artifact(t_agg.encode_artifact(proof,
                                                              agg_pi))
    t_agg.verify_agg(proof2, pi2)
    assert digest == t_agg.recursion_digest(pi2)


@pytest.mark.parametrize("where", ["header", "proof"])
def test_flipped_artifact_byte_rejected(chains, where):
    proof, _, agg_pi = chains["t"]
    blob = bytearray(t_agg.encode_artifact(proof, agg_pi))
    # a byte of children_root (header) or one near the end of the proof
    at = 6 + 32 * 3 if where == "header" else len(blob) - 40
    blob[at] ^= 1
    with pytest.raises((t_stark.VerifyError, t_agg.AggError, ValueError)):
        p2, pi2 = t_agg.decode_artifact(bytes(blob))
        t_agg.verify_agg(p2, pi2)


@pytest.fixture(scope="module")
def agg_inputs(chains):
    """The aggregation public inputs of both chains' steps."""
    t_pi_ = t_agg.build_agg_public(chains["t_steps"])
    j_pi_ = j_agg.build_agg_public(chains["j_steps"])
    t_pi_.pi_digest = chains["t"][2].pi_digest
    j_pi_.pi_digest = chains["j"][2].pi_digest
    return t_pi_, j_pi_


def test_ext_prove_agg_bytes_equal_jax(chains, agg_inputs):
    """prove_agg at 128 bits proves over the quadratic extension."""
    t_pi_, j_pi_ = agg_inputs
    t_proof = t_agg.prove_agg(t_pi_, chains["t_steps"],
                              t_params.ProverOptions(**KW128),
                              device="cpu")
    j_proof = j_agg.prove_agg(j_pi_, chains["j_steps"],
                              JProverOptions(**KW128))
    assert t_proof.context.options.field_extension == 2
    assert t_proof.context.trace_len == 8
    assert (t_formats.serialize_stark_proof(t_proof)
            == j_formats.serialize_stark_proof(j_proof))
    t_agg.verify_agg(t_proof, t_pi_, 128)
    t_proof.ood_trace_current[0] ^= 1
    with pytest.raises(t_stark.VerifyError):
        t_agg.verify_agg(t_proof, t_pi_, 128)


def test_host_prover_bytes_equal_jax(chains, agg_inputs):
    """The restored host prover on the aggregation trace."""
    import numpy as np
    t_pi_, j_pi_ = agg_inputs
    t_trace = t_agg.build_agg_trace(t_pi_, chains["t_steps"],
                                    device="cpu")
    j_trace = j_agg.build_agg_trace(j_pi_, chains["j_steps"])
    kw = dict(num_queries=16, blowup=8, grinding_factor=0)
    t_proof = t_stark.prove_trace(
        t_trace, t_agg.ZlAggAir(t_trace.width, t_trace.length, t_pi_),
        t_pi_, t_params.ProofOptions(**kw), device="cpu")
    j_proof = j_stark.prove_trace(
        j_trace, j_agg.ZlAggAir(j_trace.width, j_trace.length, j_pi_),
        j_pi_, JProofOptions(**kw), np)
    assert (t_formats.serialize_stark_proof(t_proof)
            == j_formats.serialize_stark_proof(j_proof))
    t_agg.verify_agg(t_proof, t_pi_)


def test_prove_chain_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prog = t_compile_str(SRC)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    with pytest.raises(RuntimeError):
        t_agg.prove_chain(prog, pub, t_params.ProverOptions(**KW))
