"""The slice as a whole, on the CPU: the port's segment prover
(`zklisp_tpu_torch.prove.stark_device.prove_trace(device="cpu")`) on the
tiny program of tests/test_device_prover.py (1024 x 219, 8 queries,
blowup 8) against the JAX package's host reference
`stark.prove_trace(..., np)` — the prover the JAX device prover itself is
held to.  Proof bytes are compared exactly (tolerance 0).  The proof is
made twice: in the configuration the card runs by default, forced on the
CPU (four-step matrix NTT, matrix DEEP, fused FRI chain, and
ZKL_CVM_LEVEL=1 for the leveled constraint executor), and with the four
kill switches set (radix-2 NTT, limb-dot DEEP, stack executor, per-layer
FRI loop).  Both must give the host reference's bytes.

Then the port on its own: `prove_program` over two 512-row segments and
`verify_step` on each StepProof."""

import contextlib
import os

import numpy as np
import pytest

from zklisp_tpu.air.airpi import build_air_pi_for_trace
from zklisp_tpu.air.zk_air import ZkLispAir
from zklisp_tpu.compiler import compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder, VmArg
from zklisp_tpu.prove.coin import RandomCoin
from zklisp_tpu.prove.formats import serialize_stark_proof
from zklisp_tpu.prove.params import ProofOptions
from zklisp_tpu.prove.stark import prove_trace
from zklisp_tpu.trace import build as tb
from zklisp_tpu_torch.air import airpi as t_airpi
from zklisp_tpu_torch.air import zk_air as t_zk_air
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.field import mxu as t_mxu
from zklisp_tpu_torch.prove import coin as t_coin
from zklisp_tpu_torch.prove import cvm as t_cvm
from zklisp_tpu_torch.prove import formats as t_formats
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.prove import stark as t_stark
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


@pytest.fixture(scope="module")
def port_setup():
    prog = t_compile_str(SRC)
    pi = (t_pi.PublicInputsBuilder(prog)
          .with_secret_args([t_pi.VmArg.u64(41)]).build())
    trace = t_tb.build_trace(prog, pi)
    air_pi = t_airpi.build_air_pi_for_trace(
        pi, pi.feature_mask, t_tb.rom_acc_from_program(prog), None, None,
        trace)
    air = t_zk_air.ZkLispAir(trace.width, trace.length, air_pi)
    return prog, pi, trace, air, air_pi


SWITCHES = ("ZKL_NO_MXU_NTT", "ZKL_NO_MXU_DEEP", "ZKL_CVM_LEVEL",
            "ZKL_NO_FUSED_FRI")
DEFAULT_FORCED = {"ZKL_CVM_LEVEL": "1"}
EARLIER = {"ZKL_NO_MXU_NTT": "1", "ZKL_NO_MXU_DEEP": "1",
           "ZKL_CVM_LEVEL": "0", "ZKL_NO_FUSED_FRI": "1"}


@contextlib.contextmanager
def _configuration(env):
    """Set the four switches to `env` (unset where it names none) and
    count the calls that tell the two configurations apart."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(env)
    calls = {"field_matmul": 0, "execute_leveled": 0, "fri_layers_chain": 0,
             "fri_layers_loop": 0}
    real = {"field_matmul": (t_mxu, t_mxu.field_matmul),
            "execute_leveled": (t_cvm, t_cvm.execute_leveled),
            "fri_layers_chain": (t_sd, t_sd.fri_layers_chain),
            "fri_layers_loop": (t_sd, t_sd.fri_layers_loop)}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name, (mod, fn) in real.items():
        setattr(mod, name, spy(name, fn))
    try:
        yield calls
    finally:
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)
        for k in SWITCHES:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def _prove(port_setup, env):
    _, _, trace, air, air_pi = port_setup
    assert (trace.length, trace.width) == (1024, 219)
    opts = t_params.ProofOptions(num_queries=8, blowup=8, grinding_factor=0)
    with _configuration(env) as calls:
        proof = t_sd.prove_trace(trace, air, air_pi, opts, device="cpu")
    return proof, calls


@pytest.fixture(scope="module")
def port_proof(port_setup):
    """The configuration the card runs by default, forced on the CPU."""
    proof, calls = _prove(port_setup, DEFAULT_FORCED)
    # iNTT + coset NTT of the trace chunk(s), quotient interpolation and
    # re-LDE: two products each; plus the DEEP dot
    assert calls["field_matmul"] >= 9
    assert calls["execute_leveled"] == 1
    assert (calls["fri_layers_chain"], calls["fri_layers_loop"]) == (1, 0)
    return proof


@pytest.fixture(scope="module")
def host_proof_bytes():
    """The JAX package's host prover on the same program (computed once:
    it is the slowest step of this module)."""
    prog = compile_str(SRC)
    pi = PublicInputsBuilder(prog).with_secret_args([VmArg.u64(41)]).build()
    trace = tb.build_trace(prog, pi)
    air_pi = build_air_pi_for_trace(pi, pi.feature_mask,
                                    tb.rom_acc_from_program(prog),
                                    None, None, trace)
    air = ZkLispAir(trace.width, trace.length, air_pi)
    opts = ProofOptions(num_queries=8, blowup=8, grinding_factor=0)
    return serialize_stark_proof(prove_trace(trace, air, air_pi, opts, np))


def test_port_proof_verifies(port_setup, port_proof):
    t_stark.verify_trace(port_proof, port_setup[4])
    blob = t_formats.serialize_stark_proof(port_proof)
    t_stark.verify_trace(t_formats.deserialize_stark_proof(blob),
                         port_setup[4])


def test_port_verifier_rejects_a_flipped_byte(port_setup, port_proof):
    blob = bytearray(t_formats.serialize_stark_proof(port_proof))
    rejected = 0
    for at in (len(blob) // 3, len(blob) // 2, len(blob) - 5):
        bad = bytearray(blob)
        bad[at] ^= 0x01
        with pytest.raises((t_stark.VerifyError, ValueError, AssertionError,
                            IndexError, OverflowError)):
            t_stark.verify_trace(
                t_formats.deserialize_stark_proof(bytes(bad)),
                port_setup[4])
        rejected += 1
    assert rejected == 3
    # and a tampered field of the in-memory proof
    port_proof.ood_trace_current[0] ^= 1
    try:
        with pytest.raises(t_stark.VerifyError):
            t_stark.verify_trace(port_proof, port_setup[4])
    finally:
        port_proof.ood_trace_current[0] ^= 1


def test_port_proof_bytes_equal_host_reference(port_proof, host_proof_bytes):
    got = t_formats.serialize_stark_proof(port_proof)
    assert len(got) == len(host_proof_bytes)
    assert got == host_proof_bytes


def test_earlier_configuration_has_the_same_bytes(port_setup, port_proof,
                                                  host_proof_bytes):
    """All four kill switches set: none of the new paths runs, and the
    proof has the same bytes as the default configuration's and the host
    reference's."""
    proof, calls = _prove(port_setup, EARLIER)
    assert calls == {"field_matmul": 0, "execute_leveled": 0,
                     "fri_layers_chain": 0, "fri_layers_loop": 1}
    got = t_formats.serialize_stark_proof(proof)
    assert got == t_formats.serialize_stark_proof(port_proof)
    assert got == host_proof_bytes


@pytest.mark.parametrize("seed", [[1, 2, 3], [7], list(range(20))])
def test_grind_finds_the_smallest_nonce(seed):
    """The port's device-side scan (here on the CPU) returns the same
    smallest passing nonce as the JAX package's host coin at grind 8."""
    ref_coin = RandomCoin(seed)
    ref = ref_coin.grind(8)
    coin = t_coin.RandomCoin(seed)
    assert coin.seed == ref_coin.seed
    got = coin.grind(8, device="cpu")
    assert got == ref
    assert coin.check_leading_zeros(got) >= 8
    assert all(coin.check_leading_zeros(v) < 8 for v in range(got))
    # host coin draws of the port's copy agree too
    assert coin.draw_many(12) == ref_coin.draw_many(12)
    assert coin.draw_integers(8, 1 << 13, got) == \
        ref_coin.draw_integers(8, 1 << 13, ref)


def test_prove_program_two_segments_and_verify_step(port_setup):
    prog, pi, _, _, _ = port_setup
    opts = t_params.ProverOptions(queries=8, blowup=8, grind=0,
                                  min_security_bits=0,
                                  max_segment_rows=512)
    seen = []
    steps = t_prover.prove_program(prog, pi, opts, device="cpu",
                                   on_steps=seen.extend)
    assert len(steps) == 2 and seen == steps
    for i, step in enumerate(steps):
        assert step.proof.pi.segment_index == i
        assert step.proof.pi.segments_total == 2
        assert step.proof.inner.context.trace_len == 512
        t_prover.verify_step(step)
    # chained state: segment 1 starts where segment 0 ended
    assert steps[1].proof.pi.state_in_hash == \
        steps[0].proof.pi.state_out_hash
    # the StepProof container round-trips and still verifies
    again = t_formats.StepProof.from_bytes(steps[1].to_bytes())
    t_prover.verify_step(again)
    # a tampered inner proof is rejected
    steps[0].proof.inner.ood_quotient_current[0] ^= 1
    with pytest.raises(t_stark.VerifyError):
        t_prover.verify_step(steps[0])


def test_prove_program_default_device_needs_a_card(port_setup):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    prog, pi, _, _, _ = port_setup
    opts = t_params.ProverOptions(queries=8, blowup=8, grind=0,
                                  min_security_bits=0)
    with pytest.raises(RuntimeError):
        t_prover.prove_program(prog, pi, opts)
