"""The plain reference agrees with what it re-derives: BLAKE3 with its
published vector and the port's, Poseidon2 with the port's, the VM and
the programs' meaning with the port's VM, and the readers of the bytes
with the port's codecs."""

import dataclasses
import os

import pytest

from zkbench.harness.spec import Spec
from zkbench.programs import generate
from zkbench.reference import poseidon2, stf, vm
from zkbench.reference.blake3 import blake3

CELLS = Spec().bench["workloads"]


def test_blake3_vector_and_port():
    from zklisp_tpu_torch.crypto.blake3 import blake3 as port
    assert blake3(b"").hex() == ("af1349b9f5f9a1a6a0404dea36dcc949"
                                 "9bcb25c9adc112b7cc9a93cae41f3262")
    rng = __import__("random").Random(5)
    for n in (1, 63, 64, 65, 1023, 1024, 1025, 2048, 3073, 5000, 9000):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert blake3(data) == port(data), n


def test_poseidon2_matches_the_port():
    from zklisp_tpu_torch.crypto import poseidon as port
    sid = os.urandom(32)
    assert poseidon2.hash2(sid, 3, 5) == port.poseidon_hash_two_lanes(
        sid, 3, 5)
    assert poseidon2.absorb(sid, [7, 11, 13]) == port.sponge_absorb(
        [7, 11, 13], sid)
    assert poseidon2.ro(b"d", b"x") == port.ro_from_slices(b"d", [b"x"])


@pytest.mark.parametrize("cell", CELLS, ids=[c["name"] for c in CELLS])
def test_vm_and_meaning_match_the_ports_vm(cell):
    from zklisp_tpu_torch import frontend
    from zklisp_tpu_torch.compiler import compile_entry
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zkbench.harness import job
    spec = Spec()
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    jobs = generate.Jobs(cfg, traffic, 2 ** 33 + 1, job.op_count)
    for k in (0, 1):
        j = jobs.job(k)
        prog = compile_entry(j["source"], [])
        ops = [(type(o).__name__, dataclasses.asdict(o)) for o in prog.ops]
        edges, levels = vm.run(ops, prog.program_id, cfg["max_segment_rows"])
        assert len(edges) == traffic["rows"] // cfg["max_segment_rows"] + 1
        want = stf.result(j["kind"], j["params"], prog.program_id)
        got = frontend.run_vm(prog, PublicInputsBuilder(prog).build())
        assert edges[-1][prog.out_reg] == want == got.value


def test_the_meaning_is_the_sources_not_the_ops():
    """Another balance changes the value the source means."""
    sid = bytes(32)
    p = {"ACCTS": 8, "BATCH": 15, "balance": 1 << 31, "amount": 3,
         "fee": 2}
    assert stf.result("rollup", p, sid) != stf.result(
        "rollup", dict(p, balance=(1 << 31) + 1), sid)
    assert stf.result("fib", {"N": 3, "a": 5, "b": 7}, sid) == 14


def test_vm_refuses_an_op_it_does_not_model():
    with pytest.raises(vm.VmError):
        vm.run([("DivMod", {})], bytes(32), 32)
