"""The reference's own check of the STARK inside each step proof
(zkbench/reference/stark.py and hasher.py): its hasher agrees with the
plain-integer Poseidon2, a sound toy proof reads 0 on every number, each
part of the proof altered in its bytes is read, and a wrong low-degree
extension or constraint composition planted in the port's wave is read
by the reference alone."""

import random

import pytest
import torch

from zkbench.harness import job
from zkbench.programs.generate import Jobs
from zkbench.reference import codec, hasher, poseidon2, stark
from zkbench.reference.field import P
from zkbench.tests import toy_bench


@pytest.fixture(autouse=True)
def _fast_hasher(monkeypatch):
    # the toy configurations state 1 hasher round, as the port is told here
    monkeypatch.setenv("ZKL_POSEIDON_HASHER_ROUNDS", "1")


def _edge_states():
    rng = random.Random(5)
    out = [[rng.randrange(P) for _ in range(12)] for _ in range(60)]
    out += [[P - 1] * 12, [0] * 12, [1] * 12,
            [P - 1 - i for i in range(12)], [(1 << 128) - 1 - P] * 12,
            [(1 << 127) + i for i in range(12)]]
    return out


@pytest.mark.parametrize("rounds", [1, 27])
def test_the_batched_permutation_is_poseidon2(rounds):
    states = _edge_states()
    perm = hasher.Permutation(bytes(32), rounds, "cpu")
    got = perm(torch.stack([hasher.to_limbs(s, "cpu") for s in states]))
    for b, s in enumerate(states):
        assert hasher.to_ints(got[b]) == poseidon2.permute(s, bytes(32),
                                                           rounds)


def test_the_hasher_matches_the_ports():
    from zklisp_tpu_torch.crypto import poseidon as pos
    h = hasher.Hasher(1, "cpu")
    rng = random.Random(9)
    rows = [[rng.randrange(P) for _ in range(23)] for _ in range(4)]
    a = [rng.randrange(P) for _ in range(4)]
    b = [rng.randrange(P) for _ in range(4)]
    fb = poseidon2.fe_bytes
    assert [fb(x) for x in h.hash_elements(rows)] == [
        pos.hash_elements(r) for r in rows]
    assert [fb(x) for x in h.merge(list(zip(a, b)))] == [
        pos.merge(fb(x), fb(y)) for x, y in zip(a, b)]
    assert [fb(x) for x in h.merge_with_int(a, [0, 1, 2 ** 63, 77])] == [
        pos.merge_with_int(fb(x), v) for x, v in zip(a, [0, 1, 2 ** 63, 77])]


@pytest.fixture(scope="module")
def toy_steps():
    """The step proofs of one sound toy job (fib, 2 segments)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ZKL_POSEIDON_HASHER_ROUNDS", "1")
    spec = toy_bench.spec()
    cfg, traffic = spec.config("toy-fib"), spec.traffic("toy-512")
    with job.keep_steps() as kept:
        done = job.run_job(Jobs(cfg, traffic, 41, job.op_count).job(0),
                           job.options(cfg), "cpu", kept)
    mp.undo()
    return [s.to_bytes() for s in done.steps]


def _numbers(blobs):
    got = stark.check([codec.step(b) for b in blobs], 1, "cpu")
    return {k: sum(g[k] for g in got) for k in stark.NUMBERS}


def test_a_sound_proof_reads_zero(toy_steps):
    assert _numbers(toy_steps) == dict.fromkeys(stark.NUMBERS, 0)


def _alter(blob: bytes, value: int, nth: int = 0) -> bytes:
    """The blob with the nth occurrence of a field element's 16 bytes
    changed in its lowest bit."""
    raw = value.to_bytes(16, "little")
    at = -1
    for _ in range(nth + 1):
        at = blob.index(raw, at + 1)
    out = bytearray(blob)
    out[at] ^= 1
    return bytes(out)


def test_each_part_altered_is_read(toy_steps):
    blob = toy_steps[1]
    i = codec.step(blob)["inner"]
    row = i["trace_rows"][0]
    col = next(k for k, v in enumerate(row) if v > 1)
    got = _numbers([_alter(blob, row[col], row[:col].count(row[col]))])
    assert got["merkle"] >= 1 and got["deep"] >= 1
    v0 = i["fri_layers"][1]["pairs"][0][0]
    got = _numbers([_alter(blob, v0)])
    assert got["merkle"] >= 1 and got["fri"] >= 1
    got = _numbers([_alter(blob, i["fri_remainder"][0])])
    assert got["fri"] >= 1 and got["merkle"] == 0
    got = _numbers([_alter(blob, i["ood_quotient_current"][0])])
    assert got["ood_air"] == 1
    node = next(lv[0] for lv in i["trace_batch"] if lv)
    out = bytearray(blob)
    out[blob.index(node)] ^= 1
    assert _numbers([bytes(out)])["merkle"] >= 1
    nonce = i["pow_nonce"].to_bytes(8, "little")
    out = bytearray(blob)
    out[blob.index(nonce, len(blob) - len(blob) // 2)] ^= 0x80
    assert sum(_numbers([bytes(out)]).values()) >= 1


@pytest.mark.parametrize("stage", ["lde", "composition"])
def test_the_reference_alone_reads_a_wrong_tensor_stage(monkeypatch, stage):
    toy_bench.wrong_stage(monkeypatch, stage)
    spec = toy_bench.spec()
    cfg, traffic = spec.config("toy-fib"), spec.traffic("toy-512")
    with job.keep_steps() as kept:
        try:                        # the port's aggregation may refuse it
            job.run_job(Jobs(cfg, traffic, 43, job.op_count).job(0),
                        job.options(cfg), "cpu", kept)
        except Exception:
            pass
    got = _numbers([s.to_bytes() for s in kept[-1]])
    assert got["ood_air"] == len(kept[-1])
