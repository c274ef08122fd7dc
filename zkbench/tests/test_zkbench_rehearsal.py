"""A run of the harness on the CPU at a toy size (the fib program at 512
rows, 2 segments, weak proof options; zkbench/tests/configs): the same
code as a run on the card, with the look for a card skipped.  A sound
run is correct; the control (the prover given fewer queries than the
configuration states) and each fault that a cell of this benchmark can
have, planted under the timed path, make `correct` false.  (The
exchange between chips is not a fault these one-chip cells can have.)"""

import dataclasses
import io
import json

import pytest

from zkbench import control, run
from zkbench.harness import job
from zkbench.tests import toy_bench


@pytest.fixture(autouse=True)
def _fast_hasher(monkeypatch):
    # the Merkle and coin hasher at 1 round: a third off each CPU proof
    # (the toy configurations state the same `hasher_rounds` to the
    # reference)
    monkeypatch.setenv("ZKL_POSEIDON_HASHER_ROUNDS", "1")


def _per_layer():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    out = [{k: v for k, v in m.items() if k != "workloads"}
           for m in bench["per_layer"]]
    return out + [{"name": "toy.jobs", "unit": "jobs", "better": "higher",
                   "source": "program_counter", "layer": "entry",
                   "moves": "artifact_s"}]


def _run(trace=0, seed=2 ** 35 + 7):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", "toy-fib.2seg", "--seed", str(seed),
                   "--seconds", "0", "--trace", str(trace)],
                  device="cpu", spec=toy_bench.spec(_per_layer()),
                  out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_a_sound_run_is_correct():
    res, err = _run()
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 1
    assert set(res["metrics"]) == {"artifact_s", "peak_device_gib",
                                   "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(v[0] == 0 for k, v in res["checks"].items()
               if k != "security_bits")
    assert err.rstrip().splitlines()[-1].startswith("check security_bits")


def test_a_traced_run_reads_the_programs_phases():
    res, _ = _run(trace=1)
    assert res["correct"] is True
    m = res["metrics"]
    for name in ("verify_s", "agg_s", "steps_s", "wave.host_s",
                 "wave.tail_s", "wave.composition_s", "wave.lde_s",
                 "wave.commit_s"):
        assert m[name]["value"] > 0, name
    assert m["toy.jobs"]["value"] == 1
    # no card: nothing ran on a device, so no device metric is read
    for name in ("device.idle_share", "device.launches_per_seg",
                 "poseidon12_roofline", "digit_dot_roofline"):
        assert name not in m
    assert "breakdown" in res and res["device"]["window_s"] > 0


@pytest.fixture
def in_window(monkeypatch):
    """A flag that is set while the closed loop runs (after the warm-up
    job), so that a planted fault hits the timed path only."""
    flag = []
    orig = job.closed_loop

    def closed_loop(*args, **kwargs):
        flag.append(True)
        return orig(*args, **kwargs)
    monkeypatch.setattr(job, "closed_loop", closed_loop)
    return flag


def _plant(monkeypatch, in_window, fault):
    from zklisp_tpu_torch.agg import aggregate
    from zklisp_tpu_torch.prove import prover
    if fault in ("state_unchanged", "half_left_out"):
        orig = prover.prove_program

        def prove_program(*args, **kwargs):
            steps = orig(*args, **kwargs)
            if not in_window:
                return steps
            if fault == "state_unchanged":    # segment 1 repeats segment 0
                return [steps[0]] * len(steps)
            return steps[:len(steps) // 2]
        monkeypatch.setattr(prover, "prove_program", prove_program)
    elif fault == "answer_altered":           # the program's data
        orig = job.compile_entry

        def compile_entry(src, args):
            prog = orig(src, args)
            if in_window:
                prog.ops[:] = [dataclasses.replace(op, imm=op.imm + 1)
                               if type(op).__name__ == "Const"
                               and op.imm > 1 else op for op in prog.ops]
            return prog
        monkeypatch.setattr(job, "compile_entry", compile_entry)
    elif fault in ("lde", "composition"):     # a wrong tensor stage
        toy_bench.wrong_stage(monkeypatch, fault, lambda: bool(in_window))
    elif fault == "artifact_altered":         # the final state in the bytes
        orig = aggregate.encode_artifact

        def encode_artifact(proof, rc_pi):
            blob = bytearray(orig(proof, rc_pi))
            if in_window:
                blob[blob.index(rc_pi.vm_state_final)] ^= 1
            return bytes(blob)
        monkeypatch.setattr(aggregate, "encode_artifact", encode_artifact)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "artifact_altered",
                                   "lde", "composition"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, in_window,
                                                      fault):
    _plant(monkeypatch, in_window, fault)
    res, err = _run()
    assert in_window
    assert res["correct"] is False, err[-2000:]
    assert res["failed"] >= 1


def test_the_control_is_not_correct():
    out = io.StringIO()
    rc = control.main(["--workload", "toy-fib.2seg", "--seeds", "1,2,3",
                       "--set", "queries=4"], device="cpu",
                      spec=toy_bench.spec(), out=out)
    assert rc == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert len(lines) == 4
    for line in lines[:3]:
        assert "params" in line["fails"]
    assert lines[-1]["least"]["params"] > 0


def test_the_reference_alone_catches_each_fault():
    """The faults that the port's own aggregation or verifier stops
    above, fed to the reference directly: it catches each by itself."""
    from zkbench.programs.generate import Jobs
    from zkbench.reference import judge as ref
    spec = toy_bench.spec()
    cfg, traffic = spec.config("toy-fib"), spec.traffic("toy-512")
    with job.keep_steps() as kept:
        done = job.run_job(Jobs(cfg, traffic, 99, job.op_count).job(0),
                           job.options(cfg), "cpu", kept)
    sound = done.for_reference()
    stated = job.stated(cfg, traffic)
    assert all(v == 0 for k, v in ref.judge(sound, stated).items()
               if k != "security_bits")

    def numbers(**change):
        return ref.judge(dict(sound, **change), stated)

    got = numbers(steps=[sound["steps"][0]] * 2)      # state unchanged
    assert got["state_hash"] > 0 and got["segments"] > 0
    got = numbers(steps=sound["steps"][:1])           # half left out
    assert got["segments"] > 0 and got["commitments"] > 0
    art = bytearray(sound["artifact"])                # final state altered
    final = ref.codec.artifact(sound["artifact"])["vm_state_final"]
    art[art.index(final)] ^= 1
    assert numbers(artifact=bytes(art))["state_hash"] == 1
    other = dict(sound["params"], b=sound["params"]["b"] + 1)
    assert numbers(params=other)["result"] == 1       # another answer
