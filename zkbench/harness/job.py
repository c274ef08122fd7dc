"""One proving job through the port, as a user of `cli prove` and
`cli verify` pays for it, and the closed loop that runs jobs back to back.

A job: compile the source (`compile_entry`), build the public inputs
(`PublicInputsBuilder`, no arguments), `agg.prove_chain` on the device,
`agg.encode_artifact`; then `agg.decode_artifact` of the bytes, the
CLI's program-id and pi-digest checks, and `agg.verify_agg`.  It is done
when the artifact verifies.

The step proofs that `prove_chain` aggregates are kept for the reference
by wrapping `prove/prover.py::prove_program`, which `prove_chain` looks
up when it is called: the wrapper returns what it was given.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from zklisp_tpu_torch.agg import aggregate as agg
from zklisp_tpu_torch.compiler import compile_entry
from zklisp_tpu_torch.core.pi import PublicInputsBuilder
from zklisp_tpu_torch.prove import prover
from zklisp_tpu_torch.prove.params import ProverOptions


class JobError(Exception):
    pass


def op_count(source: str) -> int:
    return len(compile_entry(source, []).ops)


def options(cfg: dict) -> ProverOptions:
    return ProverOptions(queries=cfg["queries"], blowup=cfg["blowup"],
                         grind=cfg["grind"],
                         min_security_bits=cfg["min_security_bits"],
                         max_segment_rows=cfg["max_segment_rows"])


def stated(cfg: dict, traffic: dict) -> dict:
    """What the configuration and the traffic state, as the reference
    holds each job to it."""
    out = {k: cfg[k] for k in ("queries", "blowup", "grind",
                               "min_security_bits", "feature_mask",
                               "hasher_rounds")}
    out["segment_rows"] = cfg["max_segment_rows"]
    out["segments"] = traffic["rows"] // cfg["max_segment_rows"]
    return out


@contextmanager
def keep_steps():
    """Within the block, every list of step proofs that prove_program
    returns is appended to the yielded list."""
    kept, orig = [], prover.prove_program

    def prove_program(*args, **kwargs):
        steps = orig(*args, **kwargs)
        kept.append(steps)
        return steps

    prover.prove_program = prove_program
    try:
        yield kept
    finally:
        prover.prove_program = orig


@dataclasses.dataclass
class Done:
    """What one job produced, and its own clock readings."""
    job: dict                 # the generator's: source, kind, params
    program: object
    steps: list
    artifact: bytes
    chain: dict               # agg.LAST_CHAIN_TIMINGS of this job
    verify_s: float
    seconds: float

    def for_reference(self) -> dict:
        """The job as plain data: what the reference judges."""
        return dict(self.job, artifact=self.artifact,
                    steps=[s.to_bytes() for s in self.steps],
                    out_reg=self.program.out_reg,
                    ops=[(type(o).__name__, dataclasses.asdict(o))
                         for o in self.program.ops])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(job: dict, opts: ProverOptions, device) -> None:
    """The step proofs of one job of the cell's shapes, and nothing after
    them: a process's first wave builds its tables and grows the
    allocator, which a timed job should not pay.  The aggregation, the
    encoding and the verification have no such first cost: a job timed
    after this warm-up is as fast as the later ones (PERF.md)."""
    program = compile_entry(job["source"], [])
    pi = PublicInputsBuilder(program).build()
    prover.prove_program(program, pi, opts, device=device)
    sync(device)


def run_job(job: dict, opts: ProverOptions, device, kept: list) -> Done:
    """Prove and verify one job; `kept` is keep_steps()'s list."""
    t0 = time.perf_counter()
    with record_function("job:compile"):
        program = compile_entry(job["source"], [])
        pi = PublicInputsBuilder(program).build()
    n_kept = len(kept)
    with record_function("job:prove_chain"):
        proof, _, rc_pi = agg.prove_chain(program, pi, opts, device=device)
    chain = dict(agg.LAST_CHAIN_TIMINGS)
    with record_function("job:encode"):
        blob = agg.encode_artifact(proof, rc_pi)
    tv = time.perf_counter()
    with record_function("job:verify"):
        got, got_pi = agg.decode_artifact(blob)
        if (got_pi.program_id != program.program_id
                or got_pi.program_commitment != program.program_id
                or got_pi.pi_digest != pi.digest()):
            raise JobError("the artifact names another program or inputs")
        agg.verify_agg(got, got_pi, opts.min_security_bits)
    t1 = time.perf_counter()
    if len(kept) != n_kept + 1:
        raise JobError("prove_chain did not prove the program once")
    return Done(job, program, kept[-1], blob, chain, t1 - tv, t1 - t0)


def closed_loop(jobs, opts, device, seconds: float, kept: list):
    """Jobs 0, 1, ... back to back, one in flight, started until
    `seconds` have passed since the first started; the one in flight then
    finishes.  Returns (finished jobs, window seconds, the exception that
    stopped the loop or None)."""
    done, k = [], 0
    t0 = time.perf_counter()
    error = None
    while True:
        try:
            done.append(run_job(jobs.job(k), opts, device, kept))
        except Exception as e:             # a failed job ends the window
            error = e
            break
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return done, time.perf_counter() - t0, error
