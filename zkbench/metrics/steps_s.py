"""steps_s: seconds per job of the step proofs, `prove_program` inside
`prove_chain` (agg.LAST_CHAIN_TIMINGS["steps_s"]): trace build, the
wave prover, the child challenges that overlap it."""

from zkbench.harness.readings import Readings, per_job_chain


def read(ctx: Readings):
    return per_job_chain(ctx, "steps_s")
