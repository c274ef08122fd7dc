"""agg_s: seconds per job of aggregation, from the end of the step proofs
to the aggregation proof (agg.LAST_CHAIN_TIMINGS["agg_s"], host clock
around work that ends synchronized)."""

from zkbench.harness.readings import Readings, per_job_chain


def read(ctx: Readings):
    return per_job_chain(ctx, "agg_s")
