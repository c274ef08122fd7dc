"""verify_s: seconds per job to decode the artifact and `verify_agg` it
(agg/aggregate.py), on the benchmark's host clock around those calls."""

from zkbench.harness.readings import Readings


def read(ctx: Readings):
    if not ctx.verify_s:
        return None
    return sum(ctx.verify_s) / len(ctx.verify_s)
