"""toy.jobs: jobs in the window (a test's own per-layer metric, found by
name in zkbench/tests/metrics)."""


def read(ctx):
    return float(ctx.jobs) if ctx.jobs else None
