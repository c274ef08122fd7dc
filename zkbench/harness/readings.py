"""What a traced window leaves for the per-layer metric readers.

A reader is `zkbench/metrics/<metric name>.py` with `read(ctx)`, which
returns a number or None when the window holds nothing to read (the
harness then leaves the metric out of the result line), and optionally
`attach(ctx)`, called before the window, to turn on a counter of the
program's.  `ctx` is a `Readings`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Readings:
    spec: object                  # harness.spec.Spec
    cfg: dict                     # the configuration as run
    jobs: int = 0                 # whole jobs in the window
    segments: int = 0             # step proofs made in the window
    chain: list = field(default_factory=list)      # LAST_CHAIN_TIMINGS
    verify_s: list = field(default_factory=list)   # per job
    phases: list = field(default_factory=list)     # tracing.events()
    trace: object = None          # harness.devtrace.DeviceTrace
    logs: dict = field(default_factory=dict)       # counters' logs


def per_job_phases(ctx: Readings, names) -> float | None:
    """Seconds per job in the program's phases `names` (tracing.events:
    host clock, the card synchronized at each device phase's end)."""
    hits = [dt for name, dt, _ in ctx.phases if name in names]
    if not hits or not ctx.jobs:
        return None
    return sum(hits) / ctx.jobs


def per_job_chain(ctx: Readings, key: str) -> float | None:
    vals = [c[key] for c in ctx.chain if key in c]
    if not vals or not ctx.jobs:
        return None
    return sum(vals) / ctx.jobs


def roofline(ctx: Readings, kernel: str, log_key: str, least) -> \
        float | None:
    """Percent of the kernel's device time that its least time is:
    `least(log)` over the launches its counter logged in the window,
    against the device time of the kernels named so in the trace.  None
    when the kernel did not run or the trace and the log disagree on the
    launch count."""
    log = ctx.logs.get(log_key)
    if ctx.trace is None or not log:
        return None
    seconds, count = ctx.trace.kernel_seconds(kernel)
    if count != len(log) or seconds <= 0:
        return None
    return 100.0 * least(log) / seconds
