"""digit_dot_roofline: percent of the digit_dot kernel's device time (the
profiler's kernels named digit_dot, summed over the window) that the
least time of its launches is (zkbench/work/digit_dot.py, from the
(M, K, N) of each launch: the program's `digit_dot.shape_log`)."""

from zkbench.harness.readings import Readings, roofline

LOG = "digit_dot"


def attach(ctx: Readings):
    from zklisp_tpu_torch.field import digit_dot
    digit_dot.digit_dot.shape_log = ctx.logs.setdefault(LOG, [])


def read(ctx: Readings):
    work = ctx.spec.work("digit_dot")
    return roofline(ctx, work.KERNEL, LOG, work.least_seconds)
