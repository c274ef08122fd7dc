"""poseidon12_roofline: percent of the poseidon12 kernel's device time
(the profiler's kernels named poseidon12, summed over the window) that
the least time of its launches is (zkbench/work/poseidon12.py, from the
states of each launch: the program's `permute12.batch_log`)."""

from zkbench.harness.readings import Readings, roofline

LOG = "poseidon12"


def attach(ctx: Readings):
    from zklisp_tpu_torch.crypto import poseidon_cuda
    poseidon_cuda.permute12.batch_log = ctx.logs.setdefault(LOG, [])


def read(ctx: Readings):
    work = ctx.spec.work("poseidon12")
    rounds = ctx.cfg["poseidon_rounds"]
    return roofline(ctx, work.KERNEL, LOG,
                    lambda log: work.least_seconds(log, rounds))
