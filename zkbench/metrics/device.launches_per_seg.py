"""device.launches_per_seg: kernel launch calls on the host
(cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel, cuLaunchKernelEx
in the profiler's trace) in the window, per step proof made in it."""

from zkbench.harness.readings import Readings


def read(ctx: Readings):
    t = ctx.trace
    if t is None or not t.launches or not ctx.segments:
        return None
    return t.launches / ctx.segments
