"""device.idle_share: percent of the window in which no operation ran on
the card: 100 * (1 - union of the kernel, copy and set intervals /
window), from torch.profiler over the whole window.  Work that overlaps
on several streams counts once."""

from zkbench.harness.readings import Readings


def read(ctx: Readings):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
