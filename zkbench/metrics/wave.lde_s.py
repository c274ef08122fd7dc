"""wave.lde_s: seconds per job in the wave's low-degree extension
(wave_lde: field/ntt.py, field/mxu.py, the digit_dot kernel)."""

from zkbench.harness.readings import Readings, per_job_phases

PHASES = ("wave_lde",)


def read(ctx: Readings):
    return per_job_phases(ctx, PHASES)
