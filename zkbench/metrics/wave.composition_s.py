"""wave.composition_s: seconds per job in the wave's constraint
composition and quotient (wave_composition, wave_quotient:
prove/composition_device.py, prove/cvm.py, field/limb.py)."""

from zkbench.harness.readings import Readings, per_job_phases

PHASES = ("wave_composition", "wave_quotient")


def read(ctx: Readings):
    return per_job_phases(ctx, PHASES)
