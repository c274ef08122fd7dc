"""wave.tail_s: seconds per job in the wave's launch-bound tail
(parallel/mesh_prover.py): wave_deep_sync, wave_fri, wave_openings."""

from zkbench.harness.readings import Readings, per_job_phases

PHASES = ("wave_deep_sync", "wave_fri", "wave_openings")


def read(ctx: Readings):
    return per_job_phases(ctx, PHASES)
