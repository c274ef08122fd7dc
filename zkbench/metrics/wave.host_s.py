"""wave.host_s: seconds per job in the wave prover's host phases
(parallel/mesh_prover.py): wave_fs_coeffs, wave_zpows, wave_assembly
(a worker thread), wave_seg_prep and wave_limb_convert."""

from zkbench.harness.readings import Readings, per_job_phases

PHASES = ("wave_fs_coeffs", "wave_zpows", "wave_assembly", "wave_seg_prep",
          "wave_limb_convert")


def read(ctx: Readings):
    return per_job_phases(ctx, PHASES)
