"""wave.commit_s: seconds per job in the wave's Merkle commitments
(wave_trace_commit, wave_constraint_commit: crypto/poseidon_torch.py,
prove/kernels.py, the poseidon12 kernel)."""

from zkbench.harness.readings import Readings, per_job_phases

PHASES = ("wave_trace_commit", "wave_constraint_commit")


def read(ctx: Readings):
    return per_job_phases(ctx, PHASES)
