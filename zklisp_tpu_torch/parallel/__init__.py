"""Proving across several segments at once: the wave prover
(`mesh_prover.prove_program_mesh`)."""
