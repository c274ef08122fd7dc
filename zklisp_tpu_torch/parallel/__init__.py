"""Proving across several segments and devices: the wave prover, on one
device or sharded over a mesh (`mesh_prover.prove_program_mesh`), the
sharded NTT (`ntt_mesh`) and multi-process proving over
torch.distributed (`multihost`)."""
