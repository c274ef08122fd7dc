"""Prover/verifier orchestration of the port.

prove_program: plan segments -> build the full trace once -> per segment
(serial loop, `prev_state` chained): derive the segment layout, slice the
trace, compute boundary state, prove with the device segment prover
(stark_device.prove_trace), wrap into a zl1 StepProof.  A program of more
than one segment goes to the wave prover instead
(parallel/mesh_prover.py: every stage once over a wave of segments, the
same StepProof bytes), as in the JAX package; ZKL_WAVE=0 (read at call
time) keeps the serial loop.

verify_step: verify one StepProof against its recorded public inputs
with the host verifier (stark.verify_trace).

By default every segment keeps the program-wide feature mask and the FULL
trace's usage mask (uniform-segment mode), so all segments share one AIR
structure and one set of cached tables.  ZKL_UNIFORM_SEGMENTS=0 (read at
call time) gives each segment its own feature mask, column layout and
usage mask instead, as the JAX package's host path does.  ZKL_PREFLIGHT=
console|json runs the row-wise constraint check before each segment is
proved.

Not here yet: streamed traces, upload prefetch in the serial loop and
parallel segment proving.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as _np

from ..air.airpi import (build_air_pi_for_trace, compute_vm_usage_mask,
                         segment_boundaries_from_full)
from ..air.zk_air import AirPublicInputs, ZkLispAir
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..device import resolve
from ..field import f128
from ..trace import build as tb
from ..trace.layout import Columns, LayoutConfig, STEPS_PER_LEVEL_P2
from ..utils.tracing import phase
from . import planner, stark
from .formats import StepMeta, StepProof, Zl1Proof
from .params import (ProofOptions, ProverOptions,
                     select_partitions_for_trace)
from .stark_device import prove_trace


class ProveError(Exception):
    pass


class MerkleRootMismatch(ProveError):
    """The trace's computed merkle-verify root chain does not match
    PublicInputs.merkle_root — the proof could never verify."""


def check_merkle_root_binding(full_trace,
                              pub_inputs: pi_mod.PublicInputs) -> None:
    """Fail fast on a wrong merkle root BEFORE proving.

    The AIR binds every merkle_last accumulator to the PI root
    (vm/air/merkle.rs root assertion); the reference only discovers a
    mismatch at verify time ("OOD constraint composition mismatch"),
    after a full proving run.  The trace builder already computed every
    chain root host-side (trace.merkle_roots), so compare here and
    raise a named error in seconds.  Streamed traces skip the check
    (their slotted sinks carry no ledger).  Opt out:
    ZKL_MERKLE_ROOT_CHECK=0 (used by adversarial tests that need the
    doomed artifact)."""
    if not (pub_inputs.feature_mask & pi_mod.FM_MERKLE):
        return
    if os.environ.get("ZKL_MERKLE_ROOT_CHECK", "") == "0":
        return
    roots = getattr(full_trace, "merkle_roots", None)
    if not roots:
        return
    expected = f128.be_from_le8(pub_inputs.merkle_root)
    for i, root in enumerate(roots):
        if root != expected:
            raise MerkleRootMismatch(
                f"merkle-verify chain {i} computes root {root:#034x} "
                f"but PublicInputs.merkle_root decodes to "
                f"{expected:#034x}; a proof built now could never "
                f"verify — fix the root passed to with_merkle_root / "
                f"--merkle-root (crypto.poseidon.merkle_root_from_path "
                f"computes it from the path)")


def prove_program(program: Program, pub_inputs: pi_mod.PublicInputs,
                  opts: ProverOptions, on_steps: Optional[Callable] = None,
                  device=None) -> List[StepProof]:
    """Prove every segment of `program` on `device` (default: the CUDA
    card; `device="cpu"` only when the caller asks) and return the
    StepProofs in order.

    on_steps: optional hook called with each batch of finished
    StepProofs as soon as it is assembled: one segment's in the serial
    loop, one wave's in the wave prover.  If it returns True, proving
    stops after that batch and the steps proved so far are returned (a
    deliberately partial run, e.g. under a time budget).

    More than one segment: the wave prover (`ZKL_WAVE=0` opts out), on
    any device.  ZKL_MESH (several GPUs) raises NotImplementedError."""
    dev = resolve(device)
    if os.environ.get("ZKL_MESH", "") not in ("", "0"):
        from ..parallel.mesh_prover import prove_program_mesh
        return prove_program_mesh(program, pub_inputs, opts, device=dev,
                                  on_steps=on_steps)
    base_opts = opts.to_proof_options()
    segments = planner.plan_segments(program, pub_inputs, opts)
    if not segments:
        raise ProveError("segment planner returned no segments")
    if len(segments) > 1 and os.environ.get("ZKL_WAVE", "") != "0":
        from ..parallel.mesh_prover import prove_program_mesh
        return prove_program_mesh(program, pub_inputs, opts, device=dev,
                                  on_steps=on_steps)

    full_trace = tb.build_trace(program, pub_inputs)
    check_merkle_root_binding(full_trace, pub_inputs)
    suite_id = pub_inputs.program_id
    rom_acc = (tb.rom_acc_from_program(program)
               if any(pub_inputs.program_id) else (0, 0, 0))

    n_seg = len(segments)
    steps: List[StepProof] = []
    prev_state: Optional[tb.PrevState] = None
    for i, seg in enumerate(segments):
        step, state_out = prove_segment(
            suite_id, rom_acc, i, n_seg, seg, full_trace, program,
            pub_inputs, base_opts, opts.min_security_bits, prev_state,
            device=dev)
        steps.append(step)
        prev_state = tb.PrevState(state_out)
        if on_steps is not None and on_steps([step]) is True:
            break
    return steps


def _uniform_segments(in_mesh: bool = False) -> bool:
    """Uniform-segment mode (default on; the port is a device path):
    every segment keeps the program-wide feature mask and the FULL
    trace's usage mask, so all segments share one AIR structure and one
    set of cached tables (and one wave).  Opt out: ZKL_UNIFORM_SEGMENTS=0,
    which trims each segment to its own features as the JAX package's
    host path does.  `in_mesh` (the wave prover asks) is the JAX
    package's signature: there the wave counts as a device path; in the
    port both paths are, so it changes nothing."""
    return os.environ.get("ZKL_UNIFORM_SEGMENTS", "") != "0"


def uniform_usage_for(full_trace,
                      in_mesh: bool = False) -> Optional[Tuple[int, int]]:
    """(vm_usage_mask, ram_delta_clk_bits) of the FULL trace, cached on
    the trace object; None when uniform mode is off (each segment's
    usage is then scanned from its own rows)."""
    if not _uniform_segments(in_mesh):
        return None
    if getattr(full_trace, "_uniform_usage", None) is None:
        full_trace._uniform_usage = compute_vm_usage_mask(
            full_trace, Columns.baseline())
    return full_trace._uniform_usage


def _segment_layout(program: Program, pub_inputs: pi_mod.PublicInputs,
                    seg: tb.Segment, in_mesh: bool = False):
    """Effective feature mask + column layout for one segment: the
    program-wide feature mask in uniform-segment mode, else the
    segment's own mask where it differs."""
    eff_mask = base_mask = pub_inputs.feature_mask
    if not _uniform_segments(in_mesh):
        seg_features = planner.compute_segment_features_for_levels(
            program, seg.r_start // STEPS_PER_LEVEL_P2,
            seg.r_end // STEPS_PER_LEVEL_P2)
        seg_mask = planner.compute_segment_feature_mask(pub_inputs,
                                                        seg_features)
        if seg_mask != 0 and seg_mask != base_mask:
            eff_mask = seg_mask
    fmap_vm = bool(eff_mask & pi_mod.FM_VM)
    rom_enabled = any(pub_inputs.program_id)

    layout_cfg = LayoutConfig(
        vm=fmap_vm,
        ram=bool(eff_mask & pi_mod.FM_RAM),
        sponge=bool(eff_mask & pi_mod.FM_SPONGE),
        merkle=bool(eff_mask & pi_mod.FM_MERKLE),
        rom=rom_enabled)
    return eff_mask, tb.SegmentLayout(Columns.baseline(), layout_cfg)


def segment_limbs16(full_trace, program: Program,
                    pub_inputs: pi_mod.PublicInputs,
                    seg: tb.Segment) -> _np.ndarray:
    """(C, n, 8) uint16 limb slice of the full trace for one segment."""
    _, seg_layout = _segment_layout(program, pub_inputs, seg)
    full16 = full_trace.to_limbs16()
    return _np.ascontiguousarray(
        full16[seg_layout.seg_to_full, seg.r_start:seg.r_end])


def prove_segment(suite_id: bytes, rom_acc: Tuple[int, int, int],
                  segment_index: int, segments_total: int,
                  seg: tb.Segment, full_trace, program: Program,
                  pub_inputs: pi_mod.PublicInputs,
                  base_opts: ProofOptions, min_bits: int,
                  prev_state: Optional[tb.PrevState],
                  device=None) -> Tuple[StepProof, bytes]:
    """Prove one segment with the device segment prover; returns the
    StepProof and the segment's state_out hash (the next segment's
    `prev_state`)."""
    dev = resolve(device)
    eff_mask, seg_layout = _segment_layout(program, pub_inputs, seg)

    with phase("segment_trace", rows=seg.r_end - seg.r_start):
        trace, state_in_hash, state_out_hash = \
            tb.build_segment_trace_with_state(full_trace, seg,
                                              seg_layout, prev_state)

    with phase("boundaries"):
        boundaries = segment_boundaries_from_full(full_trace, seg)

    num_partitions, hash_rate = select_partitions_for_trace(
        trace.width, trace.length)
    wf_opts = base_opts.with_partitions(num_partitions, hash_rate)

    with phase("air_pi"):
        air_pi = build_air_pi_for_trace(
            pub_inputs, eff_mask, rom_acc, seg_layout.cols, boundaries,
            trace, usage_override=uniform_usage_for(full_trace))
        pi_len = len(air_pi.to_elements())
        air = ZkLispAir(trace.width, trace.length, air_pi)

    preflight(air, trace)

    meta = StepMeta.from_env(trace.length, wf_opts, min_bits, pi_len)
    # segment limbs as a numpy slice of the cached full-trace u16 array
    # (converting ~1M Python ints per segment costs seconds)
    seg16 = segment_limbs16(full_trace, program, pub_inputs, seg)
    inner = prove_trace(trace, air, air_pi, wf_opts, limbs16=seg16,
                        device=dev)

    with phase("step_assembly"):
        boundary = _boundary_dict(boundaries, state_in_hash,
                                  state_out_hash)
        zl1 = Zl1Proof.new_multi_segment(
            suite_id, meta, pub_inputs, segment_index, segments_total,
            boundary, inner)
        step = StepProof(zl1, pub_inputs, rom_acc, air_pi.vm_usage_mask,
                         air_pi.ram_delta_clk_bits)
    return step, state_out_hash


def preflight(air: ZkLispAir, trace) -> None:
    """ZKL_PREFLIGHT=console|json (prove.rs:128-136, read at call time):
    the row-wise constraint check with the exact prover AIR before the
    segment is proved; raises ProveError on a violation.  The serial loop
    and the wave prover both run it."""
    pf_mode = os.environ.get("ZKL_PREFLIGHT", "off").lower()
    if pf_mode in ("console", "json"):
        from ..air.preflight import run_preflight
        violations = run_preflight(air, trace)
        if violations:
            raise ProveError(f"preflight violations: {violations[:3]}")


def _boundary_dict(boundaries, state_in_hash, state_out_hash) -> dict:
    return dict(
        pc_init=f128.fe_to_bytes_fold(boundaries.pc_init),
        state_in_hash=state_in_hash,
        state_out_hash=state_out_hash,
        ram_gp_unsorted_in=f128.fe_to_bytes_fold(
            boundaries.ram_gp_unsorted_in),
        ram_gp_unsorted_out=f128.fe_to_bytes_fold(
            boundaries.ram_gp_unsorted_out),
        ram_gp_sorted_in=f128.fe_to_bytes_fold(
            boundaries.ram_gp_sorted_in),
        ram_gp_sorted_out=f128.fe_to_bytes_fold(
            boundaries.ram_gp_sorted_out),
        rom_s_in_0=f128.fe_to_bytes_fold(boundaries.rom_s_in[0]),
        rom_s_in_1=f128.fe_to_bytes_fold(boundaries.rom_s_in[1]),
        rom_s_in_2=f128.fe_to_bytes_fold(boundaries.rom_s_in[2]),
        rom_s_out_0=f128.fe_to_bytes_fold(boundaries.rom_s_out[0]),
        rom_s_out_1=f128.fe_to_bytes_fold(boundaries.rom_s_out[1]),
        rom_s_out_2=f128.fe_to_bytes_fold(boundaries.rom_s_out[2]),
    )


def air_pi_from_step(step: StepProof) -> AirPublicInputs:
    """Rebuild AirPublicInputs from a StepProof (agg/fs.rs:44-65)."""
    zp = step.proof.pi
    return AirPublicInputs(
        core=step.pi_core,
        segment_feature_mask=0,
        rom_acc=tuple(step.rom_acc),
        pc_init=f128.fe_from_bytes_fold(zp.pc_init),
        ram_gp_unsorted_in=f128.fe_from_bytes_fold(zp.ram_gp_unsorted_in),
        ram_gp_unsorted_out=f128.fe_from_bytes_fold(
            zp.ram_gp_unsorted_out),
        ram_gp_sorted_in=f128.fe_from_bytes_fold(zp.ram_gp_sorted_in),
        ram_gp_sorted_out=f128.fe_from_bytes_fold(zp.ram_gp_sorted_out),
        rom_s_in=(f128.fe_from_bytes_fold(zp.rom_s_in_0),
                  f128.fe_from_bytes_fold(zp.rom_s_in_1),
                  f128.fe_from_bytes_fold(zp.rom_s_in_2)),
        rom_s_out=(f128.fe_from_bytes_fold(zp.rom_s_out_0),
                   f128.fe_from_bytes_fold(zp.rom_s_out_1),
                   f128.fe_from_bytes_fold(zp.rom_s_out_2)),
        vm_usage_mask=step.vm_usage_mask,
        ram_delta_clk_bits=step.ram_delta_clk_bits,
    )


def verify_step(step: StepProof, min_bits: int = 0) -> None:
    """Verify a single step proof against its recorded public inputs.

    Note: unlike the trusted-setup-free slow path (verify_proof), this
    trusts the boundary state recorded in the zl1 container; chain-level
    checks (verify_chain / aggregation) bind the boundaries together.
    """
    eff_mask = _effective_mask_for_step(step)
    air_pi = air_pi_from_step(step)
    air_pi.segment_feature_mask = eff_mask
    stark.verify_trace(step.proof.inner, air_pi, min_bits)


def _effective_mask_for_step(step: StepProof) -> int:
    """Reconstruct the effective feature mask the prover used.

    RAM/Merkle/ROM trims are width-visible (their column blocks are
    dropped); sponge presence is recovered from the recorded
    vm_usage_mask (VM_USAGE_SPONGE tracks op_sponge occurrence, the same
    predicate the planner uses); Poseidon follows sponge|merkle.
    """
    from ..trace.layout import VM_USAGE_SPONGE
    width = step.proof.inner.context.trace_width
    baseline = Columns.baseline().width()
    base = step.pi_core.feature_mask
    if width >= baseline:
        return base
    rom_enabled = any(step.pi_core.program_id)
    found = None
    for ram in (True, False):
        for merkle in (True, False):
            cfg = LayoutConfig(vm=True, ram=ram, sponge=True,
                               merkle=merkle, rom=rom_enabled)
            if Columns(cfg).width() == width:
                found = (ram, merkle)
                break
        if found:
            break
    if found is None:
        raise stark.VerifyError("cannot derive segment layout from width")
    ram, merkle = found
    sponge = (bool(base & pi_mod.FM_SPONGE)
              and bool(step.vm_usage_mask & (1 << VM_USAGE_SPONGE)))
    mask = pi_mod.FM_VM | (base & pi_mod.FM_VM_EXPECT)
    if ram and (base & pi_mod.FM_RAM):
        mask |= pi_mod.FM_RAM
    if sponge:
        mask |= pi_mod.FM_SPONGE
    if merkle and (base & pi_mod.FM_MERKLE):
        mask |= pi_mod.FM_MERKLE
    if (sponge or (merkle and (base & pi_mod.FM_MERKLE))) \
            and (base & pi_mod.FM_POSEIDON):
        mask |= pi_mod.FM_POSEIDON
    return mask
