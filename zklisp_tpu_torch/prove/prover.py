"""Prover/verifier orchestration of the port.

prove_program: plan segments -> choose the trace source (`stream_mode`)
-> per segment: derive the segment layout, take its rows, compute
boundary state, prove with the device segment prover
(stark_device.prove_trace), wrap into a zl1 StepProof.

Trace source: the full trace, built once; or, for traces of at least
2^19 rows or under ZKL_STREAM_TRACE=1 (read at call time; =0 forces the
full trace), the streamed source of trace/stream.py, which keeps one
segment of rows resident and builds each window on demand.  A streamed
segment's usage mask comes from its own rows, as in the JAX package.

Paths: ZKL_MESH=1 (read at call time) sends the program to the wave
prover on the default mesh (every visible card) when that mesh has more
than one device, before the trace source is chosen, so such a program is
never streamed, as in the JAX package; with one device the switch
changes nothing.  Otherwise a full trace of more than one segment goes
to the wave prover (parallel/mesh_prover.py: every stage once over a
wave of segments, the same StepProof bytes), as in the JAX package;
ZKL_WAVE=0, and every streamed program, keep the serial loop
(`prev_state` chained, each segment's limb upload queued ahead of its
proof: all of them up front from a full trace, one segment ahead from a
streamed one).
`max_concurrent_segments` > 1 (off the wave) proves segments side by side
in threads instead, each on its own CUDA stream on a card.

verify_step: verify one StepProof against its recorded public inputs
with the host verifier (stark.verify_trace).  verify_proof: the slow path
that rebuilds the trace to derive the boundary public inputs.

By default every segment keeps the program-wide feature mask and the FULL
trace's usage mask (uniform-segment mode), so all segments share one AIR
structure and one set of cached tables.  ZKL_UNIFORM_SEGMENTS=0 (read at
call time) gives each segment its own feature mask, column layout and
usage mask instead, as the JAX package's host path does.  ZKL_PREFLIGHT=
console|json runs the row-wise constraint check before each segment is
proved.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as _np
import torch

from ..air.airpi import (build_air_pi_for_trace, compute_vm_usage_mask,
                         segment_boundaries_from_full)
from ..air.zk_air import AirPublicInputs, ZkLispAir
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..device import resolve
from ..field import f128
from ..trace import build as tb
from ..trace.layout import (Columns, LayoutConfig, STEPS_PER_LEVEL_P2,
                            VM_USAGE_SPONGE)
from ..trace.stream import StreamedTrace
from ..utils.tracing import phase
from . import planner, stark
from . import stark_device as sd
from .formats import StepMeta, StepProof, Zl1Proof
from .params import (ProofOptions, ProverOptions,
                     select_partitions_for_trace)

STREAM_MIN_ROWS = 1 << 19    # rows from which a trace streams by default


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


def stream_mode(n_rows: int) -> bool:
    """Whether `prove_program` takes its rows from the streamed trace
    source (trace/stream.py: one segment of rows resident at a time)
    instead of building the whole trace.  ZKL_STREAM_TRACE=1 forces it
    on, =0 off (read at call time); unset, traces of at least
    STREAM_MIN_ROWS rows stream, as in the JAX package."""
    env = os.environ.get("ZKL_STREAM_TRACE", "")
    return env not in ("", "0") or (not env and n_rows >= STREAM_MIN_ROWS)


def prove_program(program: Program, pub_inputs: pi_mod.PublicInputs,
                  opts: ProverOptions, on_steps: Optional[Callable] = None,
                  device=None) -> List[StepProof]:
    """Prove every segment of `program` on `device` (default: the CUDA
    card; `device="cpu"` only when the caller asks) and return the
    StepProofs in order.

    on_steps: optional hook called with each batch of finished
    StepProofs as soon as it is assembled: one segment's in the serial
    loop and in parallel segment proving, one wave's in the wave prover.
    If it returns True, proving stops after that batch and the steps
    proved so far are returned (a deliberately partial run, e.g. under a
    time budget).

    ZKL_MESH=1 with more than one device in `default_mesh(device=dev)`
    (the visible cards) proves on that mesh, streamed or not, as in the
    JAX package.  Otherwise the trace source (`stream_mode`) is chosen
    first: a streamed program stays off the wave.  More than one segment
    goes to the wave prover (`ZKL_WAVE=0` opts out), on any device.  Off
    the wave, `opts.max_concurrent_segments` > 1 proves segments side by
    side in threads (`_prove_concurrent`), else the serial loop runs
    (`_prove_serial`)."""
    dev = resolve(device)
    if os.environ.get("ZKL_MESH", "") not in ("", "0"):
        from ..parallel.mesh_prover import default_mesh, prove_program_mesh
        mesh = default_mesh(device=dev)
        if mesh.size > 1:
            return prove_program_mesh(program, pub_inputs, opts, mesh=mesh,
                                      on_steps=on_steps)
    base_opts = opts.to_proof_options()
    segments = planner.plan_segments(program, pub_inputs, opts)
    if not segments:
        raise ProveError("segment planner returned no segments")
    n_rows = max(s.r_end for s in segments)
    streaming = stream_mode(n_rows)
    if (not streaming and len(segments) > 1
            and os.environ.get("ZKL_WAVE", "") != "0"):
        from ..parallel.mesh_prover import prove_program_mesh
        return prove_program_mesh(program, pub_inputs, opts, device=dev,
                                  on_steps=on_steps)

    if streaming:
        with phase("stream_pass1", rows=n_rows, segments=len(segments)):
            full_trace = StreamedTrace(program, pub_inputs, segments)
    else:
        full_trace = tb.build_trace(program, pub_inputs)
        check_merkle_root_binding(full_trace, pub_inputs)
    rom_acc = (tb.rom_acc_from_program(program)
               if any(pub_inputs.program_id) else (0, 0, 0))
    job = _Job(program, pub_inputs, full_trace, segments, rom_acc,
               base_opts, opts.min_security_bits, dev, on_steps)
    max_parallel = max(opts.max_concurrent_segments or 1, 1)
    if max_parallel > 1 and len(segments) > 1:
        return _prove_concurrent(job, max_parallel)
    return _prove_serial(job)


@dataclass
class _Job:
    """What every segment of one `prove_program` call shares."""
    program: Program
    pub_inputs: pi_mod.PublicInputs
    full_trace: object            # TraceTable or StreamedTrace
    segments: List[tb.Segment]
    rom_acc: Tuple[int, int, int]
    base_opts: ProofOptions
    min_bits: int
    device: torch.device
    on_steps: Optional[Callable]

    def prove(self, i: int, prev_state, staged=None, window=None):
        return prove_segment(
            self.pub_inputs.program_id, self.rom_acc, i, len(self.segments),
            self.segments[i], self.full_trace, self.program,
            self.pub_inputs, self.base_opts, self.min_bits, prev_state,
            device=self.device, staged=staged, window=window)

    def stop_after(self, step: StepProof) -> bool:
        return self.on_steps is not None and self.on_steps([step]) is True


def _prove_serial(job: _Job) -> List[StepProof]:
    """The serial loop, `prev_state` chained, with the segments' limb
    uploads queued ahead of their proofs (`stark_device.stage_limbs`).  A
    full trace stages every segment up front (slices of its cached limb
    array); a streamed one works one segment ahead: a worker thread builds
    window i+1, its limbs and their upload while segment i proves, so at
    most two windows are alive."""
    segments = job.segments
    n_seg = len(segments)
    streaming = isinstance(job.full_trace, StreamedTrace)

    def prep(seg):
        """(streamed window or None, the segment's staged limbs)."""
        window = job.full_trace.segment_table(seg) if streaming else None
        return window, sd.stage_limbs([segment_limbs16(
            job.full_trace, job.program, job.pub_inputs, seg, window)],
            job.device)

    pool = ThreadPoolExecutor(max_workers=1) if streaming else None
    ready: List = ([pool.submit(prep, segments[0])] if streaming
                   else [prep(seg) for seg in segments])
    steps: List[StepProof] = []
    prev_state: Optional[tb.PrevState] = None
    try:
        for i in range(n_seg):
            if streaming:
                window, staged = ready.pop().result()
                if i + 1 < n_seg:
                    ready.append(pool.submit(prep, segments[i + 1]))
            else:
                window, staged = ready[i]
                ready[i] = None
            step, state_out = job.prove(i, prev_state, staged=staged,
                                        window=window)
            del window, staged
            steps.append(step)
            prev_state = tb.PrevState(state_out)
            if job.stop_after(step):
                break
    finally:
        if pool is not None:
            for fut in ready:
                fut.cancel()
            pool.shutdown(wait=True)
    return steps


def _prove_concurrent(job: _Job, max_parallel: int) -> List[StepProof]:
    """Parallel segment proving (`max_concurrent_segments` > 1; the
    reference's bounded pool, prove.rs:1017-1051): segment 0 runs alone
    first and builds every lazily cached table (twiddles, constraint
    tables, hasher constants), then the rest run on `max_parallel`
    threads, each segment on its own CUDA stream on a card.  As in the
    reference, segments are not `prev_state` chained here.  on_steps is
    called once per segment; when it returns True, segments not yet
    started are skipped.  The JAX package forks processes on its host
    path; the port takes threads on every device."""
    dev = job.device
    n_seg = len(job.segments)
    steps: List[Optional[StepProof]] = [None] * n_seg
    stop = threading.Event()
    lock = threading.Lock()

    def run(i: int) -> None:
        if stop.is_set():
            return
        with (torch.cuda.stream(torch.cuda.Stream(dev))
              if dev.type == "cuda" and i else contextlib.nullcontext()):
            step, _ = job.prove(i, None)
        steps[i] = step
        with lock:
            if job.stop_after(step):
                stop.set()

    run(0)
    with ThreadPoolExecutor(max_workers=max_parallel) as ex:
        for f in [ex.submit(run, i) for i in range(1, n_seg)]:
            f.result()
    return [s for s in steps if s is not None]


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
    the trace object; None when uniform mode is off or the trace is
    streamed (each segment's usage is then scanned from its own rows, as
    in the JAX package, whose StepProofs carry those masks; a streamed
    one through `streamed_usage`)."""
    if not _uniform_segments(in_mesh) or isinstance(full_trace,
                                                    StreamedTrace):
        return None
    if getattr(full_trace, "_uniform_usage", None) is None:
        full_trace._uniform_usage = compute_vm_usage_mask(
            full_trace, Columns.baseline())
    return full_trace._uniform_usage


def streamed_usage(trace, seg_cols: Columns,
                   eff_mask: int) -> Tuple[int, int]:
    """A streamed segment's (vm_usage_mask, ram_delta_clk_bits): its own
    rows' usage, with the sponge bit set wherever the segment's feature
    mask keeps the sponge.  `verify_step` recovers the sponge feature of
    a layout narrower than the baseline from that bit
    (`_effective_mask_for_step`), so a segment proved with the sponge
    feature on and the bit clear — a segment without sponge ops in
    uniform mode — could never verify.  The JAX package makes exactly
    those proofs (its device default for traces of 2^19 rows and more);
    wherever its streamed proofs verify, these bytes are its bytes.  With
    per-segment masks the bit already follows the feature (both come
    from the segment's sponge ops)."""
    usage, delta_bits = compute_vm_usage_mask(trace, seg_cols)
    if eff_mask & pi_mod.FM_SPONGE:
        usage |= 1 << VM_USAGE_SPONGE
    return usage, delta_bits


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
                    pub_inputs: pi_mod.PublicInputs, seg: tb.Segment,
                    window=None) -> _np.ndarray:
    """(C, n, 8) uint16 limbs of one segment: a slice of the full
    trace's cached limb array, or of the streamed trace's window (built
    here unless `window` is given)."""
    _, seg_layout = _segment_layout(program, pub_inputs, seg)
    if isinstance(full_trace, StreamedTrace):
        if window is None:
            window = full_trace.segment_table(seg)
        return window.slice_rows(0, window.length,
                                 seg_layout.seg_to_full).to_limbs16()
    full16 = full_trace.to_limbs16()
    return _np.ascontiguousarray(
        full16[seg_layout.seg_to_full, seg.r_start:seg.r_end])


def prove_segment(suite_id: bytes, rom_acc: Tuple[int, int, int],
                  segment_index: int, segments_total: int,
                  seg: tb.Segment, full_trace, program: Program,
                  pub_inputs: pi_mod.PublicInputs,
                  base_opts: ProofOptions, min_bits: int,
                  prev_state: Optional[tb.PrevState],
                  device=None, staged: Optional[sd.Staged] = None,
                  window=None) -> Tuple[StepProof, bytes]:
    """Prove one segment with the device segment prover; returns the
    StepProof and the segment's state_out hash (the next segment's
    `prev_state`).  `full_trace` is a TraceTable or a StreamedTrace;
    `staged`, when given, is the segment's limb upload already begun
    (`stark_device.stage_limbs`), and `window` its streamed window
    already built."""
    dev = resolve(device)
    eff_mask, seg_layout = _segment_layout(program, pub_inputs, seg)
    streaming = isinstance(full_trace, StreamedTrace)

    with phase("segment_trace", rows=seg.r_end - seg.r_start):
        if streaming:
            if window is None:
                window = full_trace.segment_table(seg)
            trace, state_in_hash, state_out_hash = \
                tb.segment_from_window(window, seg_layout, prev_state)
        else:
            trace, state_in_hash, state_out_hash = \
                tb.build_segment_trace_with_state(full_trace, seg,
                                                  seg_layout, prev_state)

    with phase("boundaries"):
        boundaries = (full_trace.boundaries(seg) if streaming
                      else segment_boundaries_from_full(full_trace, seg))

    num_partitions, hash_rate = select_partitions_for_trace(
        trace.width, trace.length)
    wf_opts = base_opts.with_partitions(num_partitions, hash_rate)

    with phase("air_pi"):
        usage = uniform_usage_for(full_trace)
        if usage is None and streaming:
            usage = streamed_usage(trace, seg_layout.cols, eff_mask)
        air_pi = build_air_pi_for_trace(
            pub_inputs, eff_mask, rom_acc, seg_layout.cols, boundaries,
            trace, usage_override=usage)
        pi_len = len(air_pi.to_elements())
        air = ZkLispAir(trace.width, trace.length, air_pi)

    preflight(air, trace)

    meta = StepMeta.from_env(trace.length, wf_opts, min_bits, pi_len)
    # segment limbs: the staged upload, the streamed segment's own, or a
    # numpy slice of the cached full-trace u16 array (converting ~1M
    # Python ints per segment costs seconds)
    if staged is not None:
        seg16 = staged.wait()[0]
    elif streaming:
        seg16 = trace.to_limbs16()
    else:
        seg16 = segment_limbs16(full_trace, program, pub_inputs, seg)
    inner = sd.prove_trace(trace, air, air_pi, wf_opts, limbs16=seg16,
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


def verify_proof(inner: stark.StarkProof, program: Program,
                 pi: pi_mod.PublicInputs, min_bits: int = 0) -> None:
    """Slow-path verification of a one-segment proof: rebuild the trace
    to derive the boundary public inputs, then verify the inner STARK on
    the host (prove.rs verify_proof); raises stark.VerifyError."""
    pi.validate_flags()
    rom_acc = (tb.rom_acc_from_program(program) if any(pi.program_commitment)
               else (0, 0, 0))
    trace = tb.build_trace(program, pi)
    air_pi = build_air_pi_for_trace(pi, pi.feature_mask, rom_acc, None,
                                    None, trace)
    stark.verify_trace(inner, air_pi, min_bits)
