"""Wave prover: prove_program over waves of segments, on one device or
sharded over the devices of a mesh.

Counterpart of the JAX package's parallel/mesh_prover.py, byte-identical
StepProofs.  Segments with the same executable shape
(`_SegPrep.exec_key`) are grouped into WAVES of up to W segments; every
prover stage then runs once over the whole wave, the segments stacked on
a leading axis of every tensor (prove/stark_device.py's stages take that
axis), so the launches of each stage — every NTT chunk, Merkle level, FRI
layer, grind sweep, constraint level — and the host work around them are
shared by the S segments of a wave instead of repeated per segment.
Fiat-Shamir coins stay per segment on the host and advance in lockstep
between stages (the roots are the only reads from the device per stage).

A mesh (`Mesh`, `default_mesh`) is an ordered tuple of devices on one
axis, "seg", driven by this one process as the JAX package drives its
local devices.  A wave whose width S is a multiple of the mesh size is
sharded as `NamedSharding(mesh, P("seg"))` shards it: shard d takes the
contiguous block [d*S/D, (d+1)*S/D) of the wave's segments, on device d.
The shards run the same stages in lockstep (`_lockstep`): each stage is
queued on every shard before the host reads any shard's roots, so cards
work side by side.  A mesh may repeat one device (`Mesh([dev] * 4)`):
its shards then run one after another on that device, through every
sharded code path.  `mesh=None`, or a mesh of one device, is the
one-device wave.

As in the JAX package (and the reference's parallel mode,
prove.rs:1018-1051), segments are proved independently: the boundary
state chaining that the serial loop checks is checked here only under
ZKL_MESH_CHAIN=1 (`_chain_check_mesh`, whose last-edge handoff between
shards is the JAX ppermute).  Switches, read at call time: ZKL_WAVE=k
(segments per wave; 0 sends `prover.prove_program` to the serial loop),
ZKL_WAVE_BYTES (the memory a wave is sized for), ZKL_WAVE_OVERLAP=0 (no
host-assembly thread), ZKL_MESH_NTT_MIN (the LDE of a one-segment wave on
a mesh through parallel/ntt_mesh.py: a branch ported as the JAX package
has it, which `_pad_wave` never lets a wave reach, in either package).
`prover.prove_program` sends a program here on a mesh under ZKL_MESH=1
when the default mesh has more than one device.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as _np
import torch

from ..air.airpi import build_air_pi_for_trace, segment_boundaries_from_full
from ..air.zk_air import ZkLispAir
from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..crypto import poseidon as pos
from ..device import resolve
from ..field import f128, limb, ntt
from ..field import limb_host as _lh
from ..field import ntt_host as _nh
from ..prove import cvm, kernels, multiproof, planner
from ..prove import prover as pv
from ..prove import stark_device as sd
from ..prove.coin import RandomCoin
from ..prove.composition_device import eval_scan_blocks
from ..prove.formats import StepMeta, StepProof, Zl1Proof
from ..prove.params import (ProofOptions, ProverOptions,
                            select_partitions_for_trace)
from ..prove.stark import (FriLayerOpenings, ProofContext, QueryOpenings,
                           StarkProof, group_assertions)
from ..trace import build as tb
from ..utils.tracing import phase

P = f128.P
MAX_WAVE = 16           # segments per wave at most


def _bucket(x: int, step: int = 8) -> int:
    return max(step, ((x + step - 1) // step) * step)


class Mesh:
    """Devices on the one axis "seg", in shard order; a device may repeat
    (its shards then share it)."""

    axis_names = ("seg",)

    def __init__(self, devices) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """Every visible card, in order (`torch.cuda.device_count()`; the first
    `n_devices` of them when given) for a CUDA `device` (the default); for
    the CPU one `cpu` entry, or `n_devices` of them.  Never repeats a
    card."""
    dev = resolve(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices:
            devs = devs[:n_devices]
    else:
        devs = [dev] * (n_devices or 1)
    return Mesh(devs)


# ---------------------------------------------------------------------------
# per-segment host prep
# ---------------------------------------------------------------------------

class _SegPrep:
    """Everything prove_segment derives on host before device work,
    ZKL_PREFLIGHT's check included (the JAX package's wave skips it)."""

    def __init__(self, index: int, n_seg: int, seg, full_trace,
                 program: Program, pub_inputs: pi_mod.PublicInputs,
                 base_opts: ProofOptions, min_bits: int,
                 suite_id: bytes, rom_acc) -> None:
        self.index = index
        eff_mask, seg_layout = pv._segment_layout(program, pub_inputs,
                                                  seg, in_mesh=True)
        trace, state_in, state_out = tb.build_segment_trace_with_state(
            full_trace, seg, seg_layout, None)
        boundaries = segment_boundaries_from_full(full_trace, seg)
        nparts, rate = select_partitions_for_trace(trace.width,
                                                   trace.length)
        self.opts = base_opts.with_partitions(nparts, rate)
        self.air_pi = build_air_pi_for_trace(
            pub_inputs, eff_mask, rom_acc, seg_layout.cols, boundaries,
            trace, usage_override=pv.uniform_usage_for(full_trace,
                                                       in_mesh=True))
        self.air = ZkLispAir(trace.width, trace.length, self.air_pi)
        pv.preflight(self.air, trace)
        self.groups = group_assertions(self.air.get_assertions(),
                                       trace.length,
                                       self.opts.per_assertion)
        self.limbs16 = trace.to_limbs16()
        self.meta = StepMeta.from_env(trace.length, self.opts, min_bits,
                                      len(self.air_pi.to_elements()))
        self.boundary = pv._boundary_dict(boundaries, state_in, state_out)
        self.n = trace.length
        self.w = trace.width
        self.suite_id = suite_id

    def structure_key(self) -> tuple:
        """Segments sharing this key produce draws and constraints with
        identical structure, boundary assertion groups included.
        suite_id is part of the key: the composition bakes in the
        program-derived Poseidon round constants / MDS."""
        return (self.w, self.n, self.opts, self.suite_id,
                self.air_pi.vm_usage_mask, self.air_pi.ram_delta_clk_bits,
                dataclasses.astuple(self.air.features),
                self.air.rom_enabled,
                self.air.num_transition_constraints(),
                tuple((g.column, g.offsets, g.step) for g in self.groups))

    def exec_key(self) -> tuple:
        """Wave key: segments sharing it prove in ONE wave even when their
        boundary assertion SETS differ (e.g. segment 0's pc_init == 0
        binding, air/zk_air.py), because group indices, divisors, values
        and betas enter the quotient stage as per-segment data; only the
        bucketed group counts are part of the key, as in the JAX
        package (whose compiled stages take them as array shapes)."""
        n_cyc = sum(1 for g in self.groups if not g.is_single)
        n_sgl = sum(1 for g in self.groups if g.is_single)
        return (self.w, self.n, self.opts, self.suite_id,
                self.air_pi.vm_usage_mask, self.air_pi.ram_delta_clk_bits,
                dataclasses.astuple(self.air.features),
                self.air.rom_enabled,
                self.air.num_transition_constraints(),
                _bucket(n_cyc), _bucket(n_sgl) if n_sgl else 0)


# ---------------------------------------------------------------------------
# the wave prover
# ---------------------------------------------------------------------------

def _commit_row_chunk(N: int, S: int) -> int:
    """Rows of each segment per leaf-hash batch of a wave commit.

    Shrinks with the wave width S so the whole wave's hash transient
    stays near one serial segment's, floors at 4096 rows (one batch of
    S * 4096 leaves), and is clamped to N itself."""
    chunk = min(kernels.ROW_CHUNK, N)
    if S > 1:
        chunk = min(N, max(4096, min(chunk, N // S)))
    return chunk


def _pad_wave(preps: List[_SegPrep], mesh,
              wave_width: int) -> List[_SegPrep]:
    """Pad a wave to the target width, at least the mesh size: pad slots
    repeat the last segment and their device work is discarded (host
    assembly only walks real segments).  Shared by _prove_wave and the
    upload, so the staged columns always match the wave."""
    W = max(mesh.size if mesh is not None else 1, 1, wave_width)
    return list(preps) + [preps[-1]] * max(0, W - len(preps))


def _wave_shard(mesh, S: int):
    """The shards of a wave of S slots: [(device, lo, hi)], shard d the
    contiguous block [d*S/D, (d+1)*S/D) on device d; None when the wave
    is not sharded (no mesh, one device, or S not a multiple of it)."""
    if mesh is None or mesh.size <= 1 or S % mesh.size:
        return None
    k = S // mesh.size
    return [(dev, d * k, (d + 1) * k) for d, dev in enumerate(mesh.devices)]


def _wave_blocks(mesh, S: int, device):
    """The blocks a wave of S slots runs as: its shards, or the whole wave
    on `device` (the mesh's first device when there is a mesh)."""
    blocks = _wave_shard(mesh, S)
    if blocks is None:
        dev = mesh.devices[0] if mesh is not None else torch.device(device)
        blocks = [(dev, 0, S)]
    return blocks


def _stage_wave_cols(preps: List[_SegPrep], mesh, wave_width: int,
                     device) -> List[sd.Staged]:
    """Begin the wave's host->device column upload (`sd.stage_limbs`), each
    shard's block to its device, so later waves' uploads overlap the
    earlier waves' stages."""
    preps = _pad_wave(preps, mesh, wave_width)
    return [sd.stage_limbs([p.limbs16 for p in preps[lo:hi]], dev)
            for dev, lo, hi in _wave_blocks(mesh, len(preps), device)]


def _prove_wave(preps: List[_SegPrep], mesh, wave_width: int, device,
                staged: Optional[List[sd.Staged]] = None,
                defer_assembly: bool = False):
    """Prove the segments of one wave (one exec_key), padded to
    `wave_width` (at least the mesh size), every stage once over the
    wave: whole on `device` (the mesh's first device when there is a
    mesh), or sharded over the mesh (`_wave_shard`), the shards in
    lockstep.  A shard that holds only pad slots is not run: its work
    would be discarded.

    defer_assembly=True returns a zero-argument closure running the PURE
    HOST tail of the wave (remainder interpolation, multiproof
    compression, proof objects: `_assemble_wave_host`) instead of the
    proofs: the caller runs it in a worker thread behind the next wave's
    stages.  All device work, the query gathers and path opens included,
    is done before this function returns, and the closure holds only
    host data, so the worker queues nothing on the card."""
    S_real = len(preps)
    preps = _pad_wave(preps, mesh, wave_width)
    S = len(preps)
    p0 = preps[0]
    n, w, opts = p0.n, p0.w, p0.opts
    # the LDE of a one-segment wave through the sharded NTT (the JAX
    # package's condition; _pad_wave makes S >= mesh.size, so no wave on
    # a mesh of several devices meets it)
    ntt_min = int(os.environ.get("ZKL_MESH_NTT_MIN", str(1 << 20)))
    lde_mesh = (mesh if S == 1 and mesh is not None and mesh.size > 1
                and n * opts.blowup >= ntt_min else None)
    blocks = _wave_blocks(mesh, S, device)
    gens = [_wave_stages(preps[lo:hi], min(hi, S_real) - lo, dev,
                         staged[k] if staged is not None else None,
                         lde_mesh)
            for k, (dev, lo, hi) in enumerate(blocks) if lo < S_real]
    shards = _lockstep(gens, [dev for dev, _, _ in blocks])
    if len(shards) == 1:
        out = shards[0]
    else:
        out = {"opened": {k: [v for sh in shards for v in sh["opened"][k]]
                          for k in shards[0]["opened"]},
               "rem_host": _np.concatenate([sh["rem_host"]
                                            for sh in shards])}
        for k in ("t_roots", "c_roots", "ood"):
            out[k] = [v for sh in shards for v in sh[k]]

    def _assemble() -> List[StarkProof]:
        # pure host tail: safe in a worker thread behind the next wave
        return _assemble_wave_host(out["opened"], opts, S_real, n, w,
                                   out["t_roots"], out["c_roots"],
                                   out["rem_host"], out["ood"])

    if defer_assembly:
        return _assemble
    return _assemble()


def _lockstep(gens, devices) -> list:
    """Run the shards' stage generators (`_wave_stages`) side by side and
    return their results in shard order.  Each round advances every
    generator once, so a stage is queued on every shard before any shard
    reads what its stage queued.  A generator yields (name, on_device,
    fields) where a wave phase starts — the phase is timed once for the
    whole wave, its "S" the sum over the shards, and at its end every
    card of `devices` is synchronized — and None where it is about to
    read the device inside a phase.  With one generator this is that
    generator's stages in order, each in its phase."""
    ph = None
    try:
        msgs = [next(g) for g in gens]
        while True:
            if msgs[0] is not None:
                if ph is not None:
                    ph.__exit__(None, None, None)
                    ph = None
                name, on_device, fields = msgs[0]
                ph = phase(name, devices if on_device else None,
                           **dict(fields, S=sum(m[2]["S"] for m in msgs)))
                ph.__enter__()
            msgs, results = [], []
            for g in gens:
                try:
                    msgs.append(g.send(None))
                except StopIteration as stop:
                    results.append(stop.value)
            if results:
                assert len(results) == len(gens), "shards out of step"
                return results
    except BaseException as e:
        if ph is not None:
            done, ph = ph, None
            done.__exit__(type(e), e, e.__traceback__)
        raise
    finally:
        if ph is not None:
            ph.__exit__(None, None, None)


def _wave_stages(preps: List[_SegPrep], S_real: int, dev,
                 staged: Optional[sd.Staged], lde_mesh):
    """The stages of one wave, or of one shard's block of it, on `dev`: a
    generator driven by `_lockstep` (see there for what it yields).  The
    first S_real of `preps` are real segments.  Returns the host data of
    the real segments that `_assemble_wave_host` needs."""
    S = len(preps)
    p0 = preps[0]
    n, w, opts = p0.n, p0.w, p0.opts
    blowup = opts.blowup
    N = n * blowup
    Q = p0.air.ce_blowup()
    bpp = sd.LDE_BYTES_PER_POINT

    # stage 1: LDE of the wave's S * w columns, in chunks sized from the
    # memory free on the device (the outputs are allocated first)
    yield ("wave_lde", True, {"S": S, "n": n})
    if staged is None:
        staged = sd.stage_limbs([p.limbs16 for p in preps], dev)
    cols = staged.wait().reshape(S * w, n, limb.NLIMB)
    out_bytes = S * w * (n + N) * limb.NLIMB * 4
    if lde_mesh is None:
        polys_f, lde_f = sd.lde_columns(cols, blowup, sd.col_chunk_for(
            S * w, N * bpp, sd.stage_budget(dev) - out_bytes))
    else:
        from .ntt_mesh import lde_columns_sharded
        polys_f = torch.empty_like(cols)
        step = sd.col_chunk_for(S * w, n * bpp, sd.stage_budget(dev))
        for s in range(0, S * w, step):
            polys_f[s:s + step] = ntt.intt(cols[s:s + step])
        lde_f = lde_columns_sharded(polys_f, blowup, lde_mesh)
    del cols, staged
    trace_polys = polys_f.reshape(S, w, n, limb.NLIMB)
    trace_lde = lde_f.reshape(S, w, N, limb.NLIMB)

    # stage 2: trace commitment, S trees
    yield ("wave_trace_commit", True, {"S": S})
    ps_main = opts.partition_size(w)
    chunk = _commit_row_chunk(N, S)
    t_levels = kernels.commit_cols(trace_lde, ps_main, chunk)
    yield None
    t_comm = sd._DevCommitment(t_levels)
    t_roots = t_comm.roots_fe

    # FS coins per segment (host, lockstep)
    yield ("wave_fs_coeffs", False, {"S": S})
    coins, alphas_l, betas_l = [], [], []
    for i, p in enumerate(preps):
        coin = RandomCoin(ProofContext(w, n, opts).to_elements()
                          + p.air_pi.to_elements())
        coin.reseed(f128.fe_to_bytes_fold(t_roots[i]))
        alphas_l.append(coin.draw_many(p.air.num_transition_constraints()))
        betas_l.append(coin.draw_many(len(p.groups)))
        coins.append(coin)

    # Composition evaluates on the blowup_c = Q sub-domain, a strided view
    # of the LDE (no copy): the quotient's degree < Q*n makes the result
    # — and the proof bytes — identical to the full domain's.
    blowup_c = Q if (0 < Q < blowup and blowup % Q == 0) else blowup
    stride_c = blowup // blowup_c
    trace_lde_c = (trace_lde if stride_c == 1
                   else trace_lde[:, :, ::stride_c])
    n_c = n * blowup_c

    # stage 3: composition.  The layout-derived tables (periodic
    # selectors, p_last, zerofier inverse) are the same across the wave
    # (exec_key guarantees it); the group-derived divisors are per
    # segment and enter the quotient stage as data.
    yield ("wave_composition", True, {"S": S})
    tabs = [sd._host_tables(p.air, p.groups, blowup_c, dev) for p in preps]
    per_p, p_last, zinv = tabs[0][:3]
    alphas_dev = limb.from_ints(alphas_l, dev)              # (S, nc, 8)
    prog_cvm, specs = sd._record_cvm(p0.air, per_p.shape[0] + 1)
    comb = None
    if specs:
        comb = eval_scan_blocks(p0.air, trace_lde_c, blowup_c,
                                per_p[1:1 + 27], alphas_dev, specs)
    if prog_cvm.n_instr:
        gen = cvm.execute(prog_cvm, trace_lde_c, per_p, p_last,
                          alphas_dev, blowup_c)
        comb = gen if comb is None else limb.add(comb, gen)

    # boundary + quotient: every segment's own groups, padded to one
    # count (pad slots have beta = 0, so they add nothing)
    yield ("wave_quotient", True, {"S": S})
    groups = sd.boundary_groups([p.groups for p in preps], betas_l,
                                tabs, dev)
    comp = sd.quotient_comp(
        comb, trace_lde_c, *groups, zinv,
        group_chunk=max(1, sd.stage_budget(dev) // (S * n_c * bpp)))
    del comb, groups, trace_lde_c
    q_polys, q_lde = sd.quotient_finish(
        comp, n, blowup, Q, col_chunk=sd.col_chunk_for(
            S * Q, N * bpp, sd.stage_budget(dev)))
    del comp

    yield ("wave_constraint_commit", True, {"S": S})
    ps_con = opts.partition_size(Q)
    c_levels = kernels.commit_cols(q_lde, ps_con, chunk)
    yield None
    c_comm = sd._DevCommitment(c_levels)
    c_roots = c_comm.roots_fe
    for i, coin in enumerate(coins):
        coin.reseed(f128.fe_to_bytes_fold(c_roots[i]))

    # stage 4: OOD
    yield ("wave_zpows", False, {"S": S})
    zs = [coin.draw() for coin in coins]
    g_trace = f128.get_root_of_unity(n)
    zgs = [f128.mul(z, g_trace) for z in zs]
    zp = limb.from_numpy(_np.stack([_lh.powers_np(z, n) for z in zs]), dev)
    zgp = limb.from_numpy(_np.stack([_lh.powers_np(zg, n) for zg in zgs]),
                          dev)
    yield ("wave_ood", True, {"S": S})
    oc = sd.col_chunk_for(w, S * n * bpp, sd.stage_budget(dev))
    evals = torch.cat(
        [sd.ood_evals(trace_polys, zp, oc), sd.ood_evals(q_polys, zp),
         sd.ood_evals(trace_polys, zgp, oc), sd.ood_evals(q_polys, zgp)],
        dim=1)                                        # (S, 2w + 2Q)
    del trace_polys, q_polys, zp, zgp
    yield None
    vals = limb.to_ints(evals)
    ood = []
    for i, coin in enumerate(coins):
        row = [int(v) for v in vals[i]]
        tc, qc = row[:w], row[w:w + Q]
        tn, qn = row[w + Q:2 * w + Q], row[2 * w + Q:]
        coin.reseed(pos.hash_elements(tc + qc + tn + qn))
        ood.append((tc, tn, qc, qn))

    # stage 5: DEEP (one batched inverse; the coefficient dot per segment)
    yield ("wave_deep_sync", True, {"S": S})
    gz_l, gzg_l, coeffs_l = [], [], []
    for i, coin in enumerate(coins):
        tc, tn, qc, qn = ood[i]
        gammas = coin.draw_many(w)
        deltas = coin.draw_many(Q)
        gz_l.append((sum(g_ * t for g_, t in zip(gammas, tc))
                     + sum(d * q for d, q in zip(deltas, qc))) % P)
        gzg_l.append((sum(g_ * t for g_, t in zip(gammas, tn))
                      + sum(d * q for d, q in zip(deltas, qn))) % P)
        coeffs_l.append(gammas + deltas)
    inv_xz, inv_xzg = sd.deep_inv(sd._lde_xs(n, blowup, dev),
                                  limb.from_ints(zs, dev),
                                  limb.from_ints(zgs, dev))
    gz_dev = limb.from_ints(gz_l, dev)
    gzg_dev = limb.from_ints(gzg_l, dev)
    if not os.environ.get("ZKL_NO_MXU_DEEP"):
        deep = sd.deep_mxu(trace_lde, q_lde,
                           [sd.deep_planes(c, dev) for c in coeffs_l],
                           gz_dev, gzg_dev, inv_xz, inv_xzg)
    else:
        coeffs = limb.from_ints(coeffs_l, dev)
        dc = min(sd.DEEP_ROW_CHUNK, N)
        deep = torch.stack([torch.cat([
            sd.deep_chunk(trace_lde[i, :, s:s + dc],
                          q_lde[i, :, s:s + dc], coeffs[i], gz_dev[i],
                          gzg_dev[i], inv_xz[i, s:s + dc],
                          inv_xzg[i, s:s + dc])
            for s in range(0, N, dc)]) for i in range(S)])
    del inv_xz, inv_xzg

    # stage 6: FRI, every segment's layer folded and committed at once
    # (the fused chain queued on every shard before any root is read)
    num_layers = opts.num_fri_layers(N)
    yield ("wave_fri", True, {"S": S})
    if os.environ.get("ZKL_NO_FUSED_FRI"):
        fri_comms, fri_layers, final_layer = sd.fri_layers_loop(
            deep, coins, num_layers)
    else:
        levels_all, fri_layers, roots, final_layer = sd.fri_chain_queue(
            deep, coins, num_layers)
        yield None
        fri_comms = sd.fri_chain_finish(coins, levels_all, roots)
    rem_host = limb.to_numpy_u32(final_layer)
    del deep

    yield ("wave_openings", True, {"S": S_real})
    opened = _open_wave_queries(coins, opts, S_real, N, num_layers,
                                trace_lde, q_lde, t_comm, c_comm, fri_comms,
                                fri_layers, dev)
    return {"opened": opened, "t_roots": t_roots[:S_real],
            "c_roots": c_roots[:S_real], "rem_host": rem_host[:S_real],
            "ood": ood[:S_real]}


def _open_wave_queries(coins, opts, S_real: int, N: int, num_layers: int,
                       trace_lde, q_lde, t_comm, c_comm, fri_comms,
                       fri_layers, device) -> dict:
    """Device part of the wave's tail, for the real segments: grind,
    query-position draws, row gathers and Merkle sibling-path opens, each
    ONE batched gather over the wave, all read back to host structures
    (the returned dict holds no tensor).  Runs in the wave's
    `wave_openings` phase."""
    # (a) PoW grind: every real segment's search in one sweep at a time
    nonces = RandomCoin.grind_many(coins[:S_real], opts.grinding_factor,
                                   device)

    # (b) query positions (host FS draws) + folded FRI positions
    positions_l, foldeds_l = [], []
    for i in range(S_real):
        positions = sorted(set(coins[i].draw_integers(
            opts.num_queries, N, nonces[i])))
        positions_l.append(positions)
        foldeds = []
        pos_d, size_d = positions, N
        for _ in range(num_layers):
            half = size_d // 2
            folded = []
            for p_ in pos_d:
                m = p_ % half
                if m not in folded:
                    folded.append(m)
            foldeds.append((folded, half))
            pos_d, size_d = folded, half
        foldeds_l.append(foldeds)

    def index(ints):
        return torch.tensor(ints, dtype=torch.int64, device=device)

    # (c) ONE gather over the wave for trace + quotient query rows
    seg = index([i for i in range(S_real) for _ in positions_l[i]])
    rows = index([p_ for ps in positions_l for p_ in ps])
    t_rows = limb.to_numpy_u32(sd.gather_rows(trace_lde, rows, seg))
    q_rows = limb.to_numpy_u32(sd.gather_rows(q_lde, rows, seg))

    # (d) the sibling paths of both commitments, every segment's trees
    #     at once: leaf p of segment i is leaf i * N + p of the forest
    flat = [i * N + p_ for i in range(S_real) for p_ in positions_l[i]]
    tc_paths = sd.open_paths_multi([t_comm, c_comm], [flat, flat])

    # (e) ONE value gather + ONE path gather per FRI layer, every
    #     segment at once
    fri_vals_l = [[] for _ in range(S_real)]
    fri_paths_l = [[] for _ in range(S_real)]
    if num_layers:
        idxs, leaf_pos = [], []
        for d in range(num_layers):
            size_d = N >> d
            ix, lp = [], []
            for i in range(S_real):
                folded, half = foldeds_l[i][d]
                ix += [i * size_d + m for m in folded]
                ix += [i * size_d + half + m for m in folded]
                lp += [i * half + m for m in folded]
            idxs.append(index(ix))
            leaf_pos.append(lp)
        vals_flat = limb.to_ints(sd.fri_vals(fri_layers, idxs))
        paths = sd.open_paths_multi(fri_comms, leaf_pos)
        off = 0
        for d in range(num_layers):
            j = 0
            for i in range(S_real):
                nf = len(foldeds_l[i][d][0])
                fri_vals_l[i].append(
                    [int(v) for v in vals_flat[off:off + 2 * nf]])
                fri_paths_l[i].append(paths[d][j:j + nf])
                off += 2 * nf
                j += nf

    # split the flat gathers per segment
    t_rows_l, q_rows_l, t_paths_l, c_paths_l = [], [], [], []
    off = 0
    for i in range(S_real):
        k = len(positions_l[i])
        t_rows_l.append(t_rows[off:off + k])
        q_rows_l.append(q_rows[off:off + k])
        t_paths_l.append(tc_paths[0][off:off + k])
        c_paths_l.append(tc_paths[1][off:off + k])
        off += k
    return {
        "nonces": nonces, "positions_l": positions_l,
        "foldeds_l": foldeds_l, "t_rows_l": t_rows_l,
        "q_rows_l": q_rows_l, "t_paths_l": t_paths_l,
        "c_paths_l": c_paths_l, "fri_vals_l": fri_vals_l,
        "fri_paths_l": fri_paths_l,
        "fri_roots_l": [[f128.fe_to_bytes_fold(c.roots_fe[i])
                         for c in fri_comms] for i in range(S_real)],
    }


def _assemble_wave_host(opened: dict, opts, S_real: int, n: int, w: int,
                        t_roots, c_roots, rem_host,
                        ood) -> List[StarkProof]:
    """(f) pure-host proof assembly per real segment — the deferred tail
    that overlaps the next wave's device stages."""
    proofs: List[StarkProof] = []
    with phase("wave_assembly", S=S_real):
        for i in range(S_real):
            positions = opened["positions_l"][i]
            rem_ints = [int(v) for v in _lh.to_ints(
                _nh.coset_interpolate(rem_host[i], 1, _np))]
            max_deg = opts.fri_remainder_max_degree
            assert all(v == 0 for v in rem_ints[max_deg + 1:]), \
                "FRI remainder degree too high"
            fri_remainder = list(reversed(rem_ints[:max_deg + 1]))

            def rows_of(rows):
                return [[int(v) for v in _lh.to_ints(rows[j])]
                        for j in range(len(positions))]

            t_paths = opened["t_paths_l"][i]
            c_paths = opened["c_paths_l"][i]
            trace_open = QueryOpenings(
                rows_of(opened["t_rows_l"][i]), t_paths,
                multiproof.compress(positions, t_paths))
            constraint_open = QueryOpenings(
                rows_of(opened["q_rows_l"][i]), c_paths,
                multiproof.compress(positions, c_paths))

            fri_open: List[FriLayerOpenings] = []
            for d, (folded, _) in enumerate(opened["foldeds_l"][i]):
                nf = len(folded)
                vals_d = opened["fri_vals_l"][i][d]
                paths_d = opened["fri_paths_l"][i][d]
                fri_open.append(FriLayerOpenings(
                    [(vals_d[j], vals_d[nf + j]) for j in range(nf)],
                    paths_d, multiproof.compress(folded, paths_d)))

            tc, tn, qc, qn = ood[i]
            proofs.append(StarkProof(
                context=ProofContext(w, n, opts),
                trace_root=f128.fe_to_bytes_fold(t_roots[i]),
                constraint_root=f128.fe_to_bytes_fold(c_roots[i]),
                ood_trace_current=tc, ood_trace_next=tn,
                ood_quotient_current=qc, ood_quotient_next=qn,
                fri_roots=opened["fri_roots_l"][i],
                fri_remainder=fri_remainder,
                pow_nonce=opened["nonces"][i],
                trace_openings=trace_open,
                constraint_openings=constraint_open,
                fri_openings=fri_open))
    return proofs


def _chain_check_mesh(preps: List[_SegPrep], mesh=None) -> None:
    """Serial-equivalent boundary chaining for a wave run
    (ZKL_MESH_CHAIN=1): every segment's state_in_hash must equal the
    previous segment's state_out_hash, as the serial loop's prev_state
    check requires (trace/build.py _with_state_hashes).  The boundary
    hashes are compared as 8 x u32 words, padded with zero rows to a
    multiple of the mesh size, with a `valid` mask (segment 0 chains from
    the global initial state).  On a mesh of several devices each shard
    holds its contiguous block on its device, the LAST state_out of shard
    d is copied to shard d + 1 (the JAX package's ppermute; the last
    shard's wraps round to shard 0, masked out there), each shard counts
    its mismatches, and the host sums the counts (the psum).  Proof bytes
    are unaffected; a mismatch raises the TraceError the serial chain
    raises."""
    D = max(mesh.size if mesh is not None else 1, 1)
    n = len(preps)
    pad = (-n) % D

    def words(b: bytes):
        return _np.frombuffer(b, dtype="<u4").copy()

    zero = _np.zeros(8, _np.uint32)
    ins = _np.stack([words(p.boundary["state_in_hash"]) for p in preps]
                    + [zero] * pad)
    outs = _np.stack([words(p.boundary["state_out_hash"]) for p in preps]
                     + [zero] * pad)
    valid = _np.zeros(n + pad, _np.uint32)
    valid[1:n] = 1        # segment 0 chains from the global initial state

    if D > 1:
        k = (n + pad) // D

        def shard(a, dev, d):
            return torch.from_numpy(a[d * k:(d + 1) * k].astype(
                _np.int64)).to(dev, non_blocking=True)

        blocks = [(dev, shard(ins, dev, d), shard(outs, dev, d),
                   shard(valid, dev, d))
                  for d, dev in enumerate(mesh.devices)]
        counts = []
        for d, (dev, ins_l, outs_l, valid_l) in enumerate(blocks):
            prev_edge = blocks[(d - 1) % D][2][-1].to(dev, non_blocking=True)
            prev = torch.cat([prev_edge[None], outs_l[:-1]])
            counts.append(((prev != ins_l).any(dim=1).to(torch.int64)
                           * valid_l).sum())
        total = sum(int(c) for c in counts)
    else:
        # one device: the same chained comparison, no exchange
        prev = _np.concatenate([outs[-1:], outs[:-1]], axis=0)
        total = int(((prev != ins).any(axis=1).astype(_np.uint32)
                     * valid).sum())
    if total:
        raise tb.TraceError(
            f"mesh chain check: {total} segment boundary(ies) do not "
            f"chain (state_out_hash != next state_in_hash)")


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def default_wave_width(mesh, n: int, w: int, blowup: int, n_seg: int,
                       device=None) -> int:
    """Segments per wave: a multiple of the mesh size chosen so the wave's
    device residency (trace LDE, commit transient, quotient) stays within
    the memory budget: ZKL_WAVE_BYTES, else 0.4 of the memory of the
    mesh's first device (of `device` without a mesh; 6.4e9 on the CPU);
    at most MAX_WAVE, clamped to the segment count rounded up to the mesh
    size, then balanced so the waves are as even as the wave count
    allows.  As in the JAX package the whole wave is held to one device's
    budget, so a mesh that repeats one device stays within it.  Override:
    ZKL_WAVE=k.  Read at call time."""
    base = max(mesh.size if mesh is not None else 1, 1)

    def ceil_mult(x: int) -> int:
        return ((x + base - 1) // base) * base

    env = os.environ.get("ZKL_WAVE", "")
    if env:
        return max(int(env), 1)
    budget = os.environ.get("ZKL_WAVE_BYTES")
    if budget:
        budget = float(budget)
    else:
        budget = 6.4e9
        dev = (mesh.devices[0] if mesh is not None
               else torch.device("cpu" if device is None else device))
        if dev.type == "cuda":
            budget = sd.WAVE_MEMORY_SHARE * torch.cuda.mem_get_info(dev)[1]
    # per segment: trace LDE (w, N, 8) u32, about as much again of
    # commit-transpose transient, quotient LDE + polys and workspace
    per_seg = w * n * blowup * limb.NLIMB * 4 * 2.5
    cap = max(1, int(budget / max(per_seg, 1)))
    W = max(base, (min(cap, MAX_WAVE) // base) * base)
    W = min(W, ceil_mult(max(n_seg, 1)))
    # balance: ceil(n_seg / n_waves) keeps the wave count but minimizes
    # the padded tail (16 segments at cap 10 -> two waves of 8)
    if W < n_seg:
        n_waves = -(-n_seg // W)
        W = max(base, ceil_mult(-(-n_seg // n_waves)))
    return W


def prove_program_mesh(program: Program, pub_inputs: pi_mod.PublicInputs,
                       opts: ProverOptions, mesh: Optional[Mesh] = None,
                       device=None, wave: int = 0, on_steps=None,
                       segment_subset=None) -> List[StepProof]:
    """prove_program with segments batched into waves, each wave sharded
    over `mesh` (`Mesh`, `default_mesh`; waves are then sized in
    multiples of its size); `mesh=None` proves on `device` alone
    (default: the CUDA card; `device="cpu"` only when the caller asks).
    A mesh of one device is that same one-device path.

    Segments are proved independently (no prev_state chaining; see
    ZKL_MESH_CHAIN).  Requires the full trace in memory.  `wave` sets the
    segments per wave (default: `default_wave_width`).

    on_steps, when given, is called with each wave's finished
    List[StepProof] as soon as it is assembled — the hook the aggregation
    pipeline uses to overlap child FS replay with the remaining waves
    (agg.prove_chain).  If it returns True, proving stops after that
    wave and the steps proved so far are returned.

    segment_subset, when given, restricts proving to those GLOBAL segment
    indices; indices and segments_total in the zl1 containers stay
    global, so the subset's proofs are byte-identical to the same
    segments from a full run.  Returns the steps in subset order."""
    dev = resolve(mesh.devices[0] if mesh is not None else device)
    base_opts = opts.to_proof_options()
    segments = planner.plan_segments(program, pub_inputs, opts)
    if not segments:
        raise pv.ProveError("segment planner returned no segments")
    full_trace = tb.build_trace(program, pub_inputs)
    pv.check_merkle_root_binding(full_trace, pub_inputs)
    suite_id = pub_inputs.program_id
    rom_acc = (tb.rom_acc_from_program(program)
               if any(pub_inputs.program_id) else (0, 0, 0))

    n_seg = len(segments)
    sel = (list(segment_subset) if segment_subset is not None
           else list(range(n_seg)))
    with phase("wave_limb_convert"):
        full_trace.to_limbs16()   # once; segments numpy-slice the cache
    with phase("wave_seg_prep", n_seg=len(sel)):
        preps = [_SegPrep(i, n_seg, segments[i], full_trace, program,
                          pub_inputs, base_opts, opts.min_security_bits,
                          suite_id, rom_acc)
                 for i in sel]

    # ZKL_MESH_CHAIN=1: serial-equivalent boundary chaining, for the full
    # contiguous segment set only
    if (os.environ.get("ZKL_MESH_CHAIN", "") not in ("", "0")
            and sel == list(range(n_seg)) and n_seg > 1):
        _chain_check_mesh(preps, mesh)

    # group segments of one executable shape into waves
    by_key: dict = {}
    for p in preps:
        by_key.setdefault(p.exec_key(), []).append(p)
    W = wave or default_wave_width(mesh, preps[0].n, preps[0].w,
                                   base_opts.blowup, len(sel), dev)
    waves: List[List[_SegPrep]] = [grp[s:s + W] for grp in by_key.values()
                                   for s in range(0, len(grp), W)]

    # every wave's upload starts now: later waves copy while earlier
    # waves prove (the int32 columns are ~28 MB per rollup-bench segment)
    staged: List = [_stage_wave_cols(wv, mesh, W, dev) for wv in waves]
    steps: List[Optional[StepProof]] = [None] * n_seg
    stop = threading.Event()

    def _finish(wave_preps, assemble) -> None:
        inner_proofs = assemble()
        if stop.is_set():
            return                 # a wave proved after on_steps said stop
        done = []
        for p, inner in zip(wave_preps, inner_proofs):
            zl1 = Zl1Proof.new_multi_segment(
                suite_id, p.meta, pub_inputs, p.index, n_seg,
                p.boundary, inner)
            steps[p.index] = StepProof(zl1, pub_inputs, rom_acc,
                                       p.air_pi.vm_usage_mask,
                                       p.air_pi.ram_delta_clk_bits)
            done.append(steps[p.index])
        if on_steps is not None and on_steps(done) is True:
            stop.set()

    # Pipeline: wave k's pure-host assembly runs in a worker thread while
    # wave k+1's device stages execute (the closures hold only host
    # data).  At most two assemblies queue.  Opt out: ZKL_WAVE_OVERLAP=0.
    if os.environ.get("ZKL_WAVE_OVERLAP", "") != "0" and len(waves) > 1:
        pool = ThreadPoolExecutor(max_workers=1)
        futs = []
        try:
            for wi, wave_preps in enumerate(waves):
                if len(futs) >= 2:
                    futs[-2].result()
                if stop.is_set():
                    break
                assemble = _prove_wave(wave_preps, mesh, W, dev,
                                       staged[wi], defer_assembly=True)
                staged[wi] = None
                futs.append(pool.submit(_finish, wave_preps, assemble))
            for f in futs:
                f.result()
        finally:
            pool.shutdown(wait=True)
    else:
        for wi, wave_preps in enumerate(waves):
            assemble = _prove_wave(wave_preps, mesh, W, dev, staged[wi],
                                   defer_assembly=True)
            staged[wi] = None
            _finish(wave_preps, assemble)
            if stop.is_set():
                break
    return [steps[i] for i in sel if steps[i] is not None]
