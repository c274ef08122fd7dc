"""Segment prover on PyTorch tensors: the stark.prove_trace protocol with
every heavy phase on the device (counterpart of the JAX package's
prove/stark_device.py; byte-identical proofs).

  lde                trace polys + LDE (batched iNTT + coset NTT, in
                     column chunks; four-step matrix NTT from 512 points)
  trace_commit       row-chunked Poseidon leaves + tree (CUDA kernel)
  composition        constraint bytecode VM + Poseidon/ROM scan blocks
                     (two launches of csrc/composition.cu on the card),
                     on the stride-2 sub-domain when ce_blowup < blowup
  quotient           boundary groups + zerofier, interpolate, split into
                     Q columns, re-LDE
  constraint_commit
  ood                chunked fused dots against z-power tables
  deep               product-tree inverses + the coefficient dot as one
                     digit-plane matrix product over the whole domain
  fri                the whole chain (commit -> coin reseed/draw -> fold,
                     per layer) on the device, one read-back of the roots
  grind              proof-of-work scan on the device
  openings           row/path/value gathers on the device

This is the configuration the JAX package runs by default on a device.
Its kill switches carry over under the same names, read at call time:
ZKL_NO_MXU_NTT (radix-2 NTT, field/ntt.py), ZKL_NO_MXU_DEEP (row-chunked
limb dot), ZKL_CVM_LEVEL=0/1 (the CPU's stack or leveled executor,
prove/cvm.py; a CUDA tensor always takes the composition kernel) and
ZKL_NO_FUSED_FRI (per-layer FRI loop with the host coin, one blocking
root read-back per layer).  Every combination gives the same proof bytes.

Fiat-Shamir stays on the host (scalar, microseconds): the coin is
reseeded with the trace root, the constraint root,
hash_elements(ood_evals) and each FRI root.  The trace and constraint
roots are read back with a blocking copy before they are absorbed.  The
FRI chain carries the coin's seed on the device (the coin is two
Poseidon sponges) and the host coin replays the reseeds from the roots
afterwards.

Memory: the (w, N, 8) int32 trace LDE is the only full-size resident.
The plain limb ops widen to int64 and form 16-column products, so the
NTT runs in column chunks sized from their transient bytes and leaf
hashing in row chunks.

The stages below also take S segments at once, stacked on a leading
axis (the wave prover, parallel/mesh_prover.py): the Merkle trees of a
wave are built as one forest, every FRI layer folds and commits all S,
the DEEP inverse is one product tree, boundary groups come per segment.
`prove_trace` calls them with one segment.  A wave sizes its chunks from
the memory free on the card (`stage_budget`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as _np
import torch

from ..air.zk_air import ZkLispAir, _p_last_lde
from ..crypto import poseidon as pos
from ..crypto import poseidon_torch as pt
from ..device import resolve
from ..field import f128, limb, mxu, ntt
from ..field import limb_host as _lh
from ..field import ntt_host as _nh
from ..trace.layout import STEPS_PER_LEVEL_P2
from ..utils.tracing import phase
from . import cvm, kernels, multiproof
from .coin import RandomCoin
from .composition_device import (collect_generic, composition_rows,
                                 compose)
from .params import ProofOptions
from .stark import (FriLayerOpenings, ProofContext, QueryOpenings,
                    StarkProof, group_assertions, lde_points_host,
                    transition_zerofier_inv_lde)

P = f128.P
OFFSET = ntt.DEFAULT_COSET_OFFSET
LDE_CHUNK_BYTES = 2 << 30    # transient bytes of one NTT column batch
# what one LDE point costs while its column is in flight: 16-18 int64
# product columns, about a dozen temporaries of that size live at once in
# `limb._reduce_cols`, plus the four int32 digit-plane products
LDE_BYTES_PER_POINT = 1536
# the share of the card's free memory a wave stage's transients may take
# (the same share `parallel.mesh_prover.default_wave_width` sizes waves by)
WAVE_MEMORY_SHARE = 0.4
DEEP_ROW_CHUNK = 1 << 14     # rows per DEEP dot (limb-dot form)
GROUP_CHUNK = 32             # boundary groups per batched term

_STAGE_CACHE: dict = {}


def _to_host_ints(t) -> List[int]:
    return [int(v) for v in limb.to_ints(t)]


# ---------------------------------------------------------------------------
# upload of trace columns (the wave's and the serial loop's prefetch)
# ---------------------------------------------------------------------------

class Staged:
    """Trace limb columns, (S, w, n, 8) int32, on their way to the device."""

    def __init__(self, cols, event=None, host=None) -> None:
        self.cols = cols
        self.event = event
        self.host = host            # the pinned source, alive until used

    def wait(self):
        """The columns, once the current stream has waited for the copy."""
        if self.event is not None:
            cur = torch.cuda.current_stream(self.cols.device)
            cur.wait_event(self.event)
            self.cols.record_stream(cur)
        return self.cols


def stage_limbs(arrays, device) -> Staged:
    """Begin the host->device upload of S (w, n, 8) limb arrays as one
    (S, w, n, 8) tensor: on a card, from pinned host memory with
    `non_blocking=True` on a side stream, with an event that the consumer
    waits on (`Staged.wait`), so the copy overlaps the work queued before
    it; on the CPU, a plain copy."""
    dev = torch.device(device)
    host = torch.empty((len(arrays),) + tuple(arrays[0].shape),
                       dtype=torch.int32, pin_memory=dev.type == "cuda")
    hv = host.numpy()
    for i, a in enumerate(arrays):
        hv[i] = a
    if dev.type != "cuda":
        return Staged(host.to(dev))
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        cols = host.to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    return Staged(cols, event, host)


# ---------------------------------------------------------------------------
# LDE
# ---------------------------------------------------------------------------

def stage_budget(device) -> int:
    """Transient bytes one stage of a wave may take: WAVE_MEMORY_SHARE of
    the card's memory that is free now (what `torch.cuda.mem_get_info`
    reports free plus what PyTorch's allocator holds unused), read at
    call time.  On the CPU an
    eighth of LDE_CHUNK_BYTES: there the plain ops have no launches to
    share, and they run slower per element on temporaries of gigabytes."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return LDE_CHUNK_BYTES // 8
    free, _ = torch.cuda.mem_get_info(dev)
    cached = (torch.cuda.memory_reserved(dev)
              - torch.cuda.memory_allocated(dev))
    return int(WAVE_MEMORY_SHARE * (free + cached))


def col_chunk_for(n_cols: int, bytes_per_col: int, budget: int) -> int:
    """How many of `n_cols` columns keep a chunk's transients of
    `bytes_per_col` each within `budget` (at least one)."""
    return max(1, min(n_cols, budget // max(bytes_per_col, 1)))


def lde_columns(cols, blowup: int, col_chunk: int | None = None):
    """(C, n, 8) trace columns -> (polys (C, n, 8), lde (C, N, 8)),
    `col_chunk` columns at a time (default: as many as keep the int64
    product transients under LDE_CHUNK_BYTES); results are written in
    place into preallocated outputs.  A wave passes its S * w columns
    flattened, with a chunk from `stage_budget`."""
    C, n = cols.shape[0], cols.shape[1]
    if col_chunk is None:
        col_chunk = col_chunk_for(C, n * blowup * LDE_BYTES_PER_POINT,
                                  LDE_CHUNK_BYTES)
    polys = torch.empty_like(cols)
    lde = torch.empty((C, n * blowup, limb.NLIMB), dtype=cols.dtype,
                      device=cols.device)
    for s in range(0, C, col_chunk):
        p_ = ntt.intt(cols[s:s + col_chunk])
        polys[s:s + col_chunk] = p_
        lde[s:s + col_chunk] = ntt.coset_evaluate(p_, blowup)
    return polys, lde


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------

class _DevCommitment:
    """Merkle commitment whose levels stay on the device: one tree, or
    the S trees of a wave laid end to end (`kernels.commit_cols`).

    Levels are kept flat, (S * m, 8): a sibling path of leaf p of tree t
    is the path of leaf t * m + p (`open_paths_multi`).  Only the roots
    cross to the host at commit time (needed for FS reseeding; the copy
    blocks until the trees are built) unless the caller hands them in
    (the FRI chain reads all its roots in one copy); sibling paths are
    gathered on the device and transferred in one small copy."""

    def __init__(self, levels, roots_fe: List[int] | None = None) -> None:
        self.levels = [lv.reshape(-1, limb.NLIMB) for lv in levels]
        self.roots_fe = (_to_host_ints(self.levels[-1])
                         if roots_fe is None else list(roots_fe))

    @property
    def root_fe(self) -> int:
        assert len(self.roots_fe) == 1, "a wave commitment has S roots"
        return self.roots_fe[0]

    @property
    def root(self) -> bytes:
        return f128.fe_to_bytes_fold(self.root_fe)


def open_paths_multi(comms: List[_DevCommitment],
                     positions_per_comm) -> List[List[List[bytes]]]:
    """Sibling paths (bottom-up) for the given leaf indices of several
    commitments: all gathers on the device, ONE transfer.  A wave
    commitment takes the leaf indices of all its trees at once, tree t's
    offset by t * (leaves per tree)."""
    parts = []
    for c, ps in zip(comms, positions_per_comm):
        cur = torch.tensor(list(ps), dtype=torch.int64,
                           device=c.levels[0].device)
        for level in c.levels[:-1]:
            parts.append(level[cur ^ 1])
            cur = cur >> 1
    if not parts:
        return [[] for _ in comms]
    fes = limb.to_ints(torch.cat(parts))
    out: List[List[List[bytes]]] = []
    off = 0
    for c, ps in zip(comms, positions_per_comm):
        depth = len(c.levels) - 1
        nq = len(ps)
        out.append([[f128.fe_to_bytes_fold(int(fes[off + d * nq + j]))
                     for d in range(depth)] for j in range(nq)])
        off += depth * nq
    return out


def gather_rows(cols_arr, idx, seg=None):
    """(C, N, 8) column-major, idx (nq,) -> (nq, C, 8) opened rows; or
    (S, C, N, 8) with `seg` (nq,): row idx[j] of segment seg[j]."""
    if seg is None:
        return cols_arr[:, idx].transpose(0, 1)
    return cols_arr[seg, :, idx]


def fri_vals(layers, idxs):
    """[layer_d[idxs_d]] concatenated: (sum(len(idxs_d)), 8).  A wave's
    layers (S, size, 8) take flat indices, segment t's offset by
    t * size."""
    return torch.cat([layer.reshape(-1, limb.NLIMB)[ix]
                      for layer, ix in zip(layers, idxs)])


# ---------------------------------------------------------------------------
# composition + quotient
# ---------------------------------------------------------------------------

def _record_cvm(air: ZkLispAir, n_periodic: int):
    """Record the generic constraints to cvm bytecode + scan specs
    (host-side, milliseconds; cached per configuration).  The key holds
    the AIR's features: the public elements carry the program-wide
    feature mask only, and a segment's own mask changes the constraints
    at the same width and usage."""
    key = ("cvm", air.trace_width, air.trace_len, n_periodic,
           dataclasses.astuple(air.features), air.rom_enabled,
           tuple(air.pub.to_elements()))
    if key in _STAGE_CACHE:
        return _STAGE_CACHE[key]
    cur, nxt, per = cvm.sym_leaves(air.trace_width, n_periodic)
    generic, specs = collect_generic(air, cur, nxt, per)
    prog = cvm.compile_constraints(generic)
    out = (prog, tuple(specs))
    _STAGE_CACHE[key] = out
    return out


def _host_tables(air: ZkLispAir, groups, blowup: int, device):
    """Config-constant tables, built on the host and uploaded once per
    (configuration, device): one-period periodic selectors, p_last,
    zerofier inverse, and divisor inverses (cyclic groups as one period;
    singles full-length).

    Keyed on layout structure + group STRUCTURE only: the tables depend
    on offsets/steps but never on assertion values or boundary public
    inputs, so all segments of a run share one entry."""
    key = ("tables", air.trace_width, air.trace_len, blowup,
           dataclasses.astuple(air.features), air.rom_enabled,
           tuple((g.column, g.offsets, g.step) for g in groups),
           str(device))
    if key in _STAGE_CACHE:
        return _STAGE_CACHE[key]
    n = air.trace_len
    N = n * blowup
    cycle = STEPS_PER_LEVEL_P2
    dperiod = cycle * blowup

    per_p = _np.asarray(_lh.from_ints(air.periodic_lde_period(blowup)))
    p_last = _p_last_lde(n, blowup, _np).a
    zinv = transition_zerofier_inv_lde(n, blowup, _np).a

    cyc_pos = [i for i, g in enumerate(groups) if not g.is_single]
    sgl_pos = [i for i, g in enumerate(groups) if g.is_single]
    cyc = [groups[i] for i in cyc_pos]
    sgl = [groups[i] for i in sgl_pos]
    g = f128.get_root_of_unity(n)
    wN = f128.get_root_of_unity(N)
    k = n // cycle

    cyc_divp = _np.zeros((0, dperiod, limb.NLIMB), dtype=_np.uint32)
    if cyc:
        xk_vals = []
        cur = pow(OFFSET, k, P)
        wk = pow(wN, k, P)
        for _ in range(dperiod):
            xk_vals.append(cur)
            cur = f128.mul(cur, wk)
        flat = []
        for grp in cyc:
            roots = [pow(g, o * k, P) for o in grp.offsets]
            for xv in xk_vals:
                prod = 1
                for r in roots:
                    prod = prod * ((xv - r) % P) % P
                flat.append(prod)
        inv_flat = f128.batch_inv(flat)
        cyc_divp = _np.asarray(_lh.from_ints(
            [inv_flat[i * dperiod:(i + 1) * dperiod]
             for i in range(len(cyc))]), dtype=_np.uint32)

    sgl_div = _np.zeros((0, N, limb.NLIMB), dtype=_np.uint32)
    if sgl:
        # dedup by step: invert each unique (x - g^s) vector once and
        # expand by index
        xs = lde_points_host(n, blowup)
        steps = sorted({grp.step for grp in sgl})
        flat = []
        for s in steps:
            gs = pow(g, s, P)
            flat.extend((x - gs) % P for x in xs)
        inv_flat = f128.batch_inv(flat)
        uniq = _np.asarray(_lh.from_ints(
            [inv_flat[i * N:(i + 1) * N] for i in range(len(steps))]),
            dtype=_np.uint32)
        step_ix = {s: i for i, s in enumerate(steps)}
        sgl_div = uniq[[step_ix[grp.step] for grp in sgl]]

    up = lambda a: limb.from_numpy(a, device)
    out = (up(per_p), up(p_last), up(zinv), cyc_pos, up(cyc_divp),
           sgl_pos, up(sgl_div), dperiod)
    _STAGE_CACHE[key] = out
    return out


def boundary_groups(groups_l, betas_l, tables_l, device):
    """The boundary groups of S segments as `quotient_comp` takes them:
    (cyc_idx, cyc_vals, cyc_divp, cyc_betas, sgl_idx, sgl_vals, sgl_div,
    sgl_betas), each with a leading segment axis, every segment's groups
    padded to the wave's largest count with zeros (beta = 0).  Per
    segment: its groups, its betas (one per group) and its
    `_host_tables`.  Segments of one wave may differ here (segment 0
    carries the pc_init binding); the tables' layout parts do not."""
    S = len(groups_l)
    dperiod = tables_l[0][7]
    n_c = tables_l[0][1].shape[0]
    out = []
    for pos_i, div_i, tail in ((3, 4, (dperiod,)), (5, 6, (n_c,))):
        G = max(len(t[pos_i]) for t in tables_l)
        idx = _np.zeros((S, G), _np.int64)
        vals = _np.zeros((S, G, limb.NLIMB), _np.uint32)
        betas = _np.zeros((S, G, limb.NLIMB), _np.uint32)
        div = limb.zeros((S, G) + tail, device)
        for si, (groups, bet, t) in enumerate(zip(groups_l, betas_l,
                                                  tables_l)):
            pos = t[pos_i]
            if not pos:
                continue
            k = len(pos)
            idx[si, :k] = [groups[i].column for i in pos]
            vals[si, :k] = _lh.from_ints([groups[i].value for i in pos])
            betas[si, :k] = _lh.from_ints([bet[i] for i in pos])
            div[si, :k] = t[div_i]
        out += [torch.from_numpy(idx).to(device),
                limb.from_numpy(vals, device), div,
                limb.from_numpy(betas, device)]
    return tuple(out)


def quotient_comp(comb, lde, cyc_idx, cyc_vals, cyc_divp, cyc_betas,
                  sgl_idx, sgl_vals, sgl_div, sgl_betas, zinv,
                  group_chunk: int = GROUP_CHUNK):
    """Boundary terms + zerofier apply: comb (S, N_c, 8) -> comp
    (S, N_c, 8) for the S segments of a wave (S = 1 for one segment).

    lde (S, w, N_c, 8); per segment its boundary groups, padded to one
    count over the wave: cyc_idx (S, G) columns, cyc_vals (S, G, 8),
    cyc_divp (S, G, dperiod, 8), cyc_betas (S, G, 8), and the singles
    likewise with full-length divisors (S, G', N_c, 8).  A pad slot has
    beta = 0 (and a zero divisor), so it adds 0.  Groups are evaluated
    `group_chunk` at a time and summed with one reduction per chunk;
    field addition is exact mod p, so the sum equals the group-by-group
    accumulation bit for bit."""
    S, N = comb.shape[0], comb.shape[1]
    seg = torch.arange(S, device=comb.device)[:, None]
    comp = limb.mul(comb, zinv)
    if cyc_idx.shape[1]:
        dperiod = cyc_divp.shape[2]
        # fold beta into the (tiny) periodic divisor table first
        divp_b = limb.mul(cyc_divp, cyc_betas[:, :, None])
        for s in range(0, cyc_idx.shape[1], group_chunk):
            e = s + group_chunk
            numer = limb.sub(lde[seg, cyc_idx[:, s:e]],
                             cyc_vals[:, s:e, None])
            resh = numer.reshape(S, -1, N // dperiod, dperiod, limb.NLIMB)
            term = limb.mul(resh, divp_b[:, s:e, None])
            comp = limb.add(comp, limb.sum_mod(
                term.reshape(S, -1, N, limb.NLIMB), 1))
    if sgl_idx.shape[1]:
        for s in range(0, sgl_idx.shape[1], group_chunk):
            e = s + group_chunk
            numer = limb.sub(lde[seg, sgl_idx[:, s:e]],
                             sgl_vals[:, s:e, None])
            term = limb.mul(limb.mul(numer, sgl_div[:, s:e]),
                            sgl_betas[:, s:e, None])
            comp = limb.add(comp, limb.sum_mod(term, 1))
    return comp


def quotient_finish(comp, n: int, blowup: int, Q: int,
                    col_chunk: int | None = None):
    """comp (..., N_c, 8) -> (q_polys (..., Q, n, 8), q_lde
    (..., Q, N, 8)); the re-LDE runs `col_chunk` of the columns at a
    time (default: all)."""
    lead = comp.shape[:-2]
    coeffs = ntt.coset_interpolate(comp)
    q_polys = coeffs[..., :Q * n, :].reshape(-1, n, limb.NLIMB)
    col_chunk = col_chunk or q_polys.shape[0]
    q_lde = torch.cat([ntt.coset_evaluate(q_polys[s:s + col_chunk], blowup)
                       for s in range(0, q_polys.shape[0], col_chunk)])
    return (q_polys.reshape(lead + (Q, n, limb.NLIMB)),
            q_lde.reshape(lead + (Q, n * blowup, limb.NLIMB)))


# ---------------------------------------------------------------------------
# OOD, DEEP, FRI
# ---------------------------------------------------------------------------

def ood_evals(polys, zpow, col_chunk: int | None = None):
    """polys (..., C, n, 8), zpow (..., n, 8) -> [P_c(z)] as (..., C, 8),
    `col_chunk` columns at a time (default: all)."""
    C = polys.shape[-3]
    col_chunk = col_chunk or C
    zp = zpow[..., None, :, :]
    return torch.cat([limb.sum_mod(limb.mul(polys[..., s:s + col_chunk, :, :],
                                            zp), -2)
                      for s in range(0, C, col_chunk)], dim=-2)


def _lde_xs(n: int, blowup: int, device):
    """The LDE domain points on the device (cached per shape)."""
    key = ("xs", n, blowup, str(device))
    if key not in _STAGE_CACHE:
        _STAGE_CACHE[key] = limb.from_ints(lde_points_host(n, blowup),
                                           device)
    return _STAGE_CACHE[key]


def deep_inv(xs, z, zg):
    """(1/(x-z), 1/(x-zg)) over the domain via ONE product-tree batch
    inverse along the domain: xs (N, 8), z and zg (..., 8) (one point per
    segment of a wave) -> two (..., N, 8)."""
    N = xs.shape[0]
    xs_b = xs.reshape((N,) + (1,) * (z.dim() - 1) + (limb.NLIMB,))
    d = torch.stack([limb.sub(xs_b, z[None]), limb.sub(xs_b, zg[None])],
                    dim=1)                                # (N, 2, ..., 8)
    iv = limb.batch_inv_tree(d)
    return iv[:, 0].movedim(0, -2), iv[:, 1].movedim(0, -2)


def deep_chunk(lde_blk, q_blk, coeffs, gz, gzg, inv_xz_blk, inv_xzg_blk):
    """DEEP composition of one row block: lde_blk (w, chunk, 8), q_blk
    (Q, chunk, 8), coeffs (w+Q, 8)."""
    stacked = torch.cat([lde_blk, q_blk]).transpose(0, 1)  # (chunk,w+Q,8)
    gt = limb.dot(stacked, coeffs[None])
    t1 = limb.mul(limb.sub(gt, gz[None]), inv_xz_blk)
    t2 = limb.mul(limb.sub(gt, gzg[None]), inv_xzg_blk)
    return limb.add(t1, t2)


def deep_planes(coeffs: List[int], device):
    """The DEEP coefficients as the stacked digit planes `deep_mxu`
    takes: a (w+Q, 1) weight matrix, built on the host per segment."""
    return mxu.stack_planes(
        *mxu.wmat_planes(mxu.wmat_from_ints([[c] for c in coeffs])),
        device)


def deep_mxu(trace_lde, q_lde, wts, gz, gzg, inv_xz, inv_xzg):
    """Whole-domain DEEP composition of S segments: trace_lde
    (S, w, N, 8), q_lde (S, Q, N, 8), wts the S segments' coefficient
    planes, gz/gzg (S, 8), inv_xz/inv_xzg (S, N, 8) -> (S, N, 8).  Per
    segment, the coefficient dot gt[x] = sum_i c_i * col_i[x] is one
    (N, (w+Q)*8) x ((w+Q)*8, 16) digit-plane matrix product (field/mxu.py)
    instead of a limb dot that materializes (N, w+Q, 8, 8) products; the
    rest runs once over the wave."""
    gts = []
    for t_s, q_s, wt in zip(trace_lde, q_lde, wts):
        allc = torch.cat([t_s, q_s])                     # (w+Q, N, 8)
        gts.append(mxu.field_matmul(allc.transpose(0, 1), wt)[:, 0])
        del allc
    gt = torch.stack(gts)
    t1 = limb.mul(limb.sub(gt, gz[:, None]), inv_xz)
    t2 = limb.mul(limb.sub(gt, gzg[:, None]), inv_xzg)
    return limb.add(t1, t2)


def fri_fold(layer, alpha, x0, inv_2x0):
    """layer (..., size, 8), alpha (..., 8) -> (..., size/2, 8)."""
    half = layer.shape[-2] // 2
    a_f = alpha[..., None, :]
    num1 = limb.mul(layer[..., :half, :], limb.add(a_f, x0))
    num2 = limb.mul(layer[..., half:, :], limb.sub(a_f, x0))
    return limb.mul(limb.sub(num1, num2), inv_2x0)


def _x0_tables(size: int, device):
    """(x0s, inv(2*x0)) for a FRI layer of `size`, built on the host and
    uploaded once per (size, device)."""
    key = ("x0", size, str(device))
    if key in _STAGE_CACHE:
        return _STAGE_CACHE[key]
    half = size // 2
    wd = f128.get_root_of_unity(size)
    inv2 = f128.inv(2)
    x0s, invs = [], []
    cx = OFFSET
    inv_w = f128.inv(wd)
    inv_cx = f128.mul(inv2, f128.inv(OFFSET))
    for _ in range(half):
        x0s.append(cx)
        invs.append(inv_cx)
        cx = f128.mul(cx, wd)
        inv_cx = f128.mul(inv_cx, inv_w)
    out = (limb.from_ints(x0s, device), limb.from_ints(invs, device))
    _STAGE_CACHE[key] = out
    return out


def _fri_pairs_commit(layer):
    """Tree levels over the (half, 2) pair rows of one FRI layer, or of
    the S layers (S, size, 8) of a wave as S trees."""
    S = layer.reshape(-1, layer.shape[-2], limb.NLIMB).shape[0]
    half = layer.shape[-2] // 2
    rows = torch.stack([layer[..., :half, :], layer[..., half:, :]],
                       dim=-2)
    return kernels.commit_rows(rows.reshape(-1, 2, limb.NLIMB), 2, S)


def _coin_list(coins) -> List[RandomCoin]:
    return [coins] if isinstance(coins, RandomCoin) else list(coins)


def fri_layers_loop(deep, coins, num_layers: int):
    """FRI commit phase, one layer at a time with the host coin: commit,
    read the root back (blocking), reseed, draw alpha, fold.  `deep` is
    one segment's (N, 8) with its coin, or a wave's (S, N, 8) with a list
    of S coins (each layer then commits S trees and reads S roots in one
    copy).  Returns (commitments, layers, final layer); every coin ends
    reseeded with its roots."""
    dev = deep.device
    coins_l = _coin_list(coins)
    comms: List[_DevCommitment] = []
    layers = []
    layer = deep
    for _ in range(num_layers):
        comm = _DevCommitment(_fri_pairs_commit(layer))
        comms.append(comm)
        layers.append(layer)                  # full layers stay on device
        alphas = []
        for coin, r in zip(coins_l, comm.roots_fe):
            coin.reseed(f128.fe_to_bytes_fold(r))
            alphas.append(coin.draw())
        alpha = limb.from_ints(alphas, dev).reshape(deep.shape[:-2]
                                                    + (limb.NLIMB,))
        layer = fri_fold(layer, alpha, *_x0_tables(layer.shape[-2], dev))
    return comms, layers, layer


def fri_layers_chain(deep, coins, num_layers: int):
    """The same phase with the coins on the device, so the host never
    waits inside the loop: reseed = sponge(seed_fe, root_fe) under
    zkl/winter/hash/merge, draw = sponge(seed_fe, 1) under
    zkl/winter/hash/merge_with_int, for every segment's seed at once.  A
    drawn candidate IS the digest's lane-0 field element, always
    canonical, so the host coin's retry loop can never trigger and the
    device draw is exact.  All roots come back in ONE copy at the end;
    the host coins then replay the reseeds (draws do not mutate the
    seed, so the alphas need no replay).  Same arguments, returns and
    final coin states as `fri_layers_loop`.  Its two halves,
    `fri_chain_queue` (the device work) and `fri_chain_finish` (the read
    and the host coins), let a sharded wave queue every shard's chain
    before it reads any."""
    levels_all, layers, roots, layer = fri_chain_queue(deep, coins,
                                                       num_layers)
    return fri_chain_finish(coins, levels_all, roots), layers, layer


def fri_chain_queue(deep, coins, num_layers: int):
    """Queue every layer's commitment, device coin and fold of
    `fri_layers_chain`; reads nothing back.  Returns (levels per layer,
    layers, roots per layer, final layer)."""
    dev = deep.device
    coins_l = _coin_list(coins)
    S = len(coins_l)
    seed = limb.from_ints([f128.fold_bytes32_to_fe(c.seed) for c in coins_l],
                          dev)                                  # (S, 8)
    one = limb.from_ints([1] * S, dev)
    levels_all, layers, roots = [], [], []
    layer = deep
    for _ in range(num_layers):
        levels = _fri_pairs_commit(layer)
        root = levels[-1]                                       # (S, 8)
        seed = pt.sponge_fes(torch.stack([seed, root], dim=1),
                             b"zkl/winter/hash/merge")
        alpha = pt.sponge_fes(torch.stack([seed, one], dim=1),
                              b"zkl/winter/hash/merge_with_int")
        levels_all.append(levels)
        layers.append(layer)
        roots.append(root)
        layer = fri_fold(layer, alpha.reshape(deep.shape[:-2]
                                              + (limb.NLIMB,)),
                         *_x0_tables(layer.shape[-2], dev))
    return levels_all, layers, roots, layer


def fri_chain_finish(coins, levels_all, roots) -> List[_DevCommitment]:
    """Read the roots queued by `fri_chain_queue` in ONE copy, make the
    commitments and replay the host coins' reseeds."""
    coins_l = _coin_list(coins)
    comms = []
    if roots:
        root_ints = limb.to_ints(torch.stack(roots))            # (L, S)
        for levels, r in zip(levels_all, root_ints):
            comm = _DevCommitment(levels, roots_fe=[int(v) for v in r])
            comms.append(comm)
            for coin, v in zip(coins_l, comm.roots_fe):
                coin.reseed(f128.fe_to_bytes_fold(v))
    return comms


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------

def prove_trace(trace, air: ZkLispAir, air_pi, options: ProofOptions,
                limbs16=None, device=None) -> StarkProof:
    """Prove one trace segment on `device` (default: the CUDA card;
    `device="cpu"` only when the caller asks).  `limbs16` optionally
    supplies the segment's (w, n, 8) limb array (numpy or tensor)."""
    dev = resolve(device)
    n = trace.length
    w = trace.width
    blowup = options.blowup
    N = n * blowup
    context = ProofContext(w, n, options)
    Q = air.ce_blowup()

    def fe(v: int):
        return limb.from_ints([v], dev)[0]

    def index(ints):
        return torch.tensor(ints, dtype=torch.int64, device=dev)

    # stage 1: trace polys + LDE
    with phase("lde", dev, rows=n, width=w):
        src = limbs16 if limbs16 is not None else trace.to_limbs16()
        cols = (src.to(dev) if isinstance(src, torch.Tensor)
                else limb.from_numpy(src, dev))
        trace_polys, trace_lde = lde_columns(cols, blowup)

    # stage 2: trace commitment
    with phase("trace_commit", dev):
        ps_main = options.partition_size(w)
        trace_comm = _DevCommitment(kernels.commit_cols(trace_lde, ps_main))

    with phase("fs_coeff_draws"):
        coin = RandomCoin(context.to_elements() + air_pi.to_elements())
        coin.reseed(trace_comm.root)
        groups = group_assertions(air.get_assertions(), n,
                                  options.per_assertion)
        alphas = coin.draw_many(air.num_transition_constraints())
        betas = coin.draw_many(len(groups))

    # Composition evaluates on the blowup_c = Q sub-domain (every
    # stride_c-th point of the full LDE): the quotient has degree < Q*n,
    # so Q*n points determine it exactly.
    blowup_c = Q if (0 < Q < blowup and blowup % Q == 0) else blowup
    stride_c = blowup // blowup_c
    trace_lde_c = (trace_lde if stride_c == 1
                   else trace_lde[:, ::stride_c].contiguous())
    n_c = n * blowup_c
    with phase("host_tables", dev):
        tables = _host_tables(air, groups, blowup_c, dev)
    per_p, p_last, zinv = tables[:3]
    alphas_dev = limb.from_ints(alphas, dev)

    # stage 3: composition = bytecode VM + scan blocks
    with phase("record_cvm"):
        prog_cvm, specs = _record_cvm(air, per_p.shape[0] + 1)
    with phase("composition", dev,
               kernel_rows=composition_rows(trace_lde_c)):
        comb = compose(air, prog_cvm, specs, trace_lde_c, blowup_c, per_p,
                       p_last, alphas_dev)

    # boundary + quotient
    with phase("quotient", dev):
        comp = quotient_comp(
            comb[None], trace_lde_c[None],
            *boundary_groups([groups], [betas], [tables], dev), zinv)[0]
        assert comp.shape[0] == n_c
        q_polys, q_lde = quotient_finish(comp, n, blowup, Q)
        del comp, comb, trace_lde_c

    with phase("constraint_commit", dev):
        ps_con = options.partition_size(Q)
        constraint_comm = _DevCommitment(kernels.commit_cols(q_lde, ps_con))
        coin.reseed(constraint_comm.root)

    # stage 4: OOD
    with phase("ood", dev):
        z = coin.draw()
        g_trace = f128.get_root_of_unity(n)
        zg = f128.mul(z, g_trace)
        zp = limb.from_numpy(_lh.powers_np(z, n), dev)
        zgp = limb.from_numpy(_lh.powers_np(zg, n), dev)
        ood_t_cur = _to_host_ints(ood_evals(trace_polys, zp))
        ood_t_next = _to_host_ints(ood_evals(trace_polys, zgp))
        ood_q_cur = _to_host_ints(ood_evals(q_polys, zp))
        ood_q_next = _to_host_ints(ood_evals(q_polys, zgp))
        ood_all = ood_t_cur + ood_q_cur + ood_t_next + ood_q_next
        coin.reseed(pos.hash_elements(ood_all))

    # stage 5: DEEP
    with phase("deep", dev):
        gammas = coin.draw_many(w)
        deltas = coin.draw_many(Q)
        gz = sum(g_ * t for g_, t in zip(gammas, ood_t_cur)) % P
        gz = (gz + sum(d * q for d, q in zip(deltas, ood_q_cur))) % P
        gzg = sum(g_ * t for g_, t in zip(gammas, ood_t_next)) % P
        gzg = (gzg + sum(d * q for d, q in zip(deltas, ood_q_next))) % P

        inv_xz, inv_xzg = deep_inv(_lde_xs(n, blowup, dev), fe(z), fe(zg))
        gz_dev, gzg_dev = fe(gz), fe(gzg)
        if not os.environ.get("ZKL_NO_MXU_DEEP"):
            deep = deep_mxu(trace_lde[None], q_lde[None],
                            [deep_planes(gammas + deltas, dev)],
                            gz_dev[None], gzg_dev[None], inv_xz[None],
                            inv_xzg[None])[0]
        else:
            coeffs = limb.from_ints(gammas + deltas, dev)
            chunk = min(DEEP_ROW_CHUNK, N)
            deep = torch.cat([
                deep_chunk(trace_lde[:, s:s + chunk],
                           q_lde[:, s:s + chunk], coeffs, gz_dev, gzg_dev,
                           inv_xz[s:s + chunk], inv_xzg[s:s + chunk])
                for s in range(0, N, chunk)])
        del inv_xz, inv_xzg

    # stage 6: FRI
    with phase("fri", dev):
        num_layers = options.num_fri_layers(N)
        fri_phase = (fri_layers_loop if os.environ.get("ZKL_NO_FUSED_FRI")
                     else fri_layers_chain)
        fri_comms, fri_layers_vals, layer = fri_phase(deep, coin,
                                                      num_layers)

        rem_host = limb.to_numpy_u32(layer)
        rem_ints = [int(v) for v in _lh.to_ints(
            _nh.coset_interpolate(rem_host, 1, _np))]
        max_deg = options.fri_remainder_max_degree
        assert all(v == 0 for v in rem_ints[max_deg + 1:]), \
            "FRI remainder degree too high"
        fri_remainder = list(reversed(rem_ints[:max_deg + 1]))

    # grinding + positions (host-driven, device scan)
    with phase("grind", dev, bits=options.grinding_factor):
        pow_nonce = coin.grind(options.grinding_factor, device=dev)
    positions = sorted(set(coin.draw_integers(
        options.num_queries, N, pow_nonce)))

    # openings: gather opened rows on the device (no full row-major copy)
    with phase("openings", dev, nq=len(positions)):
        idx_dev = index(positions)
        t_rows = limb.to_numpy_u32(gather_rows(trace_lde, idx_dev))
        q_rows = limb.to_numpy_u32(gather_rows(q_lde, idx_dev))
        tc_paths = open_paths_multi(
            [trace_comm, constraint_comm],
            [list(positions), list(positions)])
        trace_open = QueryOpenings(
            [[int(v) for v in _lh.to_ints(t_rows[j])]
             for j in range(len(positions))], tc_paths[0],
            multiproof.compress(positions, tc_paths[0]))
        constraint_open = QueryOpenings(
            [[int(v) for v in _lh.to_ints(q_rows[j])]
             for j in range(len(positions))], tc_paths[1],
            multiproof.compress(positions, tc_paths[1]))

        # fold the query positions through all layers on the host first,
        # so every layer's value gather goes in ONE transfer
        foldeds = []
        pos_d = positions
        size_d = N
        for d in range(num_layers):
            half = size_d // 2
            folded = []
            for p_ in pos_d:
                m = p_ % half
                if m not in folded:
                    folded.append(m)
            foldeds.append((folded, half))
            pos_d = folded
            size_d = half
        fri_open: List[FriLayerOpenings] = []
        if num_layers:
            idxs = [index(folded + [half + m for m in folded])
                    for folded, half in foldeds]
            vals_flat = limb.to_ints(fri_vals(fri_layers_vals, idxs))
            all_paths = open_paths_multi(fri_comms,
                                         [f for f, _ in foldeds])
            base = 0
            for d, (folded, half) in enumerate(foldeds):
                nf = len(folded)
                pairs = [(int(vals_flat[base + i]),
                          int(vals_flat[base + nf + i]))
                         for i in range(nf)]
                base += 2 * nf
                fri_open.append(FriLayerOpenings(
                    pairs, all_paths[d],
                    multiproof.compress(folded, all_paths[d])))

    return StarkProof(
        context=context,
        trace_root=trace_comm.root,
        constraint_root=constraint_comm.root,
        ood_trace_current=ood_t_cur,
        ood_trace_next=ood_t_next,
        ood_quotient_current=ood_q_cur,
        ood_quotient_next=ood_q_next,
        fri_roots=[c.root for c in fri_comms],
        fri_remainder=fri_remainder,
        pow_nonce=pow_nonce,
        trace_openings=trace_open,
        constraint_openings=constraint_open,
        fri_openings=fri_open,
    )
