"""STARK-in-STARK aggregation.

Ports the reference aggregation layer (src/agg/{pi,layout,air,trace}.rs):
a 31-column aggregation trace with one row per child step proof, whose AIR
enforces that per-child re-verification aggregates (Merkle-root errors,
DEEP-vs-FRI-layer-0, FRI folding/remainder over all query paths) and
cross-segment boundary chains are identically zero, plus v_units / child
count accumulator chains.

The per-child verification math reuses this framework's own verifier
primitives (prove/stark.py) — openings are stored directly in the step
proofs, so no multiproof decompression pass is needed.

The step proofs come from the port's `prove_program` (the CUDA card by
default); the batched child re-verification (agg/child_batch.py) runs on
the same device, and the aggregation trace is proved by the host prover.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..air.zk_air import _p_last_lde, p_last_at_point
from ..crypto import poseidon as pos
from ..crypto.blake3 import blake3
from ..field import f128
from ..field.felt import Felt
from ..prove import stark
from ..prove.coin import RandomCoin
from ..prove.formats import StepProof
from ..prove.params import ProofOptions, ProverOptions
from ..prove.prover import air_pi_from_step, _effective_mask_for_step
from ..trace.table import TraceTable
from ..air.zk_air import ConstraintDegree, ZkLispAir
from ..device import resolve
from ..utils.tracing import phase, summary

P = f128.P

MIN_AGG_TRACE_ROWS = 8


class AggError(Exception):
    pass


# ---------------------------------------------------------------------------
# public inputs (agg/pi.rs)
# ---------------------------------------------------------------------------

@dataclass
class AggProfileMeta:
    m: int = 0
    rho: int = 0
    q: int = 0
    o: int = 0
    lambda_: int = 0
    pi_len: int = 0
    v_units: int = 0


@dataclass
class AggFriProfile:
    lde_blowup: int = 0
    folding_factor: int = 2
    redundancy: int = 1
    num_layers: int = 0


@dataclass
class AggQueryProfile:
    num_queries: int = 0
    grinding_factor: int = 0


@dataclass
class AggAirPublicInputs:
    program_id: bytes = b"\x00" * 32
    program_commitment: bytes = b"\x00" * 32
    pi_digest: bytes = b"\x00" * 32
    children_root: bytes = b"\x00" * 32
    v_units_total: int = 0
    children_count: int = 0
    batch_id: bytes = b"\x00" * 32
    profile_meta: AggProfileMeta = field(default_factory=AggProfileMeta)
    profile_fri: AggFriProfile = field(default_factory=AggFriProfile)
    profile_queries: AggQueryProfile = field(
        default_factory=AggQueryProfile)
    suite_id: bytes = b"\x00" * 32
    children_ms: List[int] = field(default_factory=list)
    vm_state_initial: bytes = b"\x00" * 32
    vm_state_final: bytes = b"\x00" * 32
    ram_gp_unsorted_initial: bytes = b"\x00" * 32
    ram_gp_unsorted_final: bytes = b"\x00" * 32
    ram_gp_sorted_initial: bytes = b"\x00" * 32
    ram_gp_sorted_final: bytes = b"\x00" * 32
    rom_s_initial: Tuple[bytes, bytes, bytes] = (b"\x00" * 32,) * 3
    rom_s_final: Tuple[bytes, bytes, bytes] = (b"\x00" * 32,) * 3
    # Host-level chain linkage (RecursionPublic.prev_digest,
    # recursion.rs:71-88): set by multi-link chain builders, enforced by
    # verify_chain.  NOT part of to_elements (the FS seed) or the ZKLRC1
    # codec — the reference keeps it out of both as well.
    prev_digest: bytes = b"\x00" * 32

    def to_elements(self) -> List[int]:
        fold = f128.fold_bytes32_to_fe
        out = [fold(self.program_id), fold(self.program_commitment),
               fold(self.pi_digest), fold(self.children_root),
               fold(self.batch_id),
               self.profile_meta.m, self.profile_meta.rho,
               self.profile_meta.q, self.profile_meta.o,
               self.profile_meta.lambda_, self.profile_meta.pi_len,
               self.profile_meta.v_units,
               self.profile_fri.lde_blowup,
               self.profile_fri.folding_factor,
               self.profile_fri.redundancy, self.profile_fri.num_layers,
               self.profile_queries.num_queries,
               self.profile_queries.grinding_factor,
               self.children_count, self.v_units_total,
               fold(self.vm_state_initial), fold(self.vm_state_final),
               fold(self.ram_gp_unsorted_initial),
               fold(self.ram_gp_unsorted_final),
               fold(self.ram_gp_sorted_initial),
               fold(self.ram_gp_sorted_final)]
        out += [fold(b) for b in self.rom_s_initial]
        out += [fold(b) for b in self.rom_s_final]
        return out


# ---------------------------------------------------------------------------
# children root (agg/child.rs children_root_from_compact)
# ---------------------------------------------------------------------------

def children_root(suite_id: bytes, steps: Sequence[StepProof]) -> bytes:
    if not steps:
        return b"\x00" * 32
    items = []
    for step in steps:
        d_fe = f128.fold_bytes32_to_fe(step.digest())
        t_fe = f128.fold_bytes32_to_fe(step.proof.inner.trace_root)
        leaf_fe = pos.poseidon_hash_two_lanes(suite_id, d_fe, t_fe)
        items.append(f128.fe_to_bytes_fold(leaf_fe))
    items.sort()
    layer = [f128.fold_bytes32_to_fe(b) for b in items]
    while len(layer) > 1:
        nxt = []
        for i in range(0, len(layer), 2):
            a = layer[i]
            b = layer[i + 1] if i + 1 < len(layer) else layer[i]
            nxt.append(pos.poseidon_hash_two_lanes(suite_id, a, b))
        layer = nxt
    return f128.fe_to_bytes_fold(layer[0])


# ---------------------------------------------------------------------------
# aggregation layout + AIR (agg/layout.rs, agg/air.rs)
# ---------------------------------------------------------------------------

class AggColumns:
    NAMES = ("ok", "v0_sum", "v1_sum", "vnext_sum", "fri_v0_child",
             "fri_v1_child", "fri_vnext_child", "fri_alpha_child",
             "fri_x0_child", "fri_x1_child", "fri_q1_child", "comp_sum",
             "alpha_div_zm_sum", "map_l0_sum", "final_llast_sum", "r",
             "alpha", "beta", "gamma", "seg_first", "trace_root_err",
             "constraint_root_err", "v_units_acc", "v_units_child",
             "child_count_acc", "vm_chain_err", "ram_u_chain_err",
             "ram_s_chain_err", "rom_chain_err_0", "rom_chain_err_1",
             "rom_chain_err_2")

    def __init__(self) -> None:
        for i, name in enumerate(self.NAMES):
            setattr(self, name, i)

    def width(self) -> int:
        return len(self.NAMES)


class ZlAggAir:
    """Aggregation AIR (agg/air.rs): 24 constraints, 5 assertions."""

    def __init__(self, trace_width: int, trace_len: int,
                 pub_inputs: AggAirPublicInputs) -> None:
        self.cols = AggColumns()
        assert trace_width == self.cols.width()
        self.trace_width = trace_width
        self.trace_len = trace_len
        self.pub = pub_inputs
        self.degrees = ([ConstraintDegree(1)]
                        + [ConstraintDegree(2, (trace_len,))]
                        + [ConstraintDegree(1)] * 9
                        + [ConstraintDegree(1, (trace_len,))]
                        + [ConstraintDegree(1)] * 12)

    def num_transition_constraints(self) -> int:
        return 24

    def max_evaluation_degree(self) -> int:
        return max(d.evaluation_degree(self.trace_len)
                   for d in self.degrees)

    def ce_blowup(self) -> int:
        n = self.trace_len
        dq = self.max_evaluation_degree() - (n - 1)
        q = max(1, -(-(dq + 1) // n))
        p2 = 1
        while p2 < q:
            p2 *= 2
        return p2

    def evaluate_transition(self, cur, next_, periodic):
        c = self.cols
        is_last = periodic[0]
        not_last = 1 - is_last
        out = []
        out.append(cur[c.ok] + 0 * is_last)
        out.append(not_last * (next_[c.v_units_acc]
                               - (cur[c.v_units_acc]
                                  + cur[c.v_units_child]
                                  * cur[c.seg_first])))
        out.append(cur[c.trace_root_err] + 0 * is_last)
        out.append(cur[c.constraint_root_err] + 0 * is_last)
        out.append(not_last * (next_[c.r] - cur[c.r]))
        out.append(not_last * (next_[c.alpha] - cur[c.alpha]))
        out.append(not_last * (next_[c.beta] - cur[c.beta]))
        out.append(not_last * (next_[c.gamma] - cur[c.gamma]))
        out.append(not_last * (next_[c.v0_sum] - cur[c.v0_sum]))
        out.append(not_last * (next_[c.v1_sum] - cur[c.v1_sum]))
        out.append(not_last * (next_[c.vnext_sum] - cur[c.vnext_sum]))
        out.append(not_last * (next_[c.child_count_acc]
                               - (cur[c.child_count_acc]
                                  + cur[c.seg_first])))
        x_diff = cur[c.fri_x1_child] - cur[c.fri_x0_child]
        lhs = cur[c.fri_vnext_child] * x_diff
        rhs = (cur[c.fri_v1_child]
               * (cur[c.fri_alpha_child] - cur[c.fri_x0_child])
               - cur[c.fri_v0_child]
               * (cur[c.fri_alpha_child] - cur[c.fri_x1_child]))
        out.append(lhs - rhs)
        out.append(cur[c.fri_vnext_child] - cur[c.fri_q1_child])
        out.append(cur[c.comp_sum] + 0 * is_last)
        out.append(cur[c.alpha_div_zm_sum] + 0 * is_last)
        out.append(cur[c.map_l0_sum] + 0 * is_last)
        out.append(cur[c.final_llast_sum] + 0 * is_last)
        out.append(cur[c.vm_chain_err] + 0 * is_last)
        out.append(cur[c.ram_u_chain_err] + 0 * is_last)
        out.append(cur[c.ram_s_chain_err] + 0 * is_last)
        out.append(cur[c.rom_chain_err_0] + 0 * is_last)
        out.append(cur[c.rom_chain_err_1] + 0 * is_last)
        out.append(cur[c.rom_chain_err_2] + 0 * is_last)
        return out

    def get_assertions(self):
        c = self.cols
        last = self.trace_len - 1
        return [(c.ok, 0, 0),
                (c.v_units_acc, 0, 0),
                (c.v_units_acc, last, self.pub.v_units_total % P),
                (c.child_count_acc, 0, 0),
                (c.child_count_acc, last, self.pub.children_count % P)]

    def periodic_lde(self, blowup: int, xp):
        return [_p_last_lde(self.trace_len, blowup, xp)]

    def periodic_values_at_point(self, z: int):
        return [Felt(p_last_at_point(self.trace_len, z))]

    def periodic_values_at_row(self, row: int):
        return [Felt(1 if row == self.trace_len - 1 else 0)]


# ---------------------------------------------------------------------------
# FS weights (agg/trace.rs derive_agg_fs_weights)
# ---------------------------------------------------------------------------

def derive_agg_fs_weights(agg_pi: AggAirPublicInputs):
    seed = agg_pi.to_elements() + [0xA9]
    coin = RandomCoin(seed)
    return (coin.draw(), coin.draw(), coin.draw(), coin.draw())
    # (beta_deep, beta_fri_layer1, delta_depth, beta_paths)


# ---------------------------------------------------------------------------
# per-child verification aggregates (agg/trace.rs math)
# ---------------------------------------------------------------------------

def _child_challenges(step: StepProof) -> dict:
    air_pi = air_pi_from_step(step)
    air_pi.segment_feature_mask = _effective_mask_for_step(step)
    inner = step.proof.inner
    air = ZkLispAir(inner.context.trace_width, inner.context.trace_len,
                    air_pi)
    return stark.replay_challenges(inner, air, air_pi)


def _fold_positions(positions: List[int], domain: int) -> List[int]:
    half = domain // 2
    out = []
    for p_ in positions:
        m = p_ % half
        if m not in out:
            out.append(m)
    return out


def _layer_pairs(step: StepProof, depth: int) -> List[Tuple[int, int]]:
    return step.proof.inner.fri_openings[depth].pairs


def _sample_fri_fold(step: StepProof, ch: dict):
    """sample_fri_fold_child: one binary fold witness (v0,v1,vnext,alpha,
    x0,x1,q1)."""
    inner = step.proof.inner
    if len(inner.fri_openings) < 2:
        return (0,) * 7
    N = inner.context.trace_len * inner.context.options.blowup
    wN = f128.get_root_of_unity(N)
    folding_root = pow(wN, N // 2, P)
    folded0 = _fold_positions(ch["positions"], N)
    pairs0 = _layer_pairs(step, 0)
    m = folded0[0]
    v0, v1 = pairs0[0]
    alpha = ch["fri_alphas"][0]
    xe = f128.mul(pow(wN, m, P), 3)
    x0, x1 = xe, f128.mul(xe, folding_root)
    num = (v1 * ((alpha - x0) % P) - v0 * ((alpha - x1) % P)) % P
    vnext = num * f128.inv((x1 - x0) % P) % P
    domain1 = N // 2
    half1 = domain1 // 2
    folded1 = _fold_positions(folded0, domain1)
    mm = m % half1
    elem = m // half1
    q1 = _layer_pairs(step, 1)[folded1.index(mm)][elem]
    return v0, v1, vnext, alpha, x0, x1, q1


# ---------------------------------------------------------------------------
# aggregation public inputs + trace builder
# ---------------------------------------------------------------------------

def build_agg_public(steps: Sequence[StepProof],
                     batch_id: bytes = b"\x00" * 32) -> AggAirPublicInputs:
    if not steps:
        raise AggError("aggregation requires at least one step proof")
    first, last = steps[0], steps[-1]
    meta0 = first.proof.meta
    suite_id = first.proof.header.suite_id
    return AggAirPublicInputs(
        program_id=first.pi_core.program_id,
        program_commitment=first.pi_core.program_commitment,
        pi_digest=first.pi_core.digest(),
        children_root=children_root(suite_id, steps),
        v_units_total=sum(s.proof.meta.v_units for s in steps),
        children_count=len(steps),
        batch_id=batch_id,
        profile_meta=AggProfileMeta(
            m=meta0.m, rho=meta0.rho, q=meta0.q, o=meta0.o,
            lambda_=meta0.lambda_, pi_len=meta0.pi_len,
            v_units=meta0.v_units),
        profile_fri=AggFriProfile(
            lde_blowup=meta0.rho, folding_factor=2, redundancy=1,
            num_layers=len(first.proof.inner.fri_openings)),
        profile_queries=AggQueryProfile(
            num_queries=meta0.q, grinding_factor=0),
        suite_id=suite_id,
        children_ms=[s.proof.meta.m for s in steps],
        vm_state_initial=first.proof.pi.state_in_hash,
        vm_state_final=last.proof.pi.state_out_hash,
        ram_gp_unsorted_initial=first.proof.pi.ram_gp_unsorted_in,
        ram_gp_unsorted_final=last.proof.pi.ram_gp_unsorted_out,
        ram_gp_sorted_initial=first.proof.pi.ram_gp_sorted_in,
        ram_gp_sorted_final=last.proof.pi.ram_gp_sorted_out,
        rom_s_initial=(first.proof.pi.rom_s_in_0,
                       first.proof.pi.rom_s_in_1,
                       first.proof.pi.rom_s_in_2),
        rom_s_final=(last.proof.pi.rom_s_out_0,
                     last.proof.pi.rom_s_out_1,
                     last.proof.pi.rom_s_out_2),
    )


def build_agg_trace(agg_pi: AggAirPublicInputs,
                    steps: Sequence[StepProof],
                    chs: Optional[Sequence[dict]] = None,
                    device=None) -> TraceTable:
    if not steps:
        raise AggError("AggTrace requires at least one child proof")
    cols = AggColumns()
    n_children = len(steps)
    if agg_pi.children_count != n_children:
        raise AggError("children_count mismatch")
    if len(agg_pi.children_ms) != n_children:
        raise AggError("children_ms length mismatch")
    for s in steps:
        if s.proof.header.suite_id != agg_pi.suite_id:
            raise AggError("suite_id mismatch across children")
        if s.proof.pi.segments_total == 0 or \
                s.proof.pi.segment_index >= s.proof.pi.segments_total:
            raise AggError("invalid segment indexing")
    totals = {s.proof.pi.segments_total for s in steps}
    if len(totals) != 1:
        raise AggError("segments_total must be uniform")
    t = totals.pop()
    if t > 1:
        idxs = sorted(s.proof.pi.segment_index for s in steps)
        if t != n_children or idxs != list(range(n_children)):
            raise AggError("segment chain must be complete and contiguous")
    pm, pq = agg_pi.profile_meta, agg_pi.profile_queries
    for s in steps:
        m = s.proof.meta
        if (m.rho != pm.rho or m.o != pm.o or m.lambda_ != pm.lambda_
                or m.pi_len != pm.pi_len):
            raise AggError("profile_meta mismatch with child meta")
        if m.q != pq.num_queries:
            raise AggError("profile_queries mismatch with child meta")
    if children_root(agg_pi.suite_id, steps) != agg_pi.children_root:
        raise AggError("children_root mismatch")
    v_sum = 0
    for i, s in enumerate(steps):
        if agg_pi.children_ms[i] == 0 or \
                agg_pi.children_ms[i] != s.proof.meta.m:
            raise AggError("children_ms mismatch")
        v_sum += s.proof.meta.v_units
    if v_sum != agg_pi.v_units_total:
        raise AggError("v_units_total mismatch")

    # At least ONE pad row after the last child: the accumulator chains
    # (C1/C11) propagate acc into the NEXT row, so the boundary
    # assertions v_units_acc[last]/child_count_acc[last] only see the
    # final child's contribution on a pad row.  The reference computes
    # max(n_children, 8).next_power_of_two() (agg/trace.rs:398) and is
    # therefore unsatisfiable at child counts that are exact powers of
    # two >= 8 (e.g. the 16 segments of its own rollup-bench config);
    # deliberate fix here (PARITY.md).
    base_rows = max(n_children + 1, MIN_AGG_TRACE_ROWS)
    n_rows = 1 << (base_rows - 1).bit_length()
    trace = TraceTable(cols.width(), n_rows)

    beta_deep, beta_l1, delta_depth, beta_paths = \
        derive_agg_fs_weights(agg_pi)

    fold = f128.fold_bytes32_to_fe
    vm_i, vm_f = fold(agg_pi.vm_state_initial), fold(agg_pi.vm_state_final)
    ru_i, ru_f = (fold(agg_pi.ram_gp_unsorted_initial),
                  fold(agg_pi.ram_gp_unsorted_final))
    rs_i, rs_f = (fold(agg_pi.ram_gp_sorted_initial),
                  fold(agg_pi.ram_gp_sorted_final))
    rom_i = [fold(b) for b in agg_pi.rom_s_initial]
    rom_f = [fold(b) for b in agg_pi.rom_s_final]

    # Per-child re-verification: the FS replay per child (threaded host
    # Python; chs, when given, was prefetched by the prove_chain pipeline
    # DURING step proving), then all same-shaped children's Merkle/DEEP/FRI
    # re-verification math in a handful of vectorized limb calls on the
    # aggregation's device (agg/child_batch.py)
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    from .child_batch import child_work_batch, group_children
    batch_dev = resolve(device)
    workers = min(8, (_os.cpu_count() or 1), n_children)
    try:
        if chs is None:
            with phase("agg_child_challenges"):
                if workers > 1:
                    with ThreadPoolExecutor(max_workers=workers) as pool:
                        chs = list(pool.map(_child_challenges, steps))
                else:
                    chs = [_child_challenges(s) for s in steps]
        child_vals = [None] * n_children
        with phase("agg_child_batch"):
            for idxs in group_children(steps, chs):
                vals = child_work_batch(
                    [steps[i] for i in idxs], [chs[i] for i in idxs],
                    beta_deep, beta_l1, delta_depth, beta_paths,
                    device=batch_dev)
                for i, v in zip(idxs, vals):
                    child_vals[i] = v
    except (ValueError, IndexError, KeyError) as e:
        # a tampered/malformed child whose openings are structurally
        # inconsistent with its REPLAYED challenges (e.g. a forged
        # commitment root shifts every FS draw, so the recorded folded
        # positions no longer exist) must be a clean rejection, not an
        # aggregator crash
        raise AggError(
            "child transcript inconsistent with replayed "
            f"Fiat-Shamir challenges: {type(e).__name__}: {e}")

    prev = None
    v_acc = 0
    count_acc = 0
    for i, s in enumerate(steps):
        zp = s.proof.pi
        vm_in, vm_out = fold(zp.state_in_hash), fold(zp.state_out_hash)
        ru_in, ru_out = (fold(zp.ram_gp_unsorted_in),
                         fold(zp.ram_gp_unsorted_out))
        rs_in, rs_out = (fold(zp.ram_gp_sorted_in),
                         fold(zp.ram_gp_sorted_out))
        rom_in = [fold(zp.rom_s_in_0), fold(zp.rom_s_in_1),
                  fold(zp.rom_s_in_2)]
        rom_out = [fold(zp.rom_s_out_0), fold(zp.rom_s_out_1),
                   fold(zp.rom_s_out_2)]

        first_c, last_c = i == 0, i + 1 == n_children
        if first_c or prev is None:
            vm_err = (vm_in - vm_i) % P
            ru_err = (ru_in - ru_i) % P
            rs_err = (rs_in - rs_i) % P
            rom_err0 = (rom_in[0] - rom_i[0]) % P
        else:
            vm_err = (vm_in - prev["vm"]) % P
            ru_err = (ru_in - prev["ru"]) % P
            rs_err = (rs_in - prev["rs"]) % P
            rom_err0 = (rom_in[0] - prev["rom"][0]) % P
        if last_c:
            vm_err = (vm_err + vm_out - vm_f) % P
            ru_err = (ru_err + ru_out - ru_f) % P
            rs_err = (rs_err + rs_out - rs_f) % P
            rom_err0 = (rom_err0 + rom_out[0] - rom_f[0]) % P

        cv = child_vals[i]
        t_err, c_err = cv["t_err"], cv["c_err"]
        deep_agg, l1_agg = cv["deep"], cv["l1"]
        path_agg, paths_agg = cv["path"], cv["paths"]
        v0, v1, vnext, alpha_s, x0, x1, q1 = cv["sample"]

        r_ = i
        trace.set(cols.seg_first, r_, 1)
        trace.set(cols.v_units_child, r_, s.proof.meta.v_units % P)
        trace.set(cols.v_units_acc, r_, v_acc)
        trace.set(cols.child_count_acc, r_, count_acc)
        trace.set(cols.trace_root_err, r_, t_err)
        trace.set(cols.constraint_root_err, r_, c_err)
        trace.set(cols.vm_chain_err, r_, vm_err)
        trace.set(cols.ram_u_chain_err, r_, ru_err)
        trace.set(cols.ram_s_chain_err, r_, rs_err)
        trace.set(cols.rom_chain_err_0, r_, rom_err0)
        trace.set(cols.fri_v0_child, r_, v0)
        trace.set(cols.fri_v1_child, r_, v1)
        trace.set(cols.fri_vnext_child, r_, vnext)
        trace.set(cols.fri_alpha_child, r_, alpha_s)
        trace.set(cols.fri_x0_child, r_, x0)
        trace.set(cols.fri_x1_child, r_, x1)
        trace.set(cols.fri_q1_child, r_, q1)
        trace.set(cols.comp_sum, r_, deep_agg)
        trace.set(cols.alpha_div_zm_sum, r_, l1_agg)
        trace.set(cols.map_l0_sum, r_, path_agg)
        trace.set(cols.final_llast_sum, r_, paths_agg)

        v_acc = (v_acc + s.proof.meta.v_units) % P
        count_acc = (count_acc + 1) % P
        prev = {"vm": vm_out, "ru": ru_out, "rs": rs_out, "rom": rom_out}

    for r_ in range(n_children, n_rows):
        trace.set(cols.v_units_acc, r_, v_acc)
        trace.set(cols.child_count_acc, r_, count_acc)
    return trace


# ---------------------------------------------------------------------------
# aggregation prove/verify + recursion glue (src/lib.rs, prove.rs)
# ---------------------------------------------------------------------------

def prove_agg(agg_pi: AggAirPublicInputs, steps: Sequence[StepProof],
              opts: ProverOptions,
              chs: Optional[Sequence[dict]] = None, device=None):
    """prove_agg_proof (prove.rs:629-719), with the host prover; the
    batched child re-verification and the proof-of-work scan run on
    `device` (default: the CUDA card; `"cpu"` only when asked)."""
    from ..prove.params import (estimate_conjectured_security_bits,
                                select_partitions_for_trace)
    trace = build_agg_trace(agg_pi, steps, chs=chs, device=device)
    agg_queries = max(opts.queries, 16)
    field_ext = 2 if opts.min_security_bits >= 128 else 1
    base = ProofOptions(
        num_queries=agg_queries, blowup=opts.blowup,
        grinding_factor=opts.grind, field_extension=field_ext,
        assertion_batching=opts.to_proof_options().assertion_batching)
    if opts.min_security_bits >= 64:
        if estimate_conjectured_security_bits(base) < opts.min_security_bits:
            raise AggError(
                "aggregation prover options below requested security")
    nparts, rate = select_partitions_for_trace(trace.width, trace.length)
    wf_opts = base.with_partitions(nparts, rate)
    air = ZlAggAir(trace.width, trace.length, agg_pi)
    if field_ext == 2:
        # ≥128-bit requests prove over the quadratic extension, matching
        # the reference's FieldExtension::Quadratic gate
        # (prove.rs:732-800, src/lib.rs:352-378).
        from ..prove.stark_ext import prove_trace_ext
        with phase("agg_prove"):
            return prove_trace_ext(trace, air, agg_pi, wf_opts,
                                   device=device)
    with phase("agg_prove"):
        return stark.prove_trace(trace, air, agg_pi, wf_opts,
                                 device=device)


def verify_agg(proof, agg_pi: AggAirPublicInputs,
               min_bits: int = 0) -> None:
    air = ZlAggAir(proof.context.trace_width, proof.context.trace_len,
                   agg_pi)
    if proof.context.options.field_extension == 2:
        from ..prove.stark_ext import verify_trace_ext
        verify_trace_ext(proof, agg_pi, min_bits, air=air)
        return
    stark.verify_trace(proof, agg_pi, min_bits, air=air)


def recursion_digest(agg_pi: AggAirPublicInputs) -> bytes:
    """prove.rs recursion_digest_from_agg_pi."""
    h = bytearray(b"zkl/recursion/agg")
    h += agg_pi.suite_id
    h += agg_pi.batch_id
    h += agg_pi.children_root
    h += struct.pack("<I", agg_pi.children_count)
    h += struct.pack("<Q", agg_pi.v_units_total)
    pm = agg_pi.profile_meta
    h += struct.pack("<IHHHHIQ", pm.m, pm.rho, pm.q, pm.o, pm.lambda_,
                     pm.pi_len, pm.v_units)
    pf = agg_pi.profile_fri
    h += struct.pack("<IBBB", pf.lde_blowup, pf.folding_factor,
                     pf.redundancy, pf.num_layers)
    pq = agg_pi.profile_queries
    h += struct.pack("<HI", pq.num_queries, pq.grinding_factor)
    return blake3(bytes(h))


def verify_child_transcript(step: StepProof) -> None:
    """Pre-aggregation child checks (agg/child.rs:905-1023).

    Mirrors the reference: recompute the blake3-folded commitment echo
    and enforce coarse shape invariants on openings and FRI layers.  A
    full STARK re-verification is NOT performed here — the aggregation
    trace re-derives every FS challenge, Merkle root, DEEP composition
    and FRI fold per query, and the agg AIR constrains the error columns
    to zero (agg/trace.rs), so a host-side re-verify only duplicated
    that work (measured ~2 s/child at q=64).
    """
    inner = step.proof.inner
    h = bytearray(b"zkl/step/root_trace")
    h += step.proof.header.suite_id
    h += inner.trace_root
    h += inner.constraint_root
    for r in inner.fri_roots:
        h += r
    if blake3(bytes(h)) != step.proof.root_trace:
        raise AggError("child commitments do not match root_trace echo")

    nq = inner.num_unique_queries()
    if nq == 0:
        raise AggError("child transcript has no query openings")
    if len(inner.constraint_openings.rows) != nq:
        raise AggError("constraint openings length != num queries")
    for row in inner.trace_openings.rows:
        if not row:
            raise AggError("empty trace opening row")
    for row in inner.constraint_openings.rows:
        if not row:
            raise AggError("empty constraint opening row")
    if len(inner.fri_openings) != len(inner.fri_roots):
        raise AggError("FRI layer count != FRI root count")
    for lo in inner.fri_openings:
        if not lo.paths and lo.batch is not None:
            continue   # compressed; expanded after FS replay
        if len(lo.paths) != len(lo.pairs):
            raise AggError("FRI layer paths/pairs mismatch")


def recursion_prove(steps: Sequence[StepProof],
                    agg_pi: AggAirPublicInputs,
                    opts: ProverOptions,
                    chs: Optional[Sequence[dict]] = None, device=None):
    """RecursionBackend::prove: verify child transcripts, then prove
    aggregation (src/lib.rs:295-492; transcript checks per
    agg/child.rs:905, not a full re-verify — see
    verify_child_transcript).  `device`: see prove_agg."""
    for s in steps:
        verify_child_transcript(s)
    proof = prove_agg(agg_pi, steps, opts, chs=chs, device=device)
    return proof, recursion_digest(agg_pi)


#: phase wall-times of the most recent prove_chain call in this process:
#: steps_s (the step proofs) and agg_s (everything after them), and the
#: split of agg_s — agg_child_challenges_s (waiting for the child FS
#: replay that ran behind the step proofs), agg_child_batch_s (the batched
#: child re-verification) and agg_prove_s (the aggregation STARK);
#: benchmark-facing, not an API.
LAST_CHAIN_TIMINGS: Dict[str, float] = {}

AGG_PHASES = ("agg_child_challenges", "agg_child_batch", "agg_prove")


def prove_chain(program, pub_inputs, opts: ProverOptions, device=None):
    """recursion.rs prove_chain: steps -> public -> agg proof.

    The step proofs are made by the port's `prove_program` on `device`
    (default: the CUDA card; `device="cpu"` only when the caller asks).
    Pipelined beyond the reference: per-child aggregation FS replay
    (_child_challenges, host Python) runs in worker threads as each step
    proof finishes, overlapping the remaining segments' device work.  The
    replay threads touch no tensor, so they queue nothing on the card's
    stream; the artifact is byte-identical to the serial path's."""
    import time as _time

    from ..prove.prover import prove_program
    if opts.min_security_bits >= 64:
        # fail fast before spending minutes on step proofs: check the
        # best options the aggregation prover could use (quadratic
        # extension) against the requested security level
        from ..prove.params import estimate_conjectured_security_bits
        best = ProofOptions(num_queries=max(opts.queries, 16),
                            blowup=opts.blowup,
                            grinding_factor=opts.grind,
                            field_extension=2)
        if estimate_conjectured_security_bits(best) < opts.min_security_bits:
            raise AggError(
                "prover options cannot reach the requested security "
                f"level ({opts.min_security_bits} bits); raise queries/"
                "blowup/grind")

    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    ch_futs: Dict[int, object] = {}
    pool = ThreadPoolExecutor(
        max_workers=min(4, max(1, (_os.cpu_count() or 1) - 1)))

    def on_steps(done: Sequence[StepProof]) -> None:
        for s in done:
            ch_futs[id(s)] = pool.submit(_child_challenges, s)

    before = summary()
    t0 = _time.time()
    try:
        steps = prove_program(program, pub_inputs, opts,
                              on_steps=on_steps, device=device)
        t_steps = _time.time() - t0
        agg_pi = build_agg_public(steps)
        agg_pi.pi_digest = pub_inputs.digest()
        chs = None
        if len(ch_futs) == len(steps):
            with phase("agg_child_challenges"):
                chs = [ch_futs[id(s)].result() for s in steps]
        proof, digest = recursion_prove(steps, agg_pi, opts, chs=chs,
                                        device=device)
    finally:
        pool.shutdown(wait=False)
    after = summary()
    LAST_CHAIN_TIMINGS.clear()
    LAST_CHAIN_TIMINGS.update(
        steps_s=t_steps, agg_s=_time.time() - t0 - t_steps,
        **{k + "_s": after.get(k, 0.0) - before.get(k, 0.0)
           for k in AGG_PHASES})
    return proof, digest, agg_pi


# ---------------------------------------------------------------------------
# chain verification (zk-lisp-proof/src/recursion.rs verify_chain)
# ---------------------------------------------------------------------------

@dataclass
class RecursionPublic:
    """Host-level chain claim, distinct from the proven AggAirPublicInputs
    (recursion.rs:71-88).  The backend proof binds each link's own
    boundary state; the chain caller assembles RecursionPublic values
    whose initial fields repeat the PREVIOUS link's finals, and
    verify_chain checks that continuity (recursion.rs:160-185)."""
    suite_id: bytes = b"\x00" * 32
    program_id: bytes = b"\x00" * 32
    program_commitment: bytes = b"\x00" * 32
    state_initial: bytes = b"\x00" * 32
    state_final: bytes = b"\x00" * 32
    ram_gp_unsorted_initial: bytes = b"\x00" * 32
    ram_gp_unsorted_final: bytes = b"\x00" * 32
    ram_gp_sorted_initial: bytes = b"\x00" * 32
    ram_gp_sorted_final: bytes = b"\x00" * 32
    rom_s_initial: tuple = (b"\x00" * 32,) * 3
    rom_s_final: tuple = (b"\x00" * 32,) * 3
    prev_digest: bytes = b"\x00" * 32
    children_root: bytes = b"\x00" * 32
    children_count: int = 0
    children_ms: list = None
    v_units_total: int = 0


def recursion_public_from(agg_pi,
                          prev_digest: bytes = b"\x00" * 32
                          ) -> RecursionPublic:
    """Backend RecursionPublicBuilder::build_public analog
    (src/lib.rs:391-483): derive the host chain claim from a proven
    link's AggAirPublicInputs."""
    return RecursionPublic(
        suite_id=agg_pi.suite_id,
        program_id=agg_pi.program_id,
        program_commitment=agg_pi.program_commitment,
        state_initial=agg_pi.vm_state_initial,
        state_final=agg_pi.vm_state_final,
        ram_gp_unsorted_initial=agg_pi.ram_gp_unsorted_initial,
        ram_gp_unsorted_final=agg_pi.ram_gp_unsorted_final,
        ram_gp_sorted_initial=agg_pi.ram_gp_sorted_initial,
        ram_gp_sorted_final=agg_pi.ram_gp_sorted_final,
        rom_s_initial=tuple(agg_pi.rom_s_initial),
        rom_s_final=tuple(agg_pi.rom_s_final),
        prev_digest=prev_digest if any(prev_digest)
        else agg_pi.prev_digest,
        children_root=agg_pi.children_root,
        children_count=agg_pi.children_count,
        children_ms=list(agg_pi.children_ms),
        v_units_total=agg_pi.v_units_total,
    )


def verify_chain(chain, opts: ProverOptions) -> None:
    """chain: iterable of links — either (proof, digest, agg_pi)
    3-tuples (the RecursionPublic is derived from agg_pi, matching a
    chain of consecutive aggregations of one program run) or the
    reference's full 4-tuples (proof, digest, agg_pi, rc_pub) where
    rc_pub is the caller-assembled RecursionPublic (recursion.rs:90)."""
    prev_pi = None
    prev_digest = None
    suite_id = program_id = program_commitment = None
    saw = False
    for link in chain:
        if len(link) == 4:
            proof, digest, backend_pi, rc_pi = link
        else:
            proof, digest, backend_pi = link
            rc_pi = recursion_public_from(backend_pi)
        verify_agg(proof, backend_pi, opts.min_security_bits)
        saw = True
        if suite_id is None:
            suite_id = rc_pi.suite_id
            program_id = rc_pi.program_id
            program_commitment = rc_pi.program_commitment
        else:
            if rc_pi.suite_id != suite_id:
                raise AggError("suite_id must be constant across chain")
            if rc_pi.program_id != program_id:
                raise AggError("program_id must be constant across chain")
            if rc_pi.program_commitment != program_commitment:
                raise AggError(
                    "program_commitment must be constant across chain")
        if prev_pi is None:
            if any(rc_pi.prev_digest):
                raise AggError("first link prev_digest must be zero")
        else:
            if rc_pi.prev_digest != prev_digest:
                raise AggError(
                    "prev_digest must match previous link's digest")
            if rc_pi.state_initial != prev_pi.state_final:
                raise AggError("vm_state_initial must chain")
            if rc_pi.ram_gp_unsorted_initial != \
                    prev_pi.ram_gp_unsorted_final:
                raise AggError("ram_gp_unsorted must chain")
            if rc_pi.ram_gp_sorted_initial != prev_pi.ram_gp_sorted_final:
                raise AggError("ram_gp_sorted must chain")
            if tuple(rc_pi.rom_s_initial) != tuple(prev_pi.rom_s_final):
                raise AggError("rom_s must chain")
        prev_pi = rc_pi
        prev_digest = digest
    if not saw:
        raise AggError("recursion chain must contain at least one step")


# ---------------------------------------------------------------------------
# ZKLRC1 artifact codec (src/lib.rs:485-773)
# ---------------------------------------------------------------------------

def encode_artifact(proof, rc_pi: AggAirPublicInputs) -> bytes:
    from ..prove.formats import serialize_stark_proof
    out = bytearray(b"ZKLRC1")
    out += rc_pi.program_id
    out += rc_pi.program_commitment
    out += rc_pi.pi_digest
    out += rc_pi.children_root
    out += rc_pi.batch_id
    out += struct.pack("<Q", rc_pi.v_units_total)
    out += struct.pack("<I", rc_pi.children_count)
    pm = rc_pi.profile_meta
    out += struct.pack("<IHHHHIQ", pm.m, pm.rho, pm.q, pm.o, pm.lambda_,
                       pm.pi_len, pm.v_units)
    pf = rc_pi.profile_fri
    out += struct.pack("<IBBB", pf.lde_blowup, pf.folding_factor,
                       pf.redundancy, pf.num_layers)
    pq = rc_pi.profile_queries
    out += struct.pack("<HI", pq.num_queries, pq.grinding_factor)
    out += rc_pi.suite_id
    out += struct.pack("<I", len(rc_pi.children_ms))
    for m in rc_pi.children_ms:
        out += struct.pack("<I", m)
    out += rc_pi.vm_state_initial
    out += rc_pi.vm_state_final
    out += rc_pi.ram_gp_unsorted_initial
    out += rc_pi.ram_gp_unsorted_final
    out += rc_pi.ram_gp_sorted_initial
    out += rc_pi.ram_gp_sorted_final
    for lane in rc_pi.rom_s_initial:
        out += lane
    for lane in rc_pi.rom_s_final:
        out += lane
    p_bytes = serialize_stark_proof(proof)
    out += struct.pack("<I", len(p_bytes))
    out += p_bytes
    return bytes(out)


def decode_artifact(data: bytes):
    from ..prove.formats import _Reader, deserialize_stark_proof
    r = _Reader(data)
    if r.take(6) != b"ZKLRC1":
        raise AggError("invalid recursion artifact magic")
    program_id = r.take(32)
    program_commitment = r.take(32)
    pi_digest = r.take(32)
    children_root = r.take(32)
    batch_id = r.take(32)
    v_units_total = r.u64()
    children_count = r.u32()
    m, rho, q, o, lam, pi_len, v_units = struct.unpack(
        "<IHHHHIQ", r.take(24))
    lde_blowup, folding_factor, redundancy, num_layers = struct.unpack(
        "<IBBB", r.take(7))
    num_queries, grinding_factor = struct.unpack("<HI", r.take(6))
    suite_id = r.take(32)
    n_ms = r.u32()
    children_ms = [r.u32() for _ in range(n_ms)]
    vm_state_initial = r.take(32)
    vm_state_final = r.take(32)
    ram_gp_unsorted_initial = r.take(32)
    ram_gp_unsorted_final = r.take(32)
    ram_gp_sorted_initial = r.take(32)
    ram_gp_sorted_final = r.take(32)
    rom_s_initial = tuple(r.take(32) for _ in range(3))
    rom_s_final = tuple(r.take(32) for _ in range(3))
    plen = r.u32()
    proof = deserialize_stark_proof(r.take(plen))
    rc_pi = AggAirPublicInputs(
        program_id=program_id, program_commitment=program_commitment,
        pi_digest=pi_digest, children_root=children_root,
        v_units_total=v_units_total, children_count=children_count,
        batch_id=batch_id,
        profile_meta=AggProfileMeta(m, rho, q, o, lam, pi_len, v_units),
        profile_fri=AggFriProfile(lde_blowup, folding_factor, redundancy,
                                  num_layers),
        profile_queries=AggQueryProfile(num_queries, grinding_factor),
        suite_id=suite_id, children_ms=children_ms,
        vm_state_initial=vm_state_initial, vm_state_final=vm_state_final,
        ram_gp_unsorted_initial=ram_gp_unsorted_initial,
        ram_gp_unsorted_final=ram_gp_unsorted_final,
        ram_gp_sorted_initial=ram_gp_sorted_initial,
        ram_gp_sorted_final=ram_gp_sorted_final,
        rom_s_initial=rom_s_initial, rom_s_final=rom_s_final)
    return proof, rc_pi
