"""STARK proof containers, the host prover and the host verifier.

The host half of the STARK core: the proof dataclasses, boundary
assertion grouping, LDE-domain tables shared with the device prover
(prove/stark_device.py), the host prover `prove_trace(..., xp=numpy)`
(trace LDE, constraint composition, DEEP composition, FRI, grinding and
query openings as batched numpy limb arithmetic — the aggregation proof
is made with it), Fiat-Shamir replay and `verify_trace`.
Quadratic-extension proofs (field_extension == 2) go to stark_ext.

Protocol structure follows winterfell as documented by the reference's
Fiat-Shamir replay (src/agg/fs.rs — treated as the spec) and its
aggregation-layer re-verification math (src/agg/trace.rs):

  seed = hash_elements(context ++ air_pi); reseed(trace_root);
  [constraint coefficient draws]; reseed(constraint_root); z = draw;
  reseed(hash_elements(T(z)||H(z)||T(zg)||H(zg))); DEEP coeff draws;
  per-FRI-layer reseed(root) + alpha draw; PoW; position draws.

DEEP(x) = sum_i g_i[(T_i(x)-T_i(z))/(x-z) + (T_i(x)-T_i(zg))/(x-zg)]
        + sum_j d_j[(H_j(x)-H_j(z))/(x-z) + (H_j(x)-H_j(zg))/(x-zg)]

FRI: folding factor 2 over pairs (i, i+L/2) with the line-interpolation
fold v' = [v1(a-x0) - v0(a-x1)]/(x1-x0), constant coset offset 3 at every
depth, and a Horner-evaluated remainder polynomial (highest-degree-first).

Deliberate deviation from winterfell (documented in PARITY.md): boundary
assertions are batched as *periodic groups* (one coefficient per
(column, value, stride) class) instead of one coefficient per assertion —
identical soundness structure, ~200x fewer boundary constraint groups for
the schedule assertions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as _np

from ..air.zk_air import AirPublicInputs, ZkLispAir
from ..crypto import poseidon as pos
from ..field import f128
from ..field import limb_host as limb
from ..field import ntt_host as ntt
from ..field.felt import Felt, FVec
from .coin import RandomCoin
from . import multiproof
from .commit import (MerkleCommitment, commit_rows, hash_row_host,
                     verify_opening)
from .params import ProofOptions

P = f128.P
OFFSET = ntt.DEFAULT_COSET_OFFSET


class VerifyError(Exception):
    pass


# ---------------------------------------------------------------------------
# proof container
# ---------------------------------------------------------------------------

@dataclass
class ProofContext:
    trace_width: int
    trace_len: int
    options: ProofOptions

    def lde_domain_size(self) -> int:
        return self.trace_len * self.options.blowup

    def to_elements(self) -> List[int]:
        """FS context seed elements (analog of winterfell
        Context::to_elements; layout is this framework's own, stable)."""
        return ([1,  # version
                 self.trace_width, self.trace_len,
                 P % (1 << 64)]  # field binding
                + self.options.to_elements())


@dataclass
class QueryOpenings:
    rows: List[List[int]]               # opened rows (field values)
    paths: List[List[bytes]]            # per-row sibling paths
    # compressed form (winterfell BatchMerkleProof analog): only `batch`
    # travels on the wire; `paths` is reconstructed from it once the
    # FS-derived query positions are known (expand_proof_openings)
    batch: "multiproof.MultiProof" = None


@dataclass
class FriLayerOpenings:
    pairs: List[Tuple[int, int]]        # (v0, v1) per folded position
    paths: List[List[bytes]]
    batch: "multiproof.MultiProof" = None


@dataclass
class StarkProof:
    context: ProofContext
    trace_root: bytes
    constraint_root: bytes
    ood_trace_current: List[int]
    ood_trace_next: List[int]
    ood_quotient_current: List[int]
    ood_quotient_next: List[int]
    fri_roots: List[bytes]
    fri_remainder: List[int]            # coefficients, highest-first
    pow_nonce: int
    trace_openings: QueryOpenings = None
    constraint_openings: QueryOpenings = None
    fri_openings: List[FriLayerOpenings] = field(default_factory=list)

    def num_unique_queries(self) -> int:
        return len(self.trace_openings.rows)


# ---------------------------------------------------------------------------
# boundary assertion grouping
# ---------------------------------------------------------------------------

CYCLE = 32  # STEPS_PER_LEVEL_P2


@dataclass(frozen=True)
class AssertionGroup:
    """Boundary assertion batch sharing one composition coefficient.

    cyclic: steps = {o + CYCLE*k | o in offsets, 0 <= k < n/CYCLE} with a
    single value; divisor = prod_o (x^(n/CYCLE) - g^(o*n/CYCLE)).
    single: one step; divisor (x - g^step).
    """
    column: int
    value: int
    offsets: Tuple[int, ...]   # cyclic offsets within the 32-row level
    step: int = -1             # >= 0 => single assertion at this step

    @property
    def is_single(self) -> bool:
        return self.step >= 0


def group_assertions(assertions: Sequence[Tuple[int, int, int]],
                     trace_len: int,
                     per_assertion: bool = False) -> List[AssertionGroup]:
    """Batch boundary assertions for the constraint composition.

    Default ("grouped") mode batches per periodic (column, value, stride)
    class — the TPU-native formulation.  `per_assertion` is the
    winterfell-compat mode (ZKL_WINTERFELL_COMPAT=1 /
    ProofOptions.assertion_batching): one group (and hence one
    composition coefficient) per assertion, in `air.get_assertions()`
    order, each with a single (x - g^step) divisor — matching
    winterfell's boundary constraints for Assertion::single, the only
    kind the reference emits (vm/air/schedule.rs:63-136,
    vm/air/mod.rs:403-445, vm/air/rom.rs:133-141).
    """
    if per_assertion:
        return [AssertionGroup(col, val, (), step)
                for col, step, val in assertions]
    by_cv = {}
    order = []
    for col, step, val in assertions:
        key = (col, val)
        if key not in by_cv:
            by_cv[key] = []
            order.append(key)
        by_cv[key].append(step)

    levels = trace_len // CYCLE
    groups: List[AssertionGroup] = []
    for key in order:
        col, val = key
        steps = sorted(by_cv[key])
        sset = set(steps)
        offsets = tuple(sorted({s % CYCLE for s in steps}))
        if (levels > 0 and len(steps) == len(offsets) * levels
                and all((o + CYCLE * k) in sset
                        for o in offsets for k in range(levels))):
            groups.append(AssertionGroup(col, val, offsets))
        else:
            for s in steps:
                groups.append(AssertionGroup(col, val, (), s))
    return groups


# ---------------------------------------------------------------------------
# domain helpers
# ---------------------------------------------------------------------------

def _roll(a, shift, xp):
    return xp.roll(a, shift, axis=0)


def lde_points_host(n: int, blowup: int) -> List[int]:
    N = n * blowup
    w = f128.get_root_of_unity(N)
    xs = []
    cur = OFFSET
    for _ in range(N):
        xs.append(cur)
        cur = f128.mul(cur, w)
    return xs


def _tile_inverse_period(values_one_period: List[int], N: int, xp) -> FVec:
    inv = f128.batch_inv(values_one_period)
    return FVec.from_ints(inv * (N // len(inv)), xp)


def transition_zerofier_inv_lde(n: int, blowup: int, xp) -> FVec:
    """(x - g^(n-1)) / (x^n - 1) over the LDE domain."""
    N = n * blowup
    # x^n - 1 has period `blowup` over the LDE index
    xn = pow(OFFSET, n, P)
    wN = f128.get_root_of_unity(N)
    wn = pow(wN, n, P)
    vals = []
    cur = xn
    for _ in range(blowup):
        vals.append((cur - 1) % P)
        cur = f128.mul(cur, wn)
    inv_xn = _tile_inverse_period(vals, N, xp)

    g_last = pow(f128.get_root_of_unity(n), n - 1, P)
    xs = lde_points_host(n, blowup)
    x_vec = FVec.from_ints(xs, xp)
    return (x_vec - Felt(g_last)) * inv_xn


def group_divisor_inv_lde(groups: Sequence[AssertionGroup], n: int,
                          blowup: int, xp) -> List[FVec]:
    """1/divisor over the LDE domain for each assertion group."""
    N = n * blowup
    wN = f128.get_root_of_unity(N)
    g = f128.get_root_of_unity(n)
    out_map = {}
    singles = [grp for grp in groups if grp.is_single]

    # batch all single divisors together, deduped by step (per-assertion
    # mode produces many groups sharing a step; the inverse table is
    # computed once per unique step and the FVec shared)
    if singles:
        xs = lde_points_host(n, blowup)
        steps = sorted({grp.step for grp in singles})
        flat = []
        for s in steps:
            gs = pow(g, s, P)
            flat.extend((x - gs) % P for x in xs)
        inv_flat = f128.batch_inv(flat)
        by_step = {}
        for i, s in enumerate(steps):
            by_step[s] = FVec.from_ints(inv_flat[i * N:(i + 1) * N], xp)
        for grp in singles:
            out_map[id(grp)] = by_step[grp.step]

    k = n // CYCLE
    period = CYCLE * blowup
    # x^k over one period of the LDE index
    xk_vals = []
    cur = pow(OFFSET, k, P)
    wk = pow(wN, k, P)
    for _ in range(period):
        xk_vals.append(cur)
        cur = f128.mul(cur, wk)

    out = []
    for grp in groups:
        if grp.is_single:
            out.append(out_map[id(grp)])
            continue
        roots = [pow(g, o * k, P) for o in grp.offsets]
        vals = []
        for xv in xk_vals:
            prod = 1
            for r in roots:
                prod = prod * ((xv - r) % P) % P
            vals.append(prod)
        out.append(_tile_inverse_period(vals, N, xp))
    return out


def group_divisor_at(grp: AssertionGroup, n: int, z: int) -> int:
    g = f128.get_root_of_unity(n)
    if grp.is_single:
        return (z - pow(g, grp.step, P)) % P
    k = n // CYCLE
    zk = pow(z, k, P)
    prod = 1
    for o in grp.offsets:
        prod = prod * ((zk - pow(g, o * k, P)) % P) % P
    return prod


# ---------------------------------------------------------------------------
# device polynomial evaluation at a point
# ---------------------------------------------------------------------------

def eval_polys_at(polys, z: int, xp) -> List[int]:
    """polys: (C, n, 8) coefficient limb array -> [P_c(z)] as ints."""
    n = polys.shape[1]
    zp = []
    cur = 1
    for _ in range(n):
        zp.append(cur)
        cur = f128.mul(cur, z)
    zpow = xp.asarray(limb.from_ints(zp))          # (n, 8)
    terms = limb.mul(polys, zpow[None], xp)        # (C, n, 8)
    acc = limb.sum_mod(terms, 1, xp)
    return [int(v) for v in limb.to_ints(_np.asarray(acc))]


def vec_inv(v: FVec) -> FVec:
    return FVec(limb.inv(v.a, v.xp), v.xp)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def prove_trace(trace, air: ZkLispAir, air_pi: AirPublicInputs,
                options: ProofOptions, xp=_np, device=None) -> StarkProof:
    """The host prover (numpy limb arithmetic).  Only the proof-of-work
    scan runs on `device` (`RandomCoin.grind`; default: the CUDA card)."""
    n = trace.length
    w = trace.width
    blowup = options.blowup
    N = n * blowup
    context = ProofContext(w, n, options)

    # 1. trace polynomials + LDE
    cols_limbs = xp.asarray(trace.to_limbs())       # (w, n, 8)
    pows = ntt.powers_table(N.bit_length() - 1, xp)
    trace_polys = xp.stack([ntt.intt(cols_limbs[c], xp)
                            for c in range(w)])     # (w, n, 8)
    trace_lde = xp.stack([
        ntt.coset_evaluate(trace_polys[c], blowup, xp, pows=pows)
        for c in range(w)])                         # (w, N, 8)

    # 2. commit to trace rows
    ps_main = options.partition_size(w)
    rows = xp.transpose(trace_lde, (1, 0, 2))
    trace_comm = commit_rows(rows, ps_main, xp)

    coin = RandomCoin(context.to_elements() + air_pi.to_elements())
    coin.reseed(trace_comm.root)

    # 3. constraint composition coefficients
    n_trans = air.num_transition_constraints()
    assertions = air.get_assertions()
    groups = group_assertions(assertions, n, options.per_assertion)
    alphas = coin.draw_many(n_trans)
    betas = coin.draw_many(len(groups))

    # 4. composition evaluations over the LDE domain
    periodic = air.periodic_lde(blowup, xp)
    cur = [FVec(trace_lde[c], xp) for c in range(w)]
    nxt = [FVec(_roll(trace_lde[c], -blowup, xp), xp) for c in range(w)]
    tvals = air.evaluate_transition(cur, nxt, periodic)

    comb = None
    for a, tv in zip(alphas, tvals):
        term = tv * Felt(a)
        comb = term if comb is None else comb + term
    z_inv = transition_zerofier_inv_lde(n, blowup, xp)
    comp = comb * z_inv

    div_invs = group_divisor_inv_lde(groups, n, blowup, xp)
    for beta, grp, dinv in zip(betas, groups, div_invs):
        numer = cur[grp.column] - Felt(grp.value)
        comp = comp + (numer * dinv) * Felt(beta)

    # 5. interpolate composition; split into Q degree-<n columns
    Q = air.ce_blowup()
    comp_coeffs = ntt.coset_interpolate(comp.a, blowup, xp)  # (N, 8)
    q_polys = comp_coeffs[:Q * n].reshape(Q, n, limb.NLIMB)
    q_lde = xp.stack([
        ntt.coset_evaluate(q_polys[i], blowup, xp, pows=pows)
        for i in range(Q)])                          # (Q, N, 8)
    ps_constraint = options.partition_size(Q)
    q_rows = xp.transpose(q_lde, (1, 0, 2))
    constraint_comm = commit_rows(q_rows, ps_constraint, xp)
    coin.reseed(constraint_comm.root)

    # 6. OOD point and frames
    z = coin.draw()
    g_trace = f128.get_root_of_unity(n)
    zg = f128.mul(z, g_trace)
    ood_t_cur = eval_polys_at(trace_polys, z, xp)
    ood_t_next = eval_polys_at(trace_polys, zg, xp)
    ood_q_cur = eval_polys_at(q_polys, z, xp)
    ood_q_next = eval_polys_at(q_polys, zg, xp)
    ood_evals = ood_t_cur + ood_q_cur + ood_t_next + ood_q_next
    coin.reseed(pos.hash_elements(ood_evals))

    # 7. DEEP composition over the LDE domain
    gammas = coin.draw_many(w)
    deltas = coin.draw_many(Q)

    gt = None
    for c in range(w):
        term = cur[c] * Felt(gammas[c])
        gt = term if gt is None else gt + term
    for j in range(Q):
        gt = gt + FVec(q_lde[j], xp) * Felt(deltas[j])

    gz = sum(g * t for g, t in zip(gammas, ood_t_cur)) % P
    gz = (gz + sum(d * q for d, q in zip(deltas, ood_q_cur))) % P
    gzg = sum(g * t for g, t in zip(gammas, ood_t_next)) % P
    gzg = (gzg + sum(d * q for d, q in zip(deltas, ood_q_next))) % P

    xs_int = lde_points_host(n, blowup)
    inv_xz = FVec.from_ints(f128.batch_inv([(x - z) % P for x in xs_int]),
                            xp)
    inv_xzg = FVec.from_ints(f128.batch_inv([(x - zg) % P for x in xs_int]),
                             xp)
    deep = (gt - Felt(gz)) * inv_xz + (gt - Felt(gzg)) * inv_xzg

    # 8. FRI commit phase
    num_layers = options.num_fri_layers(N)
    fri_layers_vals = []                 # evaluations per layer (FVec)
    fri_comms: List[MerkleCommitment] = []
    fri_alphas = []
    layer = deep
    size = N
    inv2 = f128.inv(2)
    for d in range(num_layers):
        half = size // 2
        v0 = FVec(layer.a[:half], xp)
        v1 = FVec(layer.a[half:], xp)
        pair_rows = xp.stack([v0.a, v1.a], axis=1)      # (half, 2, 8)
        comm = commit_rows(pair_rows, 2, xp)
        fri_comms.append(comm)
        fri_layers_vals.append(layer)
        coin.reseed(comm.root)
        alpha = coin.draw()
        fri_alphas.append(alpha)
        # fold: x0 = offset * g_d^i ; x1 = -x0
        # v' = [v1(a-x0) - v0(a-x1)] / (x1-x0) = (v0(a+x0) - v1(a-x0))/(2x0)
        wd = f128.get_root_of_unity(size)
        x0s = []
        cx = OFFSET
        for _ in range(half):
            x0s.append(cx)
            cx = f128.mul(cx, wd)
        x0 = FVec.from_ints(x0s, xp)
        inv_2x0 = FVec.from_ints(
            [f128.mul(inv2, f128.inv(v)) for v in x0s], xp)
        a_f = Felt(alpha)
        folded = (v0 * (a_f + x0) - v1 * (a_f - x0)) * inv_2x0
        layer = folded
        size = half

    # remainder polynomial (coset interpolation over remaining domain)
    rem_coeffs_l = ntt.coset_interpolate(layer.a, 1, xp)
    rem_ints = [int(v) for v in limb.to_ints(_np.asarray(rem_coeffs_l))]
    max_deg = options.fri_remainder_max_degree
    assert all(v == 0 for v in rem_ints[max_deg + 1:]), \
        "FRI remainder degree too high"
    fri_remainder = list(reversed(rem_ints[:max_deg + 1]))  # highest first

    # 9. grinding + query positions
    pow_nonce = coin.grind(options.grinding_factor, device=device)
    positions = coin.draw_integers(options.num_queries, N, pow_nonce)
    positions = sorted(set(positions))

    # 10. openings
    rows_host = _np.asarray(rows)

    def open_rows(comm: MerkleCommitment, mat_rows, idxs) -> QueryOpenings:
        out_rows, out_paths = [], []
        for p_ in idxs:
            row = [int(v) for v in limb.to_ints(mat_rows[p_])]
            out_rows.append(row)
            out_paths.append(comm.open(p_))
        return QueryOpenings(out_rows, out_paths,
                             multiproof.compress(idxs, out_paths))

    trace_open = open_rows(trace_comm, rows_host, positions)
    constraint_open = open_rows(constraint_comm, _np.asarray(q_rows),
                                positions)

    fri_open: List[FriLayerOpenings] = []
    pos_d = positions
    size_d = N
    for d in range(num_layers):
        half = size_d // 2
        folded = []
        for p_ in pos_d:
            m = p_ % half
            if m not in folded:
                folded.append(m)
        layer_host = _np.asarray(fri_layers_vals[d].a)
        pairs, paths = [], []
        for m in folded:
            v0 = int(limb.to_ints(layer_host[m:m + 1])[0])
            v1 = int(limb.to_ints(layer_host[half + m:half + m + 1])[0])
            pairs.append((v0, v1))
            paths.append(fri_comms[d].open(m))
        fri_open.append(FriLayerOpenings(
            pairs, paths, multiproof.compress(folded, paths)))
        pos_d = folded
        size_d = half

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


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------

def expand_proof_openings(proof: StarkProof,
                          positions: Sequence[int]) -> None:
    """Reconstruct per-position sibling paths from the compressed batch
    multiproofs (winterfell's decompression step, agg/child.rs:162-520:
    it needs the FS-derived query positions, so it runs after transcript
    replay).  Idempotent; no-op for proofs built in-process (paths are
    kept alongside the batch at prove time)."""
    if not positions or proof.trace_openings is None:
        return
    opts = proof.context.options
    wide = opts.field_extension == 2
    w = proof.context.trace_width
    Q = len(proof.ood_quotient_current)

    def _expand_rows(op: QueryOpenings, leaf_fn) -> None:
        if op is None or op.batch is None or op.paths:
            return
        leaves = [leaf_fn(row) for row in op.rows]
        try:
            op.paths, _ = multiproof.expand(op.batch, positions, leaves)
        except ValueError as e:
            raise VerifyError(f"invalid opening multiproof: {e}")

    ps_main = opts.partition_size(w)
    _expand_rows(proof.trace_openings,
                 lambda row: hash_row_host([v % P for v in row], ps_main))
    if wide:
        from .stark_ext import _ext_row_leaf
        ps_con = opts.partition_size(2 * Q)
        _expand_rows(proof.constraint_openings,
                     lambda row: _ext_row_leaf(row, ps_con))
    else:
        ps_con = opts.partition_size(Q)
        _expand_rows(proof.constraint_openings,
                     lambda row: hash_row_host(row, ps_con))

    size_d = proof.context.trace_len * opts.blowup
    pos_d = list(positions)
    for layer in proof.fri_openings:
        half = size_d // 2
        folded = []
        for p_ in pos_d:
            m = p_ % half
            if m not in folded:
                folded.append(m)
        if layer.batch is not None and not layer.paths:
            if wide:
                from ..field import f128q
                from .stark_ext import _fri_leaf
                leaves = [_fri_leaf(f128q.unpack(v0), f128q.unpack(v1))
                          for (v0, v1) in layer.pairs]
            else:
                leaves = [pos.hash_elements([v0, v1])
                          for (v0, v1) in layer.pairs]
            try:
                layer.paths, _ = multiproof.expand(layer.batch, folded,
                                                   leaves)
            except ValueError as e:
                raise VerifyError(f"invalid FRI multiproof: {e}")
        pos_d = folded
        size_d = half


def replay_challenges(proof: StarkProof, air, air_pi) -> dict:
    """Replay the Fiat-Shamir transcript (fs.rs order) from a proof.

    Returns all challenges the verifier needs; draws do not mutate the
    seed, so constraint-coefficient draws can be safely included.
    """
    options = proof.context.options
    n = proof.context.trace_len
    w = proof.context.trace_width
    N = n * options.blowup
    Q = air.ce_blowup()

    coin = RandomCoin(proof.context.to_elements() + air_pi.to_elements())
    coin.reseed(proof.trace_root)
    alphas = coin.draw_many(air.num_transition_constraints())
    groups = group_assertions(air.get_assertions(), n,
                              options.per_assertion)
    betas = coin.draw_many(len(groups))
    coin.reseed(proof.constraint_root)
    z = coin.draw()
    ood_evals = (proof.ood_trace_current + proof.ood_quotient_current
                 + proof.ood_trace_next + proof.ood_quotient_next)
    coin.reseed(pos.hash_elements(ood_evals))
    gammas = coin.draw_many(w)
    deltas = coin.draw_many(Q)
    fri_alphas = []
    for root in proof.fri_roots:
        coin.reseed(root)
        fri_alphas.append(coin.draw())
    pow_ok = (coin.check_leading_zeros(proof.pow_nonce)
              >= options.grinding_factor)
    positions = sorted(set(coin.draw_integers(
        options.num_queries, N, proof.pow_nonce)))
    expand_proof_openings(proof, positions)
    return dict(alphas=alphas, betas=betas, groups=groups, z=z,
                gammas=gammas, deltas=deltas, fri_alphas=fri_alphas,
                pow_ok=pow_ok, positions=positions)


def verify_trace(proof: StarkProof, air_pi, min_security_bits: int = 0,
                 air=None) -> None:
    """Full verification; raises VerifyError on any failure."""
    options = proof.context.options
    if options.field_extension == 2:
        from .stark_ext import verify_trace_ext
        verify_trace_ext(proof, air_pi, min_security_bits, air=air)
        return
    n = proof.context.trace_len
    w = proof.context.trace_width
    blowup = options.blowup
    N = n * blowup

    from .params import estimate_conjectured_security_bits
    if min_security_bits and (estimate_conjectured_security_bits(options)
                              < min_security_bits):
        raise VerifyError("proof options below required security level")

    if air is None:
        air = ZkLispAir(w, n, air_pi)
    Q = air.ce_blowup()
    num_layers = options.num_fri_layers(N)

    if len(proof.ood_trace_current) != w or len(proof.ood_quotient_current) != Q:
        raise VerifyError("OOD frame width mismatch")
    if len(proof.fri_roots) != num_layers:
        raise VerifyError("FRI layer count mismatch")

    # --- FS replay (fs.rs order) ---
    ch = replay_challenges(proof, air, air_pi)
    alphas, betas, groups = ch["alphas"], ch["betas"], ch["groups"]
    z, gammas, deltas = ch["z"], ch["gammas"], ch["deltas"]
    fri_alphas, positions = ch["fri_alphas"], ch["positions"]
    if not ch["pow_ok"]:
        raise VerifyError("pow nonce does not satisfy grinding factor")
    if len(positions) != proof.num_unique_queries():
        raise VerifyError("query position count mismatch")

    # --- OOD consistency ---
    g_trace = f128.get_root_of_unity(n)
    zg = f128.mul(z, g_trace)
    cur = [Felt(v) for v in proof.ood_trace_current]
    nxt = [Felt(v) for v in proof.ood_trace_next]
    periodic_z = air.periodic_values_at_point(z)
    tvals = air.evaluate_transition(cur, nxt, periodic_z)
    comb = 0
    for a, tv in zip(alphas, tvals):
        comb = (comb + a * tv.v) % P
    zn = pow(z, n, P)
    g_last = pow(g_trace, n - 1, P)
    z_div = (zn - 1) * f128.inv((z - g_last) % P) % P
    lhs = comb * f128.inv(z_div) % P
    for beta, grp in zip(betas, groups):
        numer = (proof.ood_trace_current[grp.column] - grp.value) % P
        lhs = (lhs + beta * numer % P
               * f128.inv(group_divisor_at(grp, n, z))) % P

    rhs = 0
    z_pow_n = pow(z, n, P)
    zi = 1
    for j in range(Q):
        rhs = (rhs + zi * proof.ood_quotient_current[j]) % P
        zi = (zi * z_pow_n) % P
    if lhs != rhs:
        raise VerifyError("OOD constraint composition mismatch")

    # --- query openings: Merkle checks ---
    ps_main = options.partition_size(w)
    ps_constraint = options.partition_size(Q)
    for k, p_ in enumerate(positions):
        row = proof.trace_openings.rows[k]
        if len(row) != w:
            raise VerifyError("trace opening width mismatch")
        leaf = hash_row_host(row, ps_main)
        if not verify_opening(proof.trace_root, leaf, p_,
                              proof.trace_openings.paths[k]):
            raise VerifyError(f"trace Merkle path invalid at {p_}")
        qrow = proof.constraint_openings.rows[k]
        if len(qrow) != Q:
            raise VerifyError("constraint opening width mismatch")
        leaf = hash_row_host(qrow, ps_constraint)
        if not verify_opening(proof.constraint_root, leaf, p_,
                              proof.constraint_openings.paths[k]):
            raise VerifyError(f"constraint Merkle path invalid at {p_}")

    # --- DEEP at query positions vs FRI layer 0 ---
    wN = f128.get_root_of_unity(N)
    gz = sum(g * t for g, t in zip(gammas, proof.ood_trace_current)) % P
    gz = (gz + sum(d * q for d, q in
                   zip(deltas, proof.ood_quotient_current))) % P
    gzg = sum(g * t for g, t in zip(gammas, proof.ood_trace_next)) % P
    gzg = (gzg + sum(d * q for d, q in
                     zip(deltas, proof.ood_quotient_next))) % P

    half0 = N // 2
    folded0 = []
    for p_ in positions:
        m = p_ % half0
        if m not in folded0:
            folded0.append(m)
    layer0 = proof.fri_openings[0]

    for k, p_ in enumerate(positions):
        x = f128.mul(pow(wN, p_, P), OFFSET)
        gt = 0
        for c in range(w):
            gt = (gt + gammas[c] * proof.trace_openings.rows[k][c]) % P
        for j in range(Q):
            gt = (gt + deltas[j] * proof.constraint_openings.rows[k][j]) % P
        y = ((gt - gz) * f128.inv((x - z) % P)
             + (gt - gzg) * f128.inv((x - zg) % P)) % P

        m = p_ % half0
        elem = p_ // half0
        fi = folded0.index(m)
        q0 = layer0.pairs[fi][elem]
        if y != q0:
            raise VerifyError(f"DEEP vs FRI layer-0 mismatch at {p_}")

    # --- FRI verification (agg/trace.rs compute_fri_path semantics) ---
    pos_d = positions
    size_d = N
    base_g = wN
    folding_root = pow(wN, N // 2, P)  # == -1
    gen_d = wN
    for d in range(num_layers):
        half = size_d // 2
        folded = []
        for p_ in pos_d:
            m = p_ % half
            if m not in folded:
                folded.append(m)
        layer = proof.fri_openings[d]
        if len(layer.pairs) != len(folded):
            raise VerifyError(f"FRI layer {d} opening count mismatch")
        # Merkle checks for this layer
        for i, m in enumerate(folded):
            v0, v1 = layer.pairs[i]
            leaf = pos.hash_elements([v0, v1])
            if not verify_opening(proof.fri_roots[d], leaf, m,
                                  layer.paths[i]):
                raise VerifyError(f"FRI layer {d} Merkle invalid at {m}")
        # folding checks against next layer (or remainder)
        alpha = fri_alphas[d]
        if d + 1 < num_layers:
            nxt_half = half // 2
            folded_next = []
            for m in folded:
                mm = m % nxt_half
                if mm not in folded_next:
                    folded_next.append(mm)
            next_layer = proof.fri_openings[d + 1]
        for i, m in enumerate(folded):
            v0, v1 = layer.pairs[i]
            xe = f128.mul(pow(gen_d, m, P), OFFSET)
            x0 = xe
            x1 = f128.mul(xe, folding_root)
            num = (v1 * ((alpha - x0) % P) - v0 * ((alpha - x1) % P)) % P
            vnext = num * f128.inv((x1 - x0) % P) % P
            if d + 1 < num_layers:
                mm = m % nxt_half
                elem = m // nxt_half
                fi = folded_next.index(mm)
                if vnext != next_layer.pairs[fi][elem]:
                    raise VerifyError(
                        f"FRI fold mismatch depth {d} pos {m}")
            else:
                # remainder check (Horner, highest-degree-first)
                gen_rem = pow(gen_d, 2, P)
                x_l = f128.mul(OFFSET, pow(gen_rem, m, P))
                acc = 0
                for coeff in proof.fri_remainder:
                    acc = (acc * x_l + coeff) % P
                if vnext != acc:
                    raise VerifyError(f"FRI remainder mismatch at {m}")
        pos_d = folded
        size_d = half
        gen_d = pow(gen_d, 2, P)
