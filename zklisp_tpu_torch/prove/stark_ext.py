"""Quadratic-extension STARK prover/verifier (aggregation ≥128-bit path).

The reference proves and verifies its aggregation STARK over winterfell's
`QuadExtension` whenever the requested security level is ≥128 bits
(src/prove.rs:732-800, src/lib.rs:352-378): the trace stays in the base
field, but every Fiat-Shamir challenge (composition coefficients, the OOD
point z, DEEP coefficients, FRI alphas) is drawn from — and all
derived polynomials (constraint composition, DEEP, FRI layers) live in —
the extension F[φ]/(φ²−φ−1).

This module is that path, rebuilt from the extension-field STARK
structure (spec-derived; byte parity with winterfell is out of scope —
PARITY.md).  Key algebraic fact exploited throughout: multiplication by
an extension scalar and inversion against a base-field domain point are
componentwise-linear over the base field, so every domain-sized
computation stays in the vectorized base-field limb kernels (`QVec` =
pair of FVecs); genuinely-extension scalar work (OOD frames, per-query
checks) runs on host ints (`QFelt`).

Aggregation traces are small (31 cols × #children rows), so this path is
numpy-host only; step proofs keep the base-field device pipeline.

Conventions (documented deviations / definitions, see PARITY.md):
  * coin.draw_ext() = (draw(), draw()) — two successive base draws.
  * extension values hash as interleaved base components [re, im].
  * proof containers store one extension element as the packed int
    re + (im << 128); the wire codec writes 32 LE bytes per element when
    field_extension == 2 (formats._w_fe).
  * the constraint commitment hashes rows of 2Q interleaved components
    with partition_size(2Q); FRI leaves hash [v0re, v0im, v1re, v1im].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as _np

from ..crypto import poseidon as pos
from ..field import f128, f128q
from ..field import limb_host as limb
from ..field import ntt_host as ntt
from ..field.f128q import QElem, QFelt
from ..field.felt import Felt, FVec
from .coin import RandomCoin
from .commit import (MerkleCommitment, commit_rows, hash_row_host,
                     merkle_root_from_leaf, verify_opening)
from .params import ProofOptions
from .stark import (FriLayerOpenings, ProofContext, QueryOpenings,
                    StarkProof, VerifyError, group_assertions,
                    group_divisor_at, group_divisor_inv_lde,
                    lde_points_host, transition_zerofier_inv_lde)

P = f128.P
OFFSET = ntt.DEFAULT_COSET_OFFSET
_xp = _np


def draw_ext(coin: RandomCoin) -> QElem:
    re = coin.draw()
    im = coin.draw()
    return (re, im)


def draw_ext_many(coin: RandomCoin, n: int) -> List[QElem]:
    return [draw_ext(coin) for _ in range(n)]


class QVec:
    """Vector of extension elements as a pair of base-field FVecs."""

    __slots__ = ("re", "im")

    def __init__(self, re: FVec, im: FVec) -> None:
        self.re = re
        self.im = im

    @staticmethod
    def from_base(v: FVec) -> "QVec":
        return QVec(v, FVec.zeros(v.shape, v.xp))

    @staticmethod
    def from_qelems(vals: Sequence[QElem], xp=_np) -> "QVec":
        return QVec(FVec.from_ints([v[0] for v in vals], xp),
                    FVec.from_ints([v[1] for v in vals], xp))

    def _coerce(self, o) -> "QVec":
        if isinstance(o, QVec):
            return o
        if isinstance(o, FVec):
            return QVec.from_base(o)
        if isinstance(o, QFelt):
            o = o.v
        if isinstance(o, tuple):
            sh, xp = self.re.shape, self.re.xp
            return QVec(FVec.const(o[0], sh, xp), FVec.const(o[1], sh, xp))
        return QVec.from_base(self.re._coerce(o))

    def __add__(self, o):
        o = self._coerce(o)
        return QVec(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return QVec(self.re - o.re, self.im - o.im)

    def __rsub__(self, o):
        return self._coerce(o).__sub__(self)

    def __mul__(self, o):
        o = self._coerce(o)
        t = self.im * o.im
        return QVec(self.re * o.re + t,
                    self.re * o.im + self.im * o.re + t)

    __rmul__ = __mul__

    def inv(self) -> "QVec":
        """Componentwise extension inverse: conj / norm (zero -> zero)."""
        xp = self.re.xp
        nrm = self.re * self.re + self.re * self.im - self.im * self.im
        n_ints = nrm.to_ints()
        n_inv = FVec.from_ints(f128.batch_inv([int(v) for v in n_ints]),
                               xp)
        return QVec((self.re + self.im) * n_inv, (-self.im) * n_inv)

    def to_qelems(self) -> List[QElem]:
        re = [int(v) for v in self.re.to_ints()]
        im = [int(v) for v in self.im.to_ints()]
        return list(zip(re, im))


def _intt_ext(vals: Sequence[QElem], xp=_np) -> List[QElem]:
    """Coset-interpolate extension evaluations componentwise."""
    re = ntt.coset_interpolate(
        xp.asarray(limb.from_ints([v[0] for v in vals])), 1, xp)
    im = ntt.coset_interpolate(
        xp.asarray(limb.from_ints([v[1] for v in vals])), 1, xp)
    re_i = [int(v) for v in limb.to_ints(_np.asarray(re))]
    im_i = [int(v) for v in limb.to_ints(_np.asarray(im))]
    return list(zip(re_i, im_i))


def _eval_base_polys_at_ext(polys_ints: List[List[int]],
                            z: QElem) -> List[QElem]:
    """Evaluate base-coefficient polynomials at an extension point
    (Horner highest-coefficient-first)."""
    out = []
    for coeffs in polys_ints:
        acc: QElem = (0, 0)
        for c in reversed(coeffs):
            acc = f128q.mul(acc, z)
            acc = ((acc[0] + c) % P, acc[1])
        out.append(acc)
    return out


def _polys_to_int_rows(polys) -> List[List[int]]:
    """(C, n, 8) limb array -> C lists of n int coefficients."""
    h = _np.asarray(polys)
    return [[int(v) for v in limb.to_ints(h[c])] for c in range(h.shape[0])]


def _pack_list(vals: Sequence[QElem]) -> List[int]:
    return [f128q.pack(v) for v in vals]


def _unpack_list(vals: Sequence[int]) -> List[QElem]:
    return [f128q.unpack(v) for v in vals]


def _ext_row_leaf(row_packed: Sequence[int], partition_size: int) -> bytes:
    """Leaf hash for a row of packed extension values: interleaved base
    components, partitioned like a 2W-wide base row."""
    flat = f128q.flatten(_unpack_list(row_packed))
    return hash_row_host(flat, partition_size)


def _fri_leaf(v0: QElem, v1: QElem) -> bytes:
    return pos.hash_elements(f128q.flatten([v0, v1]))


def p_last_at_ext(n: int, z: QElem) -> QElem:
    g = f128.get_root_of_unity(n)
    gl = pow(g, n - 1, P)
    if z == (gl, 0):
        return (1, 0)
    num = f128q.sub(f128q.exp(z, n), f128q.ONE)
    den = f128q.mul_base(f128q.sub(z, (gl, 0)), n)
    return f128q.mul_base(f128q.mul(num, f128q.inv(den)), gl)


def group_divisor_at_ext(grp, n: int, z: QElem) -> QElem:
    g = f128.get_root_of_unity(n)
    if grp.is_single:
        return f128q.sub(z, (pow(g, grp.step, P), 0))
    k = n // 32
    zk = f128q.exp(z, k)
    prod = f128q.ONE
    for o in grp.offsets:
        prod = f128q.mul(prod, f128q.sub(zk, (pow(g, o * k, P), 0)))
    return prod


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------

def prove_trace_ext(trace, air, air_pi, options: ProofOptions,
                    device=None) -> StarkProof:
    assert options.field_extension == 2
    xp = _xp
    n = trace.length
    w = trace.width
    blowup = options.blowup
    N = n * blowup
    context = ProofContext(w, n, options)

    # 1. trace polynomials + LDE (base field, identical to the base path)
    cols_limbs = xp.asarray(trace.to_limbs())
    pows = ntt.powers_table(N.bit_length() - 1, xp)
    trace_polys = xp.stack([ntt.intt(cols_limbs[c], xp)
                            for c in range(w)])
    trace_lde = xp.stack([
        ntt.coset_evaluate(trace_polys[c], blowup, xp, pows=pows)
        for c in range(w)])

    ps_main = options.partition_size(w)
    rows = xp.transpose(trace_lde, (1, 0, 2))
    trace_comm = commit_rows(rows, ps_main, xp)

    coin = RandomCoin(context.to_elements() + air_pi.to_elements())
    coin.reseed(trace_comm.root)

    # 2. extension composition coefficients
    n_trans = air.num_transition_constraints()
    groups = group_assertions(air.get_assertions(), n,
                              options.per_assertion)
    alphas = draw_ext_many(coin, n_trans)
    betas = draw_ext_many(coin, len(groups))

    # 3. composition over the LDE domain.  Transition values are base
    # field; the extension linear combination is two base combinations
    # (re parts / im parts of the coefficients).
    periodic = air.periodic_lde(blowup, xp)
    cur = [FVec(trace_lde[c], xp) for c in range(w)]
    nxt = [FVec(xp.roll(trace_lde[c], -blowup, axis=0), xp)
           for c in range(w)]
    tvals = air.evaluate_transition(cur, nxt, periodic)

    comb_re = comb_im = None
    for a, tv in zip(alphas, tvals):
        tre = tv * Felt(a[0])
        tim = tv * Felt(a[1])
        comb_re = tre if comb_re is None else comb_re + tre
        comb_im = tim if comb_im is None else comb_im + tim
    z_inv = transition_zerofier_inv_lde(n, blowup, xp)
    comp = QVec(comb_re * z_inv, comb_im * z_inv)

    div_invs = group_divisor_inv_lde(groups, n, blowup, xp)
    for beta, grp, dinv in zip(betas, groups, div_invs):
        numer = (cur[grp.column] - Felt(grp.value)) * dinv
        comp = comp + QVec(numer * Felt(beta[0]), numer * Felt(beta[1]))

    # 4. interpolate; split into Q extension columns; commit interleaved
    Q = air.ce_blowup()
    q_polys_c = []
    q_lde_c = []
    for compo in (comp.re, comp.im):
        coeffs = ntt.coset_interpolate(compo.a, blowup, xp)
        qp = coeffs[:Q * n].reshape(Q, n, limb.NLIMB)
        q_polys_c.append(qp)
        q_lde_c.append(xp.stack([
            ntt.coset_evaluate(qp[i], blowup, xp, pows=pows)
            for i in range(Q)]))

    # interleaved rows (N, 2Q, 8): [q0re, q0im, q1re, q1im, ...]
    inter = xp.empty((2 * Q, N, limb.NLIMB), dtype=xp.uint32)
    inter[0::2] = q_lde_c[0]
    inter[1::2] = q_lde_c[1]
    ps_constraint = options.partition_size(2 * Q)
    q_rows = xp.transpose(inter, (1, 0, 2))
    constraint_comm = commit_rows(q_rows, ps_constraint, xp)
    coin.reseed(constraint_comm.root)

    # 5. OOD at extension point z
    z = draw_ext(coin)
    g_trace = f128.get_root_of_unity(n)
    zg = f128q.mul_base(z, g_trace)

    t_poly_ints = _polys_to_int_rows(trace_polys)
    q_poly_re_ints = _polys_to_int_rows(q_polys_c[0])
    q_poly_im_ints = _polys_to_int_rows(q_polys_c[1])

    def q_at(zz: QElem) -> List[QElem]:
        re_e = _eval_base_polys_at_ext(q_poly_re_ints, zz)
        im_e = _eval_base_polys_at_ext(q_poly_im_ints, zz)
        # H_j(z) = Hre_j(z) + φ·Him_j(z)
        phi: QElem = (0, 1)
        return [f128q.add(r, f128q.mul(phi, i))
                for r, i in zip(re_e, im_e)]

    ood_t_cur = _eval_base_polys_at_ext(t_poly_ints, z)
    ood_t_next = _eval_base_polys_at_ext(t_poly_ints, zg)
    ood_q_cur = q_at(z)
    ood_q_next = q_at(zg)
    ood_flat = f128q.flatten(ood_t_cur + ood_q_cur
                             + ood_t_next + ood_q_next)
    coin.reseed(pos.hash_elements(ood_flat))

    # 6. DEEP composition (extension), vectorized componentwise
    gammas = draw_ext_many(coin, w)
    deltas = draw_ext_many(coin, Q)

    gt = None
    for c in range(w):
        term = QVec(cur[c] * Felt(gammas[c][0]), cur[c] * Felt(gammas[c][1]))
        gt = term if gt is None else gt + term
    for j in range(Q):
        hj = QVec(FVec(q_lde_c[0][j], xp), FVec(q_lde_c[1][j], xp))
        gt = gt + hj * QFelt(deltas[j])

    def lincomb(coeffs_e: List[QElem], vals_e: List[QElem]) -> QElem:
        acc: QElem = (0, 0)
        for ce, ve in zip(coeffs_e, vals_e):
            acc = f128q.add(acc, f128q.mul(ce, ve))
        return acc

    gz = f128q.add(lincomb(gammas, ood_t_cur), lincomb(deltas, ood_q_cur))
    gzg = f128q.add(lincomb(gammas, ood_t_next),
                    lincomb(deltas, ood_q_next))

    xs_int = lde_points_host(n, blowup)
    x_vec = QVec.from_base(FVec.from_ints(xs_int, xp))
    inv_xz = (x_vec - QFelt(z)).inv()
    inv_xzg = (x_vec - QFelt(zg)).inv()
    deep = (gt - QFelt(gz)) * inv_xz + (gt - QFelt(gzg)) * inv_xzg

    # 7. FRI (extension values, base-field domain)
    num_layers = options.num_fri_layers(N)
    fri_layers_vals: List[List[QElem]] = []
    fri_comms: List[MerkleCommitment] = []
    layer = deep
    size = N
    inv2 = f128.inv(2)
    for d in range(num_layers):
        half = size // 2
        v0 = QVec(FVec(layer.re.a[:half], xp), FVec(layer.im.a[:half], xp))
        v1 = QVec(FVec(layer.re.a[half:], xp), FVec(layer.im.a[half:], xp))
        vals = layer.to_qelems()
        fri_layers_vals.append(vals)
        # leaf rows: (half, 4, 8) interleaved [v0re, v0im, v1re, v1im]
        rows4 = xp.stack([v0.re.a, v0.im.a, v1.re.a, v1.im.a], axis=1)
        comm = commit_rows(rows4, 4, xp)
        fri_comms.append(comm)
        coin.reseed(comm.root)
        alpha = draw_ext(coin)

        wd = f128.get_root_of_unity(size)
        x0s = []
        cx = OFFSET
        for _ in range(half):
            x0s.append(cx)
            cx = f128.mul(cx, wd)
        x0q = QVec.from_base(FVec.from_ints(x0s, xp))
        inv_2x0 = FVec.from_ints(
            [f128.mul(inv2, f128.inv(v)) for v in x0s], xp)
        a_q = QFelt(alpha)
        # v' = [v0(a+x0) - v1(a-x0)] / (2x0); a-x0 = -(x0-a)
        folded = (v0 * (x0q + a_q) + v1 * (x0q - a_q)) * inv_2x0
        layer = folded
        size = half

    rem = _intt_ext(layer.to_qelems(), xp)
    max_deg = options.fri_remainder_max_degree
    assert all(v == (0, 0) for v in rem[max_deg + 1:]), \
        "FRI remainder degree too high"
    fri_remainder = _pack_list(list(reversed(rem[:max_deg + 1])))

    # 8. grinding + positions
    pow_nonce = coin.grind(options.grinding_factor, device=device)
    positions = sorted(set(coin.draw_integers(
        options.num_queries, N, pow_nonce)))

    # 9. openings.  Trace rows are base values; in extension mode the
    # container packs every element (base values pack with im = 0).
    rows_host = _np.asarray(rows)
    q_rows_host = _np.asarray(q_rows)

    from . import multiproof

    def open_trace(idxs) -> QueryOpenings:
        out_rows, out_paths = [], []
        for p_ in idxs:
            row = [int(v) for v in limb.to_ints(rows_host[p_])]
            out_rows.append(row)
            out_paths.append(trace_comm.open(p_))
        return QueryOpenings(out_rows, out_paths,
                             multiproof.compress(idxs, out_paths))

    def open_constraint(idxs) -> QueryOpenings:
        out_rows, out_paths = [], []
        for p_ in idxs:
            flat = [int(v) for v in limb.to_ints(q_rows_host[p_])]
            packed = [f128q.pack((flat[2 * j], flat[2 * j + 1]))
                      for j in range(Q)]
            out_rows.append(packed)
            out_paths.append(constraint_comm.open(p_))
        return QueryOpenings(out_rows, out_paths,
                             multiproof.compress(idxs, out_paths))

    trace_open = open_trace(positions)
    constraint_open = open_constraint(positions)

    fri_open: List[FriLayerOpenings] = []
    pos_d = positions
    size_d = N
    for d in range(num_layers):
        half = size_d // 2
        folded_idx = []
        for p_ in pos_d:
            m = p_ % half
            if m not in folded_idx:
                folded_idx.append(m)
        vals = fri_layers_vals[d]
        pairs, paths = [], []
        for m in folded_idx:
            pairs.append((f128q.pack(vals[m]), f128q.pack(vals[half + m])))
            paths.append(fri_comms[d].open(m))
        fri_open.append(FriLayerOpenings(
            pairs, paths, multiproof.compress(folded_idx, paths)))
        pos_d = folded_idx
        size_d = half

    return StarkProof(
        context=context,
        trace_root=trace_comm.root,
        constraint_root=constraint_comm.root,
        ood_trace_current=_pack_list(ood_t_cur),
        ood_trace_next=_pack_list(ood_t_next),
        ood_quotient_current=_pack_list(ood_q_cur),
        ood_quotient_next=_pack_list(ood_q_next),
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

def replay_challenges_ext(proof: StarkProof, air, air_pi) -> dict:
    options = proof.context.options
    n = proof.context.trace_len
    N = n * options.blowup
    w = proof.context.trace_width
    Q = air.ce_blowup()

    coin = RandomCoin(proof.context.to_elements() + air_pi.to_elements())
    coin.reseed(proof.trace_root)
    alphas = draw_ext_many(coin, air.num_transition_constraints())
    groups = group_assertions(air.get_assertions(), n,
                              options.per_assertion)
    betas = draw_ext_many(coin, len(groups))
    coin.reseed(proof.constraint_root)
    z = draw_ext(coin)
    ood_flat = f128q.flatten(_unpack_list(
        proof.ood_trace_current + proof.ood_quotient_current
        + proof.ood_trace_next + proof.ood_quotient_next))
    coin.reseed(pos.hash_elements(ood_flat))
    gammas = draw_ext_many(coin, w)
    deltas = draw_ext_many(coin, Q)
    fri_alphas = []
    for root in proof.fri_roots:
        coin.reseed(root)
        fri_alphas.append(draw_ext(coin))
    pow_ok = (coin.check_leading_zeros(proof.pow_nonce)
              >= options.grinding_factor)
    positions = sorted(set(coin.draw_integers(
        options.num_queries, N, proof.pow_nonce)))
    from .stark import expand_proof_openings
    expand_proof_openings(proof, positions)
    return dict(alphas=alphas, betas=betas, groups=groups, z=z,
                gammas=gammas, deltas=deltas, fri_alphas=fri_alphas,
                pow_ok=pow_ok, positions=positions)


def verify_trace_ext(proof: StarkProof, air_pi, min_security_bits: int = 0,
                     air=None) -> None:
    options = proof.context.options
    assert options.field_extension == 2
    n = proof.context.trace_len
    w = proof.context.trace_width
    blowup = options.blowup
    N = n * blowup

    from .params import estimate_conjectured_security_bits
    if min_security_bits and (estimate_conjectured_security_bits(options)
                              < min_security_bits):
        raise VerifyError("proof options below required security level")

    if air is None:
        from ..air.zk_air import ZkLispAir
        air = ZkLispAir(w, n, air_pi)
    Q = air.ce_blowup()
    num_layers = options.num_fri_layers(N)

    if (len(proof.ood_trace_current) != w
            or len(proof.ood_quotient_current) != Q):
        raise VerifyError("OOD frame width mismatch")
    if len(proof.fri_roots) != num_layers:
        raise VerifyError("FRI layer count mismatch")

    ch = replay_challenges_ext(proof, air, air_pi)
    alphas, betas, groups = ch["alphas"], ch["betas"], ch["groups"]
    z, gammas, deltas = ch["z"], ch["gammas"], ch["deltas"]
    fri_alphas, positions = ch["fri_alphas"], ch["positions"]
    if not ch["pow_ok"]:
        raise VerifyError("pow nonce does not satisfy grinding factor")
    if len(positions) != proof.num_unique_queries():
        raise VerifyError("query position count mismatch")

    # --- OOD consistency (extension scalars through the AIR) ---
    g_trace = f128.get_root_of_unity(n)
    zg = f128q.mul_base(z, g_trace)
    ood_t_cur = _unpack_list(proof.ood_trace_current)
    ood_t_next = _unpack_list(proof.ood_trace_next)
    ood_q_cur = _unpack_list(proof.ood_quotient_current)
    ood_q_next = _unpack_list(proof.ood_quotient_next)

    curq = [QFelt(v) for v in ood_t_cur]
    nxtq = [QFelt(v) for v in ood_t_next]
    # Only single-periodic AIRs (p_last) are supported on the extension
    # path; the aggregation AIR is the sole user (prove.rs:732-800).
    assert len(air.periodic_values_at_row(0)) == 1, \
        "extension path supports single-periodic (p_last) AIRs only"
    periodic_z = [QFelt(p_last_at_ext(n, z))]
    tvals = air.evaluate_transition(curq, nxtq, periodic_z)
    comb: QElem = (0, 0)
    for a, tv in zip(alphas, tvals):
        comb = f128q.add(comb, f128q.mul(a, QFelt(tv).v))
    zn = f128q.exp(z, n)
    g_last = pow(g_trace, n - 1, P)
    z_div = f128q.mul(f128q.sub(zn, f128q.ONE),
                      f128q.inv(f128q.sub(z, (g_last, 0))))
    lhs = f128q.mul(comb, f128q.inv(z_div))
    for beta, grp in zip(betas, groups):
        numer = f128q.sub(ood_t_cur[grp.column], (grp.value, 0))
        term = f128q.mul(f128q.mul(beta, numer),
                         f128q.inv(group_divisor_at_ext(grp, n, z)))
        lhs = f128q.add(lhs, term)

    rhs: QElem = (0, 0)
    z_pow_n = f128q.exp(z, n)
    zi: QElem = f128q.ONE
    for j in range(Q):
        rhs = f128q.add(rhs, f128q.mul(zi, ood_q_cur[j]))
        zi = f128q.mul(zi, z_pow_n)
    if not f128q.eq(lhs, rhs):
        raise VerifyError("OOD constraint composition mismatch (ext)")

    # --- query openings: Merkle checks ---
    ps_main = options.partition_size(w)
    ps_constraint = options.partition_size(2 * Q)
    for k, p_ in enumerate(positions):
        row = proof.trace_openings.rows[k]
        if len(row) != w:
            raise VerifyError("trace opening width mismatch")
        if any(v >> 128 for v in row):
            raise VerifyError("trace opening not in base field")
        leaf = hash_row_host([v % P for v in row], ps_main)
        if not verify_opening(proof.trace_root, leaf, p_,
                              proof.trace_openings.paths[k]):
            raise VerifyError(f"trace Merkle path invalid at {p_}")
        qrow = proof.constraint_openings.rows[k]
        if len(qrow) != Q:
            raise VerifyError("constraint opening width mismatch")
        leaf = _ext_row_leaf(qrow, ps_constraint)
        if not verify_opening(proof.constraint_root, leaf, p_,
                              proof.constraint_openings.paths[k]):
            raise VerifyError(f"constraint Merkle path invalid at {p_}")

    # --- DEEP at query positions vs FRI layer 0 ---
    wN = f128.get_root_of_unity(N)

    def lincomb(coeffs_e, vals_e) -> QElem:
        acc: QElem = (0, 0)
        for ce, ve in zip(coeffs_e, vals_e):
            acc = f128q.add(acc, f128q.mul(ce, ve))
        return acc

    gz = f128q.add(lincomb(gammas, ood_t_cur), lincomb(deltas, ood_q_cur))
    gzg = f128q.add(lincomb(gammas, ood_t_next),
                    lincomb(deltas, ood_q_next))

    half0 = N // 2
    folded0 = []
    for p_ in positions:
        m = p_ % half0
        if m not in folded0:
            folded0.append(m)
    layer0 = proof.fri_openings[0]

    for k, p_ in enumerate(positions):
        x = f128.mul(pow(wN, p_, P), OFFSET)
        gt: QElem = (0, 0)
        for c in range(w):
            gt = f128q.add(gt, f128q.mul_base(
                gammas[c], proof.trace_openings.rows[k][c] % P))
        for j in range(Q):
            gt = f128q.add(gt, f128q.mul(
                deltas[j], f128q.unpack(
                    proof.constraint_openings.rows[k][j])))
        y = f128q.add(
            f128q.mul(f128q.sub(gt, gz),
                      f128q.inv(f128q.sub((x, 0), z))),
            f128q.mul(f128q.sub(gt, gzg),
                      f128q.inv(f128q.sub((x, 0), zg))))
        m = p_ % half0
        elem = p_ // half0
        fi = folded0.index(m)
        q0 = f128q.unpack(layer0.pairs[fi][elem])
        if not f128q.eq(y, q0):
            raise VerifyError(f"DEEP vs FRI layer-0 mismatch at {p_}")

    # --- FRI verification ---
    pos_d = positions
    size_d = N
    folding_root = pow(wN, N // 2, P)
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
        for i, m in enumerate(folded):
            v0 = f128q.unpack(layer.pairs[i][0])
            v1 = f128q.unpack(layer.pairs[i][1])
            leaf = _fri_leaf(v0, v1)
            if not verify_opening(proof.fri_roots[d], leaf, m,
                                  layer.paths[i]):
                raise VerifyError(f"FRI layer {d} Merkle invalid at {m}")
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
            v0 = f128q.unpack(layer.pairs[i][0])
            v1 = f128q.unpack(layer.pairs[i][1])
            xe = f128.mul(pow(gen_d, m, P), OFFSET)
            x0 = (xe, 0)
            x1 = (f128.mul(xe, folding_root), 0)
            num = f128q.sub(
                f128q.mul(v1, f128q.sub(alpha, x0)),
                f128q.mul(v0, f128q.sub(alpha, x1)))
            vnext = f128q.mul(num, f128q.inv(f128q.sub(x1, x0)))
            if d + 1 < num_layers:
                mm = m % nxt_half
                elem = m // nxt_half
                fi = folded_next.index(mm)
                exp_v = f128q.unpack(next_layer.pairs[fi][elem])
                if not f128q.eq(vnext, exp_v):
                    raise VerifyError(
                        f"FRI fold mismatch depth {d} pos {m} (ext)")
            else:
                gen_rem = pow(gen_d, 2, P)
                x_l = f128.mul(OFFSET, pow(gen_rem, m, P))
                acc: QElem = (0, 0)
                for coeff in proof.fri_remainder:
                    acc = f128q.add(f128q.mul_base(acc, x_l),
                                    f128q.unpack(coeff))
                if not f128q.eq(vnext, acc):
                    raise VerifyError(
                        f"FRI remainder mismatch at {m} (ext)")
        pos_d = folded
        size_d = half
        gen_d = pow(gen_d, 2, P)
