"""Batched per-child aggregation verification math.

The aggregation trace builder re-verifies every child at every query:
Merkle root recomputation, the DEEP composition, FRI layer-1 and
full-path fold aggregates (agg/trace.rs:1126-1258 and friends).  This
module computes those values for every same-shaped child in a handful of
vectorized limb calls on the aggregation's torch device: on the CUDA card
the leaf and Merkle re-hash goes through the poseidon12 kernel, on the
CPU the same tensor code runs each kernel's plain version.

Children of one shape (trace size, width, options, number of distinct
queries, number of FRI layers) form one batch; the FRI layers' counts of distinct folded
positions may differ between them, since the fold math builds one flat
list of folds over all children.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as _np
import torch

from ..crypto import poseidon_torch as pt
from ..field import f128
from ..field import limb as tl
from ..field import limb_host as limb
from ..prove.formats import StepProof

P = f128.P
NL = limb.NLIMB


def _to_dev(a, dev) -> torch.Tensor:
    """A numpy limb (or bool) array as a tensor on `dev`."""
    a = _np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a).to(dev)
    return tl.from_numpy(a, dev)


def _to_ints(t: torch.Tensor):
    """Limb tensor -> array of Python ints (on the host)."""
    return limb.to_ints(t.detach().cpu().numpy().astype(_np.uint32))


def _fold_positions(positions, domain):
    half = domain // 2
    out = []
    for p_ in positions:
        m = p_ % half
        if m not in out:
            out.append(m)
    return out


def _shape_key(step: StepProof, ch: dict) -> tuple:
    inner = step.proof.inner
    return (inner.context.trace_width, inner.context.trace_len,
            inner.context.options, len(inner.ood_quotient_current),
            len(ch["positions"]), len(inner.fri_openings))


def _from_ints_2d(rows: List[List[int]]) -> _np.ndarray:
    return _np.asarray(limb.from_ints(rows), dtype=_np.uint32)


def _merkle_errors_batch(steps, chs, dev) -> List[Tuple[int, int]]:
    """(t_err, c_err) per child: leaf hashes + path re-merges batched
    across ALL children (one vectorized sponge per tree level)."""
    B = len(steps)
    inner0 = steps[0].proof.inner
    opts = inner0.context.options
    w = inner0.context.trace_width
    Q = len(inner0.ood_quotient_current)
    nq = len(chs[0]["positions"])
    ps_main = opts.partition_size(w)
    ps_con = opts.partition_size(Q)

    def roots_for(openings_rows, paths, ps):
        # leaves: (B*nq, width, 8) -> one partitioned row hash
        rows = _np.stack([_from_ints_2d(openings_rows(i))
                          for i in range(B)]).reshape(B * nq, -1, NL)
        acc = pt.hash_rows_partitioned(_to_dev(rows, dev), ps)
        depth = len(paths(0)[0])
        idx = _np.concatenate(
            [_np.asarray(chs[i]["positions"], dtype=_np.int64)
             for i in range(B)])
        for d in range(depth):
            sib = _np.stack([
                limb.from_ints([f128.fold_bytes32_to_fe(p[d])
                                for p in paths(i)])
                for i in range(B)]).reshape(B * nq, NL)
            sib = _to_dev(sib, dev)
            right = _to_dev((idx & 1).astype(bool), dev)
            first = torch.where(right[:, None], sib, acc)
            second = torch.where(right[:, None], acc, sib)
            pairs = torch.stack([first, second], dim=1)
            acc = pt.sponge_fes(pairs, b"zkl/winter/hash/merge")
            idx = idx >> 1
        return _to_ints(acc).reshape(B, nq)

    t_roots = roots_for(
        lambda i: steps[i].proof.inner.trace_openings.rows,
        lambda i: steps[i].proof.inner.trace_openings.paths, ps_main)
    c_roots = roots_for(
        lambda i: steps[i].proof.inner.constraint_openings.rows,
        lambda i: steps[i].proof.inner.constraint_openings.paths, ps_con)

    out = []
    for i, s in enumerate(steps):
        inner = s.proof.inner
        t_exp = f128.fold_bytes32_to_fe(inner.trace_root)
        c_exp = f128.fold_bytes32_to_fe(inner.constraint_root)
        t_err = int(sum(int(r) - t_exp for r in t_roots[i]) % P)
        c_err = int(sum(int(r) - c_exp for r in c_roots[i]) % P)
        out.append((t_err, c_err))
    return out


def _deep_aggs_batch(steps, chs, beta: int, dev) -> List[int]:
    """DEEP vs FRI layer-0 aggregate per child
    (compute_deep_agg_over_queries): one fused linear combination and one
    batched inversion for all children x queries."""
    B = len(steps)
    inner0 = steps[0].proof.inner
    if not inner0.fri_openings:
        return [0] * B
    n = inner0.context.trace_len
    w = inner0.context.trace_width
    N = n * inner0.context.options.blowup
    Q = len(inner0.ood_quotient_current)
    nq = len(chs[0]["positions"])
    wN = f128.get_root_of_unity(N)
    gN = f128.get_root_of_unity(n)

    rows = _np.stack([
        _np.concatenate([_from_ints_2d(s.proof.inner.trace_openings.rows),
                         _from_ints_2d(
                             s.proof.inner.constraint_openings.rows)],
                        axis=1)
        for s in steps])                              # (B, nq, w+Q, 8)
    coeffs = _np.stack([
        limb.from_ints(chs[i]["gammas"] + chs[i]["deltas"])
        for i in range(B)])                           # (B, w+Q, 8)

    # host scalars per child
    gz_l, gzg_l, z_l, zg_l = [], [], [], []
    for i, s in enumerate(steps):
        inner = s.proof.inner
        ch = chs[i]
        gammas, deltas = ch["gammas"], ch["deltas"]
        gz = (sum(g * t for g, t in zip(gammas, inner.ood_trace_current))
              + sum(d * q for d, q in
                    zip(deltas, inner.ood_quotient_current))) % P
        gzg = (sum(g * t for g, t in zip(gammas, inner.ood_trace_next))
               + sum(d * q for d, q in
                     zip(deltas, inner.ood_quotient_next))) % P
        gz_l.append(gz)
        gzg_l.append(gzg)
        z_l.append(ch["z"])
        zg_l.append(f128.mul(ch["z"], gN))

    xs = _np.stack([
        limb.from_ints([f128.mul(pow(wN, p_, P), 3)
                        for p_ in chs[i]["positions"]])
        for i in range(B)])                           # (B, nq, 8)

    rows_d = _to_dev(rows, dev)
    coeffs_d = _to_dev(coeffs, dev)
    gt = tl.dot(rows_d.reshape(B * nq, w + Q, NL),
                coeffs_d[:, None].expand(rows.shape
                                         ).reshape(B * nq, w + Q, NL))

    z_d = _to_dev(limb.from_ints(z_l), dev)
    zg_d = _to_dev(limb.from_ints(zg_l), dev)
    xs_d = _to_dev(xs, dev).reshape(B * nq, NL)
    diffs = torch.cat(
        [tl.sub(xs_d, torch.repeat_interleave(z_d, nq, dim=0)),
         tl.sub(xs_d, torch.repeat_interleave(zg_d, nq, dim=0))])
    # batch_inv_tree needs a power-of-two batch: pad with ones
    total = diffs.shape[0]
    padded = 1 << (total - 1).bit_length()
    if padded != total:
        diffs = torch.cat(
            [diffs, _to_dev(limb.from_ints([1] * (padded - total)), dev)])
    invs = tl.batch_inv_tree(diffs)
    inv_xz, inv_xzg = invs[:B * nq], invs[B * nq:2 * B * nq]

    gz_d = torch.repeat_interleave(_to_dev(limb.from_ints(gz_l), dev), nq,
                                   dim=0)
    gzg_d = torch.repeat_interleave(_to_dev(limb.from_ints(gzg_l), dev), nq,
                                    dim=0)
    y = tl.add(tl.mul(tl.sub(gt, gz_d), inv_xz),
               tl.mul(tl.sub(gt, gzg_d), inv_xzg))
    y_h = _to_ints(y).reshape(B, nq)

    out = []
    half0 = N // 2
    for i, s in enumerate(steps):
        positions = chs[i]["positions"]
        folded0 = _fold_positions(positions, N)
        pairs0 = s.proof.inner.fri_openings[0].pairs
        agg, beta_pow = 0, 1
        for k, p_ in enumerate(positions):
            q0 = pairs0[folded0.index(p_ % half0)][p_ // half0]
            agg = (agg + beta_pow * ((int(y_h[i][k]) - q0) % P)) % P
            beta_pow = beta_pow * beta % P
        out.append(agg)
    return out


def _fri_folds_batch(steps, chs, beta_l1: int, delta: int,
                     beta_paths: int, dev):
    """Batched FRI fold verification values for all children.

    Computes, per child, the layer-1 aggregate, the single-path aggregate
    (compute_fri_path_agg_over_layers at sample 0), and the aggregate over
    all paths.  All folds across (children,
    depths, paths) are evaluated in one vectorized pass; the
    inverse 1/(x1 - x0) = inv(-6) * gen^-m is a host power (x1 = -x0
    on the folding coset), so no batched inversion is needed."""
    B = len(steps)
    inner0 = steps[0].proof.inner
    num_layers = len(inner0.fri_openings)
    if num_layers < 2:
        return [(0, 0, 0)] * B

    N = inner0.context.trace_len * inner0.context.options.blowup
    wN = f128.get_root_of_unity(N)
    # vnext = num/(x1-x0) with x1 = -x0 rewrites to
    # [v0(a+x0) - v1(a-x0)]/(2*x0); x0 = 3*gen^m => 1/(2x0) =
    # inv(6) * gen^-m, a host power — no batched inversion needed
    inv_6 = f128.inv(6)

    # collect every (child, depth, path) fold into flat arrays
    v0s, v1s, alphas, x0s, inv2x0s = [], [], [], [], []
    meta = []        # (child, depth, m, q_next or None at last depth)
    for i, s in enumerate(steps):
        inner = s.proof.inner
        positions_d = list(chs[i]["positions"])
        domain_d = N
        gen_d = wN
        for depth in range(num_layers):
            folded = _fold_positions(positions_d, domain_d)
            pairs = inner.fri_openings[depth].pairs
            inv_gen = f128.inv(gen_d)
            if depth + 1 < num_layers:
                folded_next = _fold_positions(folded, domain_d // 2)
                next_pairs = inner.fri_openings[depth + 1].pairs
                half_next = domain_d // 4
            for k, m in enumerate(folded):
                v0, v1 = pairs[k]
                x0 = f128.mul(pow(gen_d, m, P), 3)
                v0s.append(v0)
                v1s.append(v1)
                alphas.append(chs[i]["fri_alphas"][depth])
                x0s.append(x0)
                inv2x0s.append(f128.mul(inv_6, pow(inv_gen, m, P)))
                if depth + 1 < num_layers:
                    q_next = next_pairs[
                        folded_next.index(m % half_next)][m // half_next]
                else:
                    q_next = None
                meta.append((i, depth, k, m, q_next))
            positions_d = folded
            domain_d //= 2
            gen_d = pow(gen_d, 2, P)

    F = len(v0s)
    v0_d = _to_dev(limb.from_ints(v0s), dev)
    v1_d = _to_dev(limb.from_ints(v1s), dev)
    a_d = _to_dev(limb.from_ints(alphas), dev)
    x0_d = _to_dev(limb.from_ints(x0s), dev)
    i2_d = _to_dev(limb.from_ints(inv2x0s), dev)
    # vnext = [v0*(a+x0) - v1*(a-x0)] / (2*x0)   (x1 = -x0)
    num1 = tl.mul(v0_d, tl.add(a_d, x0_d))
    num2 = tl.mul(v1_d, tl.sub(a_d, x0_d))
    vnext = tl.mul(tl.sub(num1, num2), i2_d)
    vnext_h = _to_ints(vnext)

    # remainder evaluations for last-depth folds (host Horner; few)
    out = []
    ptr_by_child: Dict[int, List[Tuple]] = {i: [] for i in range(B)}
    for idx, m_ in enumerate(meta):
        ptr_by_child[m_[0]].append((idx, m_))

    for i, s in enumerate(steps):
        inner = s.proof.inner
        folds = ptr_by_child[i]
        # layer-1 aggregate: depth-0 folds in folded0 order
        l1_agg, beta_pow = 0, 1
        for idx, (_, depth, k, m, q_next) in folds:
            if depth != 0:
                continue
            l1_agg = (l1_agg + beta_pow
                      * ((int(vnext_h[idx]) - q_next) % P)) % P
            beta_pow = beta_pow * beta_l1 % P

        # per-path aggregates (path k folds at every depth)
        min_paths = min((len(lo.pairs) for lo in inner.fri_openings
                         if lo.pairs), default=0)
        gen_rem = pow(wN, 1 << num_layers, P)
        path_aggs = []
        for k in range(min_paths):
            agg, delta_pow = 0, 1
            v_rem = pos_rem = 0
            for idx, (_, depth, kk, m, q_next) in folds:
                if kk != k:
                    continue
                if q_next is not None:
                    agg = (agg + delta_pow
                           * ((int(vnext_h[idx]) - q_next) % P)) % P
                    delta_pow = delta_pow * delta % P
                else:
                    v_rem, pos_rem = int(vnext_h[idx]), m
            x_l = f128.mul(3, pow(gen_rem, pos_rem, P))
            acc = 0
            for coeff in inner.fri_remainder:
                acc = (acc * x_l + coeff) % P
            agg = (agg + delta_pow * ((v_rem - acc) % P)) % P
            path_aggs.append(agg)

        paths_agg, beta_pow = 0, 1
        for a in path_aggs:
            paths_agg = (paths_agg + beta_pow * a) % P
            beta_pow = beta_pow * beta_paths % P
        out.append((l1_agg, path_aggs[0] if path_aggs else 0, paths_agg))
    return out


def child_work_batch(steps: Sequence[StepProof], chs: Sequence[dict],
                     beta_deep: int, beta_l1: int, delta_depth: int,
                     beta_paths: int, device) -> List[dict]:
    """The re-verification values of ONE shape group of children, one
    dict per child, computed on the torch `device` (on a CUDA card every
    Poseidon permutation is a poseidon12 launch; on `"cpu"` the same
    tensor code runs each kernel's plain version)."""
    from . import aggregate as agg
    dev = torch.device(device)
    merr = _merkle_errors_batch(steps, chs, dev)
    deeps = _deep_aggs_batch(steps, chs, beta_deep, dev)
    folds = _fri_folds_batch(steps, chs, beta_l1, delta_depth,
                             beta_paths, dev)
    out = []
    for i, s in enumerate(steps):
        l1, path0, paths = folds[i]
        out.append({
            "t_err": merr[i][0], "c_err": merr[i][1],
            "deep": deeps[i],
            "l1": l1,
            "path": (path0
                     if len(s.proof.inner.fri_openings) >= 2 else 0),
            "paths": paths,
            "sample": agg._sample_fri_fold(s, chs[i]),
        })
    return out


def group_children(steps: Sequence[StepProof],
                   chs: Sequence[dict]) -> List[List[int]]:
    """Indices of same-shaped children (batch groups)."""
    groups: Dict[tuple, List[int]] = {}
    for i, s in enumerate(steps):
        groups.setdefault(_shape_key(s, chs[i]), []).append(i)
    return list(groups.values())
