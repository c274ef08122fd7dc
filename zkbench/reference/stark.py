"""The benchmark's own check of the STARK inside each step proof, from the
proof's bytes alone: the openings that tie the committed trace, the
constraint composition and every FRI layer to the out-of-domain frame and
to the statement (zk-lisp's winterfell proofs; the transcript order of
zk-lisp src/agg/fs.rs).

For every step proof it

- replays Fiat-Shamir with its own hasher (reference/hasher.py): the seed
  from the proof context and the AIR's public inputs, the composition
  coefficients, the out-of-domain point z, the DEEP coefficients, one
  folding challenge per FRI root, the proof-of-work nonce against the
  grinding factor, and the query positions;
- evaluates the AIR (reference/air.py) on the out-of-domain frame and
  checks it against the constraint composition's columns at z: the
  composition a wave computes is wrong exactly where this fails;
- rebuilds the trace, constraint and every FRI layer's Merkle root from
  the opened rows and the multiproof's nodes: a low-degree extension
  that is not the committed trace's fails here or below;
- checks the DEEP composition of each opened row against FRI layer 0, each
  FRI fold against the next layer, and the last fold against the
  remainder polynomial, whose degree it bounds.

`check(steps, rounds, device)` returns, for each step proof, a count of
disagreements under each of `NUMBERS`.  All steps of a run go through
the hasher together, one batched permutation a step of the transcript or
a level of the trees.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from . import air as zair
from .field import COSET_OFFSET, P, fold32, inv, root_of_unity
from .hasher import Hasher
from .layout import Columns, LayoutConfig, VM_USAGE_SPONGE
from .poseidon2 import fe_bytes

NUMBERS = ("fiat_shamir", "ood_air", "merkle", "deep", "fri")
CYCLE = 32


# ---------------------------------------------------------------------------
# the statement: the AIR's public inputs and boundary groups of a step
# ---------------------------------------------------------------------------

def effective_mask(step: dict) -> int:
    """The feature mask the prover used for a segment: RAM and Merkle
    trims show in the trace width, the sponge in the usage mask
    (zk-lisp prove.rs, segment layouts)."""
    width = step["inner"]["width"]
    base = step["feature_mask"]
    if width >= Columns(LayoutConfig()).width():
        return base
    rom = any(step["program_id"])
    found = None
    for ram in (True, False):
        for merkle in (True, False):
            cfg = LayoutConfig(vm=True, ram=ram, sponge=True, merkle=merkle,
                               rom=rom)
            if found is None and Columns(cfg).width() == width:
                found = (ram, merkle)
    if found is None:
        raise ValueError("no segment layout has this width")
    ram, merkle = found
    sponge = (bool(base & zair.FM_SPONGE)
              and bool(step["usage_mask"] & (1 << VM_USAGE_SPONGE)))
    mask = zair.FM_VM | (base & zair.FM_VM_EXPECT)
    if ram and base & zair.FM_RAM:
        mask |= zair.FM_RAM
    if sponge:
        mask |= zair.FM_SPONGE
    if merkle and base & zair.FM_MERKLE:
        mask |= zair.FM_MERKLE
    if (sponge or (merkle and base & zair.FM_MERKLE)) \
            and base & zair.FM_POSEIDON:
        mask |= zair.FM_POSEIDON
    return mask


def air_of(step: dict) -> zair.ZkLispAir:
    if step["n_args"]:
        raise ValueError("the benchmark's programs take no arguments")

    def fe(k):
        return int.from_bytes(step[k][:16], "little") % P
    core = zair.Core(step["program_id"], step["program_commitment"],
                     step["merkle_root"], step["feature_mask"])
    pi = zair.AirPublicInputs(
        core=core, segment_feature_mask=effective_mask(step),
        rom_acc=tuple(int.from_bytes(b[:16], "little") % P
                      for b in step["rom_acc"]),
        pc_init=fe("pc_init"),
        ram_gp_unsorted_in=fe("gp_unsorted_in"),
        ram_gp_unsorted_out=fe("gp_unsorted_out"),
        ram_gp_sorted_in=fe("gp_sorted_in"),
        ram_gp_sorted_out=fe("gp_sorted_out"),
        rom_s_in=tuple(fe(f"rom_in_{k}") for k in range(3)),
        rom_s_out=tuple(fe(f"rom_out_{k}") for k in range(3)),
        vm_usage_mask=step["usage_mask"],
        ram_delta_clk_bits=step["ram_delta_clk_bits"])
    i = step["inner"]
    return zair.ZkLispAir(i["width"], i["length"], pi)


def groups_of(assertions, n: int) -> list:
    """Boundary assertions batched as the prover's composition batches
    them: one group per (column, value) whose steps repeat every 32 rows
    at the same offsets on every level, else one group per step.  A
    group is (column, value, offsets, step); step -1 for a periodic one."""
    by_cv: Dict[tuple, list] = {}
    for col, step, val in assertions:
        by_cv.setdefault((col, val), []).append(step)
    levels = n // CYCLE
    out = []
    for (col, val), steps in by_cv.items():
        sset = set(steps)
        offsets = tuple(sorted({s % CYCLE for s in steps}))
        if (levels > 0 and len(steps) == len(offsets) * levels
                and all(o + CYCLE * k in sset
                        for o in offsets for k in range(levels))):
            out.append((col, val, offsets, -1))
        else:
            out += [(col, val, (), s) for s in sorted(steps)]
    return out


def divisor_at(group, n: int, z: int) -> int:
    """The group's zerofier at z: (z - g^step), or for a periodic group
    the product over its offsets o of (z^(n/32) - g^(o n/32))."""
    g = root_of_unity(n)
    _, _, offsets, step = group
    if step >= 0:
        return (z - pow(g, step, P)) % P
    k = n // CYCLE
    zk = pow(z, k, P)
    out = 1
    for o in offsets:
        out = out * ((zk - pow(g, o * k, P)) % P) % P
    return out


def seed_elements(i: dict, pi: zair.AirPublicInputs) -> List[int]:
    """The proof context and options, then the AIR's public inputs."""
    return ([1, i["width"], i["length"], P % (1 << 64),
             i["queries"], i["blowup"], i["grind"], i["ext"], i["folding"],
             i["remainder_degree"]] + pi.to_elements())


# ---------------------------------------------------------------------------
# batched hashing over the steps
# ---------------------------------------------------------------------------

def _by_length(fn, items: Sequence[Sequence[int]]) -> List[int]:
    """fn over items, one call for each length that occurs."""
    out: List[int] = [0] * len(items)
    groups: Dict[int, List[int]] = {}
    for k, it in enumerate(items):
        groups.setdefault(len(it), []).append(k)
    for ks in groups.values():
        for k, v in zip(ks, fn([items[k] for k in ks])):
            out[k] = v
    return out


class Coins:
    """winterfell's random coins of many proofs, stepped together: a
    reseed merges the digest into the seed; the k-th draw after it is
    merge_with_int(seed, k), a field element."""

    def __init__(self, h: Hasher, seeds: Sequence[Sequence[int]]) -> None:
        self.h = h
        self.seed = _by_length(h.hash_elements, seeds)

    def reseed(self, digests: Dict[int, int]) -> None:
        """Coin k merges digests[k] into its seed."""
        ks = list(digests)
        for k, v in zip(ks, self.h.merge([(self.seed[k], digests[k])
                                          for k in ks])):
            self.seed[k] = v

    def draws(self, counts: Sequence[int]) -> List[List[int]]:
        flat_s, flat_k = [], []
        for s, c in zip(self.seed, counts):
            flat_s += [s] * c
            flat_k += range(1, c + 1)
        vals = self.h.merge_with_int(flat_s, flat_k)
        out, at = [], 0
        for c in counts:
            out.append(vals[at:at + c])
            at += c
        return out


def merkle_roots(h: Hasher, trees: Sequence[tuple]) -> List[object]:
    """The root each tree's opening proves, or None where the multiproof
    does not fit its positions.  A tree is (depth, positions, leaves,
    nodes): nodes[level] lists, in ascending index order, the sibling of
    every known index whose sibling is not known."""
    known = []
    alive = []
    for depth, positions, leaves, nodes in trees:
        ok = len(nodes) == depth and len(positions) == len(leaves) > 0
        known.append(dict(zip(positions, leaves)) if ok else {})
        alive.append(ok)
    for level in range(max((t[0] for t in trees), default=0)):
        jobs = []                                  # (tree, parent index)
        for t, (depth, _, _, nodes) in enumerate(trees):
            if not alive[t] or level >= depth:
                continue
            kn = known[t]
            it = iter(nodes[level])
            for idx in sorted(kn):
                if idx ^ 1 not in kn:
                    sib = next(it, None)
                    if sib is None or sib[16:] != bytes(16):
                        alive[t] = False
                        break
                    kn[idx ^ 1] = fold32(sib)
            if alive[t] and next(it, None) is not None:
                alive[t] = False
            if alive[t]:
                jobs += [(t, p) for p in sorted({i >> 1 for i in kn})]
        merged = h.merge([(known[t][2 * p], known[t][2 * p + 1])
                          for t, p in jobs]) if jobs else []
        fresh: Dict[int, dict] = {}
        for (t, p), v in zip(jobs, merged):
            fresh.setdefault(t, {})[p] = v
        for t in fresh:
            known[t] = fresh[t]
    return [known[t].get(0) if alive[t] and len(known[t]) == 1 else None
            for t in range(len(trees))]


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def _fold_positions(positions: Sequence[int], half: int) -> List[int]:
    out = []
    for p in positions:
        if p % half not in out:
            out.append(p % half)
    return out


def check(steps: Sequence[dict], rounds: int, device="cpu") -> List[dict]:
    """{number: count} for every step proof (codec.step dicts)."""
    h = Hasher(rounds, device)
    S = len(steps)
    counts = [dict.fromkeys(NUMBERS, 0) for _ in range(S)]
    if not S:
        return counts
    inn = [s["inner"] for s in steps]
    airs = [air_of(s) for s in steps]
    pis = [a.pub for a in airs]
    n = [i["length"] for i in inn]
    N = [i["length"] * i["blowup"] for i in inn]
    w = [i["width"] for i in inn]
    Q = [a.ce_blowup() for a in airs]
    layers = []
    for i in inn:
        size, k = i["length"] * i["blowup"], 0
        while size > (i["remainder_degree"] + 1) * i["blowup"]:
            size //= i["folding"]
            k += 1
        layers.append(k)
    groups = [groups_of(a.get_assertions(), n[k]) for k, a in enumerate(airs)]
    # the options the port's step proofs are made with: base field, FRI
    # folding 2, one partition a row, boundary groups batched
    shape_ok = [i["ext"] == 1 and i["folding"] == 2 and i["partitions"] == 1
                and not i["per_assertion"]
                and len(i["ood_trace_current"]) == w[k]
                and len(i["ood_trace_next"]) == w[k]
                and len(i["ood_quotient_current"]) == Q[k]
                and len(i["ood_quotient_next"]) == Q[k]
                and len(i["fri_roots"]) == layers[k]
                and len(i["fri_layers"]) == layers[k]
                and len(i["fri_remainder"]) <= i["remainder_degree"] + 1
                for k, i in enumerate(inn)]

    # --- Fiat-Shamir ---
    coins = Coins(h, [seed_elements(i, pi) for i, pi in zip(inn, pis)])
    coins.reseed({k: fold32(i["trace_root"]) for k, i in enumerate(inn)})
    ab = coins.draws([a.num_transition_constraints() + len(g)
                      for a, g in zip(airs, groups)])
    coins.reseed({k: fold32(i["constraint_root"])
                  for k, i in enumerate(inn)})
    zs = [d[0] for d in coins.draws([1] * S)]
    ood = [i["ood_trace_current"] + i["ood_quotient_current"]
           + i["ood_trace_next"] + i["ood_quotient_next"] for i in inn]
    coins.reseed(dict(enumerate(_by_length(h.hash_elements, ood))))
    gd = coins.draws([w[k] + Q[k] for k in range(S)])
    fri_alphas: List[List[int]] = [[] for _ in range(S)]
    for d in range(max(len(i["fri_roots"]) for i in inn)):
        coins.reseed({k: fold32(i["fri_roots"][d])
                      for k, i in enumerate(inn) if d < len(i["fri_roots"])})
        alpha = coins.draws([int(d < len(i["fri_roots"])) for i in inn])
        for k, a in enumerate(alpha):
            fri_alphas[k] += a
    heads = h.merge_with_int(coins.seed, [i["pow_nonce"] for i in inn])
    coins.seed = heads
    drawn = coins.draws([i["queries"] for i in inn])
    positions = []
    for k, i in enumerate(inn):
        head = heads[k] & ((1 << 64) - 1)
        zeros = 64 if head == 0 else (head & -head).bit_length() - 1
        positions.append(sorted({v & (N[k] - 1) for v in drawn[k]}))
        counts[k]["fiat_shamir"] += (int(zeros < i["grind"])
                                     + int(not shape_ok[k])
                                     + int(len(i["trace_rows"])
                                           != len(positions[k]))
                                     + int(len(i["constraint_rows"])
                                           != len(positions[k])))
    live = [k for k in range(S) if shape_ok[k]
            and len(inn[k]["trace_rows"]) == len(positions[k])
            and len(inn[k]["constraint_rows"]) == len(positions[k])]

    # --- the out-of-domain frame against the AIR ---
    for k in live:
        i, a, z = inn[k], airs[k], zs[k]
        nt = a.num_transition_constraints()
        alphas, betas = ab[k][:nt], ab[k][nt:]
        cur = [zair.Felt(v) for v in i["ood_trace_current"]]
        nxt = [zair.Felt(v) for v in i["ood_trace_next"]]
        tv = a.evaluate_transition(cur, nxt, a.periodic_values_at_point(z))
        comb = sum(al * t.v for al, t in zip(alphas, tv)) % P
        g = root_of_unity(n[k])
        z_div = (pow(z, n[k], P) - 1) * inv(z - pow(g, n[k] - 1, P)) % P
        lhs = comb * inv(z_div) % P
        for beta, grp in zip(betas, groups[k]):
            col, val = grp[0], grp[1]
            lhs = (lhs + beta * ((i["ood_trace_current"][col] - val) % P)
                   * inv(divisor_at(grp, n[k], z))) % P
        zn, rhs, zi = pow(z, n[k], P), 0, 1
        for q in i["ood_quotient_current"]:
            rhs = (rhs + zi * q) % P
            zi = zi * zn % P
        counts[k]["ood_air"] += int(lhs != rhs)

    # --- Merkle: trace, constraint and every FRI layer ---
    t_leaves = _by_length(h.hash_elements,
                          [r for k in live for r in inn[k]["trace_rows"]])
    c_leaves = _by_length(h.hash_elements,
                          [r for k in live for r in inn[k]["constraint_rows"]])
    fri_pos: Dict[tuple, List[int]] = {}
    pair_rows = []
    for k in live:
        pos_d, size = positions[k], N[k]
        for d in range(layers[k]):
            pos_d = _fold_positions(pos_d, size // 2)
            fri_pos[k, d] = pos_d
            size //= 2
            pair_rows += [list(p) for p in inn[k]["fri_layers"][d]["pairs"]]
    f_leaves = _by_length(h.hash_elements, pair_rows)
    trees, owners = [], []
    at_t = at_f = 0
    for k in live:
        i, m = inn[k], len(positions[k])
        depth = N[k].bit_length() - 1
        trees.append((depth, positions[k], t_leaves[at_t:at_t + m],
                      i["trace_batch"]))
        trees.append((depth, positions[k], c_leaves[at_t:at_t + m],
                      i["constraint_batch"]))
        owners += [(k, i["trace_root"]), (k, i["constraint_root"])]
        at_t += m
        for d in range(layers[k]):
            lay = i["fri_layers"][d]
            c = len(lay["pairs"])
            trees.append((depth - 1 - d, fri_pos[k, d],
                          f_leaves[at_f:at_f + c], lay["batch"]))
            owners.append((k, i["fri_roots"][d]))
            at_f += c
    for (k, root), got in zip(owners, merkle_roots(h, trees)):
        counts[k]["merkle"] += int(got is None or fe_bytes(got) != root)

    # --- DEEP against FRI layer 0, the folds, the remainder ---
    for k in live:
        i, z = inn[k], zs[k]
        gammas, deltas = gd[k][:w[k]], gd[k][w[k]:]
        zg = z * root_of_unity(n[k]) % P

        def comb(t_vals, q_vals):
            return (sum(g_ * t for g_, t in zip(gammas, t_vals))
                    + sum(d_ * q for d_, q in zip(deltas, q_vals))) % P
        gz = comb(i["ood_trace_current"], i["ood_quotient_current"])
        gzg = comb(i["ood_trace_next"], i["ood_quotient_next"])
        wN = root_of_unity(N[k])
        half = N[k] // 2
        lay0 = i["fri_layers"][0] if layers[k] else None
        f0 = fri_pos.get((k, 0), [])
        for q, p in enumerate(positions[k]):
            x = pow(wN, p, P) * COSET_OFFSET % P
            gt = comb(i["trace_rows"][q], i["constraint_rows"][q])
            y = ((gt - gz) * inv(x - z) + (gt - gzg) * inv(x - zg)) % P
            ok = (lay0 is not None and p % half in f0
                  and len(lay0["pairs"]) == len(f0)
                  and lay0["pairs"][f0.index(p % half)][p // half] == y)
            counts[k]["deep"] += int(not ok)
        gen, size = wN, N[k]
        for d in range(layers[k]):
            lay, alpha = i["fri_layers"][d], fri_alphas[k][d]
            folded = fri_pos[k, d]
            if len(lay["pairs"]) != len(folded):
                counts[k]["fri"] += 1
                break
            last = d + 1 == layers[k]
            if not last:
                nxt_pos = fri_pos[k, d + 1]
                nxt = i["fri_layers"][d + 1]["pairs"]
            minus_one = pow(gen, size // 2, P)
            for (v0, v1), m in zip(lay["pairs"], folded):
                x0 = pow(gen, m, P) * COSET_OFFSET % P
                x1 = x0 * minus_one % P
                v = ((v1 * (alpha - x0) - v0 * (alpha - x1))
                     * inv(x1 - x0)) % P
                if not last:
                    mm = m % (size // 4)
                    ok = (len(nxt) == len(nxt_pos)
                          and nxt[nxt_pos.index(mm)][m // (size // 4)] == v)
                else:
                    xl = COSET_OFFSET * pow(gen * gen % P, m, P) % P
                    acc = 0
                    for c in i["fri_remainder"]:
                        acc = (acc * xl + c) % P
                    ok = acc == v
                counts[k]["fri"] += int(not ok)
            gen, size = gen * gen % P, size // 2
    return counts

