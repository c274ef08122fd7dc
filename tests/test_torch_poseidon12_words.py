"""A step-by-step model of the 32-bit word arithmetic of the team kernel in
zklisp_tpu_torch/csrc/poseidon12.cu, held against the field.

The kernel itself runs only on the card (chip_smoke.py holds it against
permute12_plain there).  Here every PTX instruction it issues is replayed
on Python integers, the carry flag included, in the kernel's order: the
product chains of `mac_aligned` and their counters, `acc_words`,
`square8`, the two folds and the conditional subtract of `reduce9`, and
the team's partition of lanes and MDS rows.  An instruction without `.cc` that would drop a carry or a
borrow fails the model.  Exact equality (tolerance 0) with
zklisp_tpu_torch.field.f128 on the suite's real MDS and round constants.
"""

import random

import pytest

from zklisp_tpu_torch.crypto import poseidon as pos
from zklisp_tpu_torch.field import f128

P = f128.P
MASK = (1 << 32) - 1
M = 11520                    # C = M * 2^32 - 1
TEAM = 12                    # threads per state in the kernel


class Ptx:
    """u32 PTX integer instructions with the carry flag CC.CF."""

    def __init__(self):
        self.cf = 0

    def _out(self, t, cc):
        if cc:
            self.cf = t >> 32
        else:
            assert t >> 32 == 0, "a carry dropped by an instruction without .cc"
        return t & MASK

    def mad(self, hi, a, b, c, carry_in, cc):
        p = a * b
        t = (p >> 32 if hi else p & MASK) + c + (self.cf if carry_in else 0)
        return self._out(t, cc)

    def addc(self, a, b, carry_in, cc):
        return self._out(a + b + (self.cf if carry_in else 0), cc)

    def subc(self, a, b, borrow_in, cc):
        t = a - b - (self.cf if borrow_in else 0)
        if cc:
            self.cf = 1 if t < 0 else 0
        else:
            assert t >= 0, "a borrow dropped by an instruction without .cc"
        return t & MASK


def words(v, n=4):
    return [(v >> (32 * i)) & MASK for i in range(n)]


def value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def pairs(x, r, i, prods):
    """One chain: r[i], r[i+1], ... += lo, hi of each product in turn
    (mad.lo.cc, then madc.hi.cc / madc.lo.cc ... madc.hi.cc); returns the
    carry-out, which the kernel adds to a counter with addc."""
    for n, (a, b) in enumerate(prods):
        r[i + 2 * n] = x.mad(0, a, b, r[i + 2 * n], n > 0, 1)
        r[i + 2 * n + 1] = x.mad(1, a, b, r[i + 2 * n + 1], 1, 1)
    return x.addc(0, 0, 1, 0)


def acc_zero():
    """acc_t: e = positions 0..7, o = positions 1..6, counters at 5..8."""
    return {"e": [0] * 8, "o": [0] * 6, 5: 0, 6: 0, 7: 0, 8: 0}


def mac_aligned(s, a, b):
    x = Ptx()
    e, o = s["e"], s["o"]
    s[8] += pairs(x, e, 0, [(a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
                            (a[3], b[3])])
    s[6] += pairs(x, e, 2, [(a[0], b[2]), (a[1], b[3])])
    s[6] += pairs(x, e, 2, [(a[2], b[0]), (a[3], b[1])])
    s[7] += pairs(x, o, 0, [(a[0], b[1]), (a[1], b[2]), (a[2], b[3])])
    s[7] += pairs(x, o, 0, [(a[1], b[0]), (a[2], b[1]), (a[3], b[2])])
    s[5] += pairs(x, o, 2, [(a[0], b[3])])
    s[5] += pairs(x, o, 2, [(a[3], b[0])])


def acc_words(s):
    x = Ptx()
    e, o = list(s["e"]), s["o"]
    top = s[8]
    e[1] = x.addc(e[1], o[0], 0, 1)
    for i in range(2, 7):
        e[i] = x.addc(e[i], o[i - 1], 1, 1)
    e[7] = x.addc(e[7], s[7], 1, 1)
    top = x.addc(top, 0, 1, 0)
    e[5] = x.addc(e[5], s[5], 0, 1)
    e[6] = x.addc(e[6], s[6], 1, 1)
    e[7] = x.addc(e[7], 0, 1, 1)
    top = x.addc(top, 0, 1, 0)
    return e, top


def reduce9(w, top):
    x = Ptx()
    # fold 1: t = L + (H*M) << 32 - H
    t = [w[0], w[1], w[2], w[3], 0, 0]
    t[1] = x.mad(0, w[4], M, t[1], 0, 1)
    t[2] = x.mad(1, w[4], M, t[2], 1, 1)
    t[3] = x.mad(0, w[6], M, t[3], 1, 1)
    t[4] = x.mad(1, w[6], M, t[4], 1, 1)
    t[5] = x.mad(0, top, M, t[5], 1, 0)
    t[2] = x.mad(0, w[5], M, t[2], 0, 1)
    t[3] = x.mad(1, w[5], M, t[3], 1, 1)
    t[4] = x.mad(0, w[7], M, t[4], 1, 1)
    t[5] = x.mad(1, w[7], M, t[5], 1, 0)
    t[0] = x.subc(t[0], w[4], 0, 1)
    t[1] = x.subc(t[1], w[5], 1, 1)
    t[2] = x.subc(t[2], w[6], 1, 1)
    t[3] = x.subc(t[3], w[7], 1, 1)
    t[4] = x.subc(t[4], top, 1, 1)
    t[5] = x.subc(t[5], 0, 1, 0)
    # fold 2: (k, u) = t[0..3] + (t4 + t5 * 2^32) * C
    u, k = t[:4], 0
    u[1] = x.mad(0, t[4], M, u[1], 0, 1)
    u[2] = x.mad(1, t[4], M, u[2], 1, 1)
    u[3] = x.addc(u[3], 0, 1, 1)
    k = x.addc(k, 0, 1, 0)
    u[2] = x.mad(0, t[5], M, u[2], 0, 1)
    u[3] = x.mad(1, t[5], M, u[3], 1, 1)
    k = x.addc(k, 0, 1, 0)
    u[0] = x.subc(u[0], t[4], 0, 1)
    u[1] = x.subc(u[1], t[5], 1, 1)
    u[2] = x.subc(u[2], 0, 1, 1)
    u[3] = x.subc(u[3], 0, 1, 1)
    k = x.subc(k, 0, 1, 0)
    # v = u + C; the result is v when k or the carry k2, else u
    v = [x.addc(u[0], 0xFFFFFFFF, 0, 1), x.addc(u[1], 0x2CFF, 1, 1),
         x.addc(u[2], 0, 1, 1), x.addc(u[3], 0, 1, 1)]
    k2 = x.addc(0, 0, 1, 0)
    return v if (k | k2) else u


def square8(a):
    x = Ptx()
    r = [0] * 8
    r[1] = x.mad(0, a[0], a[1], 0, 0, 0)            # mul.lo
    r[2] = x.mad(1, a[0], a[1], 0, 0, 0)            # mul.hi
    r[3] = x.mad(0, a[1], a[2], 0, 0, 0)
    r[4] = x.mad(1, a[1], a[2], 0, 0, 0)
    r[5] = x.mad(0, a[2], a[3], 0, 0, 0)
    r[6] = x.mad(1, a[2], a[3], 0, 0, 0)
    r[2] = x.mad(0, a[0], a[2], r[2], 0, 1)
    r[3] = x.mad(1, a[0], a[2], r[3], 1, 1)
    r[4] = x.mad(0, a[1], a[3], r[4], 1, 1)
    r[5] = x.mad(1, a[1], a[3], r[5], 1, 1)
    r[6] = x.addc(r[6], 0, 1, 1)
    r[7] = x.addc(r[7], 0, 1, 0)
    r[3] = x.mad(0, a[0], a[3], r[3], 0, 1)
    r[4] = x.mad(1, a[0], a[3], r[4], 1, 1)
    r[5] = x.addc(r[5], 0, 1, 1)
    r[6] = x.addc(r[6], 0, 1, 1)
    r[7] = x.addc(r[7], 0, 1, 0)
    r[1] = x.addc(r[1], r[1], 0, 1)
    for i in range(2, 7):
        r[i] = x.addc(r[i], r[i], 1, 1)
    r[7] = x.addc(r[7], r[7], 1, 0)
    r[0] = x.mad(0, a[0], a[0], 0, 0, 0)
    r[1] = x.mad(1, a[0], a[0], r[1], 0, 1)         # mad.hi.cc
    r[2] = x.mad(0, a[1], a[1], r[2], 1, 1)
    r[3] = x.mad(1, a[1], a[1], r[3], 1, 1)
    r[4] = x.mad(0, a[2], a[2], r[4], 1, 1)
    r[5] = x.mad(1, a[2], a[2], r[5], 1, 1)
    r[6] = x.mad(0, a[3], a[3], r[6], 1, 1)
    r[7] = x.mad(1, a[3], a[3], r[7], 1, 1)
    top = x.addc(0, 0, 1, 0)
    return r, top


def cube(a):
    x2 = reduce9(*square8(a))
    s = acc_zero()
    mac_aligned(s, x2, a)
    w, top = acc_words(s)
    assert top == 0
    return reduce9(w, top)


def mds_row(rc, row, cubes):
    """One MDS row: the round constant plus 12 products, accumulated
    without reduction, reduced once."""
    s = acc_zero()
    s["e"][:4] = rc
    for j in range(12):
        mac_aligned(s, row[j], cubes[j])
    return reduce9(*acc_words(s))


def lane_of(k):
    """The lane (and MDS row) thread k of a team owns."""
    return k


def permute_model(state, suite, rounds):
    """The kernel's round loop for one team: thread k cubes lane k into the
    team's cube buffer, then computes MDS row k from all 12 cubes."""
    mds = [[words(v) for v in row] for row in suite.mds]
    rcs = [[words(v) for v in row] for row in suite.rc]
    x = [words(v) for v in state]
    for r in range(rounds):
        cubes = [None] * 12
        for k in range(TEAM):
            cubes[lane_of(k)] = cube(x[lane_of(k)])
        x = [mds_row(rcs[r][lane_of(k)], mds[lane_of(k)], cubes)
             for k in range(TEAM)]
    return [value(v) for v in x]


def permute_field(state, suite, rounds):
    s = list(state)
    for r in range(rounds):
        c = [f128.mul(f128.mul(v, v), v) for v in s]
        s = [(sum(suite.mds[i][j] * c[j] for j in range(12))
              + suite.rc[r][i]) % P for i in range(12)]
    return s


def _reduce(v):
    return value(reduce9(words(v, 8), v >> 256))


@pytest.mark.parametrize("rounds", [27, 8])
@pytest.mark.parametrize("fill", ["p-1", "0", "1", "random"])
def test_model_permutation_matches_field(rounds, fill):
    suite = pos.get_poseidon_suite(pos.HASHER_SUITE_ID, rounds)
    if fill == "random":
        rng = random.Random(rounds)
        state = [rng.randrange(P) for _ in range(12)]
    else:
        state = [{"p-1": P - 1, "0": 0, "1": 1}[fill]] * 12
    want = permute_field(state, suite, rounds)
    got = permute_model(state, suite, rounds)
    assert got == want
    assert all(v < P for v in got)


def test_team_partition_covers_each_lane_once():
    owned = [lane_of(k) for k in range(TEAM)]
    assert sorted(owned) == list(range(12))


def test_accumulator_holds_the_worst_row():
    """rc = p-1 and twelve products (p-1)*(p-1): the accumulator's words
    and counters hold 12*(p-1)^2 + (p-1) exactly (nine words)."""
    worst = 12 * (P - 1) ** 2 + (P - 1)
    assert worst < 1 << 260
    pm1 = words(P - 1)
    s = acc_zero()
    s["e"][:4] = pm1
    for _ in range(12):
        mac_aligned(s, pm1, pm1)
    assert max(s[c] for c in (5, 6, 7, 8)) <= 24
    w, top = acc_words(s)
    assert value(w) + (top << 256) == worst
    assert value(reduce9(w, top)) == worst % P


def test_reduce_edges():
    """Both folds and the conditional subtract at their boundaries: values
    around p, 2p and 2^128, the fold-2 carry k, the largest input."""
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, (1 << 128) - 1,
             1 << 128, (1 << 128) + (1 << 96), (P - 1) ** 2,
             12 * (P - 1) ** 2 + (P - 1), (1 << 260) - 1]
    rng = random.Random(7)
    edges += [rng.randrange(1 << 260) for _ in range(200)]
    edges += [rng.randrange(1 << 256) for _ in range(200)]
    for v in edges:
        assert _reduce(v) == v % P


def test_square_and_cube():
    rng = random.Random(3)
    for v in [0, 1, 2, P - 1, P - 2, (1 << 127), (1 << 96) - 1] + [
            rng.randrange(P) for _ in range(100)]:
        r, top = square8(words(v))
        assert top == 0 and value(r) == v * v
        assert value(cube(words(v))) == pow(v, 3, P)
