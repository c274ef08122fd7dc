"""The composition kernel (zklisp_tpu_torch/csrc/composition.cu) against
the plain executors.

CPU part.  The recorded programs of rollup-bench (BATCH 15) and
fib-2pow16 (segment 0 of each, 4096 rows) are packed into the arrays the
kernel reads (`cvm.compile_registers`) and replayed by a model of the
kernel's two row loops on Python integers: the generic interpreter
(operand kinds, register file, the EMIT sum with its flush every
ZKL_FLUSH products) and the round blocks (cubes, MDS rows, -K_j, the
27 gated rounds), on the kernel's 32-bit word arithmetic.  The word
helpers it shares with csrc/poseidon12.cu come from that kernel's model
(tests/test_torch_poseidon12_words.py); the new ones (addmod, submod,
negmod, reduce9 at the kernel's 2^264 bound) are replayed here
instruction by instruction, carries included.  A few rows are held
against `cvm.interpret`, the stack and the leveled executors, and
`_scan_rounds` (through `eval_scan_blocks_plain`), on random values:
the kernel must agree on ANY inputs.  Exact equality (tolerance 0).

Card part (marker `chip`, skipped without a CUDA card; run on the card
with `python -m pytest --noconftest tests/test_torch_composition_kernel.py
-m chip`; tests/conftest.py sets up JAX, which the port does not need):
the kernel against the plain executors on the card, limb for limb, at
S = 2 and S = 16 segments of 32,768 rows on the wave's strided view, and
on a ragged row count."""

import os
import random

import numpy as np
import pytest
import torch

from test_torch_poseidon12_words import (Ptx, acc_words, acc_zero, cube,
                                         mac_aligned, reduce9, value, words)
from zklisp_tpu_torch.compiler import compile_entry
from zklisp_tpu_torch.core.pi import PublicInputsBuilder
from zklisp_tpu_torch.field import f128
from zklisp_tpu_torch.field import limb as tl
from zklisp_tpu_torch.field import limb_host
from zklisp_tpu_torch.parallel.mesh_prover import _SegPrep
from zklisp_tpu_torch.prove import composition_device as comp
from zklisp_tpu_torch.prove import cvm, planner
from zklisp_tpu_torch.prove import stark_device as sd
from zklisp_tpu_torch.prove.params import ProverOptions
from zklisp_tpu_torch.trace import build as tb
from zklisp_tpu_torch.trace.layout import POSEIDON_ROUNDS

P = f128.P
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
FLUSH = 255                  # csrc/composition.cu: ZKL_FLUSH
BOUND = 1 << 264             # what the kernel lets reduce9 see
PROGRAMS = ("rollup-bench", "fib-2pow16")
BLOWUP = 8                   # the composition sub-domain's blowup
PERIOD = 16                  # of the random periodic tables (divides N)
N = 64                       # rows of the plain executors' domain


# ---------------------------------------------------------------------------
# the recorded programs
# ---------------------------------------------------------------------------

def _record(name: str):
    """(AIR, recorded program, scan specs) of segment 0 of an example, as
    the wave records them."""
    with open(os.path.join(EXAMPLES, f"{name}.zlisp")) as f:
        program = compile_entry(f.read(), [])
    pi = PublicInputsBuilder(program).build()
    opts = ProverOptions(queries=64, blowup=16, grind=0,
                         min_security_bits=0, max_segment_rows=4096)
    segs = planner.plan_segments(program, pi, opts)
    full = tb.build_trace(program, pi)
    rom_acc = (tb.rom_acc_from_program(program) if any(pi.program_id)
               else (0, 0, 0))
    prep = _SegPrep(0, len(segs), segs[0], full, program, pi,
                    opts.to_proof_options(), 0, pi.program_id, rom_acc)
    n_per = len(prep.air.periodic_pattern()) + 1
    prog, specs = sd._record_cvm(prep.air, n_per)
    return prep.air, prog, specs


@pytest.fixture(scope="module")
def recorded():
    return {name: _record(name) for name in PROGRAMS}


def _rand_limbs(rng, shape):
    raw = rng.integers(0, 1 << 16, size=tuple(shape) + (8,), dtype=np.int64)
    raw[..., 7] = np.minimum(raw[..., 7], 0xFFFE)         # canonical
    return torch.from_numpy(raw.astype(np.int32))


def _ints(t):
    """The values of a (..., 8) limb tensor as a flat list of ints."""
    return [int(v) for v in
            limb_host.to_ints(t.numpy().astype(np.uint32)).reshape(-1)]


def _domain(air, seed: int, S: int = 1):
    """Random (lde (S, w, N, 8), per_p (n_perp, PERIOD, 8), p_last,
    alphas (S, nc, 8)) for the plain executors."""
    rng = np.random.default_rng(seed)
    n_per = len(air.periodic_pattern())
    return (_rand_limbs(rng, (S, air.trace_width, N)),
            _rand_limbs(rng, (n_per, PERIOD)), _rand_limbs(rng, (N,)),
            _rand_limbs(rng, (S, air.num_transition_constraints())))


def _row_inputs(lde_i, per_i, pl_i, r):
    """One row's cur, nxt and periodic values (p_last last)."""
    w = len(lde_i)
    cur = [lde_i[c][r] for c in range(w)]
    nxt = [lde_i[c][(r + BLOWUP) % N] for c in range(w)]
    per = [p[r % PERIOD] for p in per_i] + [pl_i[r]]
    return cur, nxt, per


# ---------------------------------------------------------------------------
# the kernel's new word arithmetic, instruction by instruction
# ---------------------------------------------------------------------------

def addmod(a, b):
    x = Ptx()
    s = [x.addc(a[0], b[0], 0, 1)] + [x.addc(a[i], b[i], 1, 1)
                                       for i in range(1, 4)]
    k = x.addc(0, 0, 1, 0)
    v = [x.addc(s[0], 0xFFFFFFFF, 0, 1), x.addc(s[1], 0x2CFF, 1, 1),
         x.addc(s[2], 0, 1, 1), x.addc(s[3], 0, 1, 1)]
    k2 = x.addc(0, 0, 1, 0)
    return v if (k | k2) else s


def submod(a, b):
    x = Ptx()
    d = [x.subc(a[0], b[0], 0, 1)] + [x.subc(a[i], b[i], 1, 1)
                                       for i in range(1, 4)]
    nb = x.subc(1, 0, 1, 0)
    v = [x.subc(d[0], 0xFFFFFFFF, 0, 1), x.subc(d[1], 0x2CFF, 1, 1),
         x.subc(d[2], 0, 1, 1), x.subc(d[3], 0, 1, 1)]
    if nb == 0:
        assert x.cf == 0, "d - C borrowed after a - b did"
        return v
    return d


def negmod(a):
    if not any(a):
        return a
    mask = (1 << 64) - 1
    pl, ph = 0xFFFFD30000000001, mask
    xl, xh = a[0] | (a[1] << 32), a[2] | (a[3] << 32)
    rl = (pl - xl) & mask
    rh = (ph - xh - (1 if pl < xl else 0)) & mask
    return [rl & 0xFFFFFFFF, rl >> 32, rh & 0xFFFFFFFF, rh >> 32]


def acc_set(x):
    s = acc_zero()
    s["e"][:4] = list(x)
    return s


def acc_reduce(s):
    w, top = acc_words(s)
    assert value(w) + (top << 256) < BOUND
    return reduce9(w, top)


def mulmod(a, b):
    s = acc_zero()
    mac_aligned(s, a, b)
    return acc_reduce(s)


def _edges():
    rng = random.Random(5)
    vals = [0, 1, 2, P - 2, P - 1, (1 << 128) - (1 << 96), 1 << 127,
            (1 << 64) - 1, 1 << 64, P - (1 << 64)]
    return vals + [rng.randrange(P) for _ in range(200)]


def test_addmod_submod_negmod_match_field():
    vals = _edges()
    rng = random.Random(6)
    pairs = [(a, b) for a in vals[:10] for b in vals[:10]]
    pairs += [(rng.choice(vals), rng.choice(vals)) for _ in range(400)]
    for a, b in pairs:
        assert value(addmod(words(a), words(b))) == (a + b) % P
        assert value(submod(words(a), words(b))) == (a - b) % P
    for a in vals:
        assert value(negmod(words(a))) == (-a) % P


def test_reduce9_at_the_kernel_bound():
    """The lazy sums reach up to 2^264 (FLUSH products of (p-1)^2 on a
    canonical start): fold 1 keeps top * 11520 in one word there."""
    worst = (P - 1) + FLUSH * (P - 1) ** 2
    assert worst < BOUND
    rng = random.Random(9)
    vals = [worst, BOUND - 1, (1 << 260), (1 << 263) + P,
            27 * (P - 1) ** 2 + (P - 1), 28 * (P - 1) ** 2]
    vals += [rng.randrange(BOUND) for _ in range(300)]
    for v in vals:
        assert value(reduce9(words(v, 8), v >> 256)) == v % P
    pm1 = words(P - 1)
    s = acc_set(pm1)
    for _ in range(FLUSH):
        mac_aligned(s, pm1, pm1)
    w, top = acc_words(s)
    assert value(w) + (top << 256) == worst
    assert value(reduce9(w, top)) == worst % P


# ---------------------------------------------------------------------------
# the row loops
# ---------------------------------------------------------------------------

def generic_row(rp, cur, nxt, per, alphas):
    """composition_generic_kernel for one row: per holds the periodic
    values with p_last last; alphas are the segment's."""
    consts = [[int(v) for v in row] for row in rp.consts]
    regs = {}

    def operand(enc):
        kind, k = enc >> 24, enc & 0xFFFFFF
        if kind == cvm.RK_REG:
            return regs[k]
        if kind == cvm.RK_CONST:
            return consts[k]
        v = {cvm.RK_CUR: lambda: cur[k], cvm.RK_NXT: lambda: nxt[k],
             cvm.RK_PER: lambda: per[k], cvm.RK_PLAST: lambda: per[-1]}
        return words(v[kind]())

    acc, pending = acc_zero(), 0
    for op, dst, a, b in rp.code.tolist():
        va = operand(a)
        if op == cvm.R_EMIT:
            mac_aligned(acc, words(alphas[dst]), va)
            pending += 1
            if pending == FLUSH:
                acc, pending = acc_set(acc_reduce(acc)), 0
            continue
        vb = operand(b)
        regs[dst] = {cvm.R_MUL: mulmod, cvm.R_ADD: addmod,
                     cvm.R_SUB: submod}[op](va, vb)
        assert 0 <= dst < rp.n_regs and value(regs[dst]) < P
    return value(acc_reduce(acc))


def block_negk(mds_rc_alpha):
    """-K_j = -(sum_i a_ji rc_ji) for the 27 rounds (once a block)."""
    rc, al = mds_rc_alpha
    out = []
    for j in range(POSEIDON_ROUNDS):
        s = acc_zero()
        for i in range(len(rc[j])):
            mac_aligned(s, words(al[j][i]), words(rc[j][i]))
        out.append(negmod(acc_reduce(s)))
    return out


def scan_block_row(acc, cur, nxt, gate, mds, negk, al, gr):
    """scan_block<L, GATED> for one row: cur, nxt the L lanes, gate the
    gate column's value (None: not gated), gr the 27 round gates."""
    L = len(cur)
    c = [cube(words(x)) for x in cur]
    d = []
    for i in range(L):
        y = acc_zero()
        for j in range(L):
            mac_aligned(y, words(mds[i][j]), c[j])
        d.append(submod(words(nxt[i]), acc_reduce(y)))
    g = acc_zero()
    for j in range(POSEIDON_ROUNDS):
        t = acc_set(negk[j])
        for i in range(L):
            mac_aligned(t, words(al[j][i]), d[i])
        mac_aligned(g if gate is not None else acc, words(gr[j]),
                    acc_reduce(t))
    if gate is not None:
        mac_aligned(acc, words(gate), acc_reduce(g))


def scan_row(air, specs, start, row_cols, row_nxt, alphas, gr):
    """composition_scan_kernel for one row: start the generic sum, row_cols
    and row_nxt the row's and the next row's columns."""
    acc = acc_set(words(start))
    offs = dict(specs)
    c = air.cols
    if "poseidon" in offs:
        ix, lanes = offs["poseidon"], [c.lane_index(i) for i in range(12)]
        al = [alphas[ix + 12 * j:ix + 12 * (j + 1)]
              for j in range(POSEIDON_ROUNDS)]
        scan_block_row(acc, [row_cols[k] for k in lanes],
                       [row_nxt[k] for k in lanes], row_cols[c.pose_active],
                       air.poseidon_mds, block_negk((air.poseidon_rc, al)),
                       al, gr)
    if "rom" in offs:
        ix, lanes = offs["rom"], [c.rom_s_index(i) for i in range(3)]
        al = [alphas[ix + 3 * j:ix + 3 * (j + 1)]
              for j in range(POSEIDON_ROUNDS)]
        scan_block_row(acc, [row_cols[k] for k in lanes],
                       [row_nxt[k] for k in lanes], None, air.rom_mds,
                       block_negk((air.rom_rc, al)), al, gr)
    return value(acc_reduce(acc))


# ---------------------------------------------------------------------------
# CPU: the packed programs and the model against the plain executors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PROGRAMS)
def test_register_form(recorded, name):
    """The packed program: one instruction per binop and EMIT of the stack
    program, operands in range, few registers (the stack's depth plus
    the live CSE slots), the constants those the program pushes."""
    air, prog, _ = recorded[name]
    rp = prog.regs
    ops = prog.ops[:prog.n_instr]
    counts = np.bincount(rp.code[:, 0], minlength=4)
    assert counts[cvm.R_ADD] == np.sum(ops == cvm.OP_ADD)
    assert counts[cvm.R_SUB] == np.sum(ops == cvm.OP_SUB)
    assert counts[cvm.R_MUL] == np.sum(ops == cvm.OP_MUL)
    assert counts[cvm.R_EMIT] == np.sum(ops == cvm.OP_EMIT)
    assert 0 < rp.n_regs <= prog.stack_size + prog.n_slots
    limits = {cvm.RK_REG: rp.n_regs, cvm.RK_CUR: air.trace_width,
              cvm.RK_NXT: air.trace_width,
              cvm.RK_PER: len(air.periodic_pattern()), cvm.RK_PLAST: 1,
              cvm.RK_CONST: rp.consts.shape[0]}
    binop = rp.code[:, 0] != cvm.R_EMIT
    for col, live in ((2, np.ones_like(binop)), (3, binop)):
        enc = rp.code[live, col]
        for kind, lim in limits.items():
            k = enc[enc >> 24 == kind] & 0xFFFFFF
            assert (k < lim).all(), (kind, k.max())
        assert set(np.unique(enc >> 24)) <= set(limits)
    assert (rp.code[~binop, 1] < air.num_transition_constraints()).all()
    pushed = {int(v) for v, op in zip(
        limb_host.to_ints(prog.imm[:prog.n_instr]), ops)
        if op == cvm.OP_PUSH_CONST}
    assert {value([int(w) for w in r]) for r in rp.consts} == pushed
    assert len(rp.consts) == len(pushed)


@pytest.mark.parametrize("name", PROGRAMS)
def test_generic_model_equals_interpret_and_executors(recorded, name):
    air, prog, _ = recorded[name]
    lde, per_p, p_last, alphas = _domain(air, seed=len(name))
    stack = cvm.execute_stack(prog, lde, per_p, p_last, alphas, BLOWUP)
    leveled = cvm.execute_leveled(prog.levels, lde, per_p, p_last, alphas,
                                  BLOWUP)
    assert torch.equal(stack, leveled)
    got = _ints(stack[0])
    lde_i = [_ints(lde[0, c]) for c in range(air.trace_width)]
    per_i = [_ints(p) for p in per_p]
    pl_i = _ints(p_last)
    al = _ints(alphas[0])
    for r in (0, N - BLOWUP, N - 1, 21):
        cur, nxt, per = _row_inputs(lde_i, per_i, pl_i, r)
        want = cvm.interpret(prog, cur, nxt, per, al)
        assert got[r] == want
        assert generic_row(prog.regs, cur, nxt, per, al) == want


@pytest.mark.parametrize("name", PROGRAMS)
def test_scan_model_equals_scan_rounds(recorded, name):
    air, prog, specs = recorded[name]
    assert {k for k, _ in specs} == ({"poseidon", "rom"}
                                     if name == "rollup-bench" else {"rom"})
    lde, per_p, p_last, alphas = _domain(air, seed=7 + len(name))
    gates = per_p[1:1 + POSEIDON_ROUNDS]
    start = _rand_limbs(np.random.default_rng(1), (1, N))
    plain = comp.eval_scan_blocks(air, lde, BLOWUP, gates, alphas, specs,
                                  acc=start.clone())
    assert torch.equal(plain, tl.add(start, comp.eval_scan_blocks_plain(
        air, lde, BLOWUP, gates, alphas, specs)))
    got = _ints(plain[0])
    cols = [_ints(lde[0, c]) for c in range(air.trace_width)]
    gr_i = [_ints(g) for g in gates]
    al = _ints(alphas[0])
    st = _ints(start[0])
    for r in (0, N - BLOWUP, N - 1, 13):
        row_cols = [c[r] for c in cols]
        row_nxt = [c[(r + BLOWUP) % N] for c in cols]
        gr = [g[r % PERIOD] for g in gr_i]
        assert scan_row(air, specs, st[r], row_cols, row_nxt, al,
                        gr) == got[r]


def _many_emits(n_roots: int = 600):
    """A program with more EMITs than ZKL_FLUSH: the EMIT sum is reduced
    mid-row.  Random DAG over 3 columns and 2 periodic columns."""
    rng = np.random.default_rng(17)
    cur, nxt, per = cvm.sym_leaves(3, 3)
    pool = cur + nxt + per + [cvm.Sym("const", k=P - 1 - i)
                              for i in range(3)]
    for _ in range(200):
        a = pool[int(rng.integers(len(pool)))]
        b = pool[int(rng.integers(len(pool)))]
        pool.append(cvm.Sym(("add", "sub", "mul")[int(rng.integers(3))],
                            a, b))
    return cvm.compile_constraints(
        [(pool[len(pool) - 1 - int(rng.integers(100))], i)
         for i in range(n_roots)])


def test_generic_model_flushes_the_emit_sum():
    prog = _many_emits()
    assert np.sum(prog.regs.code[:, 0] == cvm.R_EMIT) > 2 * FLUSH
    rng = random.Random(3)
    for fill in ("max", "random"):
        vals = (lambda: P - 1) if fill == "max" else (
            lambda: rng.randrange(P))
        cur = [vals() for _ in range(3)]
        nxt = [vals() for _ in range(3)]
        per = [vals() for _ in range(3)]
        al = [vals() for _ in range(600)]
        assert (generic_row(prog.regs, cur, nxt, per, al)
                == cvm.interpret(prog, cur, nxt, per, al))


def test_dispatch_cpu_and_kernel_rows(recorded):
    """A CPU tensor takes the plain executors through `compose` and no
    kernel rows are counted; compose == generic + scan blocks."""
    air, prog, specs = recorded["fib-2pow16"]
    lde, per_p, p_last, alphas = _domain(air, seed=2, S=2)
    got = comp.compose(air, prog, specs, lde, BLOWUP, per_p, p_last, alphas)
    want = tl.add(cvm.execute_stack(prog, lde, per_p, p_last, alphas,
                                    BLOWUP),
                  comp.eval_scan_blocks_plain(air, lde, BLOWUP,
                                              per_p[1:1 + POSEIDON_ROUNDS],
                                              alphas, specs))
    assert torch.equal(got, want)
    assert comp.composition_rows(lde) == 0


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_domain(air, S, n, period, strided, seed, dev):
    """Random inputs on the card; strided: the LDE is every other row of
    a twice-as-long array, as the wave's sub-domain view."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(shape):
        t = torch.randint(0, 1 << 16, tuple(shape) + (8,), generator=g,
                          dtype=torch.int32, device=dev)
        t[..., 7].clamp_(max=0xFFFE)
        return t

    w = air.trace_width
    lde = (rand((S, w, 2 * n))[:, :, ::2] if strided else rand((S, w, n)))
    return (lde, rand((len(air.periodic_pattern()), period)), rand((n,)),
            rand((S, air.num_transition_constraints())))


@pytest.mark.chip
@pytest.mark.parametrize("S,n,period,strided", [
    (2, 32768, 256, True), (16, 32768, 256, True), (3, 592, 16, False)])
@pytest.mark.parametrize("name", PROGRAMS)
def test_kernel_equals_plain_on_card(card, recorded, name, S, n, period,
                                     strided):
    from zklisp_tpu_torch.prove import composition_cuda as cc
    air, prog, specs = recorded[name]
    lde, per_p, p_last, alphas = _card_domain(air, S, n, period, strided,
                                              S * n + len(name), card)
    gates = per_p[1:1 + POSEIDON_ROUNDS]
    launches = (cc.generic.launches, cc.scan.launches)
    gen = cvm.execute(prog, lde, per_p, p_last, alphas, BLOWUP)
    total = comp.eval_scan_blocks(air, lde, BLOWUP, gates, alphas, specs,
                                  acc=gen.clone())
    assert (cc.generic.launches, cc.scan.launches) == (launches[0] + 1,
                                                        launches[1] + 1)
    assert comp.composition_rows(lde) == S * n
    leveled = cvm.execute_leveled(prog.levels, lde, per_p, p_last, alphas,
                                  BLOWUP)
    assert torch.equal(gen, leveled)
    if S * n <= 2 * 32768:
        assert torch.equal(gen, cvm.execute_stack(prog, lde, per_p, p_last,
                                                  alphas, BLOWUP))
    plain = tl.add(leveled, comp.eval_scan_blocks_plain(
        air, lde, BLOWUP, gates, alphas, specs))
    assert torch.equal(total, plain)
    assert torch.equal(comp.compose(air, prog, specs, lde, BLOWUP, per_p,
                                    p_last, alphas), plain)
    torch.cuda.synchronize()
