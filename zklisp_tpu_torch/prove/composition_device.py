"""Constraint composition sum_i alpha_i * C_i over the evaluation domain,
split into two parts:

  * scan blocks — the Poseidon (27x12) and ROM (27x3) round constraints
    with the per-round composition coefficients (`eval_scan_blocks`);
  * generic constraints — everything else (ctrl/alu/ram/merkle, hold and
    binding rows), walked ONCE per configuration and recorded to cvm
    bytecode (see cvm.py).

`compose` sums both; the wave and the serial prover call it.  On a CUDA
tensor each part is one launch of csrc/composition.cu
(prove/composition_cuda.py), the scan blocks adding into the generic
sum; on a CPU tensor each part runs as plain PyTorch limb ops
(`eval_scan_blocks_plain`, cvm's executors), which give the same limbs.

`_walk` is the single traversal used by both; emission order (and hence
the global alpha index of every constraint) exactly matches
ZkLispAir.evaluate_transition.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..air.zk_air import ZkLispAir
from ..field import f128
from ..field import limb as tl
from ..trace.layout import POSEIDON_ROUNDS, VM_USAGE_SPONGE
from . import cvm

P = f128.P


# ---------------------------------------------------------------------------
# single traversal: scan specs + generic constraints
# ---------------------------------------------------------------------------

def _walk(air: ZkLispAir, cur, nxt, periodic, generic: Optional[list],
          specs: Optional[list]) -> int:
    """Walk modules in emission order.  Appends (expr, global alpha
    index) for every generic constraint to `generic` and
    (kind, alpha offset) for every scan block to `specs`.  Returns the
    total constraint count (== air.num_transition_constraints())."""
    f = air.features
    ix = 0
    if f.poseidon:
        if specs is not None:
            specs.append(("poseidon", ix))
        ix += POSEIDON_ROUNDS * 12
        ix = _poseidon_generic(air, cur, nxt, periodic, ix, generic)
    if f.vm:
        ix = _generic_block(air, "_eval_ctrl", cur, nxt, periodic, ix,
                            generic)
        ix = _generic_block(air, "_eval_alu", cur, nxt, periodic, ix,
                            generic)
    if f.ram:
        ix = _generic_block(air, "_eval_ram", cur, nxt, periodic, ix,
                            generic)
    if f.merkle:
        ix = _generic_block(air, "_eval_merkle", cur, nxt, periodic, ix,
                            generic)
    if any(air.pub.core.program_commitment):
        if specs is not None:
            specs.append(("rom", ix))
        ix += POSEIDON_ROUNDS * 3
        ix = _rom_generic(air, cur, nxt, periodic, ix, generic)
    assert ix == air.num_transition_constraints(), (
        ix, air.num_transition_constraints())
    return ix


def _generic_block(air, method, cur, nxt, periodic, ix, generic):
    result: List = []
    getattr(air, method)(cur, nxt, periodic, result)
    for tv in result:
        if generic is not None:
            generic.append((tv, ix))
        ix += 1
    return ix


def _poseidon_generic(air, cur, nxt, periodic, ix, generic):
    """Hold constraints (12) + sponge VM->lane bindings (10 when the
    sponge is used); alpha indices continue after the round block."""
    c = air.cols
    p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
    p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]
    g_hold = p_pad - p_pad_last
    for i in range(12):
        if generic is not None:
            generic.append((g_hold * (nxt[c.lane_index(i)]
                                      - cur[c.lane_index(i)]), ix))
        ix += 1

    sponge_used = bool(air.vm_usage_mask & (1 << VM_USAGE_SPONGE))
    if air.features.vm and air.features.sponge and sponge_used:
        if generic is not None:
            tmp: List = []
            air._eval_poseidon(cur, nxt, periodic, tmp)
            bindings = tmp[POSEIDON_ROUNDS * 12 + 12:]
            assert len(bindings) == 10
            for tv in bindings:
                generic.append((tv, ix))
                ix += 1
        else:
            ix += 10
    return ix


def _rom_generic(air, cur, nxt, periodic, ix, generic):
    """Hold (3) + map encodings (2) after the ROM round block."""
    if generic is not None:
        tmp: List = []
        air._eval_rom(cur, nxt, periodic, tmp)
        for tv in tmp[POSEIDON_ROUNDS * 3:]:
            generic.append((tv, ix))
            ix += 1
        return ix
    n_extra = _rom_extra_count(air)
    return ix + n_extra


def _rom_extra_count(air) -> int:
    return 3 + 2


def collect_generic(air: ZkLispAir, cur, nxt, periodic):
    """(generic [(expr, alpha idx)], scan specs [(kind, alpha offset)])."""
    generic: List = []
    specs: List[Tuple[str, int]] = []
    _walk(air, cur, nxt, periodic, generic, specs)
    return generic, specs


# ---------------------------------------------------------------------------
# the composition: generic constraints + scan blocks
# ---------------------------------------------------------------------------

def compose(air: ZkLispAir, prog, specs, lde, shift: int, per_p, p_last,
            alphas_arr):
    """sum_i alpha_i * C_i over the domain: (..., N, 8), or None when the
    AIR has no transition constraint.  prog, specs: `_record_cvm`'s
    recording; lde (..., w, N, 8) (a strided view is fine); shift: the
    next row's offset (the domain's blowup); per_p (n_perp, period, 8)
    one period of each short-periodic column, the 27 round gates at
    1..27; p_last (N, 8); alphas_arr (..., n_constraints, 8)."""
    comb = None
    if prog.n_instr:
        comb = cvm.execute(prog, lde, per_p, p_last, alphas_arr, shift)
    if specs:
        comb = eval_scan_blocks(air, lde, shift, per_p[1:1 + POSEIDON_ROUNDS],
                                alphas_arr, specs, acc=comb)
    return comb


def composition_rows(lde) -> int:
    """Rows the composition kernel evaluates for `lde` (..., w, N, 8): every
    row of every segment on a CUDA tensor, none on a CPU tensor (the
    phases' `kernel_rows`)."""
    if lde.device.type != "cuda":
        return 0
    return (lde.shape[0] if lde.dim() == 4 else 1) * lde.shape[-2]


# ---------------------------------------------------------------------------
# scan blocks
# ---------------------------------------------------------------------------

def eval_scan_blocks(air: ZkLispAir, lde, shift: int, gates, alphas_arr,
                     specs, acc=None):
    """acc (or 0) + the Poseidon/ROM round-constraint contributions, each
    combined with its alpha slice: (..., N, 8); None when `specs` is
    empty and no acc is given.

    lde: (..., w, N, 8) column-major evaluations, a leading segment axis
    for a wave (a strided view is fine); the next-row view of a column
    is its roll by `shift` (the evaluation domain's blowup) within its
    segment.  gates: (27, period, 8), ONE period of each round-gate
    column.  alphas_arr: (..., n_constraints, 8), each segment's own.

    A CUDA tensor takes one launch of the scan kernel, which adds into
    `acc` in place; a CPU tensor the plain version."""
    if not specs:
        return acc
    if lde.device.type == "cuda":
        from .composition_cuda import scan
        return scan(air, specs, lde, shift, gates, alphas_arr, acc)
    term = eval_scan_blocks_plain(air, lde, shift, gates, alphas_arr, specs)
    return term if acc is None else tl.add(acc, term)


def eval_scan_blocks_plain(air: ZkLispAir, lde, shift: int, gates,
                           alphas_arr, specs):
    """The scan blocks in plain PyTorch limb ops, on any device: the sum
    of `eval_scan_blocks` without acc (None when `specs` is empty),
    round by round (`_scan_rounds`)."""
    acc = None
    for kind, ix in specs:
        if kind == "poseidon":
            term = _poseidon_scan(air, lde, shift, gates, alphas_arr, ix)
        else:
            term = _rom_scan(air, lde, shift, gates, alphas_arr, ix)
        acc = term if acc is None else tl.add(acc, term)
    return acc


def _scan_rounds(lanes_cur, lanes_nxt, gate, gr, mds, rc, a_round):
    """Shared 27-round loop: sum_j sum_i a[j,i] * gate_j * (nxt_i - y_ji)
    where y = MDS * cur^3 + rc_j.  lanes (..., L, N, 8), gate (..., N, 8)
    or None, a_round (..., 27, L, 8); gr is (27, period, 8) with period
    dividing N; each round's gate is tiled inside the loop.  MDS * cur^3
    does not depend on the round and is computed once."""
    N = lanes_cur.shape[-2]
    reps = N // gr.shape[1]
    s3 = tl.cube(lanes_cur)                              # (..., L, N, 8)
    y0 = tl.dot(mds[:, None, :, :],
                s3.transpose(-3, -2)[..., None, :, :, :])  # (..., L, N, 8)
    acc = tl.zeros(lanes_cur.shape[:-3] + (N,), lanes_cur.device)
    for j in range(POSEIDON_ROUNDS):
        y = tl.add(y0, rc[j][:, None, :])
        diff = tl.sub(lanes_nxt, y)
        gr_full = gr[j] if reps == 1 else gr[j].repeat(reps, 1)
        g = tl.mul(gate, gr_full) if gate is not None else gr_full
        gated = tl.mul(diff, g[..., None, :, :])
        term = tl.dot(gated.transpose(-3, -2),
                      a_round[..., j, None, :, :])
        acc = tl.add(acc, term)
    return acc


def _round_alphas(alphas_arr, ix, lanes):
    return alphas_arr[..., ix:ix + POSEIDON_ROUNDS * lanes, :].reshape(
        alphas_arr.shape[:-2] + (POSEIDON_ROUNDS, lanes, tl.NLIMB))


def _poseidon_scan(air, lde, shift, gates, alphas_arr, ix):
    c = air.cols
    idx = torch.tensor([c.lane_index(i) for i in range(12)],
                       device=lde.device)
    lanes_cur = lde.index_select(-3, idx)
    lanes_nxt = torch.roll(lanes_cur, -shift, -2)
    pa = lde[..., c.pose_active, :, :]
    mds = tl.from_ints(air.poseidon_mds, lde.device)
    rc = tl.from_ints(air.poseidon_rc, lde.device)
    return _scan_rounds(lanes_cur, lanes_nxt, pa, gates, mds, rc,
                        _round_alphas(alphas_arr, ix, 12))


def _rom_scan(air, lde, shift, gates, alphas_arr, ix):
    c = air.cols
    idx = torch.tensor([c.rom_s_index(i) for i in range(3)],
                       device=lde.device)
    s_cur = lde.index_select(-3, idx)
    s_nxt = torch.roll(s_cur, -shift, -2)
    mds = tl.from_ints(air.rom_mds, lde.device)
    rc = tl.from_ints(air.rom_rc, lde.device)
    return _scan_rounds(s_cur, s_nxt, None, gates, mds, rc,
                        _round_alphas(alphas_arr, ix, 3))
