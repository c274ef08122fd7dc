"""The AIR of the zk-lisp VM, for the benchmark's check of a step proof's
out-of-domain frame: a frozen copy of the port's host translation of
zk-lisp's constraint system (src/vm/air/{mod,alu,ctrl,ram,rom,merkle,
poseidon,schedule,mixers}.rs), evaluated on plain integers at one point.

The timed path evaluates these constraints on the device by other code
(the constraint VM and the scanned blocks of prove/composition_device.py);
this copy is the yardstick a later change to either is held to.  It
imports nothing of the port: Poseidon2 suites from reference/poseidon2.py,
the column layout from reference/layout.py, field values as `Felt`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from . import poseidon2
from .field import (POW2_64, Felt, be_from_le8, inv as f_inv,
                    root_of_unity)
from .layout import (Columns, LayoutConfig, NR, POSEIDON_ROUNDS,
                     SPONGE_IDX_BITS, STEPS_PER_LEVEL_P2,
                     VM_USAGE_ASSERT, VM_USAGE_ASSERT_BIT,
                     VM_USAGE_ASSERT_RANGE, VM_USAGE_DIV128,
                     VM_USAGE_DIVMOD, VM_USAGE_EQ, VM_USAGE_MULWIDE,
                     VM_USAGE_RAM_DELTA_CLK, VM_USAGE_SPONGE)

FM_POSEIDON, FM_VM, FM_VM_EXPECT = 1 << 0, 1 << 1, 1 << 4
FM_SPONGE, FM_MERKLE, FM_RAM = 1 << 5, 1 << 6, 1 << 7
ROM_W_SEED_0, ROM_W_SEED_1 = 17, 1037


def pos_map() -> int:
    return 0


def pos_final() -> int:
    return 1 + POSEIDON_ROUNDS


def is_pad_pos(pos: int) -> bool:
    return pos != pos_map() and pos != pos_final() and not (
        1 <= pos <= POSEIDON_ROUNDS)


def rom_weights_for_seed(seed: int) -> List[int]:
    """[3^(seed+1) .. 3^(seed+59)] (zk-lisp utils.rs:112-141)."""
    return [pow(3, seed + 1 + k, P) for k in range(59)]


def program_field_commitment(program_id: bytes) -> Tuple[int, int]:
    """Lanes 0 and 1 of the program suite's permutation of its id's two
    halves (zk-lisp commit.rs:31-79)."""
    dom, _, _ = poseidon2.suite(program_id)
    a = int.from_bytes(program_id[:16], "little") % P
    b = int.from_bytes(program_id[16:32], "little") % P
    out = poseidon2.permute([a, b] + [0] * 8 + list(dom), program_id)
    return out[0], out[1]


def rom_encode_columns(cols: Columns) -> List[int]:
    """The 59 column indices folded by the ROM linear encoder, in order
    (zk-lisp vm/air/rom.rs)."""
    idx = list(cols.op_columns())
    for sel in (cols.sel_dst0_index, cols.sel_a_index, cols.sel_b_index,
                cols.sel_c_index, cols.sel_dst1_index):
        idx += [sel(i) for i in range(NR)]
    return idx


@dataclass
class Core:
    """The public inputs of a program that the AIR reads (zk-lisp
    PublicInputs); main_args as field elements."""
    program_id: bytes
    program_commitment: bytes
    merkle_root: bytes
    feature_mask: int
    main_args: Tuple[int, ...] = ()
    vm_out_row: int = 0
    vm_out_reg: int = 0
    vm_expected_bytes: bytes = bytes(32)


P = poseidon2.P


@dataclass
class AirPublicInputs:
    """src/lib.rs AirPublicInputs."""
    core: Core
    segment_feature_mask: int = 0
    rom_acc: Tuple[int, int, int] = (0, 0, 0)
    pc_init: int = 0
    ram_gp_unsorted_in: int = 0
    ram_gp_unsorted_out: int = 0
    ram_gp_sorted_in: int = 0
    ram_gp_sorted_out: int = 0
    rom_s_in: Tuple[int, int, int] = (0, 0, 0)
    rom_s_out: Tuple[int, int, int] = (0, 0, 0)
    vm_usage_mask: int = 0
    ram_delta_clk_bits: int = 0

    def to_elements(self) -> List[int]:
        """FS seed encoding (lib.rs:116-160): 5 base + main slots + 13."""
        main_slots = list(self.core.main_args)
        out = [self.core.feature_mask % P,
               be_from_le8(self.core.program_commitment),
               be_from_le8(self.core.merkle_root)]
        if any(self.core.program_commitment):
            fc = program_field_commitment(self.core.program_commitment)
            out += [fc[0], fc[1]]
        else:
            out += [0, 0]
        out += main_slots
        out += [self.pc_init,
                self.ram_gp_unsorted_in, self.ram_gp_unsorted_out,
                self.ram_gp_sorted_in, self.ram_gp_sorted_out]
        out += list(self.rom_s_in)
        out += list(self.rom_s_out)
        out += [self.vm_usage_mask, self.ram_delta_clk_bits]
        return out


@dataclass(frozen=True)
class Features:
    poseidon: bool
    vm: bool
    vm_expect: bool
    sponge: bool
    merkle: bool
    ram: bool

    @staticmethod
    def from_mask(m: int) -> "Features":
        return Features(
            poseidon=bool(m & FM_POSEIDON),
            vm=bool(m & FM_VM),
            vm_expect=bool(m & FM_VM_EXPECT),
            sponge=bool(m & FM_SPONGE),
            merkle=bool(m & FM_MERKLE),
            ram=bool(m & FM_RAM),
        )


@dataclass(frozen=True)
class ConstraintDegree:
    """TransitionConstraintDegree: base plus periodic-cycle multiplicands."""
    base: int
    cycles: Tuple[int, ...] = ()

    def evaluation_degree(self, trace_len: int) -> int:
        d = self.base * (trace_len - 1)
        for c in self.cycles:
            d += (trace_len // c) * (c - 1)
        return d


def _deg(base: int, cycle: bool = True) -> ConstraintDegree:
    return ConstraintDegree(base, (STEPS_PER_LEVEL_P2,) if cycle else ())


class ZkLispAir:
    """AIR instance for one trace (full or segment-local)."""

    def __init__(self, trace_width: int, trace_len: int,
                 pub_inputs: AirPublicInputs) -> None:
        self.trace_width = trace_width
        self.trace_len = trace_len
        self.pub = pub_inputs
        core = pub_inputs.core

        eff_mask = (pub_inputs.segment_feature_mask
                    if pub_inputs.segment_feature_mask != 0
                    else core.feature_mask)
        self.features = Features.from_mask(eff_mask)
        self.rom_enabled = any(core.program_id)

        suite_id = core.program_id
        dom, mds, rc = poseidon2.suite(suite_id)
        self.poseidon_rc = rc[:POSEIDON_ROUNDS]
        self.poseidon_mds = mds
        self.poseidon_dom = dom
        mds3, rc3 = poseidon2.rom_suite(suite_id)
        self.rom_mds = mds3
        self.rom_rc = rc3[:POSEIDON_ROUNDS]
        self.rom_w_enc0 = rom_weights_for_seed(ROM_W_SEED_0)
        self.rom_w_enc1 = rom_weights_for_seed(ROM_W_SEED_1)

        baseline_width = Columns.baseline().width()
        if trace_width < baseline_width:
            cfg = LayoutConfig(vm=self.features.vm, ram=self.features.ram,
                               sponge=self.features.sponge,
                               merkle=self.features.merkle,
                               rom=self.rom_enabled)
        else:
            cfg = LayoutConfig(rom=self.rom_enabled)
        self.cols = Columns(cfg)

        self.program_fe = (program_field_commitment(core.program_id)
                           if any(core.program_id) else (0, 0))
        self.main_args_fe = list(core.main_args)
        self.vm_usage_mask = pub_inputs.vm_usage_mask
        self.ram_delta_clk_bits = pub_inputs.ram_delta_clk_bits

        self.degrees = self._build_degrees()

    # ------------------------------------------------------------------
    # degrees (push_degrees of each module, in evaluation order)
    # ------------------------------------------------------------------

    def _build_degrees(self) -> List[ConstraintDegree]:
        out: List[ConstraintDegree] = []
        f = self.features
        mask = self.vm_usage_mask
        sponge_used = bool(mask & (1 << VM_USAGE_SPONGE))

        if f.poseidon:
            for _ in range(POSEIDON_ROUNDS * 12):
                out.append(_deg(4))
            for _ in range(12):
                out.append(_deg(1))
            if f.vm and f.sponge and sponge_used:
                for base in (6, 6, 3, 3, 3, 3, 3, 3, 3, 3):
                    out.append(_deg(base))

        if f.vm:
            # ctrl
            for _ in range(5 * NR):
                out.append(_deg(2))
            for _ in range(5):
                out.append(_deg(1))
            for _ in range(NR):
                out.append(_deg(2))
            if f.sponge and sponge_used:
                for _ in range(10 * (SPONGE_IDX_BITS + 1)):
                    out.append(_deg(2))
            out.append(_deg(2))          # select cond boolean slot
            for _ in range(17):
                out.append(_deg(2))
            out.append(_deg(2))          # one-hot sum
            for _ in range(17):
                out.append(_deg(2))      # ROM mirror
            out.append(_deg(1))          # pc carry
            out.append(_deg(1))          # pc increment

            # alu
            use_eq = bool(mask & (1 << VM_USAGE_EQ))
            use_divmod = bool(mask & (1 << VM_USAGE_DIVMOD))
            use_mulwide = bool(mask & (1 << VM_USAGE_MULWIDE))
            use_div128 = bool(mask & (1 << VM_USAGE_DIV128))
            use_assert = bool(mask & (1 << VM_USAGE_ASSERT))
            use_assert_bit = bool(mask & (1 << VM_USAGE_ASSERT_BIT))
            use_assert_range = bool(mask & (1 << VM_USAGE_ASSERT_RANGE))
            for _ in range(NR):
                out.append(_deg(1))
            for _ in range(NR):
                out.append(_deg(7))
            if use_eq:
                out += [_deg(5)] * 2
            if use_divmod:
                out += [_deg(5)] * 2
            if use_assert:
                out.append(_deg(5))
            if use_assert_bit:
                out.append(_deg(5))
            if use_assert_range:
                out += [_deg(5)] * 33
            if use_mulwide:
                out.append(_deg(5))
            if use_div128:
                out += [_deg(5)] * 2

        if f.ram:
            use_delta_clk = bool(mask & (1 << VM_USAGE_RAM_DELTA_CLK))
            out.append(_deg(4))                       # gp_unsorted
            out.append(ConstraintDegree(2))           # gp_sorted
            out.append(ConstraintDegree(5))           # last_write
            out.append(ConstraintDegree(3))           # read==last_write
            out.append(ConstraintDegree(6))           # first-read zero
            out.append(ConstraintDegree(5))           # same booleanity
            if use_delta_clk:
                for i in range(32):
                    if (self.ram_delta_clk_bits >> i) & 1:
                        out.append(ConstraintDegree(5))
                out.append(ConstraintDegree(5))
            out.append(ConstraintDegree(2))           # final gp equality

        if f.merkle:
            out += [_deg(3), _deg(3), _deg(3), _deg(2), _deg(3), _deg(3),
                    _deg(3)]

        if self.rom_enabled:
            for _ in range(POSEIDON_ROUNDS * 3):
                out.append(_deg(3))
            for _ in range(3):
                out.append(_deg(1))
            for _ in range(2):
                out.append(_deg(1))

        if not out:
            out.append(ConstraintDegree(1))
        return out

    def num_transition_constraints(self) -> int:
        return len(self.degrees)

    def max_evaluation_degree(self) -> int:
        return max(d.evaluation_degree(self.trace_len) for d in self.degrees)

    def ce_blowup(self) -> int:
        """Number of constraint composition (quotient) columns.

        Quotient degree = eval_degree - (n - 1) [transition zerofier];
        columns of size n; rounded up to the next power of two like
        winterfell's ce_blowup_factor.
        """
        n = self.trace_len
        dq = self.max_evaluation_degree() - (n - 1)
        q = max(1, -(-(dq + 1) // n))
        p2 = 1
        while p2 < q:
            p2 *= 2
        return p2

    # ------------------------------------------------------------------
    # transition evaluation (on Felt values)
    # ------------------------------------------------------------------

    def evaluate_transition(self, cur: Sequence, next_: Sequence,
                            periodic: Sequence) -> List:
        result: List = []
        f = self.features
        if f.poseidon:
            self._eval_poseidon(cur, next_, periodic, result)
        if f.vm:
            self._eval_ctrl(cur, next_, periodic, result)
            self._eval_alu(cur, next_, periodic, result)
        if f.ram:
            self._eval_ram(cur, next_, periodic, result)
        if f.merkle:
            self._eval_merkle(cur, next_, periodic, result)
        if any(self.pub.core.program_commitment):
            self._eval_rom(cur, next_, periodic, result)
        if not result:
            result.append(cur[self.cols.mask] * 0)
        assert len(result) == len(self.degrees), (
            len(result), len(self.degrees))
        return result

    # mixers (mixers.rs)
    @staticmethod
    def _mix_low(periodic):
        return periodic[1 + POSEIDON_ROUNDS + 3] * periodic[0]

    @classmethod
    def _mix_pi1(cls, periodic, pi):
        return cls._mix_low(periodic) * pi

    @classmethod
    def _mix_pi4(cls, periodic, pi):
        pi2 = pi * pi
        return cls._mix_low(periodic) * (pi2 * pi2)

    @classmethod
    def _mix_pi6(cls, periodic, pi):
        pi2 = pi * pi
        pi4 = pi2 * pi2
        return cls._mix_low(periodic) * (pi4 * pi2)

    def _eval_poseidon(self, cur, next_, periodic, result):
        c = self.cols
        p_map = periodic[0]
        for j in range(POSEIDON_ROUNDS):
            gr = periodic[1 + j]
            pa = cur[c.pose_active]
            s = [cur[c.lane_index(i)] for i in range(12)]
            s3 = [v * v * v for v in s]
            rc_row = self.poseidon_rc[j]
            for i in range(12):
                acc = s3[0] * Felt(self.poseidon_mds[i][0])
                for k in range(1, 12):
                    acc = acc + s3[k] * Felt(self.poseidon_mds[i][k])
                y = acc + Felt(rc_row[i])
                result.append(pa * gr * (next_[c.lane_index(i)] - y))

        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]
        g_hold = p_pad - p_pad_last
        for i in range(12):
            result.append(g_hold * (next_[c.lane_index(i)]
                                    - cur[c.lane_index(i)]))

        sponge_used = bool(self.vm_usage_mask & (1 << VM_USAGE_SPONGE))
        if self.features.vm and self.features.sponge and sponge_used:
            b_sponge = cur[c.op_sponge]
            pa = cur[c.pose_active]
            r = [cur[c.r_index(i)] for i in range(NR)]
            for lane in range(10):
                b0 = cur[c.sel_s_b_index(lane, 0)]
                b1 = cur[c.sel_s_b_index(lane, 1)]
                b2 = cur[c.sel_s_b_index(lane, 2)]
                act = cur[c.sel_s_active_index(lane)]
                s0 = b0 * r[1] + (1 - b0) * r[0]
                s1 = b0 * r[3] + (1 - b0) * r[2]
                s2 = b0 * r[5] + (1 - b0) * r[4]
                s3_ = b0 * r[7] + (1 - b0) * r[6]
                t0 = b1 * s1 + (1 - b1) * s0
                t1 = b1 * s3_ + (1 - b1) * s2
                sel_val = b2 * t1 + (1 - b2) * t0
                lane_expect = act * sel_val
                result.append(p_map * pa * b_sponge
                              * (cur[c.lane_index(lane)] - lane_expect))

    def _eval_ctrl(self, cur, next_, periodic, result):
        c = self.cols
        p_map = periodic[0]
        pi_prog = cur[c.pi_prog]
        s_low = self._mix_low(periodic)
        s_high = self._mix_pi1(periodic, pi_prog)

        ops = [cur[cc] for cc in c.op_columns()]
        (b_const, b_mov, b_add, b_sub, b_mul, b_neg, b_eq, b_sel, b_sponge,
         b_assert, b_assert_bit, b_assert_range, b_divmod, b_div128,
         b_mulwide, b_load, b_store) = ops

        sum_dst0 = sum_a = sum_b = sum_c = sum_dst1 = None
        for i in range(NR):
            sd0 = cur[c.sel_dst0_index(i)]
            sa = cur[c.sel_a_index(i)]
            sb = cur[c.sel_b_index(i)]
            sc = cur[c.sel_c_index(i)]
            sd1 = cur[c.sel_dst1_index(i)]
            sum_dst0 = sd0 if sum_dst0 is None else sum_dst0 + sd0
            sum_a = sa if sum_a is None else sum_a + sa
            sum_b = sb if sum_b is None else sum_b + sb
            sum_c = sc if sum_c is None else sum_c + sc
            sum_dst1 = sd1 if sum_dst1 is None else sum_dst1 + sd1
            result.append(p_map * sd0 * (sd0 - 1) + s_high)
            result.append(p_map * sa * (sa - 1) + s_high)
            result.append(p_map * sb * (sb - 1) + s_high)
            result.append(p_map * sc * (sc - 1) + s_high)
            result.append(p_map * sd1 * (sd1 - 1) + s_high)

        uses_a = (b_mov + b_add + b_sub + b_mul + b_neg + b_eq + b_sel
                  + b_divmod + b_div128 + b_mulwide + b_load + b_store)
        uses_b = (b_add + b_sub + b_mul + b_eq + b_sel + b_divmod + b_div128
                  + b_mulwide + b_store)
        uses_c = b_sel + b_assert + b_assert_bit + b_assert_range
        op_any = (b_const + b_mov + b_add + b_sub + b_mul + b_neg + b_eq
                  + b_sel + b_sponge + b_assert + b_assert_bit
                  + b_assert_range + b_divmod + b_div128 + b_mulwide)
        uses_dst0 = op_any - b_sponge + b_load
        uses_dst1 = b_divmod + b_div128 + b_mulwide

        result.append(p_map * (sum_dst0 - uses_dst0) + s_low)
        result.append(p_map * (sum_a - uses_a) + s_low)
        result.append(p_map * (sum_b - uses_b) + s_low)
        result.append(p_map * (sum_c - uses_c) + s_low)
        result.append(p_map * (sum_dst1 - uses_dst1) + s_low)

        for i in range(NR):
            sd0 = cur[c.sel_dst0_index(i)]
            sd1 = cur[c.sel_dst1_index(i)]
            result.append(p_map * sd0 * sd1 + s_high)

        sponge_used = bool(self.vm_usage_mask & (1 << VM_USAGE_SPONGE))
        if self.features.sponge and sponge_used:
            for lane in range(10):
                for b in range(SPONGE_IDX_BITS):
                    bitv = cur[c.sel_s_b_index(lane, b)]
                    result.append(p_map * bitv * (bitv - 1) + s_high)
                act = cur[c.sel_s_active_index(lane)]
                result.append(p_map * act * (act - 1) + s_high)

        # select cond booleanity placeholder (enforced at final in ALU)
        result.append(s_high + cur[c.mask] * 0)

        for b in ops:
            result.append(p_map * b * (b - 1) + s_high)

        op_sum = ops[0]
        for b in ops[1:]:
            op_sum = op_sum + b
        result.append(p_map * op_sum * (op_sum - 1) + s_high)

        rom_enabled = Felt(1 if any(self.pub.core.program_commitment)
                           else 0)
        for k, b in enumerate(ops):
            rom_b = cur[c.rom_op_index(k)]
            result.append(rom_enabled * p_map * (b - rom_b) + s_high)

        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]
        g_carry = p_map + (p_pad - p_pad_last)
        for j in range(POSEIDON_ROUNDS - 1):
            g_carry = g_carry + periodic[1 + j]

        pc_cur = cur[c.pc]
        pc_next = next_[c.pc]
        result.append(rom_enabled * (g_carry * (pc_next - pc_cur)) + s_low)
        result.append(rom_enabled
                      * (p_pad_last * (pc_next - (pc_cur + 1))) + s_low)

    def _eval_alu(self, cur, next_, periodic, result):
        c = self.cols
        mask = self.vm_usage_mask
        use_eq = bool(mask & (1 << VM_USAGE_EQ))
        use_divmod = bool(mask & (1 << VM_USAGE_DIVMOD))
        use_mulwide = bool(mask & (1 << VM_USAGE_MULWIDE))
        use_div128 = bool(mask & (1 << VM_USAGE_DIV128))
        use_assert = bool(mask & (1 << VM_USAGE_ASSERT))
        use_assert_bit = bool(mask & (1 << VM_USAGE_ASSERT_BIT))
        use_assert_range = bool(mask & (1 << VM_USAGE_ASSERT_RANGE))

        p_map = periodic[0]
        p_final = periodic[1 + POSEIDON_ROUNDS]
        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]

        pi_prog = cur[c.pi_prog]
        s_low = self._mix_low(periodic)
        s_write = self._mix_pi6(periodic, pi_prog)
        s_eq = self._mix_pi4(periodic, pi_prog)

        g_carry = p_map + (p_pad - p_pad_last)
        for j in range(POSEIDON_ROUNDS - 1):
            g_carry = g_carry + periodic[1 + j]

        a_val = b_val = c_val = None
        for i in range(NR):
            r = cur[c.r_index(i)]
            ta = cur[c.sel_a_index(i)] * r
            tb = cur[c.sel_b_index(i)] * r
            tc = cur[c.sel_c_index(i)] * r
            a_val = ta if a_val is None else a_val + ta
            b_val = tb if b_val is None else b_val + tb
            c_val = tc if c_val is None else c_val + tc

        for i in range(NR):
            result.append(g_carry * (next_[c.r_index(i)] - cur[c.r_index(i)])
                          + s_low)

        imm = cur[c.imm]
        b_const = cur[c.op_const]
        b_mov = cur[c.op_mov]
        b_add = cur[c.op_add]
        b_sub = cur[c.op_sub]
        b_mul = cur[c.op_mul]
        b_neg = cur[c.op_neg]
        b_eq = cur[c.op_eq]
        b_sel = cur[c.op_select]
        b_sponge = cur[c.op_sponge]
        b_assert = cur[c.op_assert]
        mode64 = cur[c.eq_inv]
        b_assert_bit = cur[c.op_assert_bit]
        b_assert_range = cur[c.op_assert_range]
        b_divmod = cur[c.op_divmod]
        b_mulwide = cur[c.op_mulwide]
        b_div128 = cur[c.op_div128]
        b_load = cur[c.op_load]

        dst0_next = dst0_cur = dst1_next = None
        for i in range(NR):
            t_n = cur[c.sel_dst0_index(i)] * next_[c.r_index(i)]
            t_c = cur[c.sel_dst0_index(i)] * cur[c.r_index(i)]
            t1 = cur[c.sel_dst1_index(i)] * next_[c.r_index(i)]
            dst0_next = t_n if dst0_next is None else dst0_next + t_n
            dst0_cur = t_c if dst0_cur is None else dst0_cur + t_c
            dst1_next = t1 if dst1_next is None else dst1_next + t1

        res = (b_const * imm + b_mov * a_val + b_add * (a_val + b_val)
               + b_sub * (a_val - b_val) + b_mul * (a_val * b_val)
               + b_neg * (0 - a_val)
               + b_sel * (c_val * a_val + (1 - c_val) * b_val)
               + b_sponge * cur[c.lane_l]
               + b_load * imm)
        if use_eq:
            res = res + b_eq * dst0_next
        if use_assert:
            res = res + b_assert
        if use_assert_bit:
            res = res + b_assert_bit

        bit_sum = None
        pow2 = 1
        for i in range(32):
            bi = cur[c.gadget_b_index(i)]
            t = bi * Felt(pow2)
            bit_sum = t if bit_sum is None else bit_sum + t
            pow2 = (pow2 * 2) % P

        if use_assert_range:
            res = res + b_assert_range * ((1 - imm) * bit_sum + imm)

        uses_two = use_divmod or use_mulwide or use_div128
        b_two = (b_divmod + b_mulwide + b_div128) if uses_two else None

        for i in range(NR):
            sd0 = cur[c.sel_dst0_index(i)]
            sd1 = cur[c.sel_dst1_index(i)]
            keep = 1 - sd0 - sd1
            if uses_two:
                w0 = (1 - b_two) * res + b_two * dst0_next
                w1 = b_two * dst1_next
            else:
                w0 = res
                w1 = Felt(0)
            result.append(
                p_final * (next_[c.r_index(i)]
                           - (keep * cur[c.r_index(i)] + sd0 * w0
                              + sd1 * w1)) + s_write)

        diff = a_val - b_val
        inv = cur[c.eq_inv]
        if use_eq:
            result.append(p_final * b_eq * (dst0_next * diff) + s_eq)
            result.append(p_final * b_eq * ((1 - dst0_next) - diff * inv)
                          + s_eq)
        if use_divmod:
            inv_b = cur[c.eq_inv]
            result.append(p_final * b_divmod
                          * (a_val - b_val * dst0_next - dst1_next) + s_eq)
            result.append(p_final * b_divmod * (b_val * inv_b - 1) + s_eq)

        p2_64 = Felt(POW2_64)
        if use_mulwide:
            result.append(
                p_final * b_mulwide
                * (a_val * b_val - (dst0_next + dst1_next * p2_64)) + s_eq)

        num128 = a_val * p2_64 + imm
        if use_div128:
            result.append(p_final * b_div128
                          * (num128 - (b_val * dst0_next + dst1_next))
                          + s_eq)
            inv_b = cur[c.eq_inv]
            result.append(p_final * b_div128 * (b_val * inv_b - 1) + s_eq)

        if use_assert:
            result.append(
                p_final * (b_assert * (c_val - 1)
                           + b_sel * (c_val * (c_val - 1))) + s_eq)
        if use_assert_bit:
            result.append(p_final * b_assert_bit * (c_val * (c_val - 1))
                          + s_eq)
        if use_assert_range:
            for i in range(32):
                bi = cur[c.gadget_b_index(i)]
                result.append(p_final * b_assert_range * (bi * (bi - 1))
                              + s_eq)
            p2_32 = Felt(pow(2, 32, P))
            eq32 = c_val - bit_sum
            eq64 = c_val - (dst0_cur + bit_sum * p2_32)
            eq_term = imm * (mode64 * eq64 + (1 - mode64) * eq32)
            result.append(p_final * b_assert_range * eq_term + s_eq)

    def _eval_ram(self, cur, next_, periodic, result):
        c = self.cols
        p_final = periodic[1 + POSEIDON_ROUNDS]
        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]
        p_last = periodic[1 + POSEIDON_ROUNDS + 3]
        g_hold = p_pad - p_pad_last

        op_load = cur[c.op_load]
        op_store = cur[c.op_store]
        event = p_final * (op_load + op_store)

        pi0 = Felt(self.program_fe[0])
        pi2 = pi0 * pi0
        pi3 = pi2 * pi0
        pi4 = pi2 * pi2
        pi5 = pi4 * pi0
        r1 = pi2 + 1
        r2 = pi3 + pi0
        r3 = pi5 + 7

        a_ev = b_ev = None
        for i in range(NR):
            ri = cur[c.r_index(i)]
            ta = cur[c.sel_a_index(i)] * ri
            tb = cur[c.sel_b_index(i)] * ri
            a_ev = ta if a_ev is None else a_ev + ta
            b_ev = tb if b_ev is None else b_ev + tb

        w_ev = op_store
        val_ev = w_ev * b_ev + (1 - w_ev) * cur[c.imm]
        clk_ev = cur[c.pc]
        comp_uns = a_ev + r1 * clk_ev + r2 * val_ev + r3 * w_ev

        result.append(
            event * (next_[c.ram_gp_unsorted]
                     - (cur[c.ram_gp_unsorted] + comp_uns))
            + (1 - event) * (next_[c.ram_gp_unsorted]
                             - cur[c.ram_gp_unsorted])
            + g_hold * (next_[c.ram_gp_unsorted] - cur[c.ram_gp_unsorted]))

        s_on = cur[c.ram_sorted]
        s_addr = cur[c.ram_s_addr]
        s_clk = cur[c.ram_s_clk]
        s_val = cur[c.ram_s_val]
        s_w = cur[c.ram_s_is_write]
        last = cur[c.ram_s_last_write]
        s_addr_n = next_[c.ram_s_addr]
        s_clk_n = next_[c.ram_s_clk]
        last_n = next_[c.ram_s_last_write]

        d_addr = s_addr_n - s_addr
        inv = cur[c.eq_inv]
        same = 1 - d_addr * inv

        comp = s_addr + r1 * s_clk + r2 * s_val + r3 * s_w
        result.append(
            s_on * (next_[c.ram_gp_sorted] - (cur[c.ram_gp_sorted] + comp))
            + (1 - s_on) * (next_[c.ram_gp_sorted] - cur[c.ram_gp_sorted]))

        last_keep = (same * ((1 - s_w) * last + s_w * s_val)
                     + (1 - same) * (s_w * s_val))
        result.append(s_on * (last_n - last_keep))
        result.append(s_on * (1 - s_w) * (s_val - last))

        s_on_n = next_[c.ram_sorted]
        s_w_n = next_[c.ram_s_is_write]
        s_val_n = next_[c.ram_s_val]
        result.append(s_on * s_on_n * (1 - same) * (1 - s_w_n) * s_val_n)
        result.append(s_on * (same * (same - 1)))

        use_delta_clk = bool(self.vm_usage_mask
                             & (1 << VM_USAGE_RAM_DELTA_CLK))
        if use_delta_clk:
            d_clk = s_clk_n - s_clk
            bits = self.ram_delta_clk_bits
            bit_sum = None
            pow2 = 1
            for i in range(32):
                bi = cur[c.gadget_b_index(i)]
                if (bits >> i) & 1:
                    result.append(s_on * same * bi * (bi - 1))
                t = bi * Felt(pow2)
                bit_sum = t if bit_sum is None else bit_sum + t
                pow2 = (pow2 * 2) % P
            result.append(s_on * s_on_n * same * (d_clk - bit_sum))

        result.append(p_last * (cur[c.ram_gp_unsorted]
                                - cur[c.ram_gp_sorted]))

    def _eval_merkle(self, cur, next_, periodic, result):
        c = self.cols
        p_map = periodic[0]
        p_final = periodic[1 + POSEIDON_ROUNDS]
        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]

        g = cur[c.merkle_g]
        dir_ = cur[c.merkle_dir]
        acc = cur[c.merkle_acc]
        sib = cur[c.merkle_sib]

        result.append(p_map * g * dir_ * (dir_ - 1))
        left = (1 - dir_) * acc + dir_ * sib
        right = (1 - dir_) * sib + dir_ * acc
        result.append(p_map * g * (cur[c.lane_l] - left))
        result.append(p_map * g * (cur[c.lane_r] - right))

        g_hold = p_map + (p_pad - p_pad_last)
        for j in range(POSEIDON_ROUNDS - 1):
            g_hold = g_hold + periodic[1 + j]
        result.append(g * g_hold * (next_[c.merkle_acc] - cur[c.merkle_acc]))

        is_first = cur[c.merkle_first]
        result.append(p_map * g * is_first * (acc - cur[c.merkle_leaf]))

        is_last = cur[c.merkle_last]
        root = Felt(be_from_le8(self.pub.core.merkle_root))
        result.append(p_final * g * is_last * (cur[c.merkle_acc] - root))

        g_next = next_[c.merkle_g]
        result.append(p_pad_last * g * g_next
                      * (next_[c.merkle_acc] - cur[c.merkle_acc]))

    def _eval_rom(self, cur, next_, periodic, result):
        c = self.cols
        for j in range(POSEIDON_ROUNDS):
            gr = periodic[1 + j]
            s = [cur[c.rom_s_index(i)] for i in range(3)]
            s3 = [v * v * v for v in s]
            rc = self.rom_rc[j]
            for i in range(3):
                acc = s3[0] * Felt(self.rom_mds[i][0])
                acc = acc + s3[1] * Felt(self.rom_mds[i][1])
                acc = acc + s3[2] * Felt(self.rom_mds[i][2])
                y = acc + Felt(rc[i])
                result.append(gr * (next_[c.rom_s_index(i)] - y))

        p_pad = periodic[1 + POSEIDON_ROUNDS + 1]
        p_pad_last = periodic[1 + POSEIDON_ROUNDS + 2]
        g_hold = p_pad - p_pad_last
        for i in range(3):
            result.append(g_hold * (next_[c.rom_s_index(i)]
                                    - cur[c.rom_s_index(i)]))

        p_map = periodic[0]
        enc_cols = rom_encode_columns(c)
        enc0 = enc1 = None
        for k, cc in enumerate(enc_cols):
            v = cur[cc]
            t0 = v * Felt(self.rom_w_enc0[k])
            t1 = v * Felt(self.rom_w_enc1[k])
            enc0 = t0 if enc0 is None else enc0 + t0
            enc1 = t1 if enc1 is None else enc1 + t1
        result.append(p_map * (cur[c.rom_s_index(1)] - enc0))
        result.append(p_map * (cur[c.rom_s_index(2)] - enc1))

    # ------------------------------------------------------------------
    # boundary assertions (mod.rs get_assertions + module assertions)
    # ------------------------------------------------------------------

    def get_assertions(self) -> List[Tuple[int, int, int]]:
        """Deduped (column, step, value) list."""
        c = self.cols
        last = self.trace_len - 1
        out: List[Tuple[int, int, int]] = []

        # ScheduleAir per-level assertions
        steps = STEPS_PER_LEVEL_P2
        lvls = (last + 1) // steps
        for lvl in range(lvls):
            base = lvl * steps
            row_map = base + pos_map()
            row_final = base + pos_final()
            out.append((c.lane_c0, row_map, self.poseidon_dom[0]))
            out.append((c.lane_c1, row_map, self.poseidon_dom[1]))
            out.append((c.g_map, row_map, 1))
            out.append((c.g_final, row_final, 1))
            for j in range(POSEIDON_ROUNDS):
                out.append((c.g_r_index(j), base + 1 + j, 1))
            out.append((c.g_final, row_map, 0))
            for j in range(POSEIDON_ROUNDS):
                out.append((c.g_r_index(j), row_map, 0))
            out.append((c.g_map, row_final, 0))
            for j in range(POSEIDON_ROUNDS):
                out.append((c.g_r_index(j), row_final, 0))
            for j in range(POSEIDON_ROUNDS):
                rj = base + 1 + j
                out.append((c.g_map, rj, 0))
                out.append((c.g_final, rj, 0))
            if lvl == 0 and self.features.vm:
                if (self.pub.pc_init == 0
                        and any(self.pub.core.program_commitment)):
                    pc = be_from_le8(self.pub.core.program_commitment)
                    out.append((c.pi_prog, row_map, pc))
                out.append((c.pc, row_map, self.pub.pc_init))

        if self.features.vm:
            if self.features.vm_expect:
                row = min(self.pub.core.vm_out_row, last)
                reg = min(self.pub.core.vm_out_reg, NR - 1)
                exp = be_from_le8(self.pub.core.vm_expected_bytes)
                out.append((c.r_index(reg), row, exp))
            if self.pub.pc_init == 0 and self.main_args_fe:
                slots = len(self.main_args_fe)
                tail_start = NR - slots
                for j, val in enumerate(self.main_args_fe):
                    out.append((c.r_index(tail_start + j), 0, val))

        if any(self.pub.core.program_commitment):
            row_map0 = pos_map()
            for i in range(3):
                out.append((c.rom_s_index(i), row_map0,
                            self.pub.rom_s_in[i]))
            for i in range(3):
                out.append((c.rom_s_index(i), last, self.pub.rom_s_out[i]))

        if not out:
            out.append((c.mask, last, 0))

        seen = {}
        dedup = []
        for col, step, val in out:
            key = (col, step)
            if key in seen:
                assert seen[key] == val % P, (
                    f"conflicting assertions at {key}")
                continue
            seen[key] = val % P
            dedup.append((col, step, val % P))
        return dedup

    # ------------------------------------------------------------------
    # periodic columns
    # ------------------------------------------------------------------

    def periodic_values_at_point(self, z: int) -> List[Felt]:
        """Periodic polynomials evaluated at an OOD point z.

        Each cycle-32 selector for position p is the Lagrange basis
        L_p(y) over the 32-point domain, evaluated at y = z^(n/32);
        p_last is the Lagrange basis at g^(n-1) over the full domain.
        """
        n = self.trace_len
        cycle = STEPS_PER_LEVEL_P2
        y = pow(z, n // cycle, P)
        g32 = root_of_unity(cycle)
        y_pow = pow(y, cycle, P)

        vals = []
        # positions: col 0 -> pos 0; col 1+j -> pos 1+j; final -> 28;
        # pad -> sum over pad positions; pad_last -> 31
        def lagrange32(pos_: int) -> int:
            gp = pow(g32, pos_, P)
            if y == gp:
                return 1
            num = (y_pow - 1) % P
            den = (cycle * (y - gp)) % P
            return num * pow(gp, 1, P) % P * f_inv(den) % P

        vals.append(Felt(lagrange32(0)))
        for j in range(POSEIDON_ROUNDS):
            vals.append(Felt(lagrange32(1 + j)))
        vals.append(Felt(lagrange32(pos_final())))
        pad_val = 0
        for pos_ in range(cycle):
            if is_pad_pos(pos_):
                pad_val = (pad_val + lagrange32(pos_)) % P
        vals.append(Felt(pad_val))
        vals.append(Felt(lagrange32(cycle - 1)))

        # p_last: Lagrange at g^(n-1) over full domain
        g = root_of_unity(n)
        gl = pow(g, n - 1, P)
        if z == gl:
            vals.append(Felt(1))
        else:
            num = (pow(z, n, P) - 1) % P
            den = (n * (z - gl)) % P
            vals.append(Felt(num * gl % P * f_inv(den) % P))
        return vals
