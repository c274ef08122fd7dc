"""The trace column layout of the zk-lisp VM (src/vm/layout.rs), for the
benchmark's AIR (reference/air.py): a frozen copy of the port's.

The 219-column baseline layout is kept bit-compatible with the reference so
that segment feature masks, ROM linear encodings and AIR constraints agree.
"""

from __future__ import annotations

from dataclasses import dataclass

POSEIDON_ROUNDS = 27
STEPS_PER_LEVEL_P2 = 32
NR = 8
SPONGE_IDX_BITS = 3

# vm_usage_mask bits (layout.rs:35-48)
VM_USAGE_ASSERT = 0
VM_USAGE_ASSERT_BIT = 1
VM_USAGE_ASSERT_RANGE = 2
VM_USAGE_DIVMOD = 3
VM_USAGE_MULWIDE = 4
VM_USAGE_DIV128 = 5
VM_USAGE_EQ = 6
VM_USAGE_SPONGE = 7
VM_USAGE_RAM_DELTA_CLK = 8


@dataclass(frozen=True)
class LayoutConfig:
    vm: bool = True
    ram: bool = True
    sponge: bool = True
    merkle: bool = True
    rom: bool = True


class Columns:
    """Column indices; mirrors layout.rs Columns::for_config exactly."""

    def __init__(self, cfg: LayoutConfig) -> None:
        self.cfg = cfg
        lanes_start = 0
        self.lanes_start = lanes_start
        self.lane_l = lanes_start
        self.lane_r = lanes_start + 1
        self.lane_c0 = lanes_start + 10
        self.lane_c1 = lanes_start + 11

        cur = lanes_start + 12
        self.g_map = cur
        self.g_final = self.g_map + 1
        self.g_r_start = self.g_final + 1
        cur = self.g_r_start + POSEIDON_ROUNDS

        self.mask = cur
        cur += 1

        self.r_start = cur
        cur += NR

        self.op_const = cur
        self.op_mov = self.op_const + 1
        self.op_add = self.op_mov + 1
        self.op_sub = self.op_add + 1
        self.op_mul = self.op_sub + 1
        self.op_neg = self.op_mul + 1
        self.op_eq = self.op_neg + 1
        self.op_select = self.op_eq + 1
        self.op_sponge = self.op_select + 1
        self.op_assert = self.op_sponge + 1
        self.op_assert_bit = self.op_assert + 1
        self.op_assert_range = self.op_assert_bit + 1
        self.op_divmod = self.op_assert_range + 1
        self.op_div128 = self.op_divmod + 1
        self.op_mulwide = self.op_div128 + 1
        self.op_load = self.op_mulwide + 1
        self.op_store = self.op_load + 1
        cur = self.op_store + 1

        self.sel_dst0_start = cur
        self.sel_a_start = self.sel_dst0_start + NR
        self.sel_b_start = self.sel_a_start + NR
        self.sel_c_start = self.sel_b_start + NR
        self.sel_dst1_start = self.sel_c_start + NR
        cur = self.sel_dst1_start + NR

        self.sel_s_bits_start = cur
        self.sel_s_active_start = self.sel_s_bits_start + 10 * SPONGE_IDX_BITS
        cur = self.sel_s_active_start + 10

        self.imm = cur
        self.eq_inv = self.imm + 1
        cur = self.eq_inv + 1

        self.ram_sorted = cur
        self.ram_s_addr = self.ram_sorted + 1
        self.ram_s_clk = self.ram_s_addr + 1
        self.ram_s_val = self.ram_s_clk + 1
        self.ram_s_is_write = self.ram_s_val + 1
        self.ram_s_last_write = self.ram_s_is_write + 1
        self.ram_gp_unsorted = self.ram_s_last_write + 1
        self.ram_gp_sorted = self.ram_gp_unsorted + 1
        after_ram = self.ram_gp_sorted + 1
        if cfg.ram:
            cur = after_ram

        self.merkle_g = cur
        self.merkle_dir = self.merkle_g + 1
        self.merkle_sib = self.merkle_dir + 1
        self.merkle_acc = self.merkle_sib + 1
        self.merkle_first = self.merkle_acc + 1
        self.merkle_last = self.merkle_first + 1
        self.merkle_leaf = self.merkle_last + 1
        after_merkle = self.merkle_leaf + 1
        if cfg.merkle:
            cur = after_merkle

        self.pi_prog = cur
        cur += 1
        self.pc = cur
        cur += 1

        self.rom_op_start = cur
        after_rom_op = self.rom_op_start + 17
        if cfg.rom:
            cur = after_rom_op

        self.pose_active = cur
        cur += 1

        self.gadget_b_start = cur
        cur = self.gadget_b_start + 32

        rom_s_start = cur
        after_rom_s = rom_s_start + 3
        if cfg.rom:
            cur = after_rom_s

        width = cur
        if not cfg.rom:
            width = self.pc + 1
        self._width = width

    @staticmethod
    def baseline() -> "Columns":
        return Columns(LayoutConfig())

    def g_r_index(self, j: int) -> int:
        return self.g_r_start + j

    def r_index(self, i: int) -> int:
        return self.r_start + i

    def sel_dst0_index(self, i: int) -> int:
        return self.sel_dst0_start + i

    def sel_dst1_index(self, i: int) -> int:
        return self.sel_dst1_start + i

    def sel_a_index(self, i: int) -> int:
        return self.sel_a_start + i

    def sel_b_index(self, i: int) -> int:
        return self.sel_b_start + i

    def sel_c_index(self, i: int) -> int:
        return self.sel_c_start + i

    def sel_s_b_index(self, lane: int, bit: int) -> int:
        return self.sel_s_bits_start + lane * SPONGE_IDX_BITS + bit

    def sel_s_active_index(self, lane: int) -> int:
        return self.sel_s_active_start + lane

    def gadget_b_index(self, i: int) -> int:
        return self.gadget_b_start + i

    def lane_index(self, i: int) -> int:
        return self.lanes_start + i

    def rom_op_index(self, i: int) -> int:
        return self.rom_op_start + i

    def rom_s_index(self, i: int) -> int:
        return self.gadget_b_start + 32 + i

    def width(self) -> int:
        return self._width

    def op_columns(self):
        """The 17 opcode one-hot columns in canonical order."""
        return (self.op_const, self.op_mov, self.op_add, self.op_sub,
                self.op_mul, self.op_neg, self.op_eq, self.op_select,
                self.op_sponge, self.op_assert, self.op_assert_bit,
                self.op_assert_range, self.op_divmod, self.op_div128,
                self.op_mulwide, self.op_load, self.op_store)
