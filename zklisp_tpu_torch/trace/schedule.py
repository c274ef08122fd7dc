"""Periodic 32-row level schedule (reference: src/vm/schedule.rs)."""

from __future__ import annotations

from typing import List

from .layout import POSEIDON_ROUNDS, STEPS_PER_LEVEL_P2


def pos_map() -> int:
    return 0


def is_round_pos(pos: int) -> bool:
    return 1 <= pos <= POSEIDON_ROUNDS


def pos_final() -> int:
    return 1 + POSEIDON_ROUNDS


def is_pad_pos(pos: int) -> bool:
    return pos != pos_map() and pos != pos_final() and not is_round_pos(pos)


def build_periodic_selectors(n: int) -> List[List[int]]:
    """31 periodic selector columns + last-row column (schedule.rs:35-80).

    Order: [map, round_0..round_26, final, pad, last_pad_in_level,
    last_row_in_trace].
    """
    cycle = STEPS_PER_LEVEL_P2
    cols_len = 1 + POSEIDON_ROUNDS + 1 + 1 + 1 + 1
    out = [[0] * n for _ in range(cols_len)]
    if n == 0:
        return out
    for row in range(n):
        pos = row % cycle
        if pos == pos_map():
            out[0][row] = 1
        for j in range(POSEIDON_ROUNDS):
            if pos == 1 + j:
                out[1 + j][row] = 1
        if pos == pos_final():
            out[1 + POSEIDON_ROUNDS][row] = 1
        if is_pad_pos(pos):
            out[1 + POSEIDON_ROUNDS + 1][row] = 1
        if pos == cycle - 1:
            out[1 + POSEIDON_ROUNDS + 2][row] = 1
    out[1 + POSEIDON_ROUNDS + 3][n - 1] = 1
    return out
