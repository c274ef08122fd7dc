"""Pure-Python BLAKE3 implementation.

zk-lisp-tpu uses BLAKE3 as the byte-level random oracle for:
  * program commitments (reference: zk-lisp-compiler/src/builder.rs:654-662)
  * public-input digests (reference: zk-lisp-proof/src/pi.rs:113-147)
  * Poseidon2 suite parameter derivation
    (reference: zk-lisp-proof-winterfell/src/poseidon/mod.rs:421-440)
  * VM boundary state hashes (reference: .../src/utils.rs:312-344)

All of these are small, host-side inputs (bytes to a few KB), so a pure
Python implementation is sufficient; the proving hot path hashes with
Poseidon on-device, never with BLAKE3.

Implemented from the public BLAKE3 specification (chunked Merkle tree over
1024-byte chunks, 7-round compression function).
"""

from __future__ import annotations

import struct

MASK32 = 0xFFFFFFFF

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state, m):
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & MASK32, (counter >> 32) & MASK32, block_len, flags,
    ]
    m = list(block_words)
    for _ in range(6):
        _round(state, m)
        m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    _round(state, m)
    for i in range(8):
        state[i] ^= state[i + 8]
        state[i + 8] ^= cv[i]
    return state


def _words_from_block(block: bytes):
    if len(block) < BLOCK_LEN:
        block = block + b"\x00" * (BLOCK_LEN - len(block))
    return struct.unpack("<16I", block)


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool):
    """Compress one chunk (<= 1024 bytes); returns (cv, root_state_or_None)."""
    cv = list(IV)
    blocks = [chunk[i:i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    out_state = None
    for bi, block in enumerate(blocks):
        flags = 0
        if bi == 0:
            flags |= CHUNK_START
        if bi == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        words = _words_from_block(block)
        state = _compress(cv, words, chunk_counter, len(block), flags)
        cv = state[:8]
        out_state = state
    return cv, out_state


def _parent_cv(left_cv, right_cv, is_root: bool):
    block = list(left_cv) + list(right_cv)
    flags = PARENT | (ROOT if is_root else 0)
    state = _compress(list(IV), block, 0, BLOCK_LEN, flags)
    return state[:8], state


def _largest_power_of_two_lt(n: int) -> int:
    assert n > 1
    return 1 << ((n - 1).bit_length() - 1)


def _subtree_cv(data: bytes, chunk_counter: int, is_root: bool):
    n_chunks = max(1, (len(data) + CHUNK_LEN - 1) // CHUNK_LEN)
    if n_chunks == 1:
        return _chunk_cv(data, chunk_counter, is_root)
    left_chunks = _largest_power_of_two_lt(n_chunks)
    split = left_chunks * CHUNK_LEN
    left_cv, _ = _subtree_cv(data[:split], chunk_counter, False)
    right_cv, _ = _subtree_cv(data[split:], chunk_counter + left_chunks, False)
    return _parent_cv(left_cv, right_cv, is_root)


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """Hash `data` with BLAKE3 (default hash mode), producing `out_len` bytes.

    Extended output beyond 64 bytes is not needed by zk-lisp-tpu and is not
    implemented.
    """
    if out_len > 64:
        raise ValueError("extended XOF output not supported")
    _, root_state = _subtree_cv(bytes(data), 0, True)
    out = struct.pack("<16I", *[w & MASK32 for w in root_state])
    return out[:out_len]


class Hasher:
    """Incremental-looking convenience wrapper (buffers input)."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def update(self, data: bytes) -> "Hasher":
        self._parts.append(bytes(data))
        return self

    def finalize(self, out_len: int = 32) -> bytes:
        return blake3(b"".join(self._parts), out_len)

    def digest(self, out_len: int = 32) -> bytes:
        return self.finalize(out_len)
