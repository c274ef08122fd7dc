"""BLAKE3 (hash mode, 32-byte output), written from the public
specification (github.com/BLAKE3-team/BLAKE3-specs, section 2) for the
benchmark's reference: chunks of 1,024 bytes compressed block by block,
chaining values merged on a stack as each chunk completes, the root
compression flagged ROOT.
"""

from __future__ import annotations

import struct

_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
_M32 = 0xFFFFFFFF
_CHUNK_START, _CHUNK_END, _PARENT, _ROOT = 1, 2, 4, 8
_BLOCK, _CHUNK = 64, 1024
_COLS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
         (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _compress(cv, words, counter, block_len, flags):
    v = list(cv) + list(_IV[:4]) + [counter & _M32, counter >> 32,
                                    block_len, flags]
    m = list(words)
    for rnd in range(7):
        for k, (a, b, c, d) in enumerate(_COLS):
            x, y = m[2 * k], m[2 * k + 1]
            v[a] = (v[a] + v[b] + x) & _M32
            t = v[d] ^ v[a]
            v[d] = ((t >> 16) | (t << 16)) & _M32
            v[c] = (v[c] + v[d]) & _M32
            t = v[b] ^ v[c]
            v[b] = ((t >> 12) | (t << 20)) & _M32
            v[a] = (v[a] + v[b] + y) & _M32
            t = v[d] ^ v[a]
            v[d] = ((t >> 8) | (t << 24)) & _M32
            v[c] = (v[c] + v[d]) & _M32
            t = v[b] ^ v[c]
            v[b] = ((t >> 7) | (t << 25)) & _M32
        if rnd < 6:
            m = [m[i] for i in _PERM]
    return [v[i] ^ v[i + 8] for i in range(8)]


def _words(block: bytes):
    return struct.unpack("<16I", block.ljust(_BLOCK, b"\x00"))


def _chunk_output(chunk: bytes, counter: int):
    """(cv, last block words, its length, its flags) of one chunk: every
    block but the last is compressed; the last is returned so that the
    caller can flag it ROOT when the chunk is the whole input."""
    cv = list(_IV)
    blocks = [chunk[i:i + _BLOCK] for i in range(0, len(chunk), _BLOCK)]
    blocks = blocks or [b""]
    for i, blk in enumerate(blocks[:-1]):
        cv = _compress(cv, _words(blk), counter, _BLOCK,
                       _CHUNK_START if i == 0 else 0)
    flags = _CHUNK_END | (_CHUNK_START if len(blocks) == 1 else 0)
    return cv, _words(blocks[-1]), len(blocks[-1]), flags, counter


def blake3(data: bytes) -> bytes:
    """The 32-byte BLAKE3 hash of `data`."""
    data = bytes(data)
    chunks = [data[i:i + _CHUNK] for i in range(0, len(data), _CHUNK)]
    chunks = chunks or [b""]
    stack = []
    out = None
    for n, chunk in enumerate(chunks):
        out = _chunk_output(chunk, n)
        if n == len(chunks) - 1:
            break
        cv = _compress(out[0], out[1], out[4], out[2], out[3])
        total = n + 1
        while total & 1 == 0:            # merge completed subtrees
            cv = _compress(_IV, stack.pop() + cv, 0, _BLOCK, _PARENT)
            total >>= 1
        stack.append(cv)
    cv, words, blen, flags, counter = out
    if not stack:
        return struct.pack("<8I", *_compress(cv, words, counter, blen,
                                             flags | _ROOT))
    right = _compress(cv, words, counter, blen, flags)
    while len(stack) > 1:
        right = _compress(_IV, stack.pop() + right, 0, _BLOCK, _PARENT)
    return struct.pack("<8I", *_compress(_IV, stack.pop() + right, 0,
                                         _BLOCK, _PARENT | _ROOT))
