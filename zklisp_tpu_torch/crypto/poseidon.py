"""Poseidon2 parameter derivation and host-side permutation/sponge.

Faithful reimplementation of the reference derivation
(zk-lisp-proof-winterfell/src/poseidon/mod.rs):

  * per-suite_id deterministic parameters via a BLAKE3 random oracle with
    domain strings `zkl/poseidon2/*` (t=12) and `zkl/rom3/*` (t=3 ROM)
  * 12x12 / 3x3 Cauchy MDS with a retry loop avoiding x+y == 0
  * full-round x^3 S-box, 27 rounds by default (vm/layout.rs:22)
  * rate-10 sponge over 32-byte chunks folded to field elements

Also implements the Winterfell hasher semantics used for Merkle commitments
and the Fiat-Shamir random coin (poseidon/hasher.rs): domains
`zkl/winter/hash/{bytes,merge,merge_many,merge_with_int}` and
`winter/hash/elements`, digest = 16 LE bytes of sponge lane 0 padded to 32.

Host-side only: the proving hot path evaluates batched permutations
on-device (crypto/poseidon_jax.py); this module is the reference
implementation those kernels are tested against, and serves small inputs
(parameter derivation, program commitments, transcript hashing).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from ..field import f128
from .blake3 import blake3

P = f128.P

POSEIDON_ROUNDS = 27
RATE = 10
T = 12

DOM_POSEIDON_RC = b"zkl/poseidon2/rc"
DOM_POSEIDON_DOM0 = b"zkl/poseidon2/dom/c0"
DOM_POSEIDON_DOM1 = b"zkl/poseidon2/dom/c1"
DOM_POSEIDON_MDS_X = b"zkl/poseidon2/mds/x"
DOM_POSEIDON_MDS_Y = b"zkl/poseidon2/mds/y"

DOM_ROM_RC = b"zkl/rom3/rc"
DOM_ROM_MDS_X = b"zkl/rom3/mds/x"
DOM_ROM_MDS_Y = b"zkl/rom3/mds/y"

HASHER_SUITE_ID = b"\x00" * 32


def ro_from_slices(domain: bytes, parts: Sequence[bytes]) -> int:
    """blake3(domain || parts...) -> field element (poseidon/mod.rs:421-440).

    Folds the first 16 digest bytes as lo64 + hi64 * 2^64 (mod p).
    """
    h = bytearray(domain)
    for p_ in parts:
        h += p_
    digest = blake3(bytes(h))
    val = int.from_bytes(digest[0:16], "little")
    lo = val & 0xFFFFFFFFFFFFFFFF
    hi = val >> 64
    return (lo + hi * f128.POW2_64) % P


ro_to_fe = ro_from_slices


def _derive_points(domain: bytes, suite_id: bytes, n: int) -> List[int]:
    pts: List[int] = []
    ctr = 0
    while len(pts) < n:
        cand = ro_from_slices(
            domain, [suite_id, bytes([len(pts)]), ctr.to_bytes(4, "little")])
        if cand != 0 and cand not in pts:
            pts.append(cand)
        else:
            ctr = (ctr + 1) & 0xFFFFFFFF
    return pts


@dataclass
class PoseidonSuite:
    dom: Tuple[int, int]
    mds: List[List[int]]       # 12x12
    rc: List[List[int]]        # rounds x 12


_SUITE_CACHE: Dict[Tuple[bytes, int], PoseidonSuite] = {}
_ROM_CACHE: Dict[bytes, Tuple[List[List[int]], List[List[int]]]] = {}


def derive_poseidon_domain_tags(suite_id: bytes) -> Tuple[int, int]:
    return (ro_from_slices(DOM_POSEIDON_DOM0, [suite_id]),
            ro_from_slices(DOM_POSEIDON_DOM1, [suite_id]))


def derive_poseidon_mds_cauchy_12x12(suite_id: bytes) -> List[List[int]]:
    x = _derive_points(DOM_POSEIDON_MDS_X, suite_id, 12)
    y = _derive_points(DOM_POSEIDON_MDS_Y, suite_id, 12)

    adj_ctr = 0
    attempts = 0
    while True:
        ok = all((xi + yj) % P != 0 for xi in x for yj in y)
        if ok:
            break
        for j in range(12):
            cand = ro_from_slices(
                DOM_POSEIDON_MDS_Y,
                [suite_id, bytes([j]), adj_ctr.to_bytes(4, "little")])
            y[j] = cand if cand != 0 else 1
        adj_ctr = (adj_ctr + 1) & 0xFFFFFFFF
        attempts += 1
        if attempts > 1_000_000:
            raise ValueError(f"poseidon MDS derivation failed for {suite_id.hex()}")

    return [[f128.inv((xi + yj) % P) for yj in y] for xi in x]


def derive_poseidon_round_constants_12(suite_id: bytes,
                                       rounds: int) -> List[List[int]]:
    return [[ro_from_slices(DOM_POSEIDON_RC,
                            [suite_id, bytes([r]), bytes([lane])])
             for lane in range(12)] for r in range(rounds)]


def derive_rom_round_constants_3(suite_id: bytes,
                                 rounds: int) -> List[List[int]]:
    return [[ro_from_slices(DOM_ROM_RC, [suite_id, bytes([r]), bytes([lane])])
             for lane in range(3)] for r in range(rounds)]


def derive_rom_mds_cauchy_3x3(suite_id: bytes) -> List[List[int]]:
    x = _derive_points(DOM_ROM_MDS_X, suite_id, 3)
    y = _derive_points(DOM_ROM_MDS_Y, suite_id, 3)
    return [[f128.inv((xi + yj) % P) for yj in y] for xi in x]


def get_poseidon_suite(suite_id: bytes,
                       rounds: int = POSEIDON_ROUNDS) -> PoseidonSuite:
    key = (bytes(suite_id), rounds)
    s = _SUITE_CACHE.get(key)
    if s is None:
        s = PoseidonSuite(
            dom=derive_poseidon_domain_tags(suite_id),
            mds=derive_poseidon_mds_cauchy_12x12(suite_id),
            rc=derive_poseidon_round_constants_12(suite_id, rounds),
        )
        _SUITE_CACHE[key] = s
    return s


def get_rom_suite(suite_id: bytes):
    """(mds3, rc3) for the t=3 ROM accumulator."""
    key = bytes(suite_id)
    s = _ROM_CACHE.get(key)
    if s is None:
        s = (derive_rom_mds_cauchy_3x3(suite_id),
             derive_rom_round_constants_3(suite_id, POSEIDON_ROUNDS))
        _ROM_CACHE[key] = s
    return s


# ---------------------------------------------------------------------------
# Permutation / sponge (host reference)
# ---------------------------------------------------------------------------

_NATIVE_SUITE_BYTES: Dict[Tuple[Tuple[int, int], int], Tuple[bytes, bytes]] = {}


def _native_suite_bytes(suite: "PoseidonSuite"):
    key = (suite.dom, len(suite.rc))
    hit = _NATIVE_SUITE_BYTES.get(key)
    if hit is None:
        pack = lambda vals: b"".join(int(v).to_bytes(16, "little")
                                     for v in vals)
        hit = (pack(v for row in suite.mds for v in row),
               pack(v for row in suite.rc for v in row))
        _NATIVE_SUITE_BYTES[key] = hit
    return hit


def permute_12(state: List[int], suite: PoseidonSuite) -> List[int]:
    from .. import native
    if native.available():
        # ~30x the pure-Python round loop; this sits behind every
        # scalar merge/hash_elements/merge_with_int on the host.
        mds_b, rc_b = _native_suite_bytes(suite)
        inp = b"".join(int(v).to_bytes(16, "little") for v in state)
        raw = native.poseidon12_batch_raw(inp, mds_b, rc_b, 1,
                                          len(suite.rc))
        return [int.from_bytes(raw[16 * i:16 * (i + 1)], "little")
                for i in range(12)]
    s = list(state)
    for rc_r in suite.rc:
        s = [(v * v % P) * v % P for v in s]
        s = [(sum(m * v for m, v in zip(row, s)) + rc_r[i]) % P
             for i, row in enumerate(suite.mds)]
    return s


def permute_3(state: List[int], mds3, rc3) -> List[int]:
    s = list(state)
    for rc_r in rc3:
        s3 = [(v * v % P) * v % P for v in s]
        s = [(mds3[i][0] * s3[0] + mds3[i][1] * s3[1]
              + mds3[i][2] * s3[2] + rc_r[i]) % P for i in range(3)]
    return s


def poseidon_hash_two_lanes(suite_id: bytes, left: int, right: int) -> int:
    """(poseidon/mod.rs:255-292): permutation of [l, r, 0.., dom0, dom1]."""
    suite = get_poseidon_suite(suite_id)
    state = [left, right] + [0] * 8 + [suite.dom[0], suite.dom[1]]
    return permute_12(state, suite)[0]


def merkle_root_from_path(suite_id: bytes, leaf: int,
                          path: Sequence[Tuple[int, int]]) -> int:
    """Host-side expected Merkle root for a (dir, sib) path.

    Mirrors the chained-step semantics the trace builder/AIR enforce
    (reference tests/merkle.rs:127-129: h = H(left, right) per level
    with left/right = dir-select(acc, sib)); callers bind the result
    into PublicInputs.merkle_root (pi.rs:71) before proving."""
    acc = leaf % P
    for d, s in path:
        if d not in (0, 1):
            raise ValueError("merkle path dir must be 0/1")
        left, right = (s, acc) if d else (acc, s)
        acc = poseidon_hash_two_lanes(suite_id, left, right)
    return acc


def sponge_absorb(inputs: Sequence[int], suite_id: bytes) -> int:
    """One-level absorb (vm/trace/poseidon.rs sponge_ref): lanes 0..n from
    inputs, capacity = domain tags, single permutation, return lane 0."""
    suite = get_poseidon_suite(suite_id)
    state = [0] * 12
    for i, v in enumerate(inputs[:10]):
        state[i] = v
    state[10], state[11] = suite.dom
    return permute_12(state, suite)[0]


def _ro_bytes_sponge(suite_id: bytes, domain: bytes, data: bytes,
                     rounds: int) -> int:
    """Rate-10 sponge over 32-byte chunks (poseidon/hasher.rs:144-231)."""
    suite = get_poseidon_suite(suite_id, rounds)
    dbuf = domain[:32] + b"\x00" * max(0, 32 - len(domain))
    dom_fe = f128.fold_bytes32_to_fe(dbuf)

    state = [0] * 12
    state[10], state[11] = suite.dom
    lane = 0

    def absorb(msg: int):
        nonlocal state, lane
        state[lane] = (state[lane] + msg) % P
        lane += 1
        if lane == RATE:
            state = permute_12(state, suite)
            lane = 0

    absorb(dom_fe)
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        if len(chunk) < 32:
            chunk = chunk + b"\x00" * (32 - len(chunk))
        absorb(f128.fold_bytes32_to_fe(chunk))
    if lane != 0:
        state = permute_12(state, suite)
    return state[0]


def poseidon_ro_bytes_sponge(suite_id: bytes, domain: bytes,
                             data: bytes) -> int:
    return _ro_bytes_sponge(suite_id, domain, data, POSEIDON_ROUNDS)


def poseidon_ro_parts(suite_id: bytes, domain: bytes,
                      parts: Sequence[bytes]) -> int:
    """Chained two-lane RO (poseidon/mod.rs:296-324)."""
    acc = 0
    dbuf = domain[:32] + b"\x00" * max(0, 32 - len(domain))
    acc = poseidon_hash_two_lanes(suite_id, acc, f128.fold_bytes32_to_fe(dbuf))
    for p_ in parts:
        for i in range(0, len(p_), 32):
            chunk = p_[i:i + 32]
            if len(chunk) < 32:
                chunk = chunk + b"\x00" * (32 - len(chunk))
            acc = poseidon_hash_two_lanes(
                suite_id, acc, f128.fold_bytes32_to_fe(chunk))
    return acc


# ---------------------------------------------------------------------------
# Winterfell hasher semantics (poseidon/hasher.rs)
# ---------------------------------------------------------------------------

def hasher_rounds() -> int:
    v = os.environ.get("ZKL_POSEIDON_HASHER_ROUNDS")
    if v:
        try:
            n = int(v)
            if n > 0:
                return n
        except ValueError:
            pass
    return 27


def hash_bytes(data: bytes) -> bytes:
    fe = _ro_bytes_sponge(HASHER_SUITE_ID, b"zkl/winter/hash/bytes", data,
                          hasher_rounds())
    return f128.fe_to_bytes_fold(fe)


def merge(d0: bytes, d1: bytes) -> bytes:
    fe = _ro_bytes_sponge(HASHER_SUITE_ID, b"zkl/winter/hash/merge",
                          d0 + d1, hasher_rounds())
    return f128.fe_to_bytes_fold(fe)


def merge_many(digests: Sequence[bytes]) -> bytes:
    if not digests:
        return b"\x00" * 32
    fe = _ro_bytes_sponge(HASHER_SUITE_ID, b"zkl/winter/hash/merge_many",
                          b"".join(digests), hasher_rounds())
    return f128.fe_to_bytes_fold(fe)


def merge_with_int(seed: bytes, value: int) -> bytes:
    fe = _ro_bytes_sponge(HASHER_SUITE_ID, b"zkl/winter/hash/merge_with_int",
                          seed + value.to_bytes(8, "little"), hasher_rounds())
    return f128.fe_to_bytes_fold(fe)


def hash_elements(elements: Sequence[int]) -> bytes:
    """ElementHasher::hash_elements over base-field elements.

    Winterfell serializes f128 elements as 16 canonical LE bytes each.
    """
    data = b"".join(f128.to_bytes16(e) for e in elements)
    fe = _ro_bytes_sponge(HASHER_SUITE_ID, b"winter/hash/elements", data,
                          hasher_rounds())
    return f128.fe_to_bytes_fold(fe)


# ---------------------------------------------------------------------------
# Program field commitment (commit.rs:31-79)
# ---------------------------------------------------------------------------

def program_field_commitment(blake32: bytes) -> Tuple[int, int]:
    suite = get_poseidon_suite(blake32)
    a = f128.from_le_bytes16(blake32[0:16])
    b = f128.from_le_bytes16(blake32[16:32])
    state = [a, b] + [0] * 8 + [suite.dom[0], suite.dom[1]]
    out = permute_12(state, suite)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# ROM weights (utils.rs:112-141)
# ---------------------------------------------------------------------------

ROM_W_SEED_0 = 17
ROM_W_SEED_1 = 1037


def rom_weights_for_seed(seed: int) -> List[int]:
    """[g^(seed+1) .. g^(seed+59)] for g = 3."""
    g = 3
    cur = pow(g, seed + 1, P)
    out = []
    for _ in range(59):
        out.append(cur)
        cur = (cur * g) % P
    return out
