"""Readers of the bytes a proving job produces, for the benchmark's
reference: the ZKLRC1 artifact (zk-lisp src/lib.rs:485-773), a ZKLSTP1
step proof (src/proof/step.rs:79-200) and the inner STARK proof ("ZTP1",
whole).  Each returns a plain dict; a truncated or malformed input
raises ValueError.
"""

from __future__ import annotations

import struct


class _R:
    def __init__(self, data: bytes) -> None:
        self.d, self.i = bytes(data), 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.d):
            raise ValueError("truncated")
        b = self.d[self.i:self.i + n]
        self.i += n
        return b

    def un(self, fmt: str):
        return struct.unpack("<" + fmt, self.take(struct.calcsize("<" + fmt)))

    def u32(self) -> int:
        return self.un("I")[0]


_META = "IHHHHIQ"        # m, rho, q, o, lambda, pi_len, v_units
_OPTS = "IIHHIBBBBHB"    # width, length, queries, blowup, grind, ext,
#                          FRI folding, remainder degree, partitions,
#                          hash rate, flags


def inner(data: bytes) -> dict:
    """The inner STARK proof: options, commitment roots, the out-of-domain
    frame, FRI roots and remainder, the proof-of-work nonce and the query
    openings with their compressed Merkle multiproofs (per level, the
    sibling digests that no opened leaf yields, in ascending index
    order).  Field elements as ints (an extension element as re + im *
    2^128), digests as 32 bytes."""
    r = _R(data)
    if r.take(4) != b"ZTP1":
        raise ValueError("inner proof magic")
    (width, length, queries, blowup, grind, ext, folding, rem_degree,
     partitions, hash_rate, flags) = r.un(_OPTS)
    fe = 32 if ext == 2 else 16
    out = {"width": width, "length": length, "queries": queries,
           "blowup": blowup, "grind": grind, "ext": ext,
           "folding": folding, "remainder_degree": rem_degree,
           "partitions": partitions, "hash_rate": hash_rate,
           "per_assertion": bool(flags & 1),
           "trace_root": r.take(32), "constraint_root": r.take(32)}
    for k in ("ood_trace_current", "ood_trace_next",
              "ood_quotient_current", "ood_quotient_next"):
        out[k] = _fes(r, fe, r.u32())
    out["fri_roots"] = [r.take(32) for _ in range(r.u32())]
    out["fri_remainder"] = _fes(r, fe, r.u32())
    out["pow_nonce"] = r.un("Q")[0]
    for k, elem in (("trace_rows", 16), ("constraint_rows", fe)):
        n, w = r.un("II")
        out[k] = [_fes(r, elem, w) for _ in range(n)]
        out[k.replace("rows", "batch")] = _batch(r)
    out["fri_layers"] = []
    for _ in range(r.u32()):
        flat = _fes(r, fe, 2 * r.u32())
        out["fri_layers"].append({"pairs": list(zip(flat[::2], flat[1::2])),
                                  "batch": _batch(r)})
    if r.i != len(r.d):
        raise ValueError("trailing bytes after an inner proof")
    return out


def _fes(r: _R, size: int, n: int) -> list:
    return [int.from_bytes(r.take(size), "little") for _ in range(n)]


def _batch(r: _R) -> list:
    return [[r.take(32) for _ in range(r.un("H")[0])]
            for _ in range(r.un("B")[0])]


_STEP_FIELDS = ("pc_init", "state_in", "state_out", "gp_unsorted_in",
                "gp_unsorted_out", "gp_sorted_in", "gp_sorted_out",
                "rom_in_0", "rom_in_1", "rom_in_2", "rom_out_0", "rom_out_1",
                "rom_out_2")


def step(data: bytes) -> dict:
    """A ZKLSTP1 step proof."""
    r = _R(data)
    if r.take(7) != b"ZKLSTP1":
        raise ValueError("step proof magic")
    out = {"lambda": r.u32(), "suite_id": r.take(32),
           "program_id": r.take(32), "program_commitment": r.take(32),
           "merkle_root": r.take(32), "feature_mask": r.un("Q")[0]}
    n_args = r.u32()
    for _ in range(n_args):
        r.take({0: 8, 1: 16, 2: 32}[r.take(1)[0]])
    out["n_args"] = n_args
    out["usage_mask"], out["ram_delta_clk_bits"] = r.un("II")
    out["rom_acc"] = [r.take(32) for _ in range(3)]
    out["segment_index"], out["segments_total"] = r.un("II")
    for name in _STEP_FIELDS:
        out[name] = r.take(32)
    out["meta"] = r.un(_META)
    out["meta_bytes"] = struct.pack("<" + _META, *out["meta"])
    out["root_trace"] = r.take(32)
    out["inner"] = inner(r.take(r.u32()))
    if r.i != len(r.d):
        raise ValueError("trailing bytes after a step proof")
    return out


_ART_FIELDS = ("vm_state_initial", "vm_state_final", "gp_unsorted_initial",
               "gp_unsorted_final", "gp_sorted_initial", "gp_sorted_final",
               "rom_initial_0", "rom_initial_1", "rom_initial_2",
               "rom_final_0", "rom_final_1", "rom_final_2")


def artifact(data: bytes) -> dict:
    """A ZKLRC1 aggregation artifact."""
    r = _R(data)
    if r.take(6) != b"ZKLRC1":
        raise ValueError("artifact magic")
    out = {k: r.take(32) for k in ("program_id", "program_commitment",
                                   "pi_digest", "children_root",
                                   "batch_id")}
    out["v_units_total"], out["children_count"] = r.un("QI")
    out["profile_meta"] = r.un(_META)
    out["fri_blowup"], out["fri_folding"], _, out["fri_layers"] = r.un("IBBB")
    out["profile_queries"], out["profile_grind"] = r.un("HI")
    out["suite_id"] = r.take(32)
    out["children_ms"] = [r.u32() for _ in range(r.u32())]
    for name in _ART_FIELDS:
        out[name] = r.take(32)
    out["proof"] = inner(r.take(r.u32()))
    if r.i != len(r.d):
        raise ValueError("trailing bytes after the artifact")
    return out
