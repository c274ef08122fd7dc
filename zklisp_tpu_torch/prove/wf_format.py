"""Winterfell-layout serialization of the inner STARK proof.

The reference's inner proofs are winterfell 0.13.1 `Proof` values and
their byte layout is fixed by winterfell's `Serializable` impls.  That
crate's source is not present in this environment, so this module
encodes the layout from the structure the reference's own parsing code
pins down (agg/child.rs reads `Queries` as values-then-paths Vec<u8>s,
agg/fs.rs parses `Commitments` into trace/constraint/FRI roots) plus
best-known winterfell semantics, with EVERY sub-layout isolated in its
own small function so a recorded golden vector from a Rust toolchain
can correct it in one place (see tests/golden/README.md and
tests/test_wf_format.py's fixture hooks).

Confidence legend per function:
  [pinned]   — implied by the reference's own code, treated as exact
  [documented] — winterfell's documented behavior, near-certain
  [assumed]  — best-known guess, golden-vector hook provided

Top-level layout (winter-air proof/mod.rs `Proof::write_into`):
  context || num_unique_queries: u8 || commitments || trace_queries
  || constraint_queries || ood_frame || fri_proof || pow_nonce: u64
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from ..field import f128
from .stark import StarkProof

P = f128.P


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def w_usize(out: bytearray, v: int) -> None:
    """[documented] winter-utils ByteWriter::write_usize: vint64 —
    7 bits per byte, high bit = continuation, little groups first."""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def r_usize(data: bytes, pos: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not (b & 0x80):
            return v, pos


def w_vec_u8(out: bytearray, payload: bytes) -> None:
    """[documented] Vec<u8>: write_usize(len) then raw bytes."""
    w_usize(out, len(payload))
    out += payload


def r_vec_u8(data: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = r_usize(data, pos)
    return data[pos:pos + n], pos + n


def w_fe(out: bytearray, v: int) -> None:
    """[pinned] f128 BaseElement: 16 LE bytes (the reference folds
    digests as 16 LE bytes + zeros everywhere)."""
    out += int(v % P).to_bytes(16, "little")


def w_digest(out: bytearray, d: bytes) -> None:
    """[pinned] PoseidonHasher digest: 32 bytes (hasher.rs Digest)."""
    assert len(d) == 32
    out += d


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

def wf_trace_info_bytes(trace_width: int, trace_len: int) -> bytes:
    """[assumed] winter-air TraceInfo::write_into for a single-segment
    trace with no aux segment and empty meta:
      main_segment_width: u32 || num_aux_segment_rands: u32(0) ||
      num_aux_segment_cols: u32(0) || trace_length: u32 ||
      meta: Vec<u8>(empty)."""
    out = bytearray()
    out += struct.pack("<I", trace_width)
    out += struct.pack("<I", 0)
    out += struct.pack("<I", 0)
    out += struct.pack("<I", trace_len)
    w_vec_u8(out, b"")
    return bytes(out)


def wf_options_bytes(o) -> bytes:
    """[assumed] winter-air ProofOptions::write_into:
      num_queries: u8 || blowup_factor: u8 || grinding_factor: u8 ||
      field_extension: u8 || fri_folding_factor: u8 ||
      fri_remainder_max_degree: u8 || batching_constraints: u8(0=Linear)
      || batching_deep: u8(0) || partition options (num_partitions: u8,
      hash_rate: u8)."""
    return bytes([o.num_queries & 0xFF, o.blowup & 0xFF,
                  o.grinding_factor & 0xFF,
                  1 if o.field_extension == 2 else 0,
                  o.fri_folding_factor & 0xFF,
                  o.fri_remainder_max_degree & 0xFF,
                  0, 0,
                  o.num_partitions & 0xFF, o.hash_rate & 0xFF])


def wf_context_bytes(proof: StarkProof) -> bytes:
    """[assumed] winter-air Context::write_into: trace_info ||
    field_modulus_bytes: Vec<u8> (16 LE bytes of the f128 modulus) ||
    options."""
    out = bytearray()
    out += wf_trace_info_bytes(proof.context.trace_width,
                               proof.context.trace_len)
    w_vec_u8(out, P.to_bytes(16, "little"))
    out += wf_options_bytes(proof.context.options)
    return bytes(out)


def wf_context_to_elements(proof: StarkProof) -> List[int]:
    """[assumed] winterfell Context::to_elements (the FS seed prefix).

    Best-known packing: TraceInfo packs (main_width << 8 | num_aux_segs)
    and trace_length as elements; ProofOptions packs
    (ext << 24 | folding << 16 | remainder_max_degree << 8 | blowup)
    then grinding_factor and num_queries.  The framework's native FS
    uses ProofContext.to_elements (prove/stark.py) instead; this
    function exists so a golden vector can validate/replace the layout
    in ONE place (tests/test_wf_format.py::test_context_elements_golden).
    """
    o = proof.context.options
    return [
        (proof.context.trace_width << 8) | 0,
        proof.context.trace_len,
        ((1 if o.field_extension == 2 else 0) << 24)
        | (o.fri_folding_factor << 16)
        | (o.fri_remainder_max_degree << 8) | o.blowup,
        o.grinding_factor,
        o.num_queries,
    ]


# ---------------------------------------------------------------------------
# commitments / queries / ood / fri
# ---------------------------------------------------------------------------

def wf_commitments_bytes(proof: StarkProof) -> bytes:
    """[pinned-ish] winter-air Commitments: ONE Vec<u8> of concatenated
    digests in trace, constraint, FRI-layer order (agg/fs.rs parses this
    exact order with Commitments::parse)."""
    payload = bytearray()
    w_digest(payload, proof.trace_root)
    w_digest(payload, proof.constraint_root)
    for r in proof.fri_roots:
        w_digest(payload, r)
    out = bytearray()
    w_vec_u8(out, bytes(payload))
    return bytes(out)


def wf_queries_bytes(rows: List[List[int]], batch) -> bytes:
    """[pinned] winter-air Queries: values Vec<u8> then paths Vec<u8>
    (agg/child.rs:300-320 reads them back in exactly this order).
    values = row elements as 16-LE-byte field elements, row-major.
    paths = serialized batch Merkle proof: depth u8, then per level
    write_usize(count) + digests ([assumed] node layout — winterfell's
    BatchMerkleProof node serialization is not visible from the
    reference; this framework's canonical ascending-frontier order is
    used, golden-vector hook in tests)."""
    values = bytearray()
    for row in rows:
        for v in row:
            w_fe(values, v)
    paths = bytearray()
    mp = batch
    paths.append(mp.depth if mp is not None else 0)
    if mp is not None:
        for level in mp.nodes:
            w_usize(paths, len(level))
            for d in level:
                paths += d
    out = bytearray()
    w_vec_u8(out, bytes(values))
    w_vec_u8(out, bytes(paths))
    return bytes(out)


def wf_ood_frame_bytes(proof: StarkProof) -> bytes:
    """[documented] winter-air OodFrame: trace states Vec<u8>
    (current row then next row, 16-LE-byte elements) then quotient
    states Vec<u8> (current then next)."""
    tr = bytearray()
    for v in proof.ood_trace_current:
        w_fe(tr, v)
    for v in proof.ood_trace_next:
        w_fe(tr, v)
    qu = bytearray()
    for v in proof.ood_quotient_current:
        w_fe(qu, v)
    for v in proof.ood_quotient_next:
        w_fe(qu, v)
    out = bytearray()
    w_vec_u8(out, bytes(tr))
    w_vec_u8(out, bytes(qu))
    return bytes(out)


def wf_fri_proof_bytes(proof: StarkProof) -> bytes:
    """[assumed] winter-fri FriProof: write_usize(num_layers) ||
    per layer (values Vec<u8> of (v0,v1) pairs, paths Vec<u8> as in
    Queries) || remainder Vec<u8> (coefficients, lowest-degree first in
    winterfell) || num_partitions: u8(1)."""
    out = bytearray()
    w_usize(out, len(proof.fri_openings))
    for layer in proof.fri_openings:
        values = bytearray()
        for (v0, v1) in layer.pairs:
            w_fe(values, v0)
            w_fe(values, v1)
        paths = bytearray()
        mp = layer.batch
        paths.append(mp.depth if mp is not None else 0)
        if mp is not None:
            for level in mp.nodes:
                w_usize(paths, len(level))
                for d in level:
                    paths += d
        w_vec_u8(out, bytes(values))
        w_vec_u8(out, bytes(paths))
    rem = bytearray()
    for c in reversed(proof.fri_remainder):      # lowest-degree first
        w_fe(rem, c)
    w_vec_u8(out, bytes(rem))
    out.append(1)
    return bytes(out)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def wf_serialize_proof(proof: StarkProof) -> bytes:
    """Serialize a StarkProof in the winterfell Proof layout."""
    out = bytearray()
    out += wf_context_bytes(proof)
    out.append(proof.num_unique_queries() & 0xFF)
    out += wf_commitments_bytes(proof)
    # trace_queries: Vec<Queries> with one main-segment entry
    w_usize(out, 1)
    out += wf_queries_bytes(proof.trace_openings.rows,
                            proof.trace_openings.batch)
    out += wf_queries_bytes(proof.constraint_openings.rows,
                            proof.constraint_openings.batch)
    out += wf_ood_frame_bytes(proof)
    out += wf_fri_proof_bytes(proof)
    out += struct.pack("<Q", proof.pow_nonce)
    return bytes(out)


def wf_parse_proof(data: bytes, proof_shape: StarkProof) -> dict:
    """Parse wf_serialize_proof output back into its components
    (roundtrip validation; needs a same-shaped proof for widths)."""
    w = proof_shape.context.trace_width
    Q = len(proof_shape.ood_quotient_current)
    pos = 0
    # context
    tw, nar, nac, tl = struct.unpack_from("<IIII", data, pos)
    pos += 16
    meta, pos = r_vec_u8(data, pos)
    modulus, pos = r_vec_u8(data, pos)
    opts = data[pos:pos + 10]
    pos += 10
    nq = data[pos]
    pos += 1
    commits, pos = r_vec_u8(data, pos)
    n_tq, pos = r_usize(data, pos)
    queries = []
    for _ in range(n_tq + 1):                    # trace entries + constraint
        values, pos = r_vec_u8(data, pos)
        paths, pos = r_vec_u8(data, pos)
        queries.append((values, paths))
    ood_tr, pos = r_vec_u8(data, pos)
    ood_qu, pos = r_vec_u8(data, pos)
    n_layers, pos = r_usize(data, pos)
    layers = []
    for _ in range(n_layers):
        values, pos = r_vec_u8(data, pos)
        paths, pos = r_vec_u8(data, pos)
        layers.append((values, paths))
    rem, pos = r_vec_u8(data, pos)
    fri_parts = data[pos]
    pos += 1
    (pow_nonce,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    assert pos == len(data), "trailing bytes in wf proof"
    return dict(trace_width=tw, trace_len=tl, modulus=modulus,
                num_unique_queries=nq, commitments=commits,
                queries=queries, ood_trace=ood_tr, ood_quotient=ood_qu,
                fri_layers=layers, fri_remainder=rem,
                pow_nonce=pow_nonce)
