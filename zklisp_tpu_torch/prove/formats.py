"""Proof containers and binary codecs.

Ports the reference's zl1 step-proof container (src/proof/format.rs), step
metadata + digest (src/proof/step.rs, src/proof/digest.rs) and the
ZKLSTP1 step-proof codec byte layout.  The inner STARK proof serialization
replaces winterfell's wire format with this framework's own length-
prefixed layout (PARITY.md).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from ..core import pi as pi_mod
from ..crypto import poseidon as pos
from ..crypto.blake3 import blake3
from ..field import f128
from .multiproof import MultiProof
from .params import ProofOptions
from .stark import (FriLayerOpenings, ProofContext, QueryOpenings,
                    StarkProof)


@dataclass
class Header:
    profile_id: int = 1
    field_id: int = 1
    version: int = 1
    suite_id: bytes = b"\x00" * 32
    rho: int = 16
    q: int = 64
    fri_folding: int = 2
    ext: int = 0


@dataclass
class Zl1PublicInputs:
    program_id: bytes
    program_commitment: bytes
    feature_mask: int
    segment_index: int
    segments_total: int
    pc_init: bytes
    state_in_hash: bytes
    state_out_hash: bytes
    ram_gp_unsorted_in: bytes
    ram_gp_unsorted_out: bytes
    ram_gp_sorted_in: bytes
    ram_gp_sorted_out: bytes
    rom_s_in_0: bytes
    rom_s_in_1: bytes
    rom_s_in_2: bytes
    rom_s_out_0: bytes
    rom_s_out_1: bytes
    rom_s_out_2: bytes


@dataclass
class StepMeta:
    m: int = 0
    rho: int = 16
    q: int = 64
    o: int = 2
    lambda_: int = 0
    pi_len: int = 0
    v_units: int = 0

    @staticmethod
    def from_env(trace_len: int, opts: ProofOptions, lambda_bits: int,
                 pi_len: int) -> "StepMeta":
        m = trace_len
        return StepMeta(m=m, rho=opts.blowup, q=opts.num_queries, o=2,
                        lambda_=min(lambda_bits, 0xFFFF), pi_len=pi_len,
                        v_units=m * opts.num_queries)


@dataclass
class Zl1Proof:
    header: Header
    pi: Zl1PublicInputs
    root_trace: bytes          # blake3-folded commitment echo
    meta: StepMeta
    inner: StarkProof

    @staticmethod
    def new_multi_segment(suite_id: bytes, meta: StepMeta,
                          core_pi: pi_mod.PublicInputs,
                          segment_index: int, segments_total: int,
                          boundary: dict, inner: StarkProof) -> "Zl1Proof":
        header = Header(suite_id=suite_id, rho=meta.rho, q=meta.q)
        pi = Zl1PublicInputs(
            program_id=core_pi.program_id,
            program_commitment=core_pi.program_commitment,
            feature_mask=core_pi.feature_mask,
            segment_index=segment_index,
            segments_total=segments_total,
            **boundary)
        # commitment echo (format.rs:231-248)
        h = bytearray(b"zkl/step/root_trace")
        h += suite_id
        h += inner.trace_root
        h += inner.constraint_root
        for r in inner.fri_roots:
            h += r
        return Zl1Proof(header, pi, blake3(bytes(h)), meta, inner)


@dataclass
class StepProof:
    proof: Zl1Proof
    pi_core: pi_mod.PublicInputs
    rom_acc: Tuple[int, int, int]
    vm_usage_mask: int
    ram_delta_clk_bits: int

    def state_in_hash(self) -> bytes:
        return self.proof.pi.state_in_hash

    def state_out_hash(self) -> bytes:
        return self.proof.pi.state_out_hash

    def digest(self) -> bytes:
        return step_digest(self.proof)

    def to_bytes(self) -> bytes:
        """ZKLSTP1 codec (proof/step.rs:79-200 byte layout)."""
        out = bytearray(b"ZKLSTP1")
        out += struct.pack("<I", self.proof.meta.lambda_)
        out += self.proof.header.suite_id
        out += self.pi_core.program_id
        out += self.pi_core.program_commitment
        out += self.pi_core.merkle_root
        out += struct.pack("<Q", self.pi_core.feature_mask)
        out += struct.pack("<I", len(self.pi_core.main_args))
        for arg in self.pi_core.main_args:
            if arg.kind == "u64":
                out += b"\x00" + struct.pack("<Q", arg.value)
            elif arg.kind == "u128":
                out += b"\x01" + int(arg.value).to_bytes(16, "little")
            else:
                out += b"\x02" + arg.value
        out += struct.pack("<I", self.vm_usage_mask)
        out += struct.pack("<I", self.ram_delta_clk_bits)
        for lane in self.rom_acc:
            out += f128.fe_to_bytes_fold(lane)
        zp = self.proof.pi
        out += struct.pack("<I", zp.segment_index)
        out += struct.pack("<I", zp.segments_total)
        out += zp.pc_init
        out += zp.state_in_hash
        out += zp.state_out_hash
        out += zp.ram_gp_unsorted_in
        out += zp.ram_gp_unsorted_out
        out += zp.ram_gp_sorted_in
        out += zp.ram_gp_sorted_out
        out += zp.rom_s_in_0
        out += zp.rom_s_in_1
        out += zp.rom_s_in_2
        out += zp.rom_s_out_0
        out += zp.rom_s_out_1
        out += zp.rom_s_out_2
        # meta
        out += struct.pack("<IHHHHIQ", self.proof.meta.m,
                           self.proof.meta.rho, self.proof.meta.q,
                           self.proof.meta.o, self.proof.meta.lambda_,
                           self.proof.meta.pi_len, self.proof.meta.v_units)
        out += self.proof.root_trace
        inner = serialize_stark_proof(self.proof.inner)
        out += struct.pack("<I", len(inner))
        out += inner
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "StepProof":
        r = _Reader(data)
        assert r.take(7) == b"ZKLSTP1", "bad magic"
        lambda_ = r.u32()
        suite_id = r.take(32)
        program_id = r.take(32)
        program_commitment = r.take(32)
        merkle_root = r.take(32)
        feature_mask = r.u64()
        n_args = r.u32()
        main_args = []
        for _ in range(n_args):
            tag = r.take(1)[0]
            if tag == 0:
                main_args.append(pi_mod.VmArg.u64(r.u64()))
            elif tag == 1:
                main_args.append(pi_mod.VmArg.u128(
                    int.from_bytes(r.take(16), "little")))
            else:
                main_args.append(pi_mod.VmArg.bytes32(r.take(32)))
        vm_usage_mask = r.u32()
        ram_delta_clk_bits = r.u32()
        rom_acc = tuple(f128.fe_from_bytes_fold(r.take(32))
                        for _ in range(3))
        segment_index = r.u32()
        segments_total = r.u32()
        fields = [r.take(32) for _ in range(13)]
        (pc_init, state_in, state_out, gu_in, gu_out, gs_in, gs_out,
         rs_in0, rs_in1, rs_in2, rs_out0, rs_out1, rs_out2) = fields
        m, rho, q, o, lam, pi_len, v_units = struct.unpack(
            "<IHHHHIQ", r.take(4 + 2 + 2 + 2 + 2 + 4 + 8))
        root_trace = r.take(32)
        inner_len = r.u32()
        inner = deserialize_stark_proof(r.take(inner_len))

        pi_core = pi_mod.PublicInputs(
            program_id=program_id,
            program_commitment=program_commitment,
            merkle_root=merkle_root,
            main_args=main_args,
            feature_mask=feature_mask)
        header = Header(suite_id=suite_id, rho=rho, q=q)
        zpi = Zl1PublicInputs(
            program_id=program_id, program_commitment=program_commitment,
            feature_mask=feature_mask, segment_index=segment_index,
            segments_total=segments_total, pc_init=pc_init,
            state_in_hash=state_in, state_out_hash=state_out,
            ram_gp_unsorted_in=gu_in, ram_gp_unsorted_out=gu_out,
            ram_gp_sorted_in=gs_in, ram_gp_sorted_out=gs_out,
            rom_s_in_0=rs_in0, rom_s_in_1=rs_in1, rom_s_in_2=rs_in2,
            rom_s_out_0=rs_out0, rom_s_out_1=rs_out1, rom_s_out_2=rs_out2)
        meta = StepMeta(m=m, rho=rho, q=q, o=o, lambda_=lam,
                        pi_len=pi_len, v_units=v_units)
        zl1 = Zl1Proof(header, zpi, root_trace, meta, inner)
        return StepProof(zl1, pi_core, rom_acc, vm_usage_mask,
                         ram_delta_clk_bits)


def step_digest(proof: Zl1Proof) -> bytes:
    """Poseidon-chained step digest (proof/digest.rs)."""
    sid = proof.header.suite_id
    suite_fe = pos.ro_to_fe(b"zkl/step/digest/suite", [sid])

    meta_bytes = struct.pack("<IHHHHIQ", proof.meta.m, proof.meta.rho,
                             proof.meta.q, proof.meta.o,
                             proof.meta.lambda_, proof.meta.pi_len,
                             proof.meta.v_units)
    meta_ro = pos.ro_to_fe(b"zkl/step/digest/meta", [meta_bytes])
    h_meta = pos.poseidon_hash_two_lanes(sid, meta_ro, 0)

    p = proof.pi
    pi_bytes = (p.program_id + p.program_commitment
                + struct.pack("<Q", p.feature_mask)
                + struct.pack("<I", p.segment_index)
                + struct.pack("<I", p.segments_total)
                + p.pc_init + p.state_in_hash + p.state_out_hash
                + p.ram_gp_unsorted_in + p.ram_gp_unsorted_out
                + p.ram_gp_sorted_in + p.ram_gp_sorted_out
                + p.rom_s_in_0 + p.rom_s_in_1 + p.rom_s_in_2
                + p.rom_s_out_0 + p.rom_s_out_1 + p.rom_s_out_2)
    pi_ro = pos.ro_to_fe(b"zkl/step/digest/pi", [pi_bytes])
    h_pi = pos.poseidon_hash_two_lanes(sid, pi_ro, 0)

    rt_fe = f128.fold_bytes32_to_fe(proof.root_trace)
    h_roots = pos.poseidon_hash_two_lanes(sid, rt_fe, 0)

    c0 = pos.poseidon_hash_two_lanes(sid, suite_fe, h_meta)
    c1 = pos.poseidon_hash_two_lanes(sid, c0, h_pi)
    ch = pos.poseidon_hash_two_lanes(sid, c1, h_roots)
    return f128.fe_to_bytes_fold(ch)


# ---------------------------------------------------------------------------
# inner STARK proof serialization (framework-native wire format)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        assert len(b) == n, "truncated proof bytes"
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def fe(self, wide: bool = False) -> int:
        # wide: packed quadratic-extension element re + (im << 128),
        # stored as 32 LE bytes (lo half then hi half)
        lo = f128.from_bytes16(self.take(16))
        if not wide:
            return lo
        hi = f128.from_bytes16(self.take(16))
        return lo | (hi << 128)


def _w_fe(out: bytearray, v: int, wide: bool = False) -> None:
    out += f128.to_bytes16(v & ((1 << 128) - 1))
    if wide:
        out += f128.to_bytes16(v >> 128)


def _w_fes(out: bytearray, vs: List[int], wide: bool = False) -> None:
    out += struct.pack("<I", len(vs))
    for v in vs:
        _w_fe(out, v, wide)


def _r_fes(r: _Reader, wide: bool = False) -> List[int]:
    n = r.u32()
    return [r.fe(wide) for _ in range(n)]


def _w_batch(out: bytearray, mp: MultiProof) -> None:
    """Compressed multiproof: depth, then per-level node counts +
    digests (canonical ascending-frontier order, prove/multiproof.py)."""
    out += struct.pack("<B", mp.depth)
    for level in mp.nodes:
        out += struct.pack("<H", len(level))
        for d in level:
            out += d


def _r_batch(r: _Reader) -> MultiProof:
    depth = r.u8()
    nodes = []
    for _ in range(depth):
        cnt = r.u16()
        nodes.append([r.take(32) for _ in range(cnt)])
    return MultiProof(depth, nodes)


def _w_openings(out: bytearray, q: QueryOpenings,
                wide: bool = False) -> None:
    out += struct.pack("<I", len(q.rows))
    if q.rows:
        out += struct.pack("<I", len(q.rows[0]))
    else:
        out += struct.pack("<I", 0)
    for row in q.rows:
        for v in row:
            _w_fe(out, v, wide)
    _w_batch(out, q.batch if q.batch is not None else MultiProof(0, []))


def _r_openings(r: _Reader, wide: bool = False) -> QueryOpenings:
    n = r.u32()
    width = r.u32()
    rows = [[r.fe(wide) for _ in range(width)] for _ in range(n)]
    # paths are reconstructed after FS replay (expand_proof_openings)
    return QueryOpenings(rows, [], _r_batch(r))


def serialize_stark_proof(p: StarkProof) -> bytes:
    out = bytearray(b"ZTP1")
    o = p.context.options
    out += struct.pack("<IIHHIBBBBHB", p.context.trace_width,
                       p.context.trace_len, o.num_queries, o.blowup,
                       o.grinding_factor, o.field_extension,
                       o.fri_folding_factor, o.fri_remainder_max_degree,
                       o.num_partitions, o.hash_rate,
                       1 if o.per_assertion else 0)
    out += p.trace_root
    out += p.constraint_root
    # In extension mode (field_extension == 2) every derived-value list
    # holds packed extension elements (re + (im << 128)) stored as 32
    # bytes; trace opening rows stay base-field (16 bytes).
    wide = o.field_extension == 2
    _w_fes(out, p.ood_trace_current, wide)
    _w_fes(out, p.ood_trace_next, wide)
    _w_fes(out, p.ood_quotient_current, wide)
    _w_fes(out, p.ood_quotient_next, wide)
    out += struct.pack("<I", len(p.fri_roots))
    for root in p.fri_roots:
        out += root
    _w_fes(out, p.fri_remainder, wide)
    out += struct.pack("<Q", p.pow_nonce)
    _w_openings(out, p.trace_openings)
    _w_openings(out, p.constraint_openings, wide)
    out += struct.pack("<I", len(p.fri_openings))
    for layer in p.fri_openings:
        out += struct.pack("<I", len(layer.pairs))
        for (v0, v1) in layer.pairs:
            _w_fe(out, v0, wide)
            _w_fe(out, v1, wide)
        _w_batch(out, layer.batch if layer.batch is not None
                 else MultiProof(0, []))
    return bytes(out)


def deserialize_stark_proof(data: bytes) -> StarkProof:
    r = _Reader(data)
    assert r.take(4) == b"ZTP1", "bad inner proof magic"
    (tw, tl, nq, blowup, grind, ext, fold, rmd, nparts, hrate, flags) = \
        struct.unpack("<IIHHIBBBBHB", r.take(4 + 4 + 2 + 2 + 4 + 4 + 2 + 1))
    opts = ProofOptions(num_queries=nq, blowup=blowup,
                        grinding_factor=grind, field_extension=ext,
                        fri_folding_factor=fold,
                        fri_remainder_max_degree=rmd,
                        num_partitions=nparts, hash_rate=hrate,
                        assertion_batching=("per_assertion" if flags & 1
                                            else "grouped"))
    ctx = ProofContext(tw, tl, opts)
    trace_root = r.take(32)
    constraint_root = r.take(32)
    wide = ext == 2
    ood_tc = _r_fes(r, wide)
    ood_tn = _r_fes(r, wide)
    ood_qc = _r_fes(r, wide)
    ood_qn = _r_fes(r, wide)
    n_roots = r.u32()
    fri_roots = [r.take(32) for _ in range(n_roots)]
    fri_remainder = _r_fes(r, wide)
    pow_nonce = r.u64()
    trace_open = _r_openings(r)
    constraint_open = _r_openings(r, wide)
    n_layers = r.u32()
    fri_open = []
    for _ in range(n_layers):
        n = r.u32()
        pairs = [(r.fe(wide), r.fe(wide)) for _ in range(n)]
        fri_open.append(FriLayerOpenings(pairs, [], _r_batch(r)))
    return StarkProof(
        context=ctx, trace_root=trace_root,
        constraint_root=constraint_root,
        ood_trace_current=ood_tc, ood_trace_next=ood_tn,
        ood_quotient_current=ood_qc, ood_quotient_next=ood_qn,
        fri_roots=fri_roots, fri_remainder=fri_remainder,
        pow_nonce=pow_nonce, trace_openings=trace_open,
        constraint_openings=constraint_open, fri_openings=fri_open)
