"""The comparison that decides whether a proving job was correct.

`judge(job, stated)` takes what one job produced and what the benchmark
generated for it, works out again everything it can without the prover,
and returns the numbers it compares, each a count of disagreements
(limit 0) except `security_bits` (limit: the configuration's
`min_security_bits`, from below):

- `program_id`: the artifact's and every step's program id, commitment
  and Poseidon suite id against BLAKE3 of the generated source text.
- `pi_digest`: the artifact's public-input digest against BLAKE3 of
  "zkl/pi/v1", the program id twice, a zero Merkle root, the
  configuration's feature mask and no arguments.
- `result`: the value main returns, as the plain VM gets it from the
  compiled ops, against the value the source means (`stf`).
- `state_hash`: every segment's boundary state hashes, and the
  artifact's first and last, against the plain VM's register files.
- `chain`: the values the aggregation chains from each segment to the
  next (zk-lisp agg/trace.rs): the two RAM grand products and lane 0 of
  the ROM accumulator; and the artifact's first and last of every
  boundary value against the first and last segment's.
- `segments`: indices 0..S-1 in order, the totals and the count S that
  the configuration's planner gives, each segment's rows.
- `commitments`: each step's root_trace echo (BLAKE3 of its roots) and
  the artifact's children_root (Poseidon2 over the step digests).
- `params`: the queries, blowup, grind, FRI folding and field of every
  step proof and of the aggregation proof against the configuration.
- `fiat_shamir`, `ood_air`, `merkle`, `deep`, `fri`: the STARK inside
  every step proof, checked from its bytes by `stark.py`: the transcript
  replayed (proof of work, query positions, the shape of the openings),
  the AIR at the out-of-domain point against the composition's columns,
  the trace, constraint and FRI Merkle roots rebuilt from the openings,
  the DEEP composition of each opened row against FRI layer 0, every
  fold against the next layer and the last against the remainder.
- `security_bits`: the least conjectured security over all the proofs,
  by zk-lisp's rule (prove.rs estimate_conjectured_security_bits).

The reference reads nothing of the prover: it takes the source text, the
parameters the generator drew, the compiled ops as plain pairs, and the
bytes of the step proofs and of the artifact.  The aggregation proof's
own openings (the aggregation AIR) it leaves to the job's `verify_agg`.
"""

from __future__ import annotations

import struct

from . import codec, poseidon2, stark, stf, vm
from .blake3 import blake3

COUNTS = ("program_id", "pi_digest", "result", "state_hash", "chain",
          "segments", "commitments", "params") + stark.NUMBERS


def security_bits(queries: int, blowup: int, grind: int, ext: int) -> int:
    """zk-lisp's conjectured security of a proof's options: the lesser of
    the field's 128 * ext bits and log2(blowup) bits per query (plus the
    grind once those reach 80), less one, at most 128."""
    q_bits = (blowup.bit_length() - 1) * queries
    if q_bits >= 80:
        q_bits += grind
    return min(min(128 * ext, q_bits) - 1, 128)


def step_digest(s: dict) -> bytes:
    sid = s["suite_id"]
    h = poseidon2.hash2
    suite_fe = poseidon2.ro(b"zkl/step/digest/suite", sid)
    h_meta = h(sid, poseidon2.ro(b"zkl/step/digest/meta", s["meta_bytes"]),
               0)
    pi = (s["program_id"] + s["program_commitment"]
          + struct.pack("<QII", s["feature_mask"], s["segment_index"],
                        s["segments_total"])
          + b"".join(s[k] for k in codec._STEP_FIELDS))
    h_pi = h(sid, poseidon2.ro(b"zkl/step/digest/pi", pi), 0)
    h_roots = h(sid, poseidon2.fold32(s["root_trace"]), 0)
    c = h(sid, h(sid, h(sid, suite_fe, h_meta), h_pi), h_roots)
    return poseidon2.fe_bytes(c)


def children_root(sid: bytes, steps) -> bytes:
    leaves = sorted(poseidon2.fe_bytes(poseidon2.hash2(
        sid, poseidon2.fold32(step_digest(s)),
        poseidon2.fold32(s["inner"]["trace_root"]))) for s in steps)
    layer = [poseidon2.fold32(b) for b in leaves]
    while len(layer) > 1:
        layer = [poseidon2.hash2(sid, layer[i],
                                 layer[min(i + 1, len(layer) - 1)])
                 for i in range(0, len(layer), 2)]
    return poseidon2.fe_bytes(layer[0])


def root_trace(s: dict) -> bytes:
    i = s["inner"]
    return blake3(b"zkl/step/root_trace" + s["suite_id"] + i["trace_root"]
                  + i["constraint_root"] + b"".join(i["fri_roots"]))


def _params(proof: dict, stated: dict, queries: int, ext: int) -> int:
    want = {"queries": queries, "blowup": stated["blowup"],
            "grind": stated["grind"], "ext": ext, "folding": 2}
    return sum(proof[k] != v for k, v in want.items())


def check_openings(jobs: list, stated: dict, device="cpu") -> list:
    """For each job, stark.check's counts of each of its step proofs: all
    jobs' steps in one batch.  A step proof that the checks cannot read
    counts 1 under every number."""
    steps = [[codec.step(b) for b in j["steps"]] for j in jobs]
    flat = [s for ss in steps for s in ss]
    try:
        got = stark.check(flat, stated["hasher_rounds"], device)
    except (ValueError, KeyError, IndexError, ZeroDivisionError):
        got = [dict.fromkeys(stark.NUMBERS, 1) for _ in flat]
    out, at = [], 0
    for ss in steps:
        out.append(got[at:at + len(ss)])
        at += len(ss)
    return out


def judge(job: dict, stated: dict, openings=None, device="cpu") -> dict:
    """{number name: value} for one job.

    job: source, kind, params (what the generator drew), ops ([(name,
    fields)]), out_reg, steps ([bytes]), artifact (bytes).
    stated: queries, blowup, grind, min_security_bits, segment_rows,
    segments, feature_mask, hasher_rounds (the configuration and the
    traffic).  openings: this job's entry of check_openings, which is
    worked out here when None."""
    n = dict.fromkeys(COUNTS, 0)
    art = codec.artifact(job["artifact"])
    steps = [codec.step(b) for b in job["steps"]]
    if openings is None:
        openings = check_openings([job], stated, device)[0]
    for got in openings:
        for k in stark.NUMBERS:
            n[k] += got[k]
    pid = blake3(job["source"].encode())
    sid = pid

    n["program_id"] = (int(art["program_id"] != pid)
                       + int(art["program_commitment"] != pid)
                       + int(art["suite_id"] != pid)
                       + sum(int(s["program_id"] != pid)
                             + int(s["program_commitment"] != pid)
                             + int(s["suite_id"] != pid)
                             for s in steps))
    pi = (b"zkl/pi/v1" + pid + pid + bytes(32)
          + struct.pack("<QI", stated["feature_mask"], 0))
    n["pi_digest"] = (int(art["pi_digest"] != blake3(pi))
                      + sum(s["feature_mask"] != stated["feature_mask"]
                            or s["n_args"] != 0 for s in steps))

    try:
        edges, _ = vm.run(job["ops"], sid, stated["segment_rows"])
        want = stf.result(job["kind"], job["params"], sid)
        n["result"] = int(edges[-1][job["out_reg"]] != want)
        hashes = [vm.state_hash(e) for e in edges]
    except (vm.VmError, ValueError, KeyError):
        n["result"] = 1
        hashes = []
    S = stated["segments"]
    if len(hashes) != S + 1:
        n["state_hash"] = 2 * S + 2
    else:
        n["state_hash"] = (int(art["vm_state_initial"] != hashes[0])
                           + int(art["vm_state_final"] != hashes[-1]))
        for i, s in enumerate(steps[:S]):
            n["state_hash"] += (int(s["state_in"] != hashes[i])
                                + int(s["state_out"] != hashes[i + 1]))

    pairs = (("gp_unsorted_out", "gp_unsorted_in"),
             ("gp_sorted_out", "gp_sorted_in"), ("rom_out_0", "rom_in_0"))
    for a, b in zip(steps, steps[1:]):
        n["chain"] += sum(a[o] != b[i] for o, i in pairs)
    if steps:
        first, last = steps[0], steps[-1]
        ends = (("gp_unsorted_initial", first, "gp_unsorted_in"),
                ("gp_unsorted_final", last, "gp_unsorted_out"),
                ("gp_sorted_initial", first, "gp_sorted_in"),
                ("gp_sorted_final", last, "gp_sorted_out"))
        ends += tuple((f"rom_initial_{k}", first, f"rom_in_{k}")
                      for k in range(3))
        ends += tuple((f"rom_final_{k}", last, f"rom_out_{k}")
                      for k in range(3))
        n["chain"] += sum(art[a] != s[b] for a, s, b in ends)

    rows = stated["segment_rows"]
    n["segments"] = (abs(len(steps) - S)
                     + int(art["children_count"] != S)
                     + int(art["children_ms"] != [rows] * S)
                     + sum(s["segment_index"] != i
                           or s["segments_total"] != S
                           or s["meta"][0] != rows
                           or s["inner"]["length"] != rows
                           for i, s in enumerate(steps)))

    n["commitments"] = sum(s["root_trace"] != root_trace(s) for s in steps)
    n["commitments"] += int(not steps or art["children_root"]
                            != children_root(steps[0]["suite_id"], steps))

    q = stated["queries"]
    ext = 2 if stated["min_security_bits"] >= 128 else 1
    n["params"] = sum(_params(s["inner"], stated, q, 1)
                      + int(s["meta"][1] != stated["blowup"])
                      + int(s["meta"][2] != q) for s in steps)
    n["params"] += (_params(art["proof"], stated, max(q, 16), ext)
                    + int(art["profile_queries"] != q)
                    + int(art["fri_blowup"] != stated["blowup"]))
    proofs = [s["inner"] for s in steps] + [art["proof"]]
    n["security_bits"] = min(security_bits(p["queries"], p["blowup"],
                                           p["grind"], p["ext"])
                             for p in proofs)
    return n


def limits(stated: dict) -> dict:
    """{number name: (sense, limit)}: counts at most 0, security at least
    the configuration's minimum."""
    out = {k: ("<=", 0) for k in COUNTS}
    out["security_bits"] = (">=", stated["min_security_bits"])
    return out


def within(value, sense: str, limit) -> bool:
    return value <= limit if sense == "<=" else value >= limit
