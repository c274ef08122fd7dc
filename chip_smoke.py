#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zklisp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA card

Builds the port's CUDA kernels (poseidon12, digit_dot, composition) from
the sources in this checkout, holds each against its plain PyTorch version
on the card, and drives the port's main path — compile the scaled
rollup-bench program, build the 2^16-row trace, prove its 16 segments of
4096 rows (blowup 16, 64 queries, grind 16, 27 hasher rounds) and
aggregate them into one ZKLRC1 artifact with `agg.prove_chain`, verify
every StepProof with `verify_step` and the artifact with `verify_agg` —
then the command line:

  default  the wave prover (parallel/mesh_prover.py: every stage once
           over a wave of segments; 16 rollup-bench segments are one wave
           on an 80 GB card), four-step matrix NTT, matrix DEEP, the
           composition kernel, fused FRI chain (what `prove_program` does
           with no switch set); all 16 segments through `agg.prove_chain`
  serial   ZKL_WAVE=0: the serial segment loop with the default switches;
           the first 2 segments through `prove_program`, whose StepProof
           bytes must equal the wave's
  earlier  ZKL_WAVE=0 and ZKL_NO_MXU_NTT, ZKL_NO_MXU_DEEP, ZKL_CVM_LEVEL=0,
           ZKL_NO_FUSED_FRI set: radix-2 NTT, limb-dot DEEP, per-layer
           FRI loop (ZKL_CVM_LEVEL moves only a CPU tensor's executor:
           the card composes through the kernel); the first 2 segments
           through `prove_program`, whose StepProof bytes must equal the
           default configuration's

Each phase prints one JSON object on a line of its own:
  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    seconds to build the three kernel libraries (in parallel) and
           the host native library, what ptxas reports for each kernel,
           and for
           the poseidon12 kernels their dynamic shared memory and SASS
           opcode counts (cuobjdump)
  kernels  poseidon12 == permute12_plain (fixed batches, edge states)
           through the wrapper and through both C entry points (the
           team kernel and the port's first kernel, kept in its source
           as a yardstick), and digit_dot == digit_dot_plain (the
           probe's shape in u8 and s8, the main path's shapes, ragged
           shapes, the edges of the TMA tiling in u8 and s8, all-255
           digits), on the card, tolerance 0; digit_dot through the
           wrapper and through the port's first kernel, kept in its
           source as a yardstick
  commit   Merkle commit of a (219, 8192, 8) array on the card: through
           the kernel vs through the plain permutation
  composition  the composition kernel (csrc/composition.cu: the generic
           program and the round blocks, two launches) at the wave's
           shapes, 16 x 32,768 and 2 x 32,768 rows of random values on the
           strided sub-domain view, with rollup-bench's and fib-2pow16's
           recorded programs: equal to the plain executors (leveled +
           round blocks), device ms beside its bound and the plain
           version's ms
  prove    per configuration (one line each, headed by the card's name
           and power limit): the segments proved, per-phase seconds (the
           default one: the wave width, the number of waves and each
           wave's phases with the peak memory at each phase's end),
           rows/s of the step proofs, peak memory, kernel launches (the
           composition kernels must run on every composed row: each
           composition phase's kernel_rows = its segments x 32,768); for
           the default one also steps_s and agg_s of `prove_chain` with
           the split of agg_s (child challenges, the child batch on the
           card with its leaf and Merkle re-hash through poseidon12,
           prove_agg), the poseidon12 launches and batches after the last
           segment (the aggregation), the artifact's length and blake3,
           the seconds of decode_artifact + verify_agg, and the
           aggregation trace built again on the card and on the CPU (the
           same tensor code with each kernel's plain version): equal,
           with both child-batch times; then the byte comparisons
  stream   the streamed trace source (trace/stream.py), one line per
           run, headed by the card's name and power limit: (a) rollup-bench
           scaled to 8 segments (2^15 rows) with ZKL_STREAM_TRACE=1
           through `agg.prove_chain` (the serial loop, one segment's
           window and upload ahead): the prove line's fields plus pass-1
           seconds, per-segment seconds, host RSS and the per-segment
           usage masks (with --segments 8 or less: that program, and the
           artifact's blake3 beside the wave's: they differ, streamed
           segments carry their own usage masks, as in the JAX package);
           (b) the first 2 segments streamed and from the full trace
           (ZKL_WAVE=0), both with ZKL_UNIFORM_SEGMENTS=0: equal StepProof
           bytes; (c) rollup-bench at BATCH 121 (16,330 ops, 2^19 rows,
           128 segments) with no switch set: it must stream; the first 8
           segments proved and verified, pass-1 seconds, peak device
           memory and the growth of the current host RSS; (d) the
           4-segment program with ZKL_WAVE=0, serial and with
           max_concurrent_segments=2: equal StepProof bytes, both times
  cli      `python -m zklisp_tpu_torch.cli prove examples/hello-zk.zlisp`
           at 128 bits (the aggregation over the quadratic extension) in a
           subprocess on the card, `cli verify` of its artifact, and of the
           artifact with one byte flipped (must be rejected)
  mesh     `prove_program_mesh` of all segments on a mesh (one wave):
           `Mesh([cuda:0] * 4)` (a quarter of the wave per shard), then
           `Mesh([cuda:0] * 2)` with ZKL_MESH_CHAIN=1, and `default_mesh()`
           where there are several cards; each run between counts_zero
           and counts_read: StepProof bytes equal to the one-device
           wave's, the artifact aggregated from its steps equal to the
           default run's (blake3) and accepted by `verify_agg`; seconds,
           launches per segment, peak memory, per-wave phases; then a
           doctored state_in_hash must make the mesh chain check raise
  ntt_mesh rollup-bench as one 2^16-row segment: the coset LDE of its 212
           trace polynomials (N = 2^20) through `stark_device.lde_columns`
           and through `ntt_mesh.lde_columns_sharded` on 2 and 4 entries
           of the card: equal limb for limb; seconds, launches, peaks
  multihost two worker processes (`python -m
           zklisp_tpu_torch.parallel.multihost`) share the card, Gloo on
           127.0.0.1, ZKL_WAVE=8 each: the gathered StepProofs equal the
           one-device wave's, process 0's artifact the default run's
           blake3, accepted by `verify_agg`; wall seconds, each worker's
           seconds, peak memory, launches and exit code (the workers
           aggregate through `prove_chain_multihost`); then
           `run_dryrun_multihost` (the JAX package's toy configuration in
           two workers, each on a mesh of 4 shards of the card, against
           this process's run on such a mesh, 4 hasher rounds)
  mesh_shapes (after mesh / ntt_mesh) each kernel == its plain version at
           every shape only those phases gave it, timed as in `shapes`
  shapes   each kernel == its plain version at every shape the default
           run gave it, and the times: poseidon12 at every batch, the
           team kernel and the yardstick as device time in turns, the
           wrapper with its host work, launches per segment, the bound,
           then the per-segment sums (plain version: the two largest
           batches); digit_dot at every shape, the wgmma kernel, the
           yardstick and `torch._int_mm`, the library's call, timed in
           turns, and the wrapper with its host work
then the `{"kernels": [...]}` summary, the whole run's seconds and, last,
the `{"ok": true, ...}` line.  Any failed phase ends the run with a
non-zero exit code and no result line.  Without a CUDA card the script
exits non-zero at once.

Options (for development; the default run takes none):
  --phases device,build,kernels,commit,composition,prove,stream,cli,mesh,
           ntt_mesh,multihost,shapes
                    subset of phases (`stream` and `shapes` need `prove`;
                    `mesh` and `multihost` without `prove` run the default
                    configuration first, as their reference)
  --segments K      K = 2, 4 or 8: the rollup-bench program scaled to K
                    segments of 4096 rows (2^16 rows: 16), aggregated whole
  --profile         after phase `prove`, the default configuration's
                    `prove_program` once more under torch.profiler: device
                    busy seconds and idle share over the wave, kernel
                    launches per segment of each wave phase and of each
                    hand-written kernel
  --stream-all      phase `stream` (c) proves all 128 segments of the
                    2^19-row trace through `agg.prove_chain` and verifies
                    the artifact; today `verify_agg` rejects it (an open
                    fault of both packages, ROADMAP.md §3: the sorted-RAM
                    chain breaks where a sorted event ends a segment)
ZKL_WAVE=k in the environment sets the default configuration's wave width.
verify_step runs in up to four worker processes (host work only).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import re
import resource
import shutil
import subprocess
import sys
import time
import types

T_START = time.time()

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device available\n")
    sys.exit(2)

os.environ.pop("ZKL_POSEIDON_HASHER_ROUNDS", None)    # full 27 rounds
os.environ.pop("ZKL_MAX_SEGMENT_ROWS", None)
os.environ.pop("ZKL_NO_NATIVE", None)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from zklisp_tpu_torch import native                          # noqa: E402
from zklisp_tpu_torch.crypto import poseidon as pos          # noqa: E402
from zklisp_tpu_torch.crypto import poseidon_cuda            # noqa: E402
from zklisp_tpu_torch.field import digit_dot as dd           # noqa: E402
from zklisp_tpu_torch.field import f128, limb                # noqa: E402
from zklisp_tpu_torch.prove import composition_cuda         # noqa: E402
from zklisp_tpu_torch.prove import kernels                   # noqa: E402
from zklisp_tpu_torch.prove import stark_device              # noqa: E402

DEV = torch.device("cuda")
P = f128.P
ROUNDS = 27
ALL_PHASES = ("device,build,kernels,commit,composition,prove,stream,cli,"
              "mesh,ntt_mesh,multihost,shapes")
SEGMENTS = 16          # of 4096 rows: the 2^16-row trace
PLAIN_SLICE = 16384    # states per call of the plain version (its int64
                       # temporaries take ~75 KB per state)

# --- the card's published peaks (NVIDIA H100 SXM data sheet) -------------
HBM_BYTES_PER_S = 3.35e12
# integer multiply-add issue rate: 132 SMs x 64 results per clock per SM
# x 1.98 GHz.  64 per clock per SM is the figure for 32-bit integer
# multiply and multiply-add at compute capability 9.0 in the CUDA C++
# Programming Guide's table "Throughput of Native Arithmetic Instructions"
# (scripts/int_mad_rate.py measures 64.2 for IMAD on an H100 SXM at 700 W).
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# The work of one state and round, in 32x32 -> 64-bit products: the 144
# MDS products (16 each), 12 squarings (10: the cross products once), 12
# multiplies (16) and 36 reductions (two folds by the 14-bit constant
# C = 11520 * 2^32 - 1: 7 each) = 2868.  ptxas makes each product one
# IMAD.WIDE.U32, which writes two registers (lo and hi) and issues at
# ~25 per clock per SM, not 64 (scripts/int_mad_rate.py, same card): so a
# product counts as two multiply-add results at the rate above, and the
# bound is still below what that instruction can reach.
MAD32_PER_STATE_ROUND = 2 * (144 * 16 + 12 * 10 + 12 * 16 + 36 * 7)
BYTES_PER_STATE = 2 * 12 * 8 * 4
# dense INT8 tensor-core rate (NVIDIA H100 SXM data sheet, no sparsity)
INT8_OPS_PER_S = 1979e12

# the switches of the earlier configuration (the JAX package's own names)
EARLIER_ENV = {"ZKL_NO_MXU_NTT": "1", "ZKL_NO_MXU_DEEP": "1",
               "ZKL_CVM_LEVEL": "0", "ZKL_NO_FUSED_FRI": "1"}
# the configurations after the default one: the serial loop (ZKL_WAVE=0),
# with the default switches and with the earlier ones, on the first
# SERIAL_SEGMENTS segments
SERIAL_CONFIGS = {"serial": {"ZKL_WAVE": "0"},
                  "earlier": dict(EARLIER_ENV, ZKL_WAVE="0")}
SERIAL_SEGMENTS = 2
# phase `stream` (b): the first SERIAL_SEGMENTS segments streamed and from
# the full trace through the serial loop, per-segment masks in both
SEGMENT_MASKS = {"ZKL_UNIFORM_SEGMENTS": "0"}
BYTE_CHECK_CONFIGS = {
    "stream_masks": dict(SEGMENT_MASKS, ZKL_STREAM_TRACE="1"),
    "full_masks": dict(SEGMENT_MASKS, ZKL_STREAM_TRACE="0", ZKL_WAVE="0")}
# every switch a configuration may set, cleared before each one
SWITCHES = (*EARLIER_ENV, "ZKL_STREAM_TRACE", "ZKL_UNIFORM_SEGMENTS")
# phase `stream` (c): rollup-bench at BATCH 121 is 16,330 ops, a 2^19-row
# trace of 128 segments, which `prove_program` streams with no switch set;
# the first THRESHOLD_FIRST are proved (all of them under --stream-all)
THRESHOLD_BATCH = 121
THRESHOLD_SEGMENTS = 128
THRESHOLD_FIRST = 8
# phase `stream` (a): the streamed chain on this many segments of 4096 rows
# (rollup-bench scaled to them; fewer than the 16 of the default run, so
# that the mesh phases fit the run's time)
STREAM_CHAIN_SEGMENTS = 8
CONCURRENT_SEGMENTS = 4        # phase `stream` (d): the 2^14-row program
VERIFY_POOL = None             # worker processes for verify_step (main())


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    sys.stderr.write("chip_smoke: FAILED: " + msg + "\n")
    sys.exit(1)


def rand_states(rng, b: int) -> np.ndarray:
    """(b, 12, 8) int32 canonical states from a seeded generator."""
    raw = rng.integers(0, 1 << 16, size=(b, 12, 8), dtype=np.int64)
    # canonical: clear the top limb's high bit pattern that could reach p
    # (p's top limbs are all 0xFFFF; a top limb < 0xFFFF is always < p)
    raw[..., 7] = np.minimum(raw[..., 7], 0xFFFE)
    return raw.astype(np.int32)


def plain_sliced(x, suite_id, rounds):
    """permute12_plain over (..., 12, 8) states in slices that bound its
    transient memory."""
    flat = x.reshape(-1, 12, 8)
    out = torch.cat([
        poseidon_cuda.permute12_plain(flat[s:s + PLAIN_SLICE], suite_id,
                                      rounds)
        for s in range(0, flat.shape[0], PLAIN_SLICE)])
    return out.reshape(x.shape)


def max_abs_diff(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


def ptxas_lines(log: str) -> list:
    """Per kernel: its entry name (mangled, template values included) with
    ptxas' register / shared-memory / spill lines and any warning (a
    serialised wgmma shows there)."""
    keep = [l.strip() for l in log.splitlines()
            if "Compiling entry function" in l or "registers" in l
            or "spill" in l or "warning" in l.lower()
            or "wgmma" in l]
    return [l.replace("ptxas info    : ", "") for l in keep]


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_counts(lib_path: str) -> dict:
    """Per kernel of a built library (`cuobjdump -sass`): its static SASS
    opcode counts, and the same counts inside its longest loop (the round
    loop of the poseidon12 kernels) with that loop's inner loops, each
    counted once.  None when cuobjdump is not on this machine."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    dump = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            funcs[name] = []
            continue
        m = SASS_LINE.search(line)
        if name is not None and m:
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    out = {}
    for name, ins in funcs.items():
        loops = []                          # (start, end) of backward BRA
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        total = collections.Counter(op for _, op, _ in ins)
        entry = {"total": len(ins), "imad": {k: v for k, v in total.items()
                                             if k.startswith("IMAD")}}
        if loops:
            lo, hi = max(loops, key=lambda l: l[1] - l[0])
            body = collections.Counter(op for a, op, _ in ins
                                       if lo <= a <= hi)
            entry["loop"] = {
                "instructions": sum(body.values()),
                "imad": {k: v for k, v in body.items()
                         if k.startswith("IMAD")},
                "other_top": dict(collections.Counter(
                    {k: v for k, v in body.items()
                     if not k.startswith("IMAD")}).most_common(8)),
                "inner_loops": [(b - a) // 16 + 1 for a, b in loops
                                if lo <= a and b <= hi and (a, b) != (lo, hi)]}
        out[name] = entry
    return out


def phase_build():
    """The kernel libraries are compiled at once (one nvcc each)."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for job in [pool.submit(poseidon_cuda.load), pool.submit(dd.load),
                    pool.submit(composition_cuda.load)]:
            job.result()                       # a failed build raises here
    t_kernels = time.time() - t0
    t0 = time.time()
    if not native.available():
        fail("host native library (f128_native) did not build")
    t_native = time.time() - t0
    emit({"phase": "build", "kernels_s": round(t_kernels, 3),
          "poseidon12_s": round(poseidon_cuda.build_info["seconds"] or 0, 3),
          "digit_dot_s": round(dd.build_info["seconds"] or 0, 3),
          "composition_s": round(
              composition_cuda.build_info["seconds"] or 0, 3),
          "native_s": round(t_native, 3),
          "ptxas": {"poseidon12":
                    ptxas_lines(poseidon_cuda.build_info["log"]),
                    "digit_dot": ptxas_lines(dd.build_info["log"]),
                    "composition":
                    ptxas_lines(composition_cuda.build_info["log"])},
          "poseidon12_dynamic_smem_bytes": {
              k: f(ROUNDS) for k, f in P12_DYNAMIC_SMEM.items()},
          "poseidon12_sass": sass_counts(poseidon_cuda.LIB_PATH)})


# the C entry points of csrc/poseidon12.cu: the wrapper's kernel (12
# threads per state) and the yardstick (the port's first kernel, one
# thread per state)
P12_ENTRIES = {"teams": "poseidon12_launch",
               "one_thread": "poseidon12_launch_one_thread"}
TEAM_STATES_PER_BLOCK = 10       # csrc/poseidon12.cu: ZKL_STATES
ONE_THREAD_BLOCK = 128           # csrc/poseidon12.cu: ZKL_BLOCK
# each kernel's dynamic shared memory per block (ptxas reports only static
# shared memory), as its launcher in csrc/poseidon12.cu sizes it
P12_DYNAMIC_SMEM = {
    "poseidon12_team_kernel": lambda r: (
        12 * 13 + r * 12 + 2 * TEAM_STATES_PER_BLOCK * 12) * 16,
    "poseidon12_kernel": lambda r: (
        (144 + r * 12) * 2 + 24 * ONE_THREAD_BLOCK) * 8}


def raw_permute(x, entry: str, rounds: int = ROUNDS):
    """One launch through the C entry point `entry`, outside the wrapper
    and its launch count."""
    mds, rc, _ = poseidon_cuda.suite_tensors(pos.HASHER_SUITE_ID, rounds,
                                             DEV)
    out = torch.empty_like(x)
    err = getattr(poseidon_cuda.load(), entry)(
        x.data_ptr(), out.data_ptr(), mds.data_ptr(), rc.data_ptr(),
        x.shape[0], rounds, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"{entry} at batch {x.shape[0]}: CUDA error {err}")
    return out


def phase_kernels():
    """poseidon12 vs permute12_plain on the card at fixed batches, the
    all-zero and the all-(p-1) state among them from 5 states up, exact
    equality: through the wrapper, and through each C entry point (the
    team kernel and the yardstick).  The batches take the ragged edges of
    both kernels' blocks (states per block, one fewer, one more)."""
    rng = np.random.default_rng(20240601)
    edges = [s + d for s in (TEAM_STATES_PER_BLOCK, ONE_THREAD_BLOCK)
             for d in (-1, 0, 1)]
    batches = sorted({1, 2, 3, 4, 5, 7, 8, 9, 263, 65536, *edges})
    checked = []
    max_err = 0
    for rounds in (27, 8):
        for b in batches:
            st = rand_states(rng, b)
            if b >= 5:
                st[0] = 0                                   # all zero
                st[1] = np.asarray(limb.P_LIMBS, np.int32)  # p - 1 ...
                st[1, :, 0] -= 1
            x = torch.from_numpy(st).to(DEV)
            ref = plain_sliced(x, pos.HASHER_SUITE_ID, rounds)
            errs = {"wrapper": max_abs_diff(poseidon_cuda.permute12(
                x, pos.HASHER_SUITE_ID, rounds), ref)}
            for k, entry in P12_ENTRIES.items():
                errs[k] = max_abs_diff(raw_permute(x, entry, rounds), ref)
            torch.cuda.synchronize()
            max_err = max(max_err, *errs.values())
            checked.append({"batch": b, "rounds": rounds,
                            "equal": all(v == 0 for v in errs.values())})
            if any(errs.values()):
                fail(f"poseidon12 != plain at batch {b} rounds {rounds}: "
                     f"{errs}")
    emit({"phase": "kernels", "kernel": "poseidon12", "tolerance": 0,
          "max_abs_err": max_err, "entries": ["wrapper", *P12_ENTRIES],
          "checked": checked})
    return max_err


def rand_digits(rng, shape, signed: bool = False):
    """8-bit digits over the dtype's full range, on the card."""
    if signed:
        arr = rng.integers(-128, 128, size=shape, dtype=np.int8)
    else:
        arr = rng.integers(0, 256, size=shape, dtype=np.uint8)
    return torch.from_numpy(arr).to(DEV)


# the two C entry points of csrc/digit_dot.cu
DD_ENTRIES = {"wgmma": "digit_dot_launch",
              "mma_sync": "digit_dot_launch_mma_sync"}
DD_DESIGNS = {"wgmma": "TMA + mbarrier ring + wgmma (the wrapper's kernel)",
              "mma_sync": "mma.sync, synchronous loads (the port's first "
                          "kernel, kept as a yardstick)"}


def raw_dot(a, wt, design: str):
    """One launch of `design` through its C entry point, outside the
    wrapper and its launch count."""
    M, N = a.shape[0], wt.shape[0]
    a2, wt2, k = dd.operands(a, wt)
    out = torch.empty((M, N), dtype=torch.int32, device=DEV)
    err = getattr(dd.load(), DD_ENTRIES[design])(
        a2.data_ptr(), wt2.data_ptr(), out.data_ptr(), M, N, k,
        int(a.dtype == torch.int8), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"digit_dot {design} at {(M, k, N)}: {dd.launch_error(err)}")
    return out


def dd_errs(a, wt) -> dict:
    """max |kernel - digit_dot_plain| on the card: through the wrapper
    (the wgmma kernel) and through the yardstick's entry point."""
    ref = dd.digit_dot_plain(a, wt)
    errs = {"wrapper": max_abs_diff(dd.digit_dot(a, wt), ref),
            "mma_sync": max_abs_diff(raw_dot(a, wt, "mma_sync"), ref)}
    torch.cuda.synchronize()
    return errs


def lde_chunk() -> int:
    """Columns per NTT batch of a rollup-bench segment (N = 65,536), as
    `stark_device.lde_columns` derives it."""
    return max(1, stark_device.LDE_CHUNK_BYTES
               // (65536 * stark_device.LDE_BYTES_PER_POINT))


def phase_kernels_digit_dot():
    """digit_dot vs digit_dot_plain on the card, exact equality, through
    the wrapper and through the yardstick: the probe's shape and data (u8 and s8), the
    main path's shapes (one product, and the four products stacked as
    `field_matmul` launches them), ragged shapes, the edges of the tiling
    (K = 32 and K not a multiple of the 128-byte box; M and N not
    multiples of 64, 128 or 256; N = 8 ... 40; grids that take each of
    the three tile widths) in u8 and s8, and the
    accumulation edge (all-255 and all -128 digits at K = 32,768)."""
    rng = np.random.default_rng(0)
    checked = []
    max_err = 0

    def check(what, a, wt):
        nonlocal max_err
        errs = dd_errs(a, wt)
        max_err = max(max_err, *errs.values())
        checked.append({"what": what, "M": a.shape[0], "K": a.shape[1],
                        "N": wt.shape[0], "dtype": str(a.dtype)[6:],
                        "equal": {str(k): v == 0 for k, v in errs.items()}})
        if any(errs.values()):
            fail(f"digit_dot != plain at {what} {tuple(a.shape)} x "
                 f"{tuple(wt.shape)}: max abs err {errs}")

    # the probe: (192, 96) . (96, 512), digits below 128, seed 0
    w8 = rng.integers(0, 128, size=(192, 96), dtype=np.uint8)
    x8 = rng.integers(0, 128, size=(96, 512), dtype=np.uint8)
    want = torch.from_numpy(w8.astype(np.int64) @ x8.astype(np.int64))
    for dt in (torch.uint8, torch.int8):
        a = torch.from_numpy(w8).to(DEV).to(dt)
        wt = torch.from_numpy(np.ascontiguousarray(x8.T)).to(DEV).to(dt)
        check("probe", a, wt)
        if max_abs_diff(dd.digit_dot(a, wt).cpu(), want) != 0:
            fail("digit_dot != the numpy int64 product at the probe")

    C = lde_chunk()
    for what, M, K, N in [
            ("intt4096 stage", C * 64, 512, 1024),
            ("intt4096 stage, stacked", 2 * C * 64, 512, 2048),
            ("ntt65536 stage", C * 256, 2048, 4096),
            ("ntt65536 stage, stacked", 2 * C * 256, 2048, 8192),
            ("deep", 65536, 1760, 16),
            ("deep, stacked", 131072, 1760, 32),
            ("ragged M=1 N=16", 1, 100, 16),
            ("ragged", 77, 45, 19),
            ("ragged", 300, 1000, 130),
            ("ragged N=33", 257, 64, 33)]:
        check(what, rand_digits(rng, (M, K)), rand_digits(rng, (N, K)))
    for signed in (False, True):
        for what, M, K, N in [
                ("K=32", 200, 32, 136), ("K=1760", 129, 1760, 40),
                ("K=2080", 257, 2080, 264), ("M=65 N=129", 65, 512, 129),
                ("M=129 N=257", 129, 640, 257), ("M=257 N=65", 257, 96, 65),
                ("N=8", 300, 256, 8), ("N=16", 129, 160, 16),
                ("N=24", 65, 2080, 24), ("N=40", 257, 1760, 40),
                ("N=8 M=1", 1, 32, 8),
                # grids large enough for the 128 x 256 tiles
                ("wide tiles, ragged", 4225, 64, 2051),
                ("wide tiles, ragged", 4225, 160, 2051),
                ("wide tiles, N%4=0", 4161, 96, 2056),
                ("wide tiles, N%4=0", 4161, 2080, 2056)]:
            check(what, rand_digits(rng, (M, K), signed),
                  rand_digits(rng, (N, K), signed))
    full = torch.full((200, 2048), 255, dtype=torch.uint8, device=DEV)
    check("all 255, K=2048", full, full[:72])
    check("all 255, K=4096*8", full.repeat(1, 16)[:40], full.repeat(1, 16))
    low = torch.full((130, 32768), -128, dtype=torch.int8, device=DEV)
    check("all -128, K=4096*8", low, low[:70])
    emit({"phase": "kernels", "kernel": "digit_dot", "tolerance": 0,
          "max_abs_err": max_err, "lde_col_chunk": C, "designs": DD_DESIGNS,
          "checked": checked})
    return max_err


def device_ms(fn, n: int = 10):
    """Device time of one fn() in ms: n calls queued behind a spin kernel
    (about 0.15 ms per call, more than the host needs to issue one), so
    the two events see the kernels back to back and not the host's
    launch overhead.  Also returns the host's time to issue one call, in
    microseconds (the loop's wall time over n: the calls only queue)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(n * 3e5))
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, host_us


def turns_ms(fns: dict, rounds: int = 4):
    """device_ms of each function, taken in turns (the order reversed
    every round); the median per function of the device ms and of the
    host's microseconds per call."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(device_ms(fns[k]))
    return ({k: float(np.median([t[0] for t in v]))
             for k, v in times.items()},
            {k: float(np.median([t[1] for t in v]))
             for k, v in times.items()})


def int_mm_call(M: int, K: int, N: int):
    """The one PyTorch call that computes the same function on s8 inputs,
    `torch._int_mm` (a yardstick only: the port never calls it), at this
    shape; None where it refuses the shape."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-128, 128, size=(M, K),
                                      dtype=np.int8)).to(DEV)
    wt = torch.from_numpy(rng.integers(-128, 128, size=(N, K),
                                       dtype=np.int8)).to(DEV)
    try:
        if max_abs_diff(torch._int_mm(a, wt.t()),
                        dd.digit_dot_plain(a, wt)) != 0:
            fail("torch._int_mm disagrees with digit_dot_plain")
    except RuntimeError as e:
        sys.stderr.write(f"chip_smoke: torch._int_mm refused "
                         f"({M}, {K}) x ({K}, {N}): {e}\n")
        return None
    return lambda: torch._int_mm(a, wt.t())


def phase_shapes_digit_dot(shape_log, name: str = "shapes", timed_only=None):
    """Every distinct (M, K, N) the main path launched, costliest first:
    the wrapper and the yardstick vs digit_dot_plain (exact equality),
    then the device times of the wgmma kernel, the yardstick and
    `torch._int_mm`, taken in turns; the wrapper's time with its host work
    (one call between two events, as the first slice timed it); and the
    plain version's."""
    rng = np.random.default_rng(20240603)
    shapes = sorted(set(shape_log), key=lambda s: -s[0] * s[1] * s[2])
    checked, timed = [], []
    max_err = 0
    for M, K, N in shapes:
        a = rand_digits(rng, (M, K))
        wt = rand_digits(rng, (N, K))
        errs = dd_errs(a, wt)
        max_err = max(max_err, *errs.values())
        checked.append({"M": M, "K": K, "N": N,
                        "equal": {str(k): v == 0 for k, v in errs.items()},
                        "launches_main_path": shape_log.count((M, K, N))})
        if any(errs.values()):
            fail(f"digit_dot != plain at main-path shape {(M, K, N)}: "
                 f"max abs err {errs}")
        if timed_only is not None and (M, K, N) not in timed_only:
            continue
        fns = {d: (lambda d=d: raw_dot(a, wt, d)) for d in DD_ENTRIES}
        lib_fn = int_mm_call(M, K, N)
        if lib_fn is not None:
            fns["library"] = lib_fn
        ms, host_us = turns_ms(fns)
        wrapper_ms = cuda_ms(lambda: dd.digit_dot(a, wt))
        # the comparison above was the plain version's warm-up
        plain_ms = cuda_ms(lambda: dd.digit_dot_plain(a, wt), reps=2,
                           warm=0)
        ops_ms = 2.0 * M * K * N / INT8_OPS_PER_S * 1e3
        bytes_ms = (M * K + K * N + 4.0 * M * N) / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        timed.append({"M": M, "K": K, "N": N, "ms": ms["wgmma"],
                      "launches_main_path": shape_log.count((M, K, N)),
                      "earlier_ms": ms["mma_sync"],
                      "wrapper_ms": wrapper_ms, "host_us": host_us,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": ("operations" if ops_ms >= bytes_ms
                                   else "bytes"),
                      "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
                      "library_ms": ms.get("library"),
                      "share_of_bound": bound_ms / ms["wgmma"],
                      "tera_ops_per_s": 2.0 * M * K * N / ms["wgmma"] / 1e9})
        del a, wt, fns, lib_fn
        torch.cuda.empty_cache()
    emit({"phase": name, "kernel": "digit_dot", "tolerance": 0,
          "max_abs_err": max_err, "timing": "ms, earlier_ms, library_ms: "
          "device time, 10 launches queued behind a spin kernel, median of "
          "4 rounds in turns; host_us: the host's time to issue one of "
          "those calls; wrapper_ms: one digit_dot call between two events, "
          "host work included, median of 5",
          "checked": checked, "timed": timed})
    return max_err, timed


def p12_bound(b: int):
    """(bound ms, by, ops ms, bytes ms) of `b` permutations of ROUNDS."""
    ops_ms = b * ROUNDS * MAD32_PER_STATE_ROUND / INT32_MAD_PER_S * 1e3
    bytes_ms = b * BYTES_PER_STATE / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def phase_shapes(batch_log, n_segments: int, agg_log=(),
                 name: str = "shapes"):
    """Every distinct batch the step proofs (`batch_log`) and the
    aggregation (`agg_log`) gave the kernel, largest first:
    the wrapper and each entry of P12_ENTRIES vs permute12_plain (exact
    equality, 27 rounds; the plain version's run is timed between two
    events); the device times of the entries, taken in turns
    (10 launches queued behind a spin kernel, so that a small batch shows
    device time and not host time); the wrapper's time with its host
    work; launches per segment and the bound.  Then the per-segment sums
    of each time and of the bound (launches x ms over the batches)."""
    rng = np.random.default_rng(20240602)
    batches = sorted(set(batch_log) | set(agg_log), reverse=True)
    checked, timed = [], []
    max_err = 0
    for b in batches:
        x = torch.from_numpy(rand_states(rng, b)).to(DEV)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        ref = plain_sliced(x, pos.HASHER_SUITE_ID, ROUNDS)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms = ev0.elapsed_time(ev1)
        errs = {"wrapper": max_abs_diff(
            poseidon_cuda.permute12(x, pos.HASHER_SUITE_ID, ROUNDS), ref)}
        for k, entry in P12_ENTRIES.items():
            errs[k] = max_abs_diff(raw_permute(x, entry), ref)
        torch.cuda.synchronize()
        max_err = max(max_err, *errs.values())
        per_seg = batch_log.count(b) / n_segments
        checked.append({"batch": b, "rounds": ROUNDS,
                        "equal": {k: v == 0 for k, v in errs.items()},
                        "launches_per_segment": per_seg,
                        "launches_aggregation": agg_log.count(b)})
        if any(errs.values()):
            fail(f"poseidon12 != plain at main-path batch {b}: {errs}")
        del ref
        ms, host_us = turns_ms({k: (lambda e=e: raw_permute(x, e))
                                for k, e in P12_ENTRIES.items()})
        wrapper_ms = cuda_ms(lambda: poseidon_cuda.permute12(
            x, pos.HASHER_SUITE_ID, ROUNDS))
        bound_ms, by, ops_ms, bytes_ms = p12_bound(b)
        row = {"batch": b, "rounds": ROUNDS,
               "launches_per_segment": per_seg,
               "launches_aggregation": agg_log.count(b),
               "ms": ms["teams"], "earlier_ms": ms["one_thread"],
               "host_us": host_us,
               "wrapper_ms": wrapper_ms, "bound_ms": bound_ms,
               "bound_by": by, "bound_ops_ms": ops_ms,
               "bound_bytes_ms": bytes_ms,
               "share_of_bound": bound_ms / ms["teams"],
               "perms_per_s": b / ms["teams"] * 1e3,
               "plain_ms": plain_ms}
        timed.append(row)
        del x
        torch.cuda.empty_cache()
    per_segment = {k: sum(r["launches_per_segment"] * r[k] for r in timed)
                   for k in ("ms", "earlier_ms", "wrapper_ms", "bound_ms")}
    emit({"phase": name, "kernel": "poseidon12", "tolerance": 0,
          "max_abs_err": max_err, "states_main_path": sum(batch_log),
          "states_aggregation": sum(agg_log),
          "timing": "ms (team kernel), earlier_ms (yardstick): device "
          "time, 10 launches "
          "queued behind a spin kernel, median of 4 rounds in turns; "
          "host_us: the host's time to issue one of those calls; "
          "wrapper_ms: one permute12 call between two events, host work "
          "included, median of 5; plain_ms: the reference run of the "
          "check, between two events",
          "per_segment_ms": per_segment, "checked": checked,
          "timed": timed})
    return max_err, timed, per_segment


def phase_commit():
    """(219, 8192, 8) columns committed on the card twice, once with every
    permutation through the kernel and once through the plain version:
    equal roots and sibling paths."""
    rng = np.random.default_rng(11)
    arr = rng.integers(0, 1 << 16, size=(219, 8192, 8),
                       dtype=np.int64).astype(np.int32)
    arr[..., 7] = np.minimum(arr[..., 7], 0xFFFE)
    positions = [int(v) for v in rng.integers(0, 8192, size=8)]
    cols = torch.from_numpy(arr).to(DEV)
    n0 = poseidon_cuda.permute12.launches
    t0 = time.time()
    lv_kernel = kernels.commit_cols(cols, 16)
    torch.cuda.synchronize()
    t_kernel = time.time() - t0
    n_kernel = poseidon_cuda.permute12.launches - n0

    wrapper = poseidon_cuda.permute12
    poseidon_cuda.permute12 = plain_sliced      # the reference commit only
    try:
        t0 = time.time()
        lv_plain = kernels.commit_cols(cols, 16)
        torch.cuda.synchronize()
        t_plain = time.time() - t0
    finally:
        poseidon_cuda.permute12 = wrapper
    if wrapper.launches - n0 != n_kernel or n_kernel <= 0:
        fail("the reference commit did not bypass the kernel")

    def paths(levels):
        out = []
        for p_ in positions:
            cur, path = p_, []
            for lv in levels[:-1]:
                path.append(lv[cur ^ 1].cpu().numpy().tolist())
                cur >>= 1
            out.append(path)
        return out

    root_kernel = lv_kernel[-1].cpu().numpy().tolist()
    root_plain = lv_plain[-1].cpu().numpy().tolist()
    ok = root_kernel == root_plain and paths(lv_kernel) == paths(lv_plain)
    emit({"phase": "commit", "shape": [219, 8192, 8], "roots_equal":
          root_kernel == root_plain, "paths_equal": ok,
          "positions": positions, "kernel_launches": n_kernel,
          "kernel_s": round(t_kernel, 3), "plain_s": round(t_plain, 3)})
    if not ok:
        fail("kernel and plain commitments differ")


def record_composition(name: str):
    """(AIR, recorded program, scan specs) of segment 0 of
    examples/<name>.zlisp at the benchmark's options, as the wave records
    them."""
    from zklisp_tpu_torch.compiler import compile_entry
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zklisp_tpu_torch.parallel.mesh_prover import _SegPrep
    from zklisp_tpu_torch.prove import planner
    from zklisp_tpu_torch.prove.params import ProverOptions
    from zklisp_tpu_torch.trace import build as tb

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", name + ".zlisp")) as f:
        program = compile_entry(f.read(), [])
    pi = PublicInputsBuilder(program).build()
    opts = ProverOptions(min_security_bits=0, blowup=16, grind=16,
                         queries=64, max_segment_rows=4096)
    segs = planner.plan_segments(program, pi, opts)
    full = tb.build_trace(program, pi)
    rom_acc = (tb.rom_acc_from_program(program) if any(pi.program_id)
               else (0, 0, 0))
    prep = _SegPrep(0, len(segs), segs[0], full, program, pi,
                    opts.to_proof_options(), 0, pi.program_id, rom_acc)
    prog, specs = stark_device._record_cvm(
        prep.air, len(prep.air.periodic_pattern()) + 1)
    return prep.air, prog, specs


def composition_work(air, prog, specs, S: int, n: int):
    """(32-bit multiply-adds, bytes) the composition of S x n rows needs:
    16 word products per 128-bit product and 7 per reduction (the two
    folds by the 14-bit constant, as MAD32_PER_STATE_ROUND counts them);
    each column the program or the blocks read, and the output, once."""
    from zklisp_tpu_torch.prove import cvm
    code = prog.regs.code
    ops = code[:, 0]
    mads = (int((ops == cvm.R_MUL).sum()) * (16 + 7)
            + int((ops == cvm.R_EMIT).sum()) * 16 + 7)      # generic
    enc = np.concatenate([code[:, 2], code[ops != cvm.R_EMIT, 3]])
    leaf = ((enc >> 24) == cvm.RK_CUR) | ((enc >> 24) == cvm.RK_NXT)
    cols = set((enc[leaf] & 0xFFFFFF).tolist())
    c = air.cols
    blocks = {"poseidon": [c.lane_index(i) for i in range(12)],
              "rom": [c.rom_s_index(i) for i in range(3)]}
    for kind, _ in specs:
        L = len(blocks[kind])
        # cubes (a square: 10, a product: 16, two reductions), the MDS
        # rows, the 27 alpha dots, the 27 gate products
        mads += (L * (10 + 16 + 14) + L * (L * 16 + 7)
                 + 27 * (L * 16 + 7) + 27 * 16)
        cols |= set(blocks[kind])
        if kind == "poseidon":
            mads += 16 + 7                          # pose_active's product
            cols.add(c.pose_active)
    mads += 16 + 7                  # the scan's start and its last fold
    nbytes = (len(cols) + 1) * S * n * 32           # columns + the output
    return mads * S * n, nbytes


def phase_composition(smi_line: str):
    """The composition kernels (generic program + round blocks) against the
    plain executors on the card at the wave's shapes, and the times: the
    kernels' device ms (10 calls behind a spin kernel, in turns), the
    bound, and the plain version's (one call after one warm-up)."""
    from zklisp_tpu_torch.prove import composition_device as comp
    from zklisp_tpu_torch.prove import cvm

    lines = []
    for name in ("rollup-bench", "fib-2pow16"):
        air, prog, specs = record_composition(name)
        for S in (16, 2):
            n = 4096 * COMPOSITION_BLOWUP
            g = torch.Generator(device=DEV)
            g.manual_seed(S * 1000 + len(name))

            def rand(shape):
                t = torch.randint(0, 1 << 16, tuple(shape) + (8,),
                                  generator=g, dtype=torch.int32,
                                  device=DEV)
                t[..., 7].clamp_(max=0xFFFE)
                return t

            lde = rand((S, air.trace_width, 2 * n))[:, :, ::2]
            per_p = rand((len(air.periodic_pattern()),
                          32 * COMPOSITION_BLOWUP))
            p_last, alphas = rand((n,)), rand(
                (S, air.num_transition_constraints()))
            gates = per_p[1:28]

            def kernel():
                return comp.compose(air, prog, specs, lde,
                                    COMPOSITION_BLOWUP, per_p, p_last,
                                    alphas)

            def plain():
                gen = cvm.execute_leveled(prog.levels, lde, per_p, p_last,
                                          alphas, COMPOSITION_BLOWUP)
                return limb.add(gen, comp.eval_scan_blocks_plain(
                    air, lde, COMPOSITION_BLOWUP, gates, alphas, specs))

            err = max_abs_diff(kernel(), plain())
            torch.cuda.synchronize()
            if err:
                fail(f"composition kernel != plain ({name}, S={S})")
            ms, host_us = turns_ms({"kernel": kernel})
            plain_ms, _ = device_ms(plain, n=1)
            mads, nbytes = composition_work(air, prog, specs, S, n)
            t_ops = 2 * mads / INT32_MAD_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            lines.append({
                "program": name, "S": S, "rows": n, "equal": True,
                "generic_instructions": int(prog.regs.code.shape[0]),
                "registers": prog.regs.n_regs, "scan_blocks":
                [k for k, _ in specs], "ms": ms["kernel"],
                "host_us_per_call": host_us["kernel"],
                "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "int_mad" if t_ops >= t_bytes else "hbm",
                "mad32": mads, "bytes": nbytes,
                "roofline_pct": 100 * max(t_ops, t_bytes) / ms["kernel"]})
            del lde, per_p, p_last, alphas
            torch.cuda.empty_cache()
    print(smi_line, flush=True)
    emit({"phase": "composition", "tolerance": 0, "launches_per_call": 2,
          "shapes": lines})


def prove_setup(n_segments: int, batch: int | None = None):
    """Compile the rollup-bench program scaled to `n_segments` segments
    of 4096 rows once for all runs: the largest BATCH that fits, or the
    given `batch`, checked to fit (at most 128 ops per segment, and
    `n_segments` segments planned)."""
    from zklisp_tpu_torch import workload
    from zklisp_tpu_torch.compiler import compile_entry
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zklisp_tpu_torch.prove import planner
    from zklisp_tpu_torch.prove.params import ProverOptions

    t0 = time.time()
    if batch is None:
        src, batch, _ = workload.rollup_source(n_segments * 4096 // 32)
    else:
        src = workload.rollup_batch_source(batch)
    program = compile_entry(src, [])
    pi = PublicInputsBuilder(program).build()
    opts = ProverOptions(min_security_bits=0, blowup=16, grind=16,
                         queries=64)
    n_ops = len(program.ops)
    planned = len(planner.plan_segments(program, pi, opts))
    if n_ops > n_segments * 4096 // 32 or planned != n_segments:
        fail(f"rollup-bench at BATCH {batch}: {n_ops} ops, {planned} "
             f"segments, not {n_segments}")
    return {"program": program, "pi": pi, "opts": opts, "batch": batch,
            "source": src, "ops": n_ops, "rows": n_segments * 4096,
            "segment_rows": 4096,
            "compile_s": time.time() - t0}


KERNEL_WRAPPERS = {"poseidon12": lambda: poseidon_cuda.permute12,
                   "digit_dot": lambda: dd.digit_dot,
                   "composition": lambda: composition_cuda.generic,
                   "composition_scan": lambda: composition_cuda.scan}
COMPOSITION_BLOWUP = 8   # rollup-bench's composition sub-domain (Q = 8)


def counts_zero():
    """Set every kernel's launch count to 0 and start its shape log."""
    for wr in KERNEL_WRAPPERS.values():
        wr().launches = 0
    poseidon_cuda.permute12.batch_log = []
    dd.digit_dot.shape_log = []


def counts_read():
    """(launches per kernel, poseidon12 batches, digit_dot shapes) since
    counts_zero(); stops the logs."""
    launches = {k: wr().launches for k, wr in KERNEL_WRAPPERS.items()}
    logs = (poseidon_cuda.permute12.batch_log, dd.digit_dot.shape_log)
    poseidon_cuda.permute12.batch_log = None
    dd.digit_dot.shape_log = None
    if launches["poseidon12"] != len(logs[0]):
        fail("poseidon12's launch count and batch log disagree")
    if launches["digit_dot"] != len(logs[1]):
        fail("digit_dot's launch count and shape log disagree")
    return launches, logs[0], logs[1]


def check_child_batch(agg, agg_pi, steps) -> dict:
    """The aggregation trace built again (outside the counted run) with
    the child batch on the card and on the CPU, where the same tensor
    code runs each kernel's plain version: the traces must be equal."""
    from zklisp_tpu_torch.agg import child_batch
    from zklisp_tpu_torch.utils import tracing

    chs = [agg._child_challenges(s) for s in steps]
    traces, seconds = {}, {}
    for where, dev in (("card", DEV), ("cpu", "cpu")):
        before = tracing.summary().get("agg_child_batch", 0.0)
        traces[where] = agg.build_agg_trace(agg_pi, steps, chs=chs,
                                            device=dev)
        seconds[where] = (tracing.summary().get("agg_child_batch", 0.0)
                          - before)
    equal = traces["card"].cols == traces["cpu"].cols
    if not equal:
        fail("the card's child batch and the CPU's give other traces")
    return {"children": len(steps),
            "groups": len(child_batch.group_children(steps, chs)),
            "traces_equal": equal, "child_batch_s": seconds}


WAVE_PHASES = ("wave_lde", "wave_trace_commit", "wave_fs_coeffs",
               "wave_composition", "wave_quotient", "wave_constraint_commit",
               "wave_zpows", "wave_ood", "wave_deep_sync", "wave_fri",
               "wave_openings", "wave_assembly")


def wave_split(events) -> list:
    """Per wave, from the phase log of a wave run: its width and each
    wave_* phase's seconds and the peak allocated bytes at its end (the
    host assembly of wave k runs in a worker thread and may end after
    wave k+1's first phases: the k-th `wave_assembly` is wave k's)."""
    waves, n_asm = [], 0
    for name, dt, fields in events:
        if name == "wave_lde":
            waves.append({"S": fields.get("S"), "seconds": {}, "peak": {}})
        if name == "wave_assembly":
            w = waves[n_asm]
            n_asm += 1
        elif name in WAVE_PHASES and waves:
            w = waves[-1]
        else:
            continue
        w["seconds"][name] = w["seconds"].get(name, 0.0) + dt
        if "peak_bytes" in fields:
            w["peak"][name] = fields["peak_bytes"]
    for w in waves:
        w["total_s"] = sum(w["seconds"].values())
    return waves


def statm_rss() -> int:
    """The process's current resident bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def maxrss() -> int:
    """The process's peak resident bytes so far (ru_maxrss, in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _verify_blob(blob: bytes) -> None:
    """verify_step of one serialized StepProof (in a worker process)."""
    from zklisp_tpu_torch.prove import formats, prover
    prover.verify_step(formats.StepProof.from_bytes(blob))


def verify_steps(steps, config: str) -> float:
    """verify_step of every StepProof on the host, in VERIFY_POOL's worker
    processes (each verification is pure Python); the seconds taken."""
    t0 = time.time()
    futs = [VERIFY_POOL.submit(_verify_blob, st.to_bytes()) for st in steps]
    for i, f in enumerate(futs):
        try:
            f.result()
        except Exception as e:                    # noqa: BLE001
            fail(f"verify_step rejected segment {i} ({config}): {e!r}")
    return time.time() - t0


def phase_prove(setup, config: str, env: dict, smi_line: str,
                chain: bool = False, first: int = SERIAL_SEGMENTS,
                name: str = "prove"):
    """Drive one configuration (`env` = the switches to set; SWITCHES and
    ZKL_WAVE=0 are cleared first, an outer ZKL_WAVE=k is kept) with every
    kernel's count set to 0 just before and read just after: through
    `agg.prove_chain` over all segments (`chain`), else through
    `prove_program` over the first `first`.  The host's current RSS is
    read before the run and after the `first`-th (a chain: the last)
    segment.  Verify every StepProof (and the artifact).  Configuration
    `default` must prove through the wave, every other one through the
    serial loop; the trace must stream (`stream_pass1` in the phase log)
    exactly where `prover.stream_mode` says.  The line is headed `name`;
    a rejected artifact fails the run after its line."""
    from zklisp_tpu_torch.agg import aggregate as agg
    from zklisp_tpu_torch.crypto.blake3 import blake3
    from zklisp_tpu_torch.prove import prover
    from zklisp_tpu_torch.utils import tracing

    outer_wave = os.environ.get("ZKL_WAVE")
    for k in SWITCHES:
        os.environ.pop(k, None)
    if outer_wave == "0":
        os.environ.pop("ZKL_WAVE")
    os.environ.update(env)
    want_stream = prover.stream_mode(setup["rows"])
    if chain:
        first = setup["rows"] // setup["segment_rows"]   # all of them

    seg_seconds, steps = [], []
    steps_log_len = [0, 0]    # the kernels' logs when the step proofs
                              # returned: the later launches are aggregation
    last = [time.time()]
    first_segment = {}        # per-phase seconds of segment 0, which pays
                              # for the tables, the allocator and the build
    rss = {}
    real_segment = prover.prove_segment
    real_program = prover.prove_program

    def timed_segment(*a, **k):
        """The serial loop's segment prover, timed (it calls this module
        attribute once per segment)."""
        out = real_segment(*a, **k)
        now = time.time()
        seg_seconds.append(now - last[0])
        last[0] = now
        if not chain:
            steps.append(out[0])
        if len(seg_seconds) == 1:
            first_segment.update(tracing.summary())
        if len(seg_seconds) == first:
            rss["after_segment"] = statm_rss()
        return out

    def recorded_program(*a, **k):
        """`prove_program` as `prove_chain` calls it (a module attribute
        looked up at call time): its steps, and the kernels' logs up to
        its return."""
        out = real_program(*a, **k)
        steps.extend(out)
        steps_log_len[:] = [len(poseidon_cuda.permute12.batch_log),
                            len(dd.digit_dot.shape_log)]
        return out

    def stop_early(_batch):
        return len(steps) >= first

    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    rss_max_before = maxrss()
    prover.prove_segment = timed_segment
    if chain:
        prover.prove_program = recorded_program
    counts_zero()
    rss["start"] = statm_rss()
    t0 = last[0] = time.time()
    try:
        if chain:
            proof, digest, agg_pi = agg.prove_chain(
                setup["program"], setup["pi"], setup["opts"], device=DEV)
        else:
            real_program(setup["program"], setup["pi"], setup["opts"],
                         on_steps=stop_early, device=DEV)
            steps_log_len[:] = [len(poseidon_cuda.permute12.batch_log),
                                len(dd.digit_dot.shape_log)]
        torch.cuda.synchronize()
    finally:
        prover.prove_segment = real_segment
        prover.prove_program = real_program
        for k in env:
            os.environ.pop(k, None)
        if outer_wave is not None:
            os.environ["ZKL_WAVE"] = outer_wave
    t_prove = time.time() - t0
    launches, batch_log, shape_log = counts_read()
    batch_log, agg_log = (batch_log[:steps_log_len[0]],
                          batch_log[steps_log_len[0]:])
    peak = torch.cuda.max_memory_allocated()
    n_total = steps[0].proof.pi.segments_total if steps else 0
    events = tracing.events()

    t_verify = verify_steps(steps, config)
    if len(steps) < min(first, 2):
        fail(f"fewer than {min(first, 2)} segments proved ({config})")
    if launches["poseidon12"] <= 0:
        fail(f"the {config} path launched the poseidon12 kernel no time")
    if chain and not agg_log:
        fail("the aggregation launched the poseidon12 kernel no time")
    if "ZKL_NO_MXU_NTT" in env:
        if launches["digit_dot"] != 0:
            fail("the earlier configuration launched digit_dot")
    elif launches["digit_dot"] <= 0:
        fail(f"the {config} path launched the digit_dot kernel no time")
    comp_events = [(nm, f) for nm, _, f in events
                   if nm in ("composition", "wave_composition")]
    if (not comp_events or launches["composition"] <= 0
            or launches["composition_scan"] <= 0):
        fail(f"the {config} path did not compose through the kernel")
    for nm, f in comp_events:
        rows = (f.get("S", 1) * setup["segment_rows"]
                * COMPOSITION_BLOWUP)
        if f.get("kernel_rows") != rows:
            fail(f"{nm}: kernel_rows {f.get('kernel_rows')}, not {rows}")
    waves = wave_split(events)
    if config == "default" and (
            not waves or sum(w["S"] for w in waves) < len(steps)):
        fail("the default configuration did not prove through the wave")
    if config != "default" and waves:
        fail(f"the {config} configuration went through the wave")
    pass1 = [dt for nm, dt, _ in events if nm == "stream_pass1"]
    if bool(pass1) != want_stream:
        fail(f"the {config} configuration streamed: {bool(pass1)}, "
             f"prover.stream_mode says {want_stream}")

    out = {"steps": [st.to_bytes() for st in steps], "launches": launches,
           "batch_log": batch_log, "agg_log": agg_log,
           "shape_log": shape_log, "waves": waves}
    rows = setup["segment_rows"] * len(steps)
    per_phase = {k: v for k, v in tracing.summary().items()
                 if k not in agg.AGG_PHASES}
    n = len(steps)
    line = {"phase": name, "config": config, "switches": env,
            "program": "examples/rollup-bench.zlisp",
            "batch": setup["batch"], "ops": setup["ops"],
            "trace_rows": setup["rows"],
            "segments_total": n_total, "segments_proved": n,
            "all_segments": n == n_total,
            "segment_rows": setup["segment_rows"],
            "width": steps[0].proof.inner.context.trace_width,
            "blowup": 16, "queries": 64, "grind": 16,
            "hasher_rounds": ROUNDS, "verified": True,
            "streamed": bool(pass1),
            "compile_trace_s": setup["compile_s"],
            "prove_s": t_prove, "verify_s": t_verify,
            "rows_per_s": rows / (agg.LAST_CHAIN_TIMINGS["steps_s"]
                                  if chain else t_prove),
            "peak_memory_bytes": peak, "launches": launches,
            "launches_per_segment": {
                "poseidon12": len(batch_log) / n,
                "digit_dot": steps_log_len[1] / n,
                "composition": (launches["composition"]
                                + launches["composition_scan"]) / n},
            "states_per_segment": sum(batch_log) / n}
    if pass1:
        line.update({
            "stream_pass1_s": pass1[0],
            "host_rss_bytes": {
                "current_before_pass1": rss["start"],
                f"current_after_segment_{first}": rss.get("after_segment"),
                "current_growth": (rss.get("after_segment", 0)
                                   - rss["start"]),
                "peak_before": rss_max_before, "peak_after": maxrss()},
            "vm_usage_masks": [[st.vm_usage_mask, st.ram_delta_clk_bits]
                               for st in steps]})
    if config == "default":
        line.update({"wave_width": max(w["S"] for w in waves),
                     "waves": len(waves), "per_wave": waves,
                     "per_phase_s": per_phase})
    else:
        line.update({
            "segment_s": seg_seconds,
            "per_phase_s_first_segment": first_segment,
            "per_phase_s_later_segments_mean": {
                k: (v - first_segment.get(k, 0.0)) / (n - 1)
                for k, v in per_phase.items()} if n > 1 else None})
    if chain:
        if n != n_total or n != setup["rows"] // setup["segment_rows"]:
            fail(f"prove_chain proved {n} of {n_total} segments")
        blob = agg.encode_artifact(proof, agg_pi)
        t0 = time.time()
        proof2, pi2 = agg.decode_artifact(blob)
        rejected = None
        try:
            agg.verify_agg(proof2, pi2)
        except Exception as e:                    # noqa: BLE001
            rejected = repr(e)
        t_verify_agg = time.time() - t0
        timings = dict(agg.LAST_CHAIN_TIMINGS)
        out["blake3"] = blake3(blob).hex()
        line.update({
            "chain": timings,
            "aggregation_poseidon12": {
                "launches": len(agg_log), "states": sum(agg_log),
                "batches": dict(collections.Counter(agg_log))},
            "artifact_bytes": len(blob),
            "artifact_blake3": out["blake3"],
            "agg_trace_rows": proof.context.trace_len,
            "agg_queries": proof.context.options.num_queries,
            "agg_field_extension": proof.context.options.field_extension,
            "verify_agg_s": t_verify_agg, "verify_agg_rejected": rejected,
            "seconds_to_verified_artifact":
                None if rejected else t_prove + t_verify_agg,
            "rows_per_s_to_verified_artifact":
                None if rejected else rows / (t_prove + t_verify_agg)})
        if config == "default" and rejected is None:
            line["child_batch_check"] = check_child_batch(agg, agg_pi,
                                                          steps)
    print(smi_line, flush=True)
    emit(line)
    if chain and rejected is not None:
        fail(f"verify_agg rejected the artifact ({config}): {rejected}")
    return out


def profile_wave(setup, wave_s: float, smi_line: str):
    """The default configuration's `prove_program` (the wave) once more,
    under torch.profiler (CPU + CUDA activities): device-busy seconds
    (the sum of the kernels' and copies' device times), the idle share
    against the unprofiled wave's wall seconds `wave_s` and against the
    profiled one; per wave phase its wall seconds, the device-busy
    seconds of the kernels that start inside the phase's range on the
    device, and the kernel launch calls (`cudaLaunchKernel`) inside its
    range on the host, per segment; each hand-written kernel's device ms
    and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zklisp_tpu_torch.prove import prover
    from zklisp_tpu_torch.utils import tracing

    for k in EARLIER_ENV:
        os.environ.pop(k, None)
    tracing.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        steps = prover.prove_program(setup["program"], setup["pi"],
                                     setup["opts"], device=DEV)
        torch.cuda.synchronize()
        wall = time.time() - t0
    waves = wave_split(tracing.events())
    profiled_wave_s = sum(w["total_s"] for w in waves)
    n_seg = len(steps)

    evs = prof.events()
    on_card = [e for e in evs if e.device_type == DeviceType.CUDA]
    kernels_ = [e for e in on_card if not e.name.startswith("phase:")]
    busy_s = sum(e.time_range.end - e.time_range.start
                 for e in kernels_) / 1e6
    starts = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                    for e in kernels_)
    launches = sorted((e.time_range.start, e.thread) for e in evs
                      if e.device_type == DeviceType.CPU and e.name in (
                          "cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"))
    by_phase = collections.defaultdict(lambda: {
        "wall_s": 0.0, "device_busy_s": 0.0, "launch_calls": 0})
    for e in evs:
        if not e.name.startswith("phase:wave_"):
            continue
        row = by_phase[e.name[6:]]
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            row["device_busy_s"] += sum(d for t, d in starts
                                        if lo <= t <= hi) / 1e6
        else:
            row["wall_s"] += (hi - lo) / 1e6
            row["launch_calls"] += sum(1 for t, th in launches
                                       if lo <= t <= hi and th == e.thread)
    per_phase = {k: {"wall_s": v["wall_s"],
                     "device_busy_s": v["device_busy_s"],
                     "idle_share": (1.0 - v["device_busy_s"] / v["wall_s"]
                                    if v["wall_s"] else None),
                     "launch_calls_per_segment": v["launch_calls"] / n_seg}
                 for k, v in sorted(by_phase.items())}
    ported = {name: {"device_ms": sum(e.time_range.end - e.time_range.start
                                      for e in kernels_
                                      if name in e.name) / 1e3,
                     "launches": sum(1 for e in kernels_ if name in e.name)}
              for name in ("poseidon12", "digit_dot")}
    top = collections.Counter()
    count = collections.Counter()
    for e in kernels_:
        top[e.name[:90]] += e.time_range.end - e.time_range.start
        count[e.name[:90]] += 1
    print(smi_line, flush=True)
    emit({"phase": "profile", "config": "default", "segments": n_seg,
          "waves": len(waves), "wave_width": max(w["S"] for w in waves),
          "profiled_wall_s": wall, "profiled_wave_s": profiled_wave_s,
          "unprofiled_wave_s": wave_s, "device_busy_s": busy_s,
          "device_busy_s_per_segment": busy_s / n_seg,
          "device_idle_share_of_unprofiled_wave": 1.0 - busy_s / wave_s,
          "device_idle_share_of_profiled_wave":
              1.0 - busy_s / profiled_wave_s,
          "device_ops": len(kernels_),
          "device_ops_per_segment": len(kernels_) / n_seg,
          "launch_calls": len(launches),
          "launch_calls_per_segment": len(launches) / n_seg,
          "per_phase": per_phase, "ported_kernels": ported,
          "top_kernels": [{"name": k, "device_ms": us / 1e3,
                           "count": count[k]}
                          for k, us in top.most_common(12)]})


def phase_prove_all(n_segments: int, smi_line: str, profile: bool):
    """The default configuration (the wave) through prove_chain, then the
    serial ones on the first segments; each one's StepProof bytes must
    equal the wave's."""
    setup = prove_setup(n_segments)
    new = phase_prove(setup, "default", {}, smi_line, chain=True)
    if profile:
        profile_wave(setup, sum(w["total_s"] for w in new["waves"]),
                     smi_line)
    for config, env in SERIAL_CONFIGS.items():
        old = phase_prove(setup, config, env, smi_line)
        both = min(len(new["steps"]), len(old["steps"]))
        equal = [new["steps"][i] == old["steps"][i] for i in range(both)]
        emit({"phase": "prove", "compare": f"StepProof bytes, default "
              f"(wave) vs {config} configuration", "segments": both,
              "equal": equal,
              "bytes": [len(b) for b in new["steps"][:both]]})
        if both < SERIAL_SEGMENTS or not all(equal):
            fail(f"the wave's and the {config} configuration's StepProof "
                 f"bytes differ")
    return setup, new


def compare_steps(what: str, a, b, n: int):
    """Emit the comparison of two runs' first `n` StepProofs; fail unless
    both have `n` and they are equal byte for byte."""
    both = min(len(a), len(b), n)
    equal = [a[i] == b[i] for i in range(both)]
    emit({"phase": "stream", "compare": what, "segments": both,
          "equal": equal, "bytes": [len(x) for x in a[:both]]})
    if both < n or not all(equal):
        fail(f"{what}: the StepProof bytes differ")


def phase_concurrent(smi_line: str):
    """(d) The 4-segment rollup-bench off the wave (ZKL_WAVE=0): the serial
    loop, then `max_concurrent_segments=2` (segment 0 alone, the rest on
    two threads, each segment on its own CUDA stream); equal StepProof
    bytes, the concurrent ones verified.  The kernels' counts are neither
    zeroed nor read here: two threads launch."""
    from zklisp_tpu_torch.prove import prover

    setup = prove_setup(CONCURRENT_SEGMENTS)
    for k in SWITCHES:
        os.environ.pop(k, None)
    outer_wave = os.environ.get("ZKL_WAVE")
    os.environ["ZKL_WAVE"] = "0"
    seconds, runs = {}, {}
    try:
        for config, opts in (
                ("serial", setup["opts"]),
                ("concurrent", dataclasses.replace(
                    setup["opts"], max_concurrent_segments=2))):
            torch.cuda.synchronize()
            t0 = time.time()
            runs[config] = prover.prove_program(
                setup["program"], setup["pi"], opts, device=DEV)
            torch.cuda.synchronize()
            seconds[config] = time.time() - t0
    finally:
        if outer_wave is None:
            os.environ.pop("ZKL_WAVE")
        else:
            os.environ["ZKL_WAVE"] = outer_wave
    t_verify = verify_steps(runs["concurrent"], "concurrent")
    print(smi_line, flush=True)
    emit({"phase": "stream", "config": "concurrent",
          "switches": {"ZKL_WAVE": "0"}, "max_concurrent_segments": 2,
          "batch": setup["batch"], "ops": setup["ops"],
          "trace_rows": setup["rows"], "segments": len(runs["serial"]),
          "serial_s": seconds["serial"],
          "concurrent_s": seconds["concurrent"],
          "verify_concurrent_s": t_verify})
    compare_steps("StepProof bytes, serial loop vs max_concurrent_"
                  "segments=2", *[[st.to_bytes() for st in r]
                                  for r in runs.values()],
                  CONCURRENT_SEGMENTS)


def phase_stream(setup, wave_blake3, smi_line: str, stream_all: bool):
    """(a) the streamed chain at full width, on STREAM_CHAIN_SEGMENTS
    segments, (b) streamed vs full-trace StepProof bytes with per-segment
    masks, (c) the 2^19-row program with no switch set, (d) concurrent
    segments."""
    n_a = min(STREAM_CHAIN_SEGMENTS, setup["rows"] // setup["segment_rows"])
    setup_a = (setup if n_a == setup["rows"] // setup["segment_rows"]
               else prove_setup(n_a))
    a = phase_prove(setup_a, "stream", {"ZKL_STREAM_TRACE": "1"}, smi_line,
                    chain=True, name="stream")
    if setup_a is setup:
        emit({"phase": "stream", "compare": "artifact blake3, streamed vs "
              "the wave (streamed segments carry their own usage masks)",
              "stream": a["blake3"], "wave": wave_blake3,
              "equal": a["blake3"] == wave_blake3})

    runs = {c: phase_prove(setup, c, env, smi_line, name="stream")
            for c, env in BYTE_CHECK_CONFIGS.items()}
    compare_steps("StepProof bytes, streamed vs full-trace serial loop, "
                  "per-segment masks", *[r["steps"] for r in runs.values()],
                  SERIAL_SEGMENTS)

    big = prove_setup(THRESHOLD_SEGMENTS, batch=THRESHOLD_BATCH)
    phase_prove(big, "threshold_all" if stream_all else "threshold", {},
                smi_line, chain=stream_all, first=THRESHOLD_FIRST,
                name="stream")
    phase_concurrent(smi_line)


def phase_cli(smi_line: str):
    """The command line in a subprocess on the card: prove hello-zk at 128
    bits (the aggregation proof over the quadratic extension), verify the
    artifact, then verify it with one byte flipped (must fail)."""
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "zklisp_tpu_torch", "build", "cli_smoke")
    os.makedirs(work, exist_ok=True)
    art = os.path.join(work, "hello.bin")
    bad = os.path.join(work, "hello_flipped.bin")
    prog = os.path.join(root, "examples", "hello-zk.zlisp")
    args = ["--arg", "u64:2", "--arg", "u64:5"]
    opts = ["--queries", "33", "--blowup", "16", "--grind", "0",
            "--security-bits", "128", "--json"]

    def cli(cmd, *extra):
        t0 = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "zklisp_tpu_torch.cli", cmd, *extra,
             *opts], cwd=root, capture_output=True, text=True, timeout=900)
        lines = res.stdout.strip().splitlines()
        try:
            out = json.loads(lines[-1]) if lines else {}
        except ValueError:
            out = {}
        return res.returncode, out, time.time() - t0, res.stderr[-2000:]

    rc, proved, t_prove, err = cli("prove", prog, *args, "--secret",
                                   "u64:3", "--out", art)
    if rc != 0 or not proved.get("ok"):
        fail(f"cli prove failed (rc {rc}): {proved} {err}")
    rc, verified, t_verify, err = cli("verify", art, prog, *args)
    if rc != 0 or verified.get("ok") is not True:
        fail(f"cli verify rejected its own artifact (rc {rc}): "
             f"{verified} {err}")
    blob = bytearray(open(art, "rb").read())
    blob[len(blob) - 40] ^= 1
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    rc_bad, flipped, _, _ = cli("verify", bad, prog, *args)
    print(smi_line, flush=True)
    emit({"phase": "cli", "program": "examples/hello-zk.zlisp",
          "options": opts[:-1], "prove": proved, "prove_s": t_prove,
          "verify": verified, "verify_s": t_verify,
          "flipped_byte_verify": flipped, "flipped_byte_rc": rc_bad})
    if rc_bad == 0 or flipped.get("ok") is not False:
        fail("cli verify accepted an artifact with a flipped byte")


# phase `mesh`: the wave sharded over repeated entries of the one card
MESH_SHARDS = 4
MESH_CHAIN_SHARDS = 2
# phase `ntt_mesh`: rollup-bench as one 2^16-row segment (N = 2^20)
NTT_MESH_ROWS = 1 << 16
NTT_MESH_SHARDS = (2, 4)
# phase `multihost`: worker processes sharing the card, segments per wave
MULTIHOST_PROCS = 2
MULTIHOST_WAVE = 8
# the toy dry run: shards of the card in each worker's mesh (the JAX dry
# run's virtual devices per process)
DRYRUN_SHARDS = 4


def artifact_check(steps, setup, want_blake3: str, what: str,
                   blob: bytes | None = None) -> dict:
    """Aggregate `steps` into a ZKLRC1 artifact (unless `blob` is one
    already), decode it and `verify_agg` it; its blake3 must be
    `want_blake3` (the default run's)."""
    from zklisp_tpu_torch.agg import aggregate as agg
    from zklisp_tpu_torch.crypto.blake3 import blake3
    from zklisp_tpu_torch.parallel import multihost

    t0 = time.time()
    if blob is None:
        proof, _, agg_pi = multihost.aggregate_steps(
            steps, setup["pi"], setup["opts"], device=DEV)
        blob = agg.encode_artifact(proof, agg_pi)
    t_agg = time.time() - t0
    t0 = time.time()
    proof2, pi2 = agg.decode_artifact(blob)
    try:
        agg.verify_agg(proof2, pi2)
    except Exception as e:                        # noqa: BLE001
        fail(f"verify_agg rejected the {what} artifact: {e!r}")
    digest = blake3(blob).hex()
    if digest != want_blake3:
        fail(f"the {what} artifact's blake3 {digest} is not the default "
             f"run's {want_blake3}")
    return {"agg_s": t_agg, "verify_agg_s": time.time() - t0,
            "artifact_bytes": len(blob), "artifact_blake3": digest,
            "verified": True, "blake3_equal": True}


def mesh_run(setup, mesh, wave: int, env: dict):
    """`prove_program_mesh` of all segments on `mesh`, every kernel's count
    set to 0 just before and read just after; the steps, launches, logs,
    seconds, peak memory and the wave's phases."""
    from zklisp_tpu_torch.parallel import mesh_prover
    from zklisp_tpu_torch.utils import tracing

    os.environ.update(env)
    tracing.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    t0 = time.time()
    try:
        steps = mesh_prover.prove_program_mesh(
            setup["program"], setup["pi"], setup["opts"], mesh=mesh,
            wave=wave)
        torch.cuda.synchronize()
    finally:
        for k in env:
            os.environ.pop(k, None)
    seconds = time.time() - t0
    launches, batch_log, shape_log = counts_read()
    n = len(steps)
    for k, v in launches.items():
        if v <= 0:
            fail(f"the mesh run on {mesh} launched {k} no time")
    return {"steps": [s.to_bytes() for s in steps], "seconds": seconds,
            "launches": launches,
            "launches_per_segment": {k: v / n for k, v in launches.items()},
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "batch_log": batch_log, "shape_log": shape_log,
            "waves": wave_split(tracing.events())}


def phase_mesh(setup, run, smi_line: str):
    """The segments on a mesh of MESH_SHARDS entries of the one card (one
    wave, a quarter of it per shard), then on MESH_CHAIN_SHARDS entries
    under ZKL_MESH_CHAIN=1, and on `default_mesh()` where there are
    several cards: every StepProof equal to the one-device wave's, the
    artifact aggregated from the mesh's steps equal to the default run's
    and accepted by `verify_agg`; a doctored state_in_hash must raise the
    chain check's error on the mesh."""
    from zklisp_tpu_torch.parallel import mesh_prover
    from zklisp_tpu_torch.prove.formats import StepProof
    from zklisp_tpu_torch.trace import build as tb

    n_seg = len(run["steps"])
    wave = max(n_seg, MESH_SHARDS)
    configs = [("cuda:0 x %d" % MESH_SHARDS,
                mesh_prover.Mesh([DEV] * MESH_SHARDS), {}),
               ("cuda:0 x %d, ZKL_MESH_CHAIN=1" % MESH_CHAIN_SHARDS,
                mesh_prover.Mesh([DEV] * MESH_CHAIN_SHARDS),
                {"ZKL_MESH_CHAIN": "1"})]
    if torch.cuda.device_count() > 1:
        configs.append(("default_mesh()", mesh_prover.default_mesh(), {}))
    chained = []
    real_check = mesh_prover._chain_check_mesh

    def spy(preps, mesh=None):
        chained.append((preps, mesh))
        return real_check(preps, mesh)

    logs = ([], [])
    mesh_prover._chain_check_mesh = spy
    try:
        for what, mesh, env in configs:
            r = mesh_run(setup, mesh, wave, env)
            equal = [a == b for a, b in zip(r["steps"], run["steps"])]
            if len(r["steps"]) != n_seg or not all(equal):
                fail(f"mesh {what}: StepProof bytes differ from the "
                     f"one-device wave's: {equal}")
            art = ({} if env else artifact_check(
                [StepProof.from_bytes(b) for b in r["steps"]], setup,
                run["blake3"], f"mesh {what}"))
            logs[0].extend(r["batch_log"])
            logs[1].extend(r["shape_log"])
            print(smi_line, flush=True)
            emit({"phase": "mesh", "mesh": what,
                  "devices": [str(d) for d in mesh.devices],
                  "switches": env, "segments": n_seg, "wave": wave,
                  "segments_per_shard": wave // mesh.size,
                  "steps_equal_one_device_wave": equal,
                  "seconds": r["seconds"],
                  "rows_per_s": setup["rows"] / r["seconds"],
                  "launches": r["launches"],
                  "launches_per_segment": r["launches_per_segment"],
                  "peak_memory_bytes": r["peak_memory_bytes"],
                  "per_wave": r["waves"], **art})
    finally:
        mesh_prover._chain_check_mesh = real_check
    if not chained:
        fail("ZKL_MESH_CHAIN=1 did not run the mesh chain check")
    preps, mesh = chained[0]
    broken = [types.SimpleNamespace(boundary=dict(p.boundary))
              for p in preps]
    broken[n_seg // 2].boundary["state_in_hash"] = bytes(32)
    try:
        real_check(broken, mesh)
    except tb.TraceError as e:
        emit({"phase": "mesh", "doctored_state_in_hash": n_seg // 2,
              "shards": mesh.size, "raised": str(e)})
    else:
        fail("the mesh chain check accepted a doctored state_in_hash")
    return logs


def phase_ntt_mesh(smi_line: str):
    """Rollup-bench as one 2^16-row segment: its trace polynomials' coset
    LDE (N = 2^20, blowup 16) through `stark_device.lde_columns` on the
    card, and through `ntt_mesh.lde_columns_sharded` on 2 and 4 entries of
    the card (each sharded run between counts_zero and counts_read): equal
    limb for limb."""
    from zklisp_tpu_torch.parallel import mesh_prover, ntt_mesh
    from zklisp_tpu_torch.prove import planner
    from zklisp_tpu_torch.trace import build as tb

    setup = prove_setup(NTT_MESH_ROWS // 4096)
    opts = dataclasses.replace(setup["opts"], max_segment_rows=NTT_MESH_ROWS)
    program, pi = setup["program"], setup["pi"]
    segs = planner.plan_segments(program, pi, opts)
    if len(segs) != 1:
        fail(f"{len(segs)} segments at max_segment_rows {NTT_MESH_ROWS}")
    full = tb.build_trace(program, pi)
    rom_acc = tb.rom_acc_from_program(program)
    base = opts.to_proof_options()
    prep = mesh_prover._SegPrep(0, 1, segs[0], full, program, pi, base, 0,
                                pi.program_id, rom_acc)
    cols = stark_device.stage_limbs([prep.limbs16], DEV).wait()[0]
    del full, prep
    blowup = opts.blowup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    polys, ref = stark_device.lde_columns(cols, blowup)
    torch.cuda.synchronize()
    one_s = time.time() - t0
    del cols
    out = {"phase": "ntt_mesh", "program": "examples/rollup-bench.zlisp",
           "rows": NTT_MESH_ROWS, "columns": int(polys.shape[0]),
           "blowup": blowup, "N": int(ref.shape[1]),
           "lde_bytes": ref.numel() * 4, "one_device_s": one_s,
           "one_device_peak_bytes": torch.cuda.max_memory_allocated(),
           "sharded": []}
    logs = ([], [])
    for C in NTT_MESH_SHARDS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_zero()
        t0 = time.time()
        got = ntt_mesh.lde_columns_sharded(
            polys, blowup, mesh_prover.Mesh([DEV] * C))
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches, batch_log, shape_log = counts_read()
        equal = torch.equal(got, ref)
        del got
        torch.cuda.empty_cache()
        if launches["digit_dot"] <= 0:
            fail(f"lde_columns_sharded on {C} shards launched digit_dot "
                 f"no time")
        logs[0].extend(batch_log)
        logs[1].extend(shape_log)
        out["sharded"].append({
            "shards": C, "R": int(ref.shape[1]) // C, "seconds": seconds,
            "equal_to_one_device_lde": equal, "launches": launches,
            "digit_dot_shapes": sorted(set(shape_log)),
            "peak_bytes": torch.cuda.max_memory_allocated()})
        if not equal:
            fail(f"lde_columns_sharded on {C} shards != lde_columns")
    del polys, ref
    torch.cuda.empty_cache()
    print(smi_line, flush=True)
    emit(out)
    return logs


def phase_multihost(setup, run, smi_line: str):
    """MULTIHOST_PROCS worker processes (`python -m
    zklisp_tpu_torch.parallel.multihost`) share the card and a Gloo group
    on 127.0.0.1, each proves its contiguous block of the segments with
    ZKL_WAVE=MULTIHOST_WAVE; the gathered StepProofs must be the one-device
    wave's, and the workers' aggregation of them
    (`prove_chain_multihost`, written by process 0) the default run's
    artifact, accepted by `verify_agg`."""
    from zklisp_tpu_torch.parallel import multihost

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "zklisp_tpu_torch", "build", "multihost")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "rollup.zlisp")
    art = os.path.join(work, "rollup.zklrc1")
    with open(src, "w") as f:
        f.write(setup["source"])
    o = setup["opts"]
    env = dict(os.environ, ZKL_WAVE=str(MULTIHOST_WAVE))
    # the workers share the card with this process: hand back its cached
    # blocks first (the default run's, when no mesh phase ran before)
    torch.cuda.empty_cache()
    parent = {"allocated_bytes": torch.cuda.memory_allocated(DEV),
              "reserved_bytes": torch.cuda.memory_reserved(DEV)}
    gathered, stats, wall = multihost.launch_workers(
        MULTIHOST_PROCS,
        ["--device", DEV.type, "--program", src, "--artifact", art,
         "--queries", str(o.queries), "--blowup", str(o.blowup),
         "--grind", str(o.grind), "--security-bits",
         str(o.min_security_bits)],
        env=env, timeout_s=900, work_dir=work)
    equal = [a == b for a, b in zip(gathered, run["steps"])]
    if len(gathered) != len(run["steps"]) or not all(equal):
        fail(f"multihost: gathered StepProofs differ from the one-device "
             f"wave's: {equal}")
    for st in stats:
        for k, v in st["launches"].items():
            if v <= 0:
                fail(f"multihost worker {st['process']} launched {k} no "
                     f"time")
    with open(art, "rb") as f:
        blob = f.read()
    art_check = artifact_check(None, setup, run["blake3"],
                               "multihost process 0", blob=blob)
    # the dry run: the toy configuration in MULTIHOST_PROCS workers, each
    # on a mesh of DRYRUN_SHARDS shards of the card, against this
    # process's run on such a mesh (it raises on a byte difference)
    t0 = time.time()
    dry = multihost.run_dryrun_multihost(MULTIHOST_PROCS, DRYRUN_SHARDS,
                                         device=DEV, timeout_s=600)
    dry_s = time.time() - t0
    print(smi_line, flush=True)
    emit({"phase": "multihost", "processes": MULTIHOST_PROCS,
          "backend": "gloo", "coordinator": "127.0.0.1",
          "switches": {"ZKL_WAVE": str(MULTIHOST_WAVE)},
          "segments": len(gathered), "steps_equal_one_device_wave": equal,
          "wall_s": wall, "parent": parent, "workers": stats,
          "worker_exit_codes": [st["exit_code"] for st in stats],
          **art_check, "dryrun": {"config": "multihost.dryrun_config",
                                  "shards_per_process": DRYRUN_SHARDS,
                                  "segments": len(dry), "equal": True,
                                  "seconds": dry_s}})


def phase_mesh_shapes(default_run, mesh_logs):
    """Each kernel against its plain version at every shape the mesh
    phases gave it that the default run did not, with the times (the
    `shapes` phase's functions, lines headed `mesh_shapes`)."""
    batches = [b for b in mesh_logs[0]
               if b not in set(default_run["batch_log"])
               | set(default_run["agg_log"])]
    shapes = [s for s in mesh_logs[1]
              if s not in set(default_run["shape_log"])]
    out = {"poseidon12": [], "digit_dot": []}
    errs = {"poseidon12": 0, "digit_dot": 0}
    if batches:
        errs["poseidon12"], out["poseidon12"], _ = phase_shapes(
            batches, len(default_run["steps"]), name="mesh_shapes")
    if shapes:
        # every shape is checked; of each (K, N) the largest M and the
        # most launched one are timed (the chunk tails give dozens of Ms)
        by_kn = collections.defaultdict(set)
        for M, K, N in shapes:
            by_kn[(K, N)].add(M)
        timed_only = set()
        for (K, N), ms in by_kn.items():
            timed_only.add((max(ms), K, N))
            timed_only.add((max(ms, key=lambda m: (shapes.count((m, K, N)),
                                                   m)), K, N))
        errs["digit_dot"], out["digit_dot"] = phase_shapes_digit_dot(
            shapes, name="mesh_shapes", timed_only=timed_only)
    return errs, out


def kernels_summary(run, errs, timed, p12_sums, mesh_timed) -> dict:
    """The `{"kernels": [...]}` line: per kernel the launches of the
    default run and the times at its costliest main-path shape
    (poseidon12: also the per-segment sums over all its batches), and the
    times at the shapes only the mesh phases gave it."""
    n = len(run["steps"])
    top_p, top_d = timed["poseidon12"][0], timed["digit_dot"][0]
    return {"kernels": [
        {"name": "poseidon12", "route": "cuda",
         "source": "zklisp_tpu_torch/csrc/poseidon12.cu",
         "replaces": "zklisp_tpu/crypto/poseidon_pallas.py:351",
         "launches": run["launches"]["poseidon12"],
         "launches_per_segment": len(run["batch_log"]) / n,
         "launches_aggregation": len(run["agg_log"]),
         "max_abs_err": errs["poseidon12"],
         "ms": top_p["ms"], "plain_ms": top_p["plain_ms"],
         "bound_ms": top_p["bound_ms"], "bound_by": top_p["bound_by"],
         "library_ms": None, "earlier_ms": top_p["earlier_ms"],
         "wrapper_ms": top_p["wrapper_ms"], "batch": top_p["batch"],
         "rounds": top_p["rounds"], "per_segment_ms": p12_sums,
         "other_shapes": timed["poseidon12"][1:],
         "mesh_shapes": mesh_timed["poseidon12"]},
        {"name": "digit_dot", "route": "cuda",
         "source": "zklisp_tpu_torch/csrc/digit_dot.cu",
         "replaces": "scripts/exp_pallas_int8_dot.py:41",
         "launches": run["launches"]["digit_dot"],
         "launches_per_segment": run["launches"]["digit_dot"] / n,
         "max_abs_err": errs["digit_dot"],
         "ms": top_d["ms"], "plain_ms": top_d["plain_ms"],
         "bound_ms": top_d["bound_ms"], "bound_by": top_d["bound_by"],
         "library_ms": top_d["library_ms"],
         "earlier_ms": top_d["earlier_ms"],
         "wrapper_ms": top_d["wrapper_ms"],
         "shape_MKN": [top_d["M"], top_d["K"], top_d["N"]],
         "other_shapes": timed["digit_dot"][1:],
         "mesh_shapes": mesh_timed["digit_dot"]}]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--segments", type=int, default=SEGMENTS,
                    choices=[2, 4, 8, 16])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stream-all", action="store_true")
    args = ap.parse_args()
    phases = args.phases.split(",")
    for ph in ("shapes", "stream"):
        if ph in phases and "prove" not in phases:
            ap.error(f"phase `{ph}` needs phase `prove`")
    global VERIFY_POOL
    VERIFY_POOL = concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, min(4, (os.cpu_count() or 2) // 2)),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        run_phases(args, phases)
    finally:
        VERIFY_POOL.shutdown(wait=True)


def run_phases(args, phases) -> None:

    seconds = {}
    t0 = time.time()

    def lap(name: str) -> None:
        nonlocal t0
        seconds[name] = round(time.time() - t0, 1)
        t0 = time.time()

    smi_line = phase_device()
    if "build" in phases:
        phase_build()
        lap("build")
    errs = {"poseidon12": 0, "digit_dot": 0}
    timed = {}
    if "kernels" in phases:
        errs["poseidon12"] = phase_kernels()
        errs["digit_dot"] = phase_kernels_digit_dot()
        lap("kernels")
    if "commit" in phases:
        phase_commit()
        lap("commit")
    if "composition" in phases:
        phase_composition(smi_line)
        lap("composition")
    if "prove" in phases:
        setup, run = phase_prove_all(args.segments, smi_line, args.profile)
        lap("prove")
    if "stream" in phases:
        phase_stream(setup, run["blake3"], smi_line, args.stream_all)
        lap("stream")
    if "cli" in phases:
        phase_cli(smi_line)
        lap("cli")
    mesh_logs = ([], [])
    if {"mesh", "multihost"} & set(phases) and "prove" not in phases:
        # the one-device wave these phases are held against
        setup = prove_setup(args.segments)
        run = phase_prove(setup, "default", {}, smi_line, chain=True)
        lap("prove_reference")
    for name in ("mesh", "ntt_mesh"):
        if name in phases:
            logs = (phase_mesh(setup, run, smi_line) if name == "mesh"
                    else phase_ntt_mesh(smi_line))
            mesh_logs[0].extend(logs[0])
            mesh_logs[1].extend(logs[1])
            lap(name)
    if "multihost" in phases:
        phase_multihost(setup, run, smi_line)
        lap("multihost")
    mesh_timed = {"poseidon12": [], "digit_dot": []}
    if mesh_logs[0] or mesh_logs[1]:
        mesh_errs, mesh_timed = phase_mesh_shapes(run, mesh_logs)
        for k, v in mesh_errs.items():
            errs[k] = max(errs[k], v)
        lap("mesh_shapes")
    if "shapes" in phases:
        err, timed["poseidon12"], p12_sums = phase_shapes(
            run["batch_log"], len(run["steps"]), run["agg_log"])
        errs["poseidon12"] = max(errs["poseidon12"], err)
        lap("shapes_poseidon12")
        err, timed["digit_dot"] = phase_shapes_digit_dot(run["shape_log"])
        errs["digit_dot"] = max(errs["digit_dot"], err)
        lap("shapes_digit_dot")
        emit(kernels_summary(run, errs, timed, p12_sums, mesh_timed))
    emit({"phase": "total", "seconds": round(time.time() - T_START, 1),
          "phases": phases, "phase_seconds": seconds})
    print(smi_line, flush=True)
    if set(phases) >= set(ALL_PHASES.split(",")):
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
    else:
        emit({"partial": True, "phases": phases})


if __name__ == "__main__":
    main()
