#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zklisp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA card

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, and drives the port's main
path — compile the scaled rollup-bench program, build the 2^16-row trace,
prove its 4096-row segments (blowup 16, 64 queries, grind 16, 27 hasher
rounds) with `prove_program`, verify every StepProof with `verify_step`.

Each phase prints one JSON object on a line of its own:
  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    seconds to build poseidon12.cu and the host native library
  kernels  poseidon12 == permute12_plain on the card (tolerance 0) at
           fixed batches, edge states included
  commit   Merkle commit of a (219, 8192, 8) array on the card: through
           the kernel vs through the plain permutation
  prove    the segments proved, per-phase seconds, rows/s, peak memory
  shapes   poseidon12 == permute12_plain at every batch shape the prove
           phase gave the kernel, and its time at the two largest
then the `{"kernels": [...]}` summary and, last, the `{"ok": true, ...}`
line.  Any failed phase ends the run with a non-zero exit code and no
result line.  Without a CUDA card the script exits non-zero at once.

Options (for development; the default run takes none):
  --phases device,build,kernels,commit,prove,shapes   subset of phases
                    (`shapes` needs `prove`)
  --segments K      prove only the first K segments (default: as many of
                    the 16 as the time budget allows, at least 2)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
from zklisp_tpu_torch.field import f128, limb                # noqa: E402
from zklisp_tpu_torch.prove import kernels                   # noqa: E402

DEV = torch.device("cuda")
P = f128.P
ROUNDS = 27
ALL_PHASES = "device,build,kernels,commit,prove,shapes"
BUDGET_S = 1000.0      # wall clock of the whole run; the prove phase stops
                       # taking segments when the next would not fit
PLAIN_SLICE = 16384    # states per call of the plain version (its int64
                       # temporaries take ~75 KB per state)

# --- the card's published peaks (NVIDIA H100 SXM data sheet) -------------
HBM_BYTES_PER_S = 3.35e12
# integer multiply-add issue rate: 132 SMs x 64 results per clock per SM
# x 1.98 GHz.  64 per clock per SM is the figure for 32-bit integer
# multiply and multiply-add at compute capability 9.0 in the CUDA C++
# Programming Guide's table "Throughput of Native Arithmetic Instructions".
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# poseidon12's design spends, per state and round: 168 field multiplies of
# four 64x64->128 products each, plus 36 reductions of four such products;
# a 64x64->128 product is four 32x32->64 multiply-adds.  The count is the
# schoolbook one: the 24 multiplies of the cubes include 12 squarings,
# which are counted as full four-product multiplies with no saving for
# the repeated cross term (3 products would do), so the bound sits 1.5%
# above what the function strictly needs.
MAD32_PER_STATE_ROUND = (168 * 4 + 36 * 4) * 4
BYTES_PER_STATE = 2 * 12 * 8 * 4


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


def phase_build():
    t0 = time.time()
    poseidon_cuda.load()
    t_kernel = time.time() - t0
    t0 = time.time()
    if not native.available():
        fail("host native library (f128_native) did not build")
    t_native = time.time() - t0
    ptxas = [l for l in poseidon_cuda.build_info["log"].splitlines()
             if "registers" in l or "spill" in l]
    emit({"phase": "build", "poseidon12_s": round(t_kernel, 3),
          "native_s": round(t_native, 3), "ptxas": ptxas[-4:]})


def phase_kernels():
    """poseidon12 vs permute12_plain on the card at fixed batches, edge
    states included: exact equality."""
    rng = np.random.default_rng(20240601)
    checked = []
    max_err = 0
    for rounds in (27, 8):
        for b in (1, 5, 263, 65536):
            st = rand_states(rng, b)
            if b >= 5:
                st[0] = 0                                   # all zero
                st[1] = np.asarray(limb.P_LIMBS, np.int32)  # p - 1 ...
                st[1, :, 0] -= 1
            x = torch.from_numpy(st).to(DEV)
            got = poseidon_cuda.permute12(x, pos.HASHER_SUITE_ID, rounds)
            ref = plain_sliced(x, pos.HASHER_SUITE_ID, rounds)
            torch.cuda.synchronize()
            err = max_abs_diff(got, ref)
            max_err = max(max_err, err)
            checked.append({"batch": b, "rounds": rounds, "equal": err == 0})
            if err != 0:
                fail(f"poseidon12 != plain at batch {b} rounds {rounds}")
    emit({"phase": "kernels", "kernel": "poseidon12", "tolerance": 0,
          "max_abs_err": max_err, "checked": checked})
    return max_err


def phase_shapes(batch_log):
    """poseidon12 vs permute12_plain at every distinct batch the main path
    gave the kernel (exact equality, 27 rounds), and both versions' times
    at the two largest of them."""
    rng = np.random.default_rng(20240602)
    batches = sorted(set(batch_log), reverse=True)
    checked, timed = [], []
    max_err = 0
    for i, b in enumerate(batches):
        x = torch.from_numpy(rand_states(rng, b)).to(DEV)
        got = poseidon_cuda.permute12(x, pos.HASHER_SUITE_ID, ROUNDS)
        ref = plain_sliced(x, pos.HASHER_SUITE_ID, ROUNDS)
        torch.cuda.synchronize()
        err = max_abs_diff(got, ref)
        max_err = max(max_err, err)
        checked.append({"batch": b, "rounds": ROUNDS, "equal": err == 0,
                        "launches_main_path": batch_log.count(b)})
        if err != 0:
            fail(f"poseidon12 != plain at main-path batch {b}")
        del got, ref
        if i < 2:
            ms = cuda_ms(lambda: poseidon_cuda.permute12(
                x, pos.HASHER_SUITE_ID, ROUNDS))
            # the comparison above was the plain version's warm-up
            plain_ms = cuda_ms(lambda: plain_sliced(
                x, pos.HASHER_SUITE_ID, ROUNDS), reps=2, warm=0)
            ops_ms = (b * ROUNDS * MAD32_PER_STATE_ROUND
                      / INT32_MAD_PER_S * 1e3)
            bytes_ms = b * BYTES_PER_STATE / HBM_BYTES_PER_S * 1e3
            timed.append({"batch": b, "rounds": ROUNDS, "ms": ms,
                          "plain_ms": plain_ms,
                          "bound_ms": max(ops_ms, bytes_ms),
                          "bound_by": ("operations" if ops_ms >= bytes_ms
                                       else "bytes"),
                          "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
                          "perms_per_s": b / ms * 1e3})
        del x
        torch.cuda.empty_cache()
    emit({"phase": "shapes", "kernel": "poseidon12", "tolerance": 0,
          "max_abs_err": max_err, "states_main_path": sum(batch_log),
          "checked": checked, "timed": timed})
    return max_err, timed


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


def phase_prove(n_segments):
    from zklisp_tpu_torch import workload
    from zklisp_tpu_torch.compiler import compile_entry
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zklisp_tpu_torch.prove import prover
    from zklisp_tpu_torch.prove.params import ProverOptions
    from zklisp_tpu_torch.utils import tracing

    t0 = time.time()
    src, batch, n_ops = workload.rollup_source(65536 // 32)
    program = compile_entry(src, [])
    pi = PublicInputsBuilder(program).build()
    opts = ProverOptions(min_security_bits=0, blowup=16, grind=16,
                         queries=64)
    t_compile = time.time() - t0

    seg_seconds = []
    last = [time.time()]

    def on_steps(_batch):
        """Stop the serial loop when the next segment would not fit."""
        now = time.time()
        seg_seconds.append(now - last[0])
        last[0] = now
        done = len(seg_seconds)
        if n_segments is not None:
            return done >= n_segments
        left = BUDGET_S - (now - T_START)
        # keep room for the next segment and for verifying all of them
        return done >= 2 and left < 1.5 * max(seg_seconds) + 4 * done + 60

    tracing.reset()
    torch.cuda.reset_peak_memory_stats()
    poseidon_cuda.permute12.batch_log = []        # the main path's shapes
    poseidon_cuda.permute12.launches = 0          # count the main path only
    t0 = last[0] = time.time()
    steps = prover.prove_program(program, pi, opts, on_steps=on_steps,
                                 device=DEV)
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    launches = poseidon_cuda.permute12.launches   # read right after the run
    batch_log = poseidon_cuda.permute12.batch_log
    poseidon_cuda.permute12.batch_log = None
    peak = torch.cuda.max_memory_allocated()
    n_total = steps[0].proof.pi.segments_total if steps else 0

    t0 = time.time()
    for i, step in enumerate(steps):
        try:
            prover.verify_step(step)
        except Exception as e:                    # noqa: BLE001
            fail(f"verify_step rejected segment {i}: {e!r}")
    t_verify = time.time() - t0
    if len(steps) < 2:
        fail("fewer than 2 segments proved")
    if launches <= 0 or launches != len(batch_log):
        fail("the main path launched the poseidon12 kernel no time")

    rows = 4096 * len(steps)
    per_phase = tracing.summary()
    n = len(steps)
    emit({"phase": "prove", "program": "examples/rollup-bench.zlisp",
          "batch": batch, "ops": n_ops, "trace_rows": 65536,
          "segments_total": n_total, "segments_proved": n,
          "all_segments": n == n_total, "segment_rows": 4096,
          "width": steps[0].proof.inner.context.trace_width,
          "blowup": 16, "queries": 64, "grind": 16, "hasher_rounds": ROUNDS,
          "verified": True, "compile_trace_s": round(t_compile, 3),
          "prove_s": round(t_prove, 3), "verify_s": round(t_verify, 3),
          "rows_per_s": rows / t_prove,
          "segment_s": [round(s, 3) for s in seg_seconds],
          "per_phase_s_one_segment": {k: round(v / n, 4)
                                      for k, v in per_phase.items()},
          "peak_memory_bytes": peak, "poseidon12_launches": launches,
          "launches_per_segment": launches / n,
          "states_per_segment": sum(batch_log) / n})
    return launches, batch_log


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=ALL_PHASES)
    ap.add_argument("--segments", type=int, default=None)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if "shapes" in phases and "prove" not in phases:
        ap.error("phase `shapes` needs phase `prove`")

    smi_line = phase_device()
    if "build" in phases:
        phase_build()
    errs, timed = [], []
    if "kernels" in phases:
        errs.append(phase_kernels())
    if "commit" in phases:
        phase_commit()
    if "prove" in phases:
        launches, batch_log = phase_prove(args.segments)
    if "shapes" in phases:
        err, timed = phase_shapes(batch_log)
        errs.append(err)

    if timed:
        top = timed[0]
        emit({"kernels": [{
            "name": "poseidon12", "route": "cuda",
            "source": "zklisp_tpu_torch/csrc/poseidon12.cu",
            "replaces": "zklisp_tpu/crypto/poseidon_pallas.py:351",
            "launches": launches, "max_abs_err": max(errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "batch": top["batch"],
            "rounds": top["rounds"], "other_shapes": timed[1:]}]})
    print(smi_line, flush=True)
    if set(phases) >= set(ALL_PHASES.split(",")):
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
    else:
        emit({"partial": True, "phases": phases,
              "seconds": round(time.time() - T_START, 1)})


if __name__ == "__main__":
    main()
