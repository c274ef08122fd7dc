#!/usr/bin/env python
"""Where one rollup-bench segment's time goes on the GPU, for the
PyTorch/CUDA port (zklisp_tpu_torch).

    python3 scripts/torch_segment_profile.py [--earlier] [--warm K]

Proves K warm-up segments (default 3) of the scaled rollup-bench program
(4096 x 212, blowup 16, 64 queries, grind 16, 27 hasher rounds), then one
more under `torch.profiler` (CPU + CUDA activities), and prints one JSON
object: the card, the profiled segment's wall seconds and per-phase
seconds (both WITH the profiler's overhead, which is large for a
launch-bound program), the device-busy seconds (sum of kernel times), the
number of kernel launches, the device time and launches of each
hand-written kernel (poseidon12, digit_dot), the top kernels by device
time, and the device's idle share taken against the wall time of the
last warm-up segment (which ran without the profiler).  A second line gives that
segment's per-phase seconds.  `--earlier` sets the four kill switches
(radix-2 NTT, limb-dot DEEP, stack executor, per-layer FRI loop).  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

EARLIER_ENV = {"ZKL_NO_MXU_NTT": "1", "ZKL_NO_MXU_DEEP": "1",
               "ZKL_CVM_LEVEL": "0", "ZKL_NO_FUSED_FRI": "1"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", action="store_true")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_segment_profile: no CUDA device available")
    os.environ.pop("ZKL_POSEIDON_HASHER_ROUNDS", None)
    for k in EARLIER_ENV:
        os.environ.pop(k, None)
    if args.earlier:
        os.environ.update(EARLIER_ENV)

    from torch.profiler import ProfilerActivity, profile

    from zklisp_tpu_torch import workload
    from zklisp_tpu_torch.compiler import compile_entry
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zklisp_tpu_torch.prove import prover
    from zklisp_tpu_torch.prove.params import ProverOptions
    from zklisp_tpu_torch.utils import tracing

    src, _, _ = workload.rollup_source(65536 // 32)
    program = compile_entry(src, [])
    pi = PublicInputsBuilder(program).build()
    opts = ProverOptions(min_security_bits=0, blowup=16, grind=16,
                         queries=64)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {"done": 0, "t": time.time(), "warm_phases": {},
             "prof_phases": {}, "wall": 0.0, "warm_wall": 0.0}

    def on_steps(_steps):
        state["done"] += 1
        if state["done"] == args.warm:
            state["warm_phases"] = tracing.summary()
            tracing.reset()
            torch.cuda.synchronize()
            state["warm_wall"] = time.time() - state["t"]
            state["t"] = time.time()
            prof.start()
        elif state["done"] == args.warm + 1:
            torch.cuda.synchronize()
            state["wall"] = time.time() - state["t"]
            prof.stop()
            state["prof_phases"] = tracing.summary()
            return True
        elif state["done"] == args.warm - 1:
            tracing.reset()        # the last warm-up segment on its own
            state["t"] = time.time()
        return None

    if args.warm < 1:
        sys.exit("torch_segment_profile: --warm must be at least 1")
    if args.warm == 1:
        tracing.reset()
    prover.prove_program(program, pi, opts, on_steps=on_steps,
                         device=torch.device("cuda"))

    def dev_us(ev) -> float:
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(ev, name, None)
            if v is not None:
                return float(v)
        return 0.0

    # device-side events only: an operator's row repeats its kernels' time
    rows = [(ev.key, dev_us(ev), ev.count) for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    kern = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_s = sum(r[1] for r in kern) / 1e6
    # the hand-written kernels, by the names their sources give them
    # (poseidon12_team_kernel, digit_dot_tc_kernel<...>, ...)
    ported = {name: {"device_ms": round(sum(r[1] for r in kern
                                            if name in r[0]) / 1e3, 4),
                     "count": int(sum(r[2] for r in kern if name in r[0]))}
              for name in ("poseidon12", "digit_dot")}
    warm_wall = state["warm_wall"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "config": "earlier" if args.earlier else "default",
        "profiled_segment_wall_s": round(state["wall"], 4),
        "device_busy_s": round(busy_s, 4),
        "last_warm_segment_wall_s_no_profiler": round(warm_wall, 4),
        "device_idle_share_of_unprofiled_wall":
            round(1.0 - busy_s / warm_wall, 4),
        "kernel_launches": int(sum(r[2] for r in kern)),
        "ported_kernels": ported,
        "per_phase_s_profiled": {k: round(v, 4) for k, v
                                 in state["prof_phases"].items()},
        "top_kernels": [{"name": k[:90], "device_ms": round(us / 1e3, 3),
                         "count": int(c)} for k, us, c in kern[:args.top]]}),
          flush=True)
    print(json.dumps({
        "card": smi, "config": "earlier" if args.earlier else "default",
        "per_phase_s_last_warm_segment_no_profiler":
            {k: round(v, 4) for k, v in state["warm_phases"].items()}}),
          flush=True)


if __name__ == "__main__":
    main()
