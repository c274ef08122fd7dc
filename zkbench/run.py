#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA prover (zklisp_tpu_torch): seconds to
a verified ZKLRC1 artifact, with per-layer time.

    python3 zkbench/run.py --workload rollup-stf.16seg --seed 7 \
        --seconds 10 --trace 0

One run of one cell of BENCHMARK.json: set-up (imports, kernel build and
load, the step proofs of one warm-up job of the cell's shapes), then jobs
back to back for `--seconds` (the job in flight then finishes), then the
plain reference judges every job of the window.  The last line on standard
output is one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones, read
from the profiler's trace and the program's phases), device, breakdown
(--trace 1) and checks (each number compared, with its limit), which
also end standard error.  A run without as many CUDA cards as the cell
asks for, or that finds JAX or the JAX package loaded, prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "zklisp_tpu")
GIB = float(1 << 30)


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the
    time this module began to import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def fix_environment() -> None:
    """No ZKL_* switch of the program's: the cell runs as its file states.
    The port's only build is its two kernels, which nvcc compiles to
    sm_90a machine code (no PTX to JIT) into zklisp_tpu_torch/build/, a
    fixed directory inside the checkout; it uses no other kernel cache."""
    for var in [v for v in os.environ if v.startswith("ZKL_")]:
        del os.environ[var]


def forbidden_modules() -> list:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_info() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def judge_all(done: list, stated: dict, device) -> tuple:
    """(worst reading of each number over the jobs, jobs that fail a
    limit) by the plain reference."""
    from zkbench.reference import judge as ref
    limits = ref.limits(stated)
    worst, bad = {}, 0
    jobs = [d.for_reference() for d in done]
    openings = ref.check_openings(jobs, stated, device)
    for j, o in zip(jobs, openings):
        got = ref.judge(j, stated, o)
        bad += not all(ref.within(got[k], *limits[k]) for k in limits)
        for k, v in got.items():
            sense = limits[k][0]
            if k not in worst or (v > worst[k] if sense == "<=" else
                                  v < worst[k]):
                worst[k] = v
    return worst, bad, limits


def run_cell(spec, cell: dict, args, device, t_start: float, err) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from zklisp_tpu_torch.utils import tracing
    from zkbench.harness import devtrace, job
    from zkbench.harness.readings import Readings
    from zkbench.programs.generate import Jobs, trace_rows

    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if traffic.get("in_flight", 1) != 1 or traffic.get("loop") != "closed":
        raise ValueError("the harness drives a closed loop, 1 in flight")
    jobs = Jobs(cfg, traffic, args.seed, job.op_count)
    warm = jobs.job(-1)
    rows = trace_rows(job.op_count(warm["source"]))
    if rows != traffic["rows"]:
        raise ValueError(f"the program has {rows} rows, the traffic "
                         f"{traffic['rows']}")
    stated = job.stated(cfg, traffic)
    opts = job.options(cfg)
    on_card = torch.device(device).type == "cuda"

    metrics_mods = ([(m, spec.metric(m["name"]))
                     for m in spec.per_layer(cell["name"])]
                    if args.trace else [])
    ctx = Readings(spec=spec, cfg=cfg)
    with job.keep_steps() as kept:
        job.warm_up(warm, opts, device)
        prof = None
        if args.trace:
            for _, mod in metrics_mods:
                if hasattr(mod, "attach"):
                    mod.attach(ctx)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
        tracing.reset()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.time() - t_start
        with record_function(devtrace.WINDOW):
            done, window_s, error = job.closed_loop(
                jobs, opts, device, args.seconds, kept)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        phases = tracing.events()
        if prof is not None:
            prof.stop()
    if error is not None:
        err.write("".join(traceback.format_exception(error)))
    n = len(done)
    values = {"setup_s": setup_s}
    if n:
        values["artifact_s"] = window_s / n
        values["peak_device_gib"] = peak / GIB
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"metrics": {}, "device": device_info}
    if args.trace:
        ctx.jobs, ctx.segments = n, sum(len(d.steps) for d in done)
        ctx.chain = [d.chain for d in done]
        ctx.verify_s = [d.verify_s for d in done]
        ctx.phases = phases
        t0 = time.time()
        ctx.trace = devtrace.DeviceTrace.from_profile(prof)
        del prof
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.trace.top_gaps()}
        err.write(f"trace read in {time.time() - t0:.1f} s: "
                  f"{len(ctx.trace.ops)} device operations, "
                  f"{ctx.trace.launches} launch calls\n")
        for m, mod in metrics_mods:
            v = mod.read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.end_to_end(cell["name"]):
            if m["name"] in values:
                out["metrics"][m["name"]] = {"value": values[m["name"]],
                                             "unit": m["unit"]}
    t0 = time.time()
    worst, bad, limits = judge_all(done, stated, device)
    err.write(f"reference: {n} jobs judged in {time.time() - t0:.1f} s; "
              f"window {window_s:.3f} s; set-up {setup_s:.3f} s; jobs "
              + " ".join(f"{d.seconds:.3f}" for d in done) + "\n")
    out["correct"] = bool(n) and error is None and bad == 0
    out["attempted"] = n + (error is not None)
    out["failed"] = bad + (error is not None)
    out["checks"] = {k: [worst.get(k), *limits[k]] for k in limits}
    return out


def main(argv=None, device=None, spec=None, out=None, err=None) -> int:
    """One run.  `device` None: the first CUDA card, which has to be
    there; tests pass "cpu" and a Spec of their own."""
    t_start = process_start()
    out, err = out or sys.stdout, err or sys.stderr
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if device is None:
        fix_environment()
    from zkbench.harness.spec import Spec
    spec = spec or Spec()
    cell = spec.cell(args.workload)
    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            err.write(f"{args.workload} needs {cell['chips']} CUDA card(s);"
                      f" this machine has "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
            return 2
        device = "cuda:0"
    res = run_cell(spec, cell, args, device, t_start, err)
    found = forbidden_modules()
    if found:
        err.write("loaded in this process, which the benchmark forbids: "
                  + ", ".join(found) + "\n")
        return 3
    if res["device"]["platform"] == "gpu":
        err.write(f"card: {card_info()}\n")
    for k, (v, sense, lim) in res["checks"].items():
        ok = v is not None and (v <= lim if sense == "<=" else v >= lim)
        err.write(f"check {k} = {v} {sense} {lim}: "
                  f"{'ok' if ok else 'FAILS'}\n")
    err.flush()
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    out.write(json.dumps(line) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
