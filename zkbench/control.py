#!/usr/bin/env python3
"""The control of the benchmark's comparison: the prover run with one
guarantee of the configuration broken, judged by the same reference
against the configuration as stated.  It has to come out not correct.

    python3 zkbench/control.py --workload rollup-stf.16seg \
        --seeds 11,12,13 --set queries=32

`--set key=value` changes the configuration the prover is given (the
default, queries=32, is the step that would tempt a later change: half
the FRI queries, still above the 64-bit minimum); the reference keeps
the configuration's own values.  One process: set-up once, then job 0 of
each seed, each judged; one JSON line per seed with every number and its
limit, and a last line with the least reading of each number over the
seeds.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one job each")
    p.add_argument("--set", action="append", default=[],
                   help="key=value given to the prover instead (integer)")
    return p.parse_args(argv)


def main(argv=None, device=None, spec=None, out=None) -> int:
    out = out or sys.stdout
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from zkbench import run
    if device is None:
        run.fix_environment()
    import torch

    from zkbench.harness import job
    from zkbench.harness.spec import Spec
    from zkbench.programs.generate import Jobs
    from zkbench.reference import judge as ref

    spec = spec or Spec()
    cell = spec.cell(args.workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    if device is None:
        if not torch.cuda.is_available():
            print("the control runs on a CUDA card", file=sys.stderr)
            return 2
        device = "cuda:0"
    broken = dict(cfg)
    for kv in args.set or ["queries=32"]:
        key, value = kv.split("=", 1)
        broken[key] = int(value)
    stated = job.stated(cfg, traffic)
    limits = ref.limits(stated)
    least = {}
    with job.keep_steps() as kept:
        for seed in (int(s) for s in args.seeds.split(",")):
            jobs = Jobs(cfg, traffic, seed, job.op_count)
            try:
                done = job.run_job(jobs.job(0), job.options(broken), device,
                                   kept)
            except Exception as e:       # a crash is a failed control
                out.write(json.dumps({"seed": seed, "error": repr(e)})
                          + "\n")
                continue
            got = ref.judge(done.for_reference(), stated, device=device)
            fails = [k for k in limits if not ref.within(got[k],
                                                         *limits[k])]
            out.write(json.dumps({"seed": seed, "fails": fails,
                                  "numbers": got,
                                  "seconds": done.seconds}) + "\n")
            for k, v in got.items():
                least[k] = min(least.get(k, v), v)
    out.write(json.dumps({"control": args.set or ["queries=32"],
                          "least": least,
                          "limits": {k: list(v) for k, v in limits.items()}})
              + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
