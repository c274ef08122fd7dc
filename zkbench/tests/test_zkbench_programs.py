"""The seeded generator changes the data of a program and never its
shape: the same op count, trace rows and planned segments on every
seed, as the configuration's traffic asks."""

import json

import pytest

from zkbench.harness.spec import Spec
from zkbench.programs import generate

CELLS = [w for w in Spec().bench["workloads"]]


def _ops(source):
    from zklisp_tpu_torch.compiler import compile_entry
    return compile_entry(source, [])


@pytest.mark.parametrize("cell", CELLS, ids=[c["name"] for c in CELLS])
def test_seeds_keep_the_shape_and_change_the_data(cell):
    from zklisp_tpu_torch.core.pi import PublicInputsBuilder
    from zklisp_tpu_torch.prove import planner
    from zkbench.harness import job
    spec = Spec()
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    seeds = (0, 1, 2 ** 31 + 5, 6_000_000_017_123)
    sources, counts, segs = set(), set(), set()
    for seed in seeds:
        jobs = generate.Jobs(cfg, traffic, seed, job.op_count)
        for k in (-1, 0, 1):
            j = jobs.job(k)
            prog = _ops(j["source"])
            sources.add(j["source"])
            counts.add(len(prog.ops))
            assert generate.trace_rows(len(prog.ops)) == traffic["rows"]
            if k == 0:
                pi = PublicInputsBuilder(prog).build()
                assert pi.feature_mask == cfg["feature_mask"]
                segs.add(len(planner.plan_segments(prog, pi,
                                                   job.options(cfg))))
    assert len(counts) == 1
    assert segs == {traffic["rows"] // cfg["max_segment_rows"]}
    assert len(sources) == 3 * len(seeds)


def test_same_seed_same_inputs():
    cfg = json.loads(open(Spec().root / "zkbench/configs/rollup-stf.json")
                     .read())
    a = generate.draw(cfg["program"], 2 ** 40 + 3, 0)
    assert a == generate.draw(cfg["program"], 2 ** 40 + 3, 0)
    assert a != generate.draw(cfg["program"], 2 ** 40 + 3, 1)
    for name, item in cfg["program"]["data"].items():
        lo, hi = item["range"]
        assert lo <= a[name] < hi


def test_rollup_ranges_keep_every_debit_covered():
    cfg = Spec().config("rollup-stf")
    data = cfg["program"]["data"]
    worst_debit = (data["amount"]["range"][1] + data["fee"]["range"][1])
    assert data["balance"]["range"][0] > 512 * worst_debit


def test_calibration_matches_the_upstream_sizes():
    from zkbench.harness import job
    spec = Spec()
    expect = {("rollup-stf", 65536): 15, ("rollup-stf", 8192): 1,
              ("fib-alu", 65536): 292}
    for (name, rows), knob in expect.items():
        cfg = spec.config(name)
        text = generate.template(cfg["program"])
        assert generate.calibrate(cfg["program"], rows, job.op_count,
                                  text) == knob


def test_a_pattern_that_is_not_in_the_template_is_refused():
    prog = {"knob": {"pattern": "(def K {})", "frozen": 3}, "data": {}}
    with pytest.raises(generate.GenError):
        generate.render(prog, "(def N 3)", 4, {})
