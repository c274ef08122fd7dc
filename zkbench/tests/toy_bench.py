"""A BENCHMARK.json of the tests' own: toy cells whose configuration and
traffic files live in zkbench/tests, found by name as the real ones."""

from pathlib import Path

TESTS = Path(__file__).resolve().parent

E2E = [{"name": "artifact_s", "unit": "s", "better": "lower", "bound": 0.1,
        "source": "host_clock"},
       {"name": "peak_device_gib", "unit": "GiB", "better": "lower",
        "bound": 0.01, "source": "host_clock"},
       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"}]


def bench(per_layer=()) -> dict:
    return {
        "command": ["python3", "zkbench/run.py"], "paths": ["zkbench"],
        "run_seconds": 1,
        "configs": [{"name": "toy-fib", "source": "test",
                     "file": "zkbench/tests/configs/toy-fib.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "toy-fib.2seg", "config": "toy-fib",
                       "traffic": "toy-512", "chips": 1, "why": "test"}],
        "end_to_end": E2E,
        "per_layer": list(per_layer)}


def spec(per_layer=()):
    from zkbench.harness.spec import Spec
    return Spec(bench(per_layer), dirs=(TESTS,))


def wrong_stage(monkeypatch, stage, when=lambda: True):
    """A wrong tensor stage in the wave, while `when()` holds, that still
    yields polynomials of the right degrees, so that the port proves on:
    the LDE reads its columns one row off (the polynomials and the
    extension of another trace), or the constraint composition comes out
    shifted by one point of its domain (another quotient than the
    AIR's)."""
    import torch

    from zklisp_tpu_torch.prove import stark_device as sd
    name = {"lde": "lde_columns", "composition": "quotient_comp"}[stage]
    orig = getattr(sd, name)

    def shifted(*args, **kwargs):
        if not when():
            return orig(*args, **kwargs)
        if stage == "lde":
            return orig(torch.roll(args[0], 1, dims=1), *args[1:], **kwargs)
        return torch.roll(orig(*args, **kwargs), 1, dims=1)
    monkeypatch.setattr(sd, name, shifted)
