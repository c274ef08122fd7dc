"""On a CUDA card: one short run of the smallest cell is correct, and the
control at that cell's size is not.  Skips without a card."""

import io
import json

import pytest

from zkbench import control, run


@pytest.mark.chip
def test_smallest_cell_on_the_card(cuda_card):
    out, err = io.StringIO(), io.StringIO()
    assert run.main(["--workload", "rollup-stf.2seg", "--seed",
                     str(2 ** 34 + 9), "--seconds", "0", "--trace", "0"],
                    out=out, err=err) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, err.getvalue()[-2000:]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.chip
def test_control_on_the_card(cuda_card):
    out = io.StringIO()
    assert control.main(["--workload", "rollup-stf.2seg", "--seeds",
                         str(2 ** 34 + 11)], out=out) == 0
    first = json.loads(out.getvalue().splitlines()[0])
    assert "params" in first["fails"]
