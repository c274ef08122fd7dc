"""The port's command line on the CPU: `python -m zklisp_tpu_torch.cli
prove --device cpu` and `verify` on examples/hello-zk.zlisp at weak
options (queries 8, blowup 8, grind 0, no security floor), run
in-process.

The artifact is proved once, with ZKL_UNIFORM_SEGMENTS=0 (per-segment
masks, as the JAX package's host path proves):

  * it equals, byte for byte, the JAX package's CLI artifact
  * verify (on the host, without --device): {"ok": true}; a wrong --arg:
    pi_digest mismatch; a flipped artifact byte: {"ok": false}
  * without --device and without a card, prove raises RuntimeError
  * the REPL passes its device to :prove
"""

import contextlib
import io
import json
import os

import pytest
import torch

from zklisp_tpu import cli as j_cli
from zklisp_tpu_torch import cli as t_cli
from zklisp_tpu_torch.repl import ReplSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELLO = os.path.join(ROOT, "examples", "hello-zk.zlisp")
ARGS = ["--arg", "u64:2", "--arg", "u64:5"]
WEAK = ["--queries", "8", "--blowup", "8", "--grind", "0",
        "--security-bits", "0"]


def _run(main, argv):
    """(exit code, last stdout line as JSON) of one CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--json"])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _prove(main, out, device=True):
    argv = (["prove", HELLO] + ARGS + ["--secret", "u64:3"] + WEAK
            + ["--out", str(out)] + (["--device", "cpu"] if device else []))
    return _run(main, argv)


def _verify(path, args=ARGS):
    return _run(t_cli.main, ["verify", str(path), HELLO] + args + WEAK)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "hello.bin"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKL_UNIFORM_SEGMENTS", "0")
        rc, out = _prove(t_cli.main, path)
    assert rc == 0 and out["ok"], out
    assert out["agg_proof_bytes"] == path.stat().st_size
    return path


def test_artifact_equals_jax_cli(artifact, tmp_path, monkeypatch):
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    theirs = tmp_path / "jax.bin"
    assert _prove(j_cli.main, theirs, device=False)[0] == 0
    assert artifact.read_bytes() == theirs.read_bytes()


def test_prove_then_verify(artifact):
    rc, out = _verify(artifact)
    assert rc == 0 and out["ok"] is True


def test_wrong_public_arg_is_rejected(artifact):
    rc, out = _verify(artifact, ["--arg", "u64:2", "--arg", "u64:6"])
    assert rc == 1 and out["ok"] is False
    assert "pi_digest mismatch" in out["error"]


def test_flipped_artifact_byte_is_rejected(artifact, tmp_path):
    blob = bytearray(artifact.read_bytes())
    blob[len(blob) - 40] ^= 1
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(blob))
    rc, out = _verify(bad)
    assert rc == 1 and out["ok"] is False


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        _prove(t_cli.main, tmp_path / "x.bin", device=False)
    with pytest.raises(RuntimeError):
        ReplSession().handle(":prove (+ 1 2)", out=io.StringIO())


def test_repl_evaluates_on_the_host():
    s = ReplSession(device="cpu")
    out = io.StringIO()
    s.handle("(def (sq x) (* x x))", out=out)
    s.handle("(sq 7)", out=out)
    assert out.getvalue().split() == ["ok", "49"]
