"""The batched child re-verification (`agg/child_batch.child_work_batch`)
on the CPU: the port's torch code (what runs on the card, here on
`device="cpu"`: plain PyTorch limb ops and Poseidon) against the JAX
package's, value for value (tolerance 0).

The children are the two StepProofs of a two-segment chain proved by the
JAX package's host prover in uniform-segment mode, as the port proves
them (queries 8, blowup 8, grind 0).  They are carried into the port
through their bytes; each package replays its own Fiat-Shamir
challenges and groups the children by shape (a batch takes one group;
the port's groups ignore the FRI layers' counts of distinct folded
positions, so they may be coarser than the JAX package's)."""

import dataclasses

import pytest
import torch

from zklisp_tpu.agg import aggregate as j_agg
from zklisp_tpu.agg import child_batch as j_cb
from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder, VmArg
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove.params import ProverOptions
from zklisp_tpu_torch.agg import aggregate as t_agg
from zklisp_tpu_torch.agg import child_batch as t_cb
from zklisp_tpu_torch.prove import formats as t_formats

SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (+ (load 3) 1)))
(main)
"""
OPTS = ProverOptions(queries=8, blowup=8, grind=0, min_security_bits=0,
                     max_segment_rows=128)


@pytest.fixture(scope="module")
def bundle():
    prog = j_compile_str(SRC)
    pub = PublicInputsBuilder(prog).with_secret_args([VmArg.u64(41)]).build()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        j_steps = j_prover.prove_program(prog, pub, OPTS)
    t_steps = [t_formats.StepProof.from_bytes(s.to_bytes())
               for s in j_steps]
    j_pi = j_agg.build_agg_public(j_steps)
    t_pi = t_agg.build_agg_public(t_steps)
    weights = t_agg.derive_agg_fs_weights(t_pi)
    assert weights == j_agg.derive_agg_fs_weights(j_pi)
    j_chs = [j_agg._child_challenges(s) for s in j_steps]
    t_chs = [t_agg._child_challenges(s) for s in t_steps]
    want = _by_group(j_cb.child_work_batch,
                     j_cb.group_children(j_steps, j_chs), j_steps, j_chs,
                     weights)
    return t_steps, t_chs, weights, want


def _by_group(batch_fn, groups, steps, chs, weights, **kw):
    """child_work_batch over each shape group; values in child order."""
    out = [None] * len(steps)
    for idxs in groups:
        vals = batch_fn([steps[i] for i in idxs], [chs[i] for i in idxs],
                        *weights, **kw)
        for i, v in zip(idxs, vals):
            out[i] = v
    return out


def _plain(ch: dict) -> dict:
    """A challenge dict with its assertion groups as tuples (the two
    packages' AssertionGroup classes never compare equal)."""
    out = dict(ch)
    out["groups"] = [dataclasses.astuple(g) for g in ch["groups"]]
    return out


def test_challenges_equal_jax(bundle):
    t_steps, t_chs, _, _ = bundle
    for t_ch, s in zip(t_chs, t_steps):
        j_ch = j_agg._child_challenges(
            j_prover.StepProof.from_bytes(s.to_bytes()))
        assert _plain(t_ch) == _plain(j_ch)


@pytest.mark.parametrize("device", ["cpu"], ids=["torch-cpu"])
def test_batch_equals_jax(bundle, device):
    t_steps, t_chs, weights, want = bundle
    got = _by_group(t_cb.child_work_batch,
                    t_cb.group_children(t_steps, t_chs), t_steps, t_chs,
                    weights, device=device)
    assert len(got) == 2 and got == want
    # an honest chain re-verifies with every error column zero
    for v in got:
        assert v["t_err"] == 0 and v["c_err"] == 0 and v["deep"] == 0


def test_one_batch_equals_one_child_batches(bundle):
    """Both children go into one batch, whose values equal those of each
    child batched alone (the layers' fold counts differ between them)."""
    t_steps, t_chs, weights, want = bundle
    assert t_cb.group_children(t_steps, t_chs) == [[0, 1]]
    pairs = [[len(lo.pairs) for lo in s.proof.inner.fri_openings]
             for s in t_steps]
    assert pairs[0] != pairs[1]
    alone = _by_group(t_cb.child_work_batch, [[0], [1]], t_steps, t_chs,
                      weights, device="cpu")
    assert alone == want


def test_torch_backend_on_cpu_tensors(bundle):
    """The batch math runs on torch tensors on the given device."""
    x = t_cb._to_dev(t_cb.limb.from_ints([3, 5]), torch.device("cpu"))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert [int(v) for v in t_cb._to_ints(t_cb.tl.mul(x, x))] == [9, 25]


def test_agg_device_without_a_card_raises(bundle):
    """The aggregation's child batch runs on its device (default: the
    card); without a card it raises and never carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    t_steps, t_chs, _, _ = bundle
    with pytest.raises(RuntimeError):
        t_agg.build_agg_trace(t_agg.build_agg_public(t_steps), t_steps,
                              chs=t_chs)
