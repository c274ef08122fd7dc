"""Streamed traces in the port on the CPU, against the JAX package,
tolerance 0: `zklisp_tpu_torch.trace.stream.StreamedTrace` and the
streamed serial loop of `prove/prover.py` (ZKL_STREAM_TRACE, the
one-ahead upload prefetch).

Windows: the port's StreamedTrace equals the port's full trace sliced per
segment (every column, the boundaries, chained state hashes: the cases of
tests/test_stream.py) and the JAX package's StreamedTrace on the same
program (windows, boundaries, captures).

Proof bytes: tests/test_torch_agg.py's two-segment program (128-row
segments, queries 8, blowup 8, grind 0) through the port's
`agg.prove_chain(device="cpu")` and the JAX `prove_chain`, both under
ZKL_STREAM_TRACE=1, the JAX side with its `_uniform_segments` forced on
(the port's default): every StepProof and the ZKLRC1 artifact equal.  A
streamed segment's usage mask comes from its own rows, so the port's
full-trace bytes differ; the wave prover must not be reached.  Then the
same program with `max_concurrent_segments=2`.  A segment without sponge
ops in a program with the sponge feature: the port's streamed proof
verifies, the JAX package's does not (`prover.streamed_usage`).

The choice of trace source (`prover.stream_mode`) at 2^19 - 1 and 2^19
rows, and the serial loop's prefetch (at most two windows alive, each
segment given its own staged limbs, an early stop leaves no worker) with
the segment prover replaced by a stub that only chains the state hashes.
"""

import dataclasses
import threading

import numpy as np
import pytest

from zklisp_tpu.agg import aggregate as j_agg
from zklisp_tpu.compiler import compile_entry as j_compile_entry
from zklisp_tpu.compiler import compile_str as j_compile_str
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.prove import planner as j_planner
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove import stark as j_stark
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu.trace.stream import StreamedTrace as JStreamedTrace
from zklisp_tpu_torch.agg import aggregate as t_agg
from zklisp_tpu_torch.air.airpi import (build_air_pi_for_trace,
                                        compute_vm_usage_mask,
                                        segment_boundaries_from_full)
from zklisp_tpu_torch.air.zk_air import ZkLispAir
from zklisp_tpu_torch.compiler import compile_entry as t_compile_entry
from zklisp_tpu_torch.compiler import compile_str as t_compile_str
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.prove import params as t_params
from zklisp_tpu_torch.prove import planner as t_planner
from zklisp_tpu_torch.prove import prover as t_prover
from zklisp_tpu_torch.prove import stark_device as sd
from zklisp_tpu_torch.trace import build as t_tb
from zklisp_tpu_torch.trace.layout import VM_USAGE_SPONGE, Columns
from zklisp_tpu_torch.trace.stream import StreamedTrace

# tests/test_stream.py's programs
RAM_SPONGE_SRC = """
(def (main a)
  (begin
    (store 1 a)
    (store 2 (safe-add (load 1) 5))
    (push (load 2))
    (loop :max 30 ((i 0) (x a))
      (begin (store 3 x) x)
      (recur (+ i 1) (hash2 x (load 3))))
    (pop)))
"""
MERKLE_SRC = """
(def (main)
  (let ((leaf 5))
    (merkle-verify leaf ((0 11) (1 22)))))
"""
WINDOW_CASES = {"ram_sponge": (RAM_SPONGE_SRC, [7], 1024),
                "merkle": (MERKLE_SRC, [], 128)}

# tests/test_torch_agg.py's program: segment 0 uses RAM, segment 1 not
SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (+ (load 3) 1)))
(main)
"""
SECRET = 41
KW = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
          max_segment_rows=128)


def _window_programs(case):
    src, args, rows = WINDOW_CASES[case]
    t_prog = t_compile_entry(src, args)
    t_pub = (t_pi.PublicInputsBuilder(t_prog)
             .with_main_args([t_pi.VmArg.u64(a) for a in args]).build())
    j_prog = j_compile_entry(src, args)
    j_pub = (JPIBuilder(j_prog)
             .with_main_args([JVmArg.u64(a) for a in args]).build())
    kw = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
              max_segment_rows=rows)
    t_segs = t_planner.plan_segments(t_prog, t_pub,
                                     t_params.ProverOptions(**kw))
    j_segs = j_planner.plan_segments(j_prog, j_pub, JProverOptions(**kw))
    assert len(t_segs) > 1, "the case needs several segments"
    return (t_prog, t_pub, t_segs), (j_prog, j_pub, j_segs)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windows_equal_full_trace(case):
    (prog, pub, segs), _ = _window_programs(case)
    full = t_tb.build_trace(prog, pub)
    strm = StreamedTrace(prog, pub, segs)
    ident = list(range(Columns.baseline().width()))
    for seg in segs:
        want = full.slice_rows(seg.r_start, seg.r_end, ident)
        got = strm.segment_table(seg)
        assert got.cols == want.cols, f"segment {seg} differs"
        assert (strm.boundaries(seg)
                == segment_boundaries_from_full(full, seg))


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windows_equal_jax(case):
    (t_prog, t_pub, t_segs), (j_prog, j_pub, j_segs) = \
        _window_programs(case)
    assert [(s.r_start, s.r_end) for s in t_segs] \
        == [(s.r_start, s.r_end) for s in j_segs]
    t_strm = StreamedTrace(t_prog, t_pub, t_segs)
    j_strm = JStreamedTrace(j_prog, j_pub, j_segs)
    assert sorted(t_strm.captures) == sorted(j_strm.captures)
    for lvl, st in t_strm.captures.items():
        jst = j_strm.captures[lvl]
        for k in ("regs", "pending_regs", "merkle_acc", "mem",
                  "events_len"):
            assert getattr(st, k) == getattr(jst, k), (lvl, k)
    assert t_strm.events == j_strm.events
    for t_seg, j_seg in zip(t_segs, j_segs):
        assert (t_strm.segment_table(t_seg).cols
                == j_strm.segment_table(j_seg).cols)
        assert (dataclasses.astuple(t_strm.boundaries(t_seg))
                == dataclasses.astuple(j_strm.boundaries(j_seg)))


def test_window_state_hashes_chain():
    """State hashes of streamed windows chain across segments and equal
    the full trace's."""
    (prog, pub, segs), _ = _window_programs("ram_sponge")
    full = t_tb.build_trace(prog, pub)
    strm = StreamedTrace(prog, pub, segs)
    prev = None
    for seg in segs:
        _, layout = t_prover._segment_layout(prog, pub, seg)
        _, s_in, s_out = t_tb.segment_from_window(strm.segment_table(seg),
                                                  layout, prev)
        _, f_in, f_out = t_tb.build_segment_trace_with_state(full, seg,
                                                             layout)
        assert (s_in, s_out) == (f_in, f_out)
        prev = t_tb.PrevState(s_out)


@pytest.mark.parametrize("env", ["1", "0", None])
@pytest.mark.parametrize("rows", [(1 << 19) - 1, 1 << 19])
def test_stream_mode_choice(monkeypatch, env, rows):
    if env is None:
        monkeypatch.delenv("ZKL_STREAM_TRACE", raising=False)
    else:
        monkeypatch.setenv("ZKL_STREAM_TRACE", env)
    want = env == "1" or (env is None and rows >= 1 << 19)
    assert t_prover.stream_mode(rows) is want


def test_sorted_ram_chain_breaks_where_an_event_ends_a_segment():
    """An open fault of both packages (ROADMAP.md §3): a segment's
    ram_gp_sorted_out is the sorted grand product at its last row, so a
    sorted RAM event on that row (a level's last pad row) enters the next
    segment's ram_gp_sorted_in and no segment's out.  The chain the
    aggregation checks breaks there, and its proof cannot verify (the
    2^19-row rollup-bench, `chip_smoke.py --stream-all`).  RAM_SPONGE_SRC
    at 128-row segments: both packages give the same boundaries, and the
    chain breaks exactly after the segments that end on a sorted event."""
    (t_prog, t_pub, _), (j_prog, j_pub, _) = _window_programs("ram_sponge")
    t_segs = t_planner.plan_segments(t_prog, t_pub,
                                     t_params.ProverOptions(**KW))
    j_segs = j_planner.plan_segments(j_prog, j_pub, JProverOptions(**KW))
    t_strm = StreamedTrace(t_prog, t_pub, t_segs)
    j_strm = JStreamedTrace(j_prog, j_pub, j_segs)
    bounds = [t_strm.boundaries(s) for s in t_segs]
    assert ([dataclasses.astuple(b) for b in bounds]
            == [dataclasses.astuple(j_strm.boundaries(s)) for s in j_segs])
    event_rows = set(t_strm.event_rows)
    breaks = [i for i in range(1, len(t_segs))
              if bounds[i].ram_gp_sorted_in != bounds[i - 1].ram_gp_sorted_out]
    assert breaks
    assert breaks == [i for i in range(1, len(t_segs))
                      if t_segs[i].r_start - 1 in event_rows]


# ---------------------------------------------------------------------------
# proof bytes
# ---------------------------------------------------------------------------

def _record_steps(mp, prover_mod):
    seen = []
    real = prover_mod.prove_program

    def wrapped(*a, **k):
        steps = real(*a, **k)
        seen.extend(steps)
        return steps

    mp.setattr(prover_mod, "prove_program", wrapped)
    return seen


def _port_program():
    prog = t_compile_str(SRC)
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    return prog, pub


def _no_wave(*a, **k):
    raise AssertionError("a streamed program reached the wave prover")


@pytest.fixture(scope="module")
def chains():
    """The port's and the JAX package's streamed chains (uniform segments)
    and the segment_table calls the port's serial loop made."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("ZKL_STREAM_TRACE", "1")
        mp.delenv("ZKL_WAVE", raising=False)
        mp.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
        mp.setattr(t_mesh, "prove_program_mesh", _no_wave)
        windows = []
        real_table = StreamedTrace.segment_table

        def counted(self, seg):
            windows.append(seg)
            return real_table(self, seg)

        mp.setattr(StreamedTrace, "segment_table", counted)
        t_prog, t_pub = _port_program()
        t_steps = _record_steps(mp, t_prover)
        t_chain = t_agg.prove_chain(t_prog, t_pub,
                                    t_params.ProverOptions(**KW),
                                    device="cpu")

        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        j_prog = j_compile_str(SRC)
        j_pub = (JPIBuilder(j_prog)
                 .with_secret_args([JVmArg.u64(SECRET)]).build())
        j_steps = _record_steps(mp, j_prover)
        j_chain = j_agg.prove_chain(j_prog, j_pub, JProverOptions(**KW))
    finally:
        mp.undo()
    return {"t": t_chain, "j": j_chain, "t_steps": t_steps,
            "j_steps": j_steps, "windows": windows}


@pytest.mark.parametrize("i", [0, 1])
def test_streamed_step_bytes_equal_jax(chains, i):
    assert len(chains["t_steps"]) == len(chains["j_steps"]) == 2
    assert (chains["t_steps"][i].to_bytes()
            == chains["j_steps"][i].to_bytes())


def test_streamed_artifact_bytes_equal_jax(chains):
    t_proof, t_digest, t_pi_ = chains["t"]
    j_proof, j_digest, j_pi_ = chains["j"]
    assert t_digest == j_digest
    assert (t_agg.encode_artifact(t_proof, t_pi_)
            == j_agg.encode_artifact(j_proof, j_pi_))
    t_agg.verify_agg(*t_agg.decode_artifact(
        t_agg.encode_artifact(t_proof, t_pi_)))


def test_streamed_usage_masks_are_per_segment(chains):
    """At least one segment's usage differs from the full trace's, which
    is what the full-trace path would have put in every StepProof."""
    prog, pub = _port_program()
    full_usage = compute_vm_usage_mask(t_tb.build_trace(prog, pub),
                                       Columns.baseline())
    usages = [(s.vm_usage_mask, s.ram_delta_clk_bits)
              for s in chains["t_steps"]]
    assert any(u != full_usage for u in usages)


def test_streamed_loop_builds_each_window_once(chains):
    assert [(s.r_start, s.r_end) for s in chains["windows"]] \
        == [(0, 128), (128, 256)]


def test_concurrent_streamed_segments_equal_serial(chains, monkeypatch):
    """max_concurrent_segments=2 on a streamed program: the serial loop's
    StepProofs (and so the JAX package's)."""
    monkeypatch.setenv("ZKL_STREAM_TRACE", "1")
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    monkeypatch.setattr(t_mesh, "prove_program_mesh", _no_wave)
    prog, pub = _port_program()
    steps = t_prover.prove_program(
        prog, pub, t_params.ProverOptions(max_concurrent_segments=2, **KW),
        device="cpu")
    assert [s.to_bytes() for s in steps] \
        == [s.to_bytes() for s in chains["j_steps"]]


def test_sponge_free_streamed_segment_verifies(monkeypatch):
    """RAM_SPONGE_SRC's first segment has no sponge op, but the program's
    feature mask keeps the sponge.  Streamed in uniform mode, the port
    proves it with the sponge usage bit set (`prover.streamed_usage`) and
    `verify_step` accepts it.  The JAX package's proof of the same segment
    (its `_uniform_segments` forced on, as on its devices) keeps the
    segment's own usage, and its own `verify_step` rejects it: the
    verifier recovers the sponge feature from that bit."""
    monkeypatch.delenv("ZKL_UNIFORM_SEGMENTS", raising=False)
    monkeypatch.setattr(j_prover, "_uniform_segments",
                        lambda in_mesh=False: True)
    (t_prog, t_pub, _), (j_prog, j_pub, _) = _window_programs("ram_sponge")
    kw = dict(KW, max_segment_rows=64)
    steps = {}
    for name, prog, pub, mod, stream_cls, plan, opts, extra in (
            ("port", t_prog, t_pub, t_prover, StreamedTrace, t_planner,
             t_params.ProverOptions(**kw), {"device": "cpu"}),
            ("jax", j_prog, j_pub, j_prover, JStreamedTrace, j_planner,
             JProverOptions(**kw), {})):
        segs = plan.plan_segments(prog, pub, opts)
        rom_acc = (mod.tb.rom_acc_from_program(prog)
                   if any(pub.program_id) else (0, 0, 0))
        steps[name], _ = mod.prove_segment(
            pub.program_id, rom_acc, 0, len(segs), segs[0],
            stream_cls(prog, pub, segs), prog, pub,
            opts.to_proof_options(), 0, None, **extra)
    sponge = 1 << VM_USAGE_SPONGE
    assert steps["port"].vm_usage_mask & sponge
    assert not steps["jax"].vm_usage_mask & sponge
    assert (steps["port"].vm_usage_mask & ~sponge
            == steps["jax"].vm_usage_mask)
    t_prover.verify_step(steps["port"])
    with pytest.raises(j_stark.VerifyError):
        j_prover.verify_step(steps["jax"])


def test_cvm_record_cache_keys_on_features(monkeypatch):
    """`stark_device._record_cvm` caches the recorded constraints per AIR.
    Two AIRs of RAM_SPONGE_SRC's first segment with one width and one set
    of public elements, but the program's feature mask (uniform mode) and
    the segment's own (ZKL_UNIFORM_SEGMENTS=0), must not share an entry:
    one run may prove both (chip_smoke.py's phase `stream`)."""
    (prog, pub, _), _ = _window_programs("ram_sponge")
    seg = t_planner.plan_segments(prog, pub,
                                  t_params.ProverOptions(**KW))[0]
    full = t_tb.build_trace(prog, pub)
    airs = []
    for uniform in ("1", "0"):
        monkeypatch.setenv("ZKL_UNIFORM_SEGMENTS", uniform)
        eff, layout = t_prover._segment_layout(prog, pub, seg)
        trace, _, _ = t_tb.build_segment_trace_with_state(full, seg, layout)
        air_pi = build_air_pi_for_trace(
            pub, eff, (0, 0, 0), layout.cols,
            segment_boundaries_from_full(full, seg), trace)
        airs.append(ZkLispAir(trace.width, trace.length, air_pi))
    assert airs[0].trace_width == airs[1].trace_width
    assert airs[0].pub.to_elements() == airs[1].pub.to_elements()
    assert airs[0].features != airs[1].features
    n_periodic = len(airs[0].periodic_lde_period(2)) + 1

    def recorded(air):
        prog_cvm, specs = sd._record_cvm(air, n_periodic)
        return prog_cvm.n_instr, specs

    monkeypatch.setattr(sd, "_STAGE_CACHE", {})
    shared = [recorded(a) for a in airs]
    monkeypatch.setattr(sd, "_STAGE_CACHE", {})
    assert shared[1] == recorded(airs[1])
    assert shared[0] != shared[1]


# ---------------------------------------------------------------------------
# the prefetch, with a stub segment prover
# ---------------------------------------------------------------------------

def _stub_run(monkeypatch, stop_at=None):
    """The streamed serial loop over RAM_SPONGE_SRC's 128-row segments
    with `prove_segment` replaced by a stub that checks its staged limbs
    and chains the state hashes.  Returns (segments, steps, the number of
    windows not yet finished at each segment_table call, pool threads
    alive after the return that were not before)."""
    monkeypatch.setenv("ZKL_STREAM_TRACE", "1")
    prog = t_compile_entry(RAM_SPONGE_SRC, [7])
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_main_args([t_pi.VmArg.u64(7)]).build())
    opts = t_params.ProverOptions(**KW)
    segs = t_planner.plan_segments(prog, pub, opts)
    finished = [0]
    ahead = []
    real_table = StreamedTrace.segment_table

    def counted(self, seg):
        ahead.append(len(ahead) + 1 - finished[0])
        return real_table(self, seg)

    def stub(suite_id, rom_acc, i, n_seg, seg, full_trace, program,
             pub_inputs, base_opts, min_bits, prev_state, device=None,
             staged=None, window=None):
        assert window is not None and staged is not None
        _, layout = t_prover._segment_layout(program, pub_inputs, seg)
        trace, _, s_out = t_tb.segment_from_window(window, layout,
                                                   prev_state)
        assert np.array_equal(staged.wait()[0].numpy(),
                              trace.to_limbs16())
        finished[0] += 1
        return ("step", i), s_out

    monkeypatch.setattr(StreamedTrace, "segment_table", counted)
    monkeypatch.setattr(t_prover, "prove_segment", stub)
    before = set(threading.enumerate())
    steps = t_prover.prove_program(
        prog, pub, opts, device="cpu",
        on_steps=(None if stop_at is None
                  else lambda batch: batch[0][1] == stop_at))
    extra = [t for t in set(threading.enumerate()) - before
             if t.is_alive()]
    return segs, steps, ahead, extra


def test_prefetch_keeps_at_most_two_windows(monkeypatch):
    segs, steps, ahead, extra = _stub_run(monkeypatch)
    assert len(segs) >= 4
    assert steps == [("step", i) for i in range(len(segs))]
    assert len(ahead) == len(segs)
    assert max(ahead) <= 2
    assert not extra


def test_early_stop_leaves_no_worker(monkeypatch):
    segs, steps, ahead, extra = _stub_run(monkeypatch, stop_at=1)
    assert steps == [("step", 0), ("step", 1)]
    assert len(ahead) <= 3 < len(segs)
    assert not extra
