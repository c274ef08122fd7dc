"""Multi-process proving of the port (zklisp_tpu_torch.parallel.multihost)
on the CPU: two real worker processes (`python -m
zklisp_tpu_torch.parallel.multihost`) join a Gloo process group on
127.0.0.1, each proves its contiguous block of a four-segment program
(128-row segments, queries 8, blowup 8, grind 0) on a local mesh of two
shards of the CPU (`--mesh-size 2`, as the JAX dry run's workers prove on
several virtual devices each), and the all-gathered
StepProofs must equal one process's byte for byte, and the last segment
(process 1's) the JAX host prover's (`prove_segment`, uniform mode, as on
its device paths).  As the JAX package's dry run does (4 rounds there),
the hasher is weakened, to one round (ZKL_POSEIDON_HASHER_ROUNDS), for
the workers and the references alike.  Also the byte exchange's ownership check, the
contiguous split, `encode_steps` and `dryrun_config` against the JAX
package's, a failing worker, and each process's own cards (`_local_mesh`)
under torchrun's `env://` with two cards simulated."""

import os
import socket
import subprocess
import sys
import threading

import pytest
import torch

from zklisp_tpu.compiler import compile_entry as j_compile_entry
from zklisp_tpu.core.pi import PublicInputsBuilder as JPIBuilder
from zklisp_tpu.core.pi import VmArg as JVmArg
from zklisp_tpu.parallel import multihost as j_mh
from zklisp_tpu.prove import planner as j_planner
from zklisp_tpu.prove import prover as j_prover
from zklisp_tpu.prove.params import ProverOptions as JProverOptions
from zklisp_tpu.trace import build as j_tb
from zklisp_tpu_torch.compiler import compile_entry as t_compile_entry
from zklisp_tpu_torch.core import pi as t_pi
from zklisp_tpu_torch.parallel import mesh_prover as t_mesh
from zklisp_tpu_torch.parallel import multihost as t_mh
from zklisp_tpu_torch.prove import params as t_params

# test_torch_wave.py's program as an entry point: four 128-row segments
SRC = """
(def (main)
  (let ((s (secret-arg 0)))
    (store 3 s)
    (store 4 (+ s 1))
    (+ (load 3) (load 4))))
"""
SECRET = 41
KW = dict(queries=8, blowup=8, grind=0, min_security_bits=0,
          max_segment_rows=128)
WORKER_ARGS = ["--secret", f"u64:{SECRET}", "--queries", "8", "--blowup",
               "8", "--grind", "0", "--security-bits", "0",
               "--max-segment-rows", "128"]
N_SEG = 4


@pytest.fixture(scope="module")
def one_round():
    mp = pytest.MonkeyPatch()
    mp.setenv("ZKL_POSEIDON_HASHER_ROUNDS", "1")
    for k in ("ZKL_WAVE", "ZKL_UNIFORM_SEGMENTS", "ZKL_MESH"):
        mp.delenv(k, raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def runs(one_round, tmp_path_factory):
    """The workers' gathered steps and stats, and meanwhile, in this
    process, the one-process wave and the JAX host proof of the last
    segment.  Every process takes one torch thread: the work is bound by
    Python's per-op cost, and spinning threads on a loaded host (tests
    side by side) slow every process many times over."""
    path = tmp_path_factory.mktemp("mh") / "program.zlisp"
    path.write_text(SRC)
    done = {}

    def workers():
        try:
            done["workers"] = t_mh.launch_workers(
                2, ["--device", "cpu", "--mesh-size", "2", "--program",
                    str(path), *WORKER_ARGS],
                env=dict(os.environ, OMP_NUM_THREADS="1"), timeout_s=600)
        except BaseException as e:                      # noqa: BLE001
            done["error"] = e

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    th = threading.Thread(target=workers)
    th.start()
    try:
        ref = _references()
    finally:
        th.join()
        torch.set_num_threads(threads)
    if "error" in done:
        raise done["error"]
    gathered, stats, _ = done["workers"]
    return dict(ref, gathered=gathered, stats=stats)


def _references():
    prog = t_compile_entry(SRC, [])
    pub = (t_pi.PublicInputsBuilder(prog)
           .with_secret_args([t_pi.VmArg.u64(SECRET)]).build())
    one = t_mesh.prove_program_mesh(prog, pub, t_params.ProverOptions(**KW),
                                    device="cpu")

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_prover, "_uniform_segments",
                   lambda in_mesh=False: True)
        j_prog = j_compile_entry(SRC, [])
        j_pub = (JPIBuilder(j_prog).with_secret_args([JVmArg.u64(SECRET)])
                 .build())
        opts = JProverOptions(**KW)
        segs = j_planner.plan_segments(j_prog, j_pub, opts)
        last, _ = j_prover.prove_segment(
            j_pub.program_id, j_tb.rom_acc_from_program(j_prog), N_SEG - 1,
            len(segs), segs[-1], j_tb.build_trace(j_prog, j_pub), j_prog,
            j_pub, opts.to_proof_options(), opts.min_security_bits, None)
    finally:
        mp.undo()
    return {"one": [s.to_bytes() for s in one], "jax_last": last.to_bytes()}


@pytest.mark.parametrize("i", range(N_SEG))
def test_gathered_steps_equal_one_process(runs, i):
    assert len(runs["gathered"]) == len(runs["one"]) == N_SEG
    assert runs["gathered"][i] == runs["one"][i]


def test_gathered_last_segment_equals_jax(runs):
    assert runs["gathered"][-1] == runs["jax_last"]


def test_each_worker_proved_on_its_own_mesh(runs):
    assert [s["process"] for s in runs["stats"]] == [0, 1]
    assert all(s["mesh"] == ["cpu", "cpu"] and s["seconds"] > 0
               for s in runs["stats"])


@pytest.mark.parametrize("cards,local,want", [
    (4, 2, [[0, 1], [2, 3]]), (1, 2, [[0], [0]]), (2, 1, [[0, 1]]),
    (3, 2, [[0], [1]])])
def test_local_mesh_gives_each_process_its_own_cards(monkeypatch, cards,
                                                     local, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    got = []
    for r in range(local):
        monkeypatch.setenv("LOCAL_RANK", str(r))
        got.append([d.index for d in t_mh._local_mesh().devices])
    assert got == want
    assert t_mh._local_mesh("cpu").devices == (torch.device("cpu"),)


_ENV_RANK = """
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 2
from zklisp_tpu_torch.parallel import multihost as mh
mh.init_multihost(timeout_s=60)
mine = [d.index for d in mh._local_mesh().devices]
every = mh._allgather(torch.tensor(mine)).tolist()
print(mh._world()[1], every)
mh.dist.destroy_process_group()
"""


def test_env_init_gives_each_rank_its_own_card():
    """torchrun's `env://` with two ranks on a host of two cards
    (simulated): each rank's mesh is its own card, and the gathered
    meshes are card 0 and card 1."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("ZKL_COORD", "ZKL_NPROCS", "ZKL_PROC_ID")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _ENV_RANK],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs == ["0 [[0], [1]]", "1 [[0], [1]]"]


def _simulated_gather(monkeypatch, per_process):
    """`_allgather` as if len(per_process) processes had each passed
    their own blobs: process p's tensor is built from per_process[p]."""
    import numpy as np
    import torch

    calls = [0]

    def fake(t):
        calls[0] += 1
        if calls[0] == 1:                                   # the lengths
            return torch.tensor([[len(b) if b is not None else -1
                                  for b in blobs]
                                 for blobs in per_process])
        L = t.shape[1]
        mats = []
        for blobs in per_process:
            m = np.zeros((len(blobs), L), np.uint8)
            for i, b in enumerate(blobs):
                if b is not None:
                    m[i, :len(b)] = np.frombuffer(b, np.uint8)
            mats.append(torch.from_numpy(m))
        return torch.stack(mats)

    monkeypatch.setattr(t_mh, "_allgather", fake)


def test_allgather_bytes_rejects_shared_ownership(monkeypatch):
    mine = [b"ab", None, b"c"]
    theirs = [None, b"xyz", None]
    _simulated_gather(monkeypatch, [mine, theirs])
    assert t_mh._allgather_bytes(mine) == [b"ab", b"xyz", b"c"]
    shared = [None, b"xyz", b"c"]
    _simulated_gather(monkeypatch, [mine, shared])
    with pytest.raises(RuntimeError, match=r"not exclusive: \[2\]"):
        t_mh._allgather_bytes(mine)
    nobody = [None, None, None]
    _simulated_gather(monkeypatch, [mine, nobody])
    with pytest.raises(RuntimeError, match=r"not exclusive: \[1\]"):
        t_mh._allgather_bytes(mine)


def test_contiguous_split_covers_every_segment():
    """Each process's block, for every (segments, processes), is the JAX
    package's contiguous block, and the blocks partition the segments in
    order."""
    for n_seg in (1, 2, 7, 16, 33):
        for nproc in (1, 2, 3, 8):
            blocks = t_mh.contiguous_blocks(n_seg, nproc)
            assert [i for b in blocks for i in b] == list(range(n_seg))
            base, rem = divmod(n_seg, nproc)
            counts = [base + (1 if p < rem else 0) for p in range(nproc)]
            assert [len(b) for b in blocks] == counts


def test_encode_steps_equals_jax():
    class Blob:
        def __init__(self, b):
            self._b = b

        def to_bytes(self):
            return self._b

    blobs = [b"", b"x", b"\x00" * 17, bytes(range(256))]
    got = t_mh.encode_steps([Blob(b) for b in blobs])
    assert got == j_mh.encode_steps([Blob(b) for b in blobs])
    assert t_mh.decode_steps(got) == j_mh.decode_steps(got) == blobs


def test_dryrun_config_equals_jax():
    t_prog, t_pi_, t_opts = t_mh.dryrun_config()
    j_prog, j_pi_, j_opts = j_mh.dryrun_config()
    assert t_prog.program_id == j_prog.program_id
    assert t_pi_.digest() == j_pi_.digest()
    assert (t_opts.queries, t_opts.blowup, t_opts.grind,
            t_opts.min_security_bits, t_opts.max_segment_rows) == (
        j_opts.queries, j_opts.blowup, j_opts.grind,
        j_opts.min_security_bits, j_opts.max_segment_rows)


def test_a_failing_worker_makes_the_caller_raise(tmp_path):
    with pytest.raises(RuntimeError, match="multihost worker . rc="):
        t_mh.launch_workers(2, ["--device", "cpu", "--program",
                                str(tmp_path / "missing.zlisp")],
                            timeout_s=120)
