"""Multi-process proving over torch.distributed (Gloo), counterpart of the
JAX package's parallel/multihost.py.

Segments are proved independently (the reference's parallel mode,
prove.rs:1018-1051), so several processes can share one program:

- `init_multihost` joins the process group: Gloo, with the coordinator
  `tcp://ZKL_COORD` and ZKL_NPROCS / ZKL_PROC_ID (or the arguments), or,
  with no coordinator, `env://` (torchrun's MASTER_ADDR / MASTER_PORT /
  RANK / WORLD_SIZE), the counterpart of JAX's auto-detection.
- `prove_program_multihost` plans the segments on every process (the
  same plan everywhere), gives each process one contiguous block of
  them, proves its block with the wave prover on the process's LOCAL
  mesh (`_local_mesh`: the cards it owns; no traffic between processes
  while proving), then exchanges the serialized StepProofs: two
  `all_gather`s, of the lengths and of one padded uint8 matrix
  (`_allgather_bytes`; the proof bytes are host bytes, as in JAX's
  `process_allgather`).  Every process returns the full segment-ordered
  list, byte-identical to one process's `prove_program_mesh`.
- Aggregation after the gather is host-side and deterministic
  (`prove_chain_multihost`): it can run on every process or on process 0
  only.

The trace is built again in every process (host work, seconds) instead of
being sent: witness bytes never leave a process, only proof bytes do.

`run_dryrun_multihost` starts N worker processes
(`python -m zklisp_tpu_torch.parallel.multihost`, `_worker_main`) on this
machine, Gloo on 127.0.0.1, and compares the gathered StepProofs with
this process's one-process run.  Workers may share one card.
"""

from __future__ import annotations

import json
import os
import struct
import time
from typing import List, Optional

import numpy as _np
import torch
import torch.distributed as dist

from ..compiler.builder import Program
from ..core import pi as pi_mod
from ..prove import planner
from ..prove.formats import StepProof
from ..prove.params import ProverOptions


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = 1800.0) -> None:
    """Join the Gloo process group: `tcp://<coordinator>` (host:port) from
    the arguments or ZKL_COORD / ZKL_NPROCS / ZKL_PROC_ID, else `env://`
    (torchrun's variables).  A process that does not hear from the
    others within `timeout_s` raises."""
    import datetime

    coordinator = coordinator or os.environ.get("ZKL_COORD")
    if num_processes is None and os.environ.get("ZKL_NPROCS"):
        num_processes = int(os.environ["ZKL_NPROCS"])
    if process_id is None and os.environ.get("ZKL_PROC_ID"):
        process_id = int(os.environ["ZKL_PROC_ID"])
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)


def _world() -> tuple:
    """(process count, this process's index); (1, 0) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _local_mesh(device=None):
    """This process's mesh: the cards it owns, or one CPU entry for
    `device="cpu"`.  With L processes on this host (LOCAL_WORLD_SIZE and
    LOCAL_RANK, which torchrun and `launch_workers` set), process r owns
    the r-th of L equal contiguous blocks of the visible cards, or card
    r mod count when there are fewer cards than processes (they then
    share it); a process alone on its host owns every visible card
    (`default_mesh`)."""
    from .mesh_prover import Mesh, default_mesh

    mesh = default_mesh(device=device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if mesh.devices[0].type != "cuda" or local <= 1:
        return mesh
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    per = mesh.size // local
    if per == 0:
        return Mesh([mesh.devices[rank % mesh.size]])
    return Mesh(mesh.devices[rank * per:(rank + 1) * per])


def _allgather(t: torch.Tensor) -> torch.Tensor:
    """all_gather of a CPU tensor: (processes,) + t.shape."""
    n, _ = _world()
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t)
    return torch.stack(out)


def _allgather_bytes(blobs: List[Optional[bytes]]) -> List[bytes]:
    """Exchange per-slot byte strings across processes.

    `blobs` has one slot per segment; each process fills only the slots
    it owns (None elsewhere).  Two all_gathers: the lengths (which also
    check that every slot has exactly one owner), then one padded uint8
    matrix.  Returns the fully populated slot list (the same on every
    process)."""
    n = len(blobs)
    lens = torch.tensor([len(b) if b is not None else -1 for b in blobs],
                        dtype=torch.int64)
    all_lens = _allgather(lens).numpy()                  # (nproc, n)
    owners = (all_lens >= 0).sum(axis=0)
    if not (owners == 1).all():
        bad = [i for i in range(n) if owners[i] != 1]
        raise RuntimeError(f"segment ownership not exclusive: {bad}")
    maxlen = int(all_lens.max())
    mat = _np.zeros((n, max(maxlen, 1)), dtype=_np.uint8)
    for i, b in enumerate(blobs):
        if b is not None:
            mat[i, :len(b)] = _np.frombuffer(b, dtype=_np.uint8)
    all_mat = _allgather(torch.from_numpy(mat)).numpy()  # (nproc, n, L)
    out: List[bytes] = []
    for i in range(n):
        p = int(_np.argmax(all_lens[:, i] >= 0))
        out.append(all_mat[p, i, :int(all_lens[p, i])].tobytes())
    return out


def contiguous_blocks(n_seg: int, nproc: int) -> List[range]:
    """Each process's contiguous block of the segments (the first
    n_seg % nproc processes take one more): a partition of
    range(n_seg) in order."""
    base, rem = divmod(n_seg, nproc)
    counts = [base + (1 if p < rem else 0) for p in range(nproc)]
    starts = [sum(counts[:p]) for p in range(nproc)]
    return [range(starts[p], starts[p] + counts[p]) for p in range(nproc)]


def prove_program_multihost(program: Program,
                            pub_inputs: pi_mod.PublicInputs,
                            opts: ProverOptions, wave: int = 0,
                            device=None, mesh=None) -> List[StepProof]:
    """prove_program across all processes of the process group.

    Each process proves its contiguous block of segments on its local
    mesh (`mesh`, default `_local_mesh(device)`) and the StepProofs are
    all-gathered; returns the full segment-ordered list on every
    process, byte-identical to one process's `prove_program_mesh`."""
    from .mesh_prover import prove_program_mesh

    nproc, pid = _world()
    if mesh is None:
        mesh = _local_mesh(device)
    if nproc == 1:
        return prove_program_mesh(program, pub_inputs, opts, mesh=mesh,
                                  wave=wave)

    n_seg = len(planner.plan_segments(program, pub_inputs, opts))
    # contiguous blocks (not strided): each process's share falls into as
    # few exec_key groups as possible, in boundary-chain order
    mine = contiguous_blocks(n_seg, nproc)[pid]
    local_steps: List[Optional[StepProof]] = [None] * n_seg
    if len(mine):
        # indices and segments_total in the zl1 containers stay global,
        # so the block's proofs are the same bytes as in a full run
        steps = prove_program_mesh(program, pub_inputs, opts, mesh=mesh,
                                   wave=wave, segment_subset=mine)
        for i, s in zip(mine, steps):
            local_steps[i] = s
    gathered = _allgather_bytes([s.to_bytes() if s is not None else None
                                 for s in local_steps])
    return [StepProof.from_bytes(b) for b in gathered]


def prove_chain_multihost(program, pub_inputs, opts: ProverOptions,
                          wave: int = 0, device=None, mesh=None,
                          on_steps=None):
    """Multi-process `prove_chain`: the steps proved across the processes,
    then the aggregation from the gathered steps on the local mesh's first
    device (deterministic, so the artifact is the same on every process; a
    caller typically writes it on process 0 only).  `on_steps` gets the
    gathered StepProofs before the aggregation."""
    if mesh is None:
        mesh = _local_mesh(device)
    steps = prove_program_multihost(program, pub_inputs, opts, wave=wave,
                                    mesh=mesh)
    if on_steps is not None:
        on_steps(steps)
    return aggregate_steps(steps, pub_inputs, opts, device=mesh.devices[0])


def aggregate_steps(steps: List[StepProof], pub_inputs, opts: ProverOptions,
                    device=None):
    """The aggregation of gathered steps, as `agg.prove_chain` makes it
    (its child batch on `device`): (proof, digest, public inputs)."""
    from ..agg import aggregate as agg

    agg_pi = agg.build_agg_public(steps)
    agg_pi.pi_digest = pub_inputs.digest()
    proof, digest = agg.recursion_prove(steps, agg_pi, opts, device=device)
    return proof, digest, agg_pi


def dryrun_config():
    """The multi-segment toy configuration that the dry run's workers and
    its one-process reference both prove (the JAX package's)."""
    from ..compiler import compile_entry
    from ..core.pi import PublicInputsBuilder, VmArg

    src = ("(def (main a b)\n"
           "  (loop :max 3 ((i 0) (x a) (y b))\n"
           "    x\n"
           "    (recur (+ i 1) y (+ x y))))\n")
    prog = compile_entry(src, [1, 1])
    pi = (PublicInputsBuilder(prog)
          .with_main_args([VmArg.u64(1), VmArg.u64(1)])
          .build())
    opts = ProverOptions(queries=2, blowup=8, grind=0,
                         min_security_bits=0, max_segment_rows=64)
    return prog, pi, opts


def encode_steps(steps: List[StepProof]) -> bytes:
    out = bytearray(struct.pack("<I", len(steps)))
    for s in steps:
        b = s.to_bytes()
        out += struct.pack("<Q", len(b))
        out += b
    return bytes(out)


def decode_steps(data: bytes) -> List[bytes]:
    n, = struct.unpack_from("<I", data, 0)
    off = 4
    out = []
    for _ in range(n):
        ln, = struct.unpack_from("<Q", data, off)
        off += 8
        out.append(data[off:off + ln])
        off += ln
    return out


def _program_config(args):
    """(program, public inputs, options) of the worker's `--program` file,
    read as the command line reads it (cli.py)."""
    from .. import cli
    from ..compiler import compile_entry

    with open(args.program) as f:
        src = f.read()
    public_vmargs, public_u64 = cli.parse_public_args(args.args)
    program = compile_entry(src, public_u64)
    pi = cli.build_pi_for_program(program, public_vmargs,
                                  cli.parse_secret_args(args.secrets))
    opts = ProverOptions(queries=args.queries, blowup=args.blowup,
                         grind=args.grind,
                         min_security_bits=args.security_bits,
                         max_segment_rows=args.max_segment_rows)
    return program, pi, opts


def _worker_main(argv: Optional[List[str]] = None) -> None:
    """One worker: join the process group, prove the program (the dry
    run's toy configuration, or `--program`) multi-process, and on
    process 0 write the gathered steps to --out; with `--artifact`
    through `prove_chain_multihost`, and process 0 writes the artifact
    too.  `--stats` gets this process's proving seconds, peak device
    memory and kernel launches, up to the gather."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m zklisp_tpu_torch.parallel.multihost")
    ap.add_argument("--coord", default=None,
                    help="host:port of process 0 (default: ZKL_COORD, "
                         "else torchrun's env://)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA cards this process owns; "
                         "'cpu' on the host")
    ap.add_argument("--mesh-size", type=int, default=1,
                    help="shards of the local mesh, all on the first "
                         "device it owns (1: the cards it owns)")
    ap.add_argument("--wave", type=int, default=0)
    ap.add_argument("--stats", default=None)
    ap.add_argument("--artifact", default=None,
                    help="every process aggregates the gathered steps "
                         "(prove_chain_multihost); process 0 writes the "
                         "ZKLRC1 artifact here")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--program", default=None)
    ap.add_argument("--arg", dest="args", action="append", default=[])
    ap.add_argument("--secret", dest="secrets", action="append", default=[])
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--blowup", type=int, default=16)
    ap.add_argument("--grind", type=int, default=16)
    ap.add_argument("--security-bits", type=int, default=0)
    ap.add_argument("--max-segment-rows", type=int, default=None)
    args = ap.parse_args(argv)

    from ..device import peak_bytes, resolve, sync
    from .mesh_prover import Mesh

    init_multihost(args.coord, args.nprocs, args.proc_id, args.timeout)
    if resolve(args.device).type == "cpu":
        # the workers of one host split its threads (its cores, or
        # OMP_NUM_THREADS): torch's threads spin, and N processes of a
        # thread per core each slow down many times
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // dist.get_world_size()))
    try:
        prog, pi, opts = (_program_config(args) if args.program
                          else dryrun_config())
        mesh = _local_mesh(args.device)
        if args.mesh_size > 1:
            mesh = Mesh([mesh.devices[0]] * args.mesh_size)
        launches = _kernel_launches()
        t0 = time.time()

        def gathered(steps):
            sync(mesh.devices)
            if args.stats:
                after = _kernel_launches()
                with open(args.stats, "w") as f:
                    json.dump({"process": dist.get_rank(),
                               "mesh": [str(d) for d in mesh.devices],
                               "seconds": time.time() - t0,
                               "peak_bytes": peak_bytes(mesh.devices),
                               "launches": {k: after[k] - launches[k]
                                            for k in after}}, f)
            if dist.get_rank() == 0:
                _write(args.out, encode_steps(steps))

        if args.artifact:
            from ..agg import aggregate as agg
            proof, _, agg_pi = prove_chain_multihost(
                prog, pi, opts, wave=args.wave, mesh=mesh,
                on_steps=gathered)
            if dist.get_rank() == 0:
                _write(args.artifact, agg.encode_artifact(proof, agg_pi))
        else:
            gathered(prove_program_multihost(prog, pi, opts,
                                             wave=args.wave, mesh=mesh))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _kernel_launches() -> dict:
    """The hand-written kernels' launch counts so far in this process."""
    from ..crypto import poseidon_cuda
    from ..field import digit_dot as dd
    return {"poseidon12": poseidon_cuda.permute12.launches,
            "digit_dot": dd.digit_dot.launches}


def launch_workers(n_procs: int = 2, worker_args=(), env=None,
                   timeout_s: float = 1800.0, work_dir=None):
    """Start `n_procs` worker processes on this machine (Gloo on
    127.0.0.1, a free port), wait for them, and return (the gathered
    StepProof bytes, each worker's `--stats` with its exit code, the wall
    seconds).  A worker that fails or outlives `timeout_s` makes this
    raise; every worker is gone when it returns."""
    import socket
    import subprocess
    import sys
    import tempfile

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix="zkl_mh_", dir=work_dir)
    out_path = os.path.join(tmp, "steps.bin")
    stats = [os.path.join(tmp, f"stats{p}.json") for p in range(n_procs)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [os.path.join(tmp, f"worker{p}.log") for p in range(n_procs)]
    procs = []
    t0 = time.time()
    try:
        for p in range(n_procs):
            with open(logs[p], "w") as log:
                # the workers share this host: each owns its block of
                # the cards, as under torchrun (`_local_mesh`)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "zklisp_tpu_torch.parallel.multihost",
                     "--coord", f"127.0.0.1:{port}",
                     "--nprocs", str(n_procs), "--proc-id", str(p),
                     "--out", out_path, "--stats", stats[p],
                     "--timeout", str(timeout_s), *worker_args],
                    env=dict(env, LOCAL_RANK=str(p),
                             LOCAL_WORLD_SIZE=str(n_procs)),
                    stdout=log, stderr=subprocess.STDOUT))
        # the first worker to fail ends the run: the others would wait
        # for it in the gather until their timeout
        pending = set(range(n_procs))
        while pending:
            for p in sorted(pending):
                rc = procs[p].poll()
                if rc is None:
                    continue
                pending.discard(p)
                if rc != 0:
                    with open(logs[p]) as f:
                        tail = f.read()[-3000:]
                    raise RuntimeError(f"multihost worker {p} rc={rc}: "
                                       f"{tail}")
            if pending and time.time() - t0 > timeout_s:
                raise RuntimeError(f"multihost worker(s) {sorted(pending)} "
                                   f"timed out after {timeout_s:.0f}s")
            time.sleep(0.1)
        wall = time.time() - t0
        with open(out_path, "rb") as f:
            gathered = decode_steps(f.read())
        worker_stats = []
        for path, proc in zip(stats, procs):
            with open(path) as f:
                worker_stats.append(dict(json.load(f),
                                         exit_code=proc.returncode))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in [out_path, *stats, *logs]:
            if os.path.exists(path):
                os.unlink(path)
        os.rmdir(tmp)
    return gathered, worker_stats, wall


def run_dryrun_multihost(n_procs: int = 2, devices_per_proc: int = 4,
                         timeout_s: Optional[float] = None,
                         device=None) -> List[bytes]:
    """Prove `dryrun_config` in `n_procs` worker processes, each on a
    mesh of `devices_per_proc` shards of `device` (default: the card),
    and compare the gathered StepProofs byte for byte with this
    process's one-process run on such a mesh; returns the gathered
    bytes.  The weakened hasher (ZKL_POSEIDON_HASHER_ROUNDS=4, unless
    set) applies to the workers and to the reference alike; this
    process's environment is left as it was."""
    from ..device import resolve
    from .mesh_prover import Mesh, prove_program_mesh

    if timeout_s is None:
        timeout_s = float(os.environ.get("ZKL_MH_DRYRUN_TIMEOUT", "2400"))
    rounds = os.environ.get("ZKL_POSEIDON_HASHER_ROUNDS", "4")
    dev = resolve(device)
    gathered, _, _ = launch_workers(
        n_procs, ["--device", str(dev), "--mesh-size",
                  str(devices_per_proc), "--wave", str(devices_per_proc)],
        env=dict(os.environ, ZKL_POSEIDON_HASHER_ROUNDS=rounds),
        timeout_s=timeout_s)
    prog, pi, opts = dryrun_config()
    before = os.environ.get("ZKL_POSEIDON_HASHER_ROUNDS")
    os.environ["ZKL_POSEIDON_HASHER_ROUNDS"] = rounds
    try:
        ref = prove_program_mesh(prog, pi, opts,
                                 mesh=Mesh([dev] * devices_per_proc),
                                 wave=devices_per_proc)
    finally:
        if before is None:
            del os.environ["ZKL_POSEIDON_HASHER_ROUNDS"]
        else:
            os.environ["ZKL_POSEIDON_HASHER_ROUNDS"] = before
    if not len(ref) == len(gathered) >= 2:
        raise RuntimeError(f"dry run: {len(gathered)} gathered steps, "
                           f"{len(ref)} from one process")
    for i, (r, g) in enumerate(zip(ref, gathered)):
        if r.to_bytes() != g:
            raise RuntimeError(f"multihost step {i} differs from "
                               f"single-process bytes")
    return gathered


if __name__ == "__main__":
    _worker_main()
