"""Command-line interface: run | prove | verify | repl.

Mirrors the reference CLI surface (zk-lisp-cli): typed argument syntax
`u64:`/`u128:`/`bytes32:0x...`, schema validation of main args, JSON
output, security-bits gating, and the ZKLRC1 aggregation artifact flow.

    python -m zklisp_tpu_torch.cli prove PROGRAM --arg u64:2 ... --out A.bin
    python -m zklisp_tpu_torch.cli verify A.bin PROGRAM --arg u64:2 ...

`prove` and `repl` take `--device` (default: the CUDA card, and an error
when there is none; `--device cpu` runs on the host).  `verify` runs on
the host, with or without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

from . import frontend
from .agg import aggregate as agg
from .agg.aggregate import AggError
from .compiler import CompileError, compile_entry
from .core.pi import PublicInputs, PublicInputsBuilder, VmArg
from .prove.params import ProverOptions
from .prove.prover import ProveError
from .prove.stark import VerifyError

MAX_BYTES_DEFAULT = 1 << 20


class CliError(Exception):
    pass


def parse_vm_arg(raw: str) -> VmArg:
    if raw.startswith("u64:"):
        return VmArg.u64(int(raw[4:], 0))
    if raw.startswith("u128:"):
        return VmArg.u128(int(raw[5:], 0))
    if raw.startswith("bytes32:"):
        h = raw[len("bytes32:"):]
        h = h[2:] if h.startswith("0x") else h
        b = bytes.fromhex(h)
        if len(b) > 32:
            raise CliError("bytes32 arg too long")
        return VmArg.bytes32(b + b"\x00" * (32 - len(b)))
    # bare integers are u64
    return VmArg.u64(int(raw, 0))


def parse_public_args(raws: List[str]) -> Tuple[List[VmArg], List[int]]:
    """(vmargs, u64 projections) — cli/main.rs parse_public_args."""
    vmargs, u64s = [], []
    for raw in raws:
        arg = parse_vm_arg(raw)
        if arg.kind == "u64":
            u64s.append(arg.value)
        elif arg.kind == "u128":
            if arg.value > (1 << 64) - 1:
                raise CliError(
                    f"u128 public arg '{raw}' does not fit into 64 bits")
            u64s.append(arg.value)
        else:
            if any(arg.value[8:]):
                raise CliError(
                    f"bytes32 public arg '{raw}' must have bytes[8..32]=0")
            u64s.append(int.from_bytes(arg.value[:8], "little"))
        vmargs.append(arg)
    return vmargs, u64s


def parse_secret_args(raws: List[str]) -> List[VmArg]:
    return [parse_vm_arg(r) for r in raws]


def validate_main_args_against_schema(program, public_args) -> None:
    schema = program.type_schemas.fns.get("main")
    if schema is None:
        return
    if len(schema.args) != len(public_args):
        raise CliError(
            f"main typed schema expects {len(schema.args)} args, "
            f"but CLI provided {len(public_args)}")
    for idx, ((role, ty), arg) in enumerate(zip(schema.args, public_args)):
        pos = idx + 1
        if role == "const":
            if ty != "u64" or arg.kind != "u64":
                raise CliError(
                    f"main arg #{pos}: const args must be u64 at CLI level")
        else:
            if arg.kind != ty:
                raise CliError(
                    f"main arg #{pos}: expected {ty} value for type '{ty}'")


def parse_merkle_root(s: Optional[str]) -> Optional[bytes]:
    """--merkle-root value: 0x-prefixed 32-byte hex (raw bytes32) or a
    decimal field element (stored LE in bytes 0..16, the reference's
    be_to_bytes32 layout, tests/merkle.rs:104-110)."""
    if not s:
        return None
    if s.startswith("0x") or s.startswith("0X"):
        raw = bytes.fromhex(s[2:])
        if len(raw) != 32:
            raise CliError("--merkle-root hex must be exactly 32 bytes")
        return raw
    try:
        v = int(s)
    except ValueError:
        raise CliError("--merkle-root must be 0x<64 hex chars> or decimal")
    if not (0 <= v < (1 << 128)):
        raise CliError("--merkle-root out of field range")
    return v.to_bytes(16, "little") + b"\x00" * 16


def build_pi_for_program(program, public_args, secret_args,
                         merkle_root: Optional[bytes] = None
                         ) -> PublicInputs:
    """cli/main.rs build_pi_for_program: Let-role args become main_args.

    merkle_root goes beyond the reference CLI (which has no flag and
    cannot prove multi-level merkle-verify programs): it binds the
    expected root into PublicInputs.merkle_root (pi.rs:71)."""
    main_args = []
    schema = program.type_schemas.fns.get("main")
    if schema is not None:
        if len(schema.args) != len(public_args):
            raise CliError("main typed schema arity mismatch")
        for (role, ty), arg in zip(schema.args, public_args):
            if role == "let":
                main_args.append(arg)
    b = (PublicInputsBuilder(program)
         .with_public_args(public_args)
         .with_main_args(main_args)
         .with_secret_args(secret_args))
    if merkle_root is not None:
        b = b.with_merkle_root(merkle_root)
    return b.build()


def _read_program(path: str, max_bytes: int) -> str:
    size = os.path.getsize(path)
    if size > max_bytes:
        raise CliError(f"file too large: {size} bytes (limit {max_bytes})")
    with open(path) as f:
        return f.read()


def _opts(args, security_bits: Optional[int]) -> ProverOptions:
    base = ProverOptions()
    return ProverOptions(
        queries=args.queries, blowup=args.blowup, grind=args.grind,
        min_security_bits=(security_bits
                           if security_bits is not None
                           else base.min_security_bits),
        max_segment_rows=args.max_segment_rows,
        max_concurrent_segments=args.max_concurrent_segments,
        winterfell_compat=getattr(args, "winterfell_compat", False))


def cmd_run(args, json_out: bool, max_bytes: int, pf: str,
            security_bits) -> None:
    src = _read_program(args.path, max_bytes)
    public_vmargs, public_u64 = parse_public_args(args.args)
    secret_vmargs = parse_secret_args(args.secrets)
    program = compile_entry(src, public_u64)
    validate_main_args_against_schema(program, public_vmargs)
    pi = build_pi_for_program(program, public_vmargs, secret_vmargs,
                              parse_merkle_root(args.merkle_root))
    if pf != frontend.PREFLIGHT_OFF:
        frontend.preflight(program, pi, _opts(args, security_bits), mode=pf)
    res = frontend.run_vm(program, pi)
    m = program.compiler_metrics
    if json_out:
        print(json.dumps({
            "ok": True, "result": str(res.value),
            "out_reg": res.out_reg, "out_row": res.out_row,
            "trace_len": res.trace_len,
            "compiler_metrics": m.to_dict(),
        }))
    else:
        print(f"Result: {res.value}")
        print(f"  out_reg=r{res.out_reg} out_row={res.out_row} "
              f"trace_len={res.trace_len}")
        print(f"  metrics: peak_live={m.peak_live} reuse_dst={m.reuse_dst} "
              f"su_reorders={m.su_reorders} "
              f"balanced_chains={m.balanced_chains} "
              f"mov_elided={m.mov_elided}")


def cmd_prove(args, json_out: bool, max_bytes: int, pf: str,
              security_bits) -> None:
    t0 = time.time()
    src = _read_program(args.path, max_bytes)
    public_vmargs, public_u64 = parse_public_args(args.args)
    secret_vmargs = parse_secret_args(args.secrets)
    program = compile_entry(src, public_u64)
    validate_main_args_against_schema(program, public_vmargs)
    pi = build_pi_for_program(program, public_vmargs, secret_vmargs,
                              parse_merkle_root(args.merkle_root))
    opts = _opts(args, security_bits)
    if pf != frontend.PREFLIGHT_OFF:
        frontend.preflight(program, pi, opts, mode=pf)

    proof, digest, rc_pi = agg.prove_chain(program, pi, opts,
                                           device=args.device)
    blob = agg.encode_artifact(proof, rc_pi)

    out_path = args.out
    if not out_path:
        base = os.path.splitext(os.path.basename(args.path))[0]
        out_path = f"agg_{base}_{int(time.time())}.bin"
    with open(out_path, "wb") as f:
        f.write(blob)

    commitment_hex = "0x" + program.program_id.hex()
    elapsed_ms = int((time.time() - t0) * 1000)
    if json_out:
        print(json.dumps({
            "ok": True, "program_commitment": commitment_hex,
            "agg_proof_path": out_path, "agg_proof_bytes": len(blob),
            "opts": {"queries": args.queries, "blowup": args.blowup,
                     "grind": args.grind},
            "time_ms": elapsed_ms,
        }))
    else:
        print(f"Program commitment: {commitment_hex}")
        print(f"Agg proof saved to {out_path} (len={len(blob)} bytes)")
        print(f"Time: {elapsed_ms} ms")


def cmd_verify(args, json_out: bool, max_bytes: int,
               security_bits) -> None:
    t0 = time.time()
    src = _read_program(args.program, max_bytes)
    public_vmargs, public_u64 = parse_public_args(args.args)
    program = compile_entry(src, public_u64)
    validate_main_args_against_schema(program, public_vmargs)

    with open(args.proof, "rb") as f:
        blob = f.read()
    proof, rc_pi = agg.decode_artifact(blob)

    pi = build_pi_for_program(program, public_vmargs, [],
                              parse_merkle_root(args.merkle_root))
    if rc_pi.program_id != program.program_id:
        raise CliError("program_id mismatch between artifact and program")
    if rc_pi.program_commitment != program.program_id:
        raise CliError("program_commitment mismatch")
    if rc_pi.pi_digest != pi.digest():
        raise CliError("pi_digest mismatch (wrong public args?)")

    opts = _opts(args, security_bits)
    agg.verify_agg(proof, rc_pi, opts.min_security_bits)
    elapsed_ms = int((time.time() - t0) * 1000)
    if json_out:
        print(json.dumps({"ok": True, "time_ms": elapsed_ms}))
    else:
        print(f"Proof verified OK ({elapsed_ms} ms)")


def main(argv: Optional[List[str]] = None) -> int:
    glob = argparse.ArgumentParser(add_help=False)
    glob.add_argument("--json", action="store_true")
    glob.add_argument("--log-level", default=None,
                      choices=["debug", "info", "warn", "error"],
                      help="enable per-phase tracing logs "
                           "(reference: zk-lisp --log-level, "
                           "cli/main.rs:53-60)")
    glob.add_argument("--max-bytes", type=int, default=MAX_BYTES_DEFAULT)
    glob.add_argument("--preflight", default="off",
                      choices=["off", "console", "json"])
    glob.add_argument("--security-bits", type=int,
                      default=int(os.environ.get("ZKL_SECURITY_BITS", "0"))
                      or None)

    p = argparse.ArgumentParser(
        prog="zklisp-tpu-torch", parents=[glob],
        description="zk-lisp STARK prover on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, with_secret=True):
        sp.add_argument("--arg", dest="args", action="append", default=[])
        sp.add_argument("--merkle-root", dest="merkle_root", default=None,
                        help="expected Merkle root bound into the PI "
                             "(0x<64 hex> bytes32 or decimal field "
                             "element); required for multi-level "
                             "merkle-verify/load-ca programs")
        if with_secret:
            sp.add_argument("--secret", dest="secrets", action="append",
                            default=[])
        sp.add_argument("--queries", type=int, default=64)
        sp.add_argument("--blowup", type=int, default=16)
        sp.add_argument("--grind", type=int, default=16)
        sp.add_argument("--max-segment-rows", type=int, default=None)
        sp.add_argument("--max-concurrent-segments", type=int, default=None)
        sp.add_argument("--winterfell-compat", action="store_true",
                        help="per-assertion boundary batching "
                             "(winterfell's composition; also via "
                             "ZKL_WINTERFELL_COMPAT=1)")

    sp = sub.add_parser("run", parents=[glob])
    sp.add_argument("path")
    common(sp)

    def device_arg(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; "
                             "'cpu' runs on the host)")

    sp = sub.add_parser("prove", parents=[glob])
    sp.add_argument("path")
    sp.add_argument("--out", default=None)
    sp.add_argument("--quiet", action="store_true")
    common(sp)
    device_arg(sp)

    sp = sub.add_parser("verify", parents=[glob])
    sp.add_argument("proof")
    sp.add_argument("program")
    common(sp, with_secret=False)

    sp = sub.add_parser("repl", parents=[glob])
    device_arg(sp)

    args = p.parse_args(argv)
    if args.log_level:
        from .utils.tracing import configure
        configure(args.log_level)
    try:
        if args.cmd == "run":
            cmd_run(args, args.json, args.max_bytes, args.preflight,
                    args.security_bits)
        elif args.cmd == "prove":
            cmd_prove(args, args.json, args.max_bytes, args.preflight,
                      args.security_bits)
        elif args.cmd == "verify":
            cmd_verify(args, args.json, args.max_bytes, args.security_bits)
        elif args.cmd == "repl":
            from .repl import run_repl
            run_repl(args.device)
    except (CliError, CompileError, frontend.PreflightError,
            VerifyError, AggError, ProveError) as e:
        if args.json:
            print(json.dumps({"ok": False, "error": str(e)}))
        else:
            print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
