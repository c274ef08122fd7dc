#!/usr/bin/env python
"""Measured issue rates of the integer multiply-adds that poseidon12 is
built from, on one CUDA card.

    python3 scripts/int_mad_rate.py

Builds a small CUDA source with nvcc (sm_90a) into the git-ignored
zklisp_tpu_torch/build/, runs one kernel per instruction form on enough
blocks to fill every SM many times over, and prints one JSON object: per
form, the measured multiply-adds per second and per SM per clock at the
clock that chip_smoke.py's bound assumes (1.98 GHz), beside the card's
name and power limit.  The forms:

  imad        32-bit  d = a * b + c                      (SASS IMAD)
  chain_wide  32x32 -> 64 products in the kernel's PTX pattern: a
              mad.lo.cc + madc.hi.cc pair over a word pair, which ptxas
              fuses into one IMAD.WIDE.U32, and the carry into a counter

Each thread runs 8 independent dependent chains, so the rate is the
pipe's and not one chain's latency.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BUILD = os.path.join(ROOT, "zklisp_tpu_torch", "build")
CLOCK_HZ = 1.98e9          # the boost clock chip_smoke.py's bound assumes
SMS = 132

SOURCE = r"""
#include <cstdint>
typedef unsigned int u32;

extern "C" __global__ void imad(const u32 *in, u32 *out, int iters) {
    u32 y = in[threadIdx.x & 31] | 1, z = in[32 + (threadIdx.x & 31)];
    u32 a[8];
#pragma unroll
    for (int k = 0; k < 8; k++) a[k] = threadIdx.x + k;
    for (int i = 0; i < iters; i++) {
#pragma unroll
        for (int r = 0; r < 16; r++) {
#pragma unroll
            for (int k = 0; k < 8; k++) a[k] = a[k] * y + z;
        }
    }
    u32 s = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) s ^= a[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// (h:l) += x * y as one mad.lo.cc / madc.hi.cc pair, then the carry into c
__device__ __forceinline__ void pair(u32 &l, u32 &h, u32 &c, u32 x, u32 y) {
    asm volatile("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
                 "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
                 "addc.u32       %2, %2, 0;"
                 : "+r"(l), "+r"(h), "+r"(c) : "r"(x), "r"(y));
}

extern "C" __global__ void chain_wide(const u32 *in, u32 *out, int iters) {
    u32 y = in[threadIdx.x & 31] | 1;
    u32 l[8], h[8], c[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        l[k] = threadIdx.x + k;
        h[k] = k;
        c[k] = 0;
    }
    for (int i = 0; i < iters; i++) {
#pragma unroll
        for (int r = 0; r < 16; r++) {
#pragma unroll
            for (int k = 0; k < 8; k++) pair(l[k], h[k], c[k], h[k], y);
        }
    }
    u32 s = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) s ^= l[k] ^ h[k] ^ c[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int run(int which, const void *in, void *out, int blocks,
                   int threads, int iters) {
    if (which == 0) imad<<<blocks, threads>>>((const u32 *)in, (u32 *)out, iters);
    if (which == 1) chain_wide<<<blocks, threads>>>((const u32 *)in, (u32 *)out, iters);
    return (int)cudaGetLastError();
}
"""

FORMS = {"imad": 0, "chain_wide": 1}


def build() -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "int_mad_rate.cu")
    lib = os.path.join(BUILD, "libint_mad_rate.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    out = ctypes.CDLL(lib)
    out.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("int_mad_rate: no CUDA device available")
    lib = build()
    blocks, threads, iters = SMS * 16, 256, 2048
    inp = torch.arange(1, 65, dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    ops = blocks * threads * iters * 16 * 8
    res = {}
    for name, which in FORMS.items():
        times = []
        for rep in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.run(which, inp.data_ptr(), out.data_ptr(), blocks,
                          threads, iters)
            b.record()
            torch.cuda.synchronize()
            if err != 0:
                sys.exit(f"int_mad_rate: {name} launch failed: {err}")
            if rep:                               # the first is a warm-up
                times.append(a.elapsed_time(b) / 1e3)
        t = sorted(times)[len(times) // 2]
        res[name] = {"seconds": t, "mads_per_s": ops / t,
                     "per_sm_per_clock_at_1.98GHz": ops / t / SMS / CLOCK_HZ}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "blocks": blocks, "threads": threads,
                      "mads_per_thread": iters * 16 * 8, "forms": res}),
          flush=True)


if __name__ == "__main__":
    main()
