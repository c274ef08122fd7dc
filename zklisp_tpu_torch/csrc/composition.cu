// composition: the constraint composition sum_i alpha_i * C_i of a STARK
// segment (or of the S segments of a wave) over its evaluation sub-domain,
// one thread per (segment, row), every intermediate on chip.
//
// Replaces no Pallas kernel: the JAX package evaluates the composition as
// XLA ops.  It replaces the port's two plain PyTorch executors on the card,
// prove/cvm.py (the leveled and the stack executor of the recorded generic
// constraints) and prove/composition_device.py::_scan_rounds (the Poseidon
// 27x12 and ROM 27x3 round blocks), which issued some 80,000 int64 tensor
// launches a wave, each moving its temporaries through device memory.
//
// Two kernels, two launches a wave, into one output (S, N, 8) int32 of
// canonical 16-bit digits:
//
//  * composition_generic_kernel interprets the generic program as data:
//    the register form of prove/cvm.py (compile_registers), rows
//    (op, dst, a, b) of ADD / SUB / MUL into a per-row register file, and
//    EMIT, which adds alpha[dst] * a to the row's sum.  An operand is a
//    register, a column of the row (cur) or of the row `blowup` ahead
//    within the segment (nxt), a short-periodic column at r mod period,
//    p_last at r, or a constant.  The program is uploaded once per
//    recorded program; nothing is compiled per job.  Opcodes and operand
//    kinds are the same for every thread (warp-uniform branches).  The
//    register file lives in shared memory, register k of thread t at
//    [k * blockDim + t] (rollup-bench needs 10 registers, 160 B a row).
//  * composition_scan_kernel evaluates the round blocks, regrouped:
//      sum_j g_j sum_i a_ji (nxt_i - y0_i - rc_ji)
//        = sum_j g_j (sum_i a_ji d_i - K_j),   d_i = nxt_i - y0_i,
//    with y0 = MDS * cur^3 (once a row) and K_j = sum_i a_ji rc_ji (once a
//    block: the alphas are the segment's).  Poseidon's gate is
//    pose_active * round gate j, so pose_active multiplies the inner sum
//    once; ROM's is the round gate alone.  Field sums are exact mod p, so
//    the canonical result equals _scan_rounds' limb for limb.  It adds
//    into the generic kernel's output (or starts from zero).
//
// Arithmetic: a field element is four 32-bit words; products and sums are
// PTX carry chains, written here after csrc/poseidon12.cu's (which stays
// as it is): `acc_t` accumulates products without reduction, `reduce9`
// folds 2^128 = C = 11520 * 2^32 - 1 twice and subtracts p once.  Lazy
// sums reduce once: an EMIT run (at most FLUSH products pending, so the
// sum stays below 2^264), each MDS row, each round's 12- or 3-term alpha
// dot (plus -K_j), the 27 gated rounds.  Every output is canonical (< p).
// tests/test_torch_composition_kernel.py replays the new word arithmetic
// instruction by instruction and both kernels' row loops.
//
// What bounds it.  Integer multiply-adds: rollup-bench (634 constraints)
// needs ~1,805 products of 128 x 128 bits a row (1,162 generic: 933 MUL,
// 229 EMIT; 520 Poseidon: 24 in the cubes, 144 MDS, 324 alpha, 28 gates;
// 123 ROM), ~26 word multiply-adds each with the folds: 0.95 G products,
// ~1.5 ms a 16 x 32,768-row wave at 132 SMs x 64 multiply-adds a clock x
// 1.98 GHz.  Bytes: each read column of the (strided) LDE once, <= 3.6 GB
// a wave, ~1.1 ms at 3.35 TB/s.  A column read again within a row comes
// from L1/L2.  The design keeps every intermediate in registers or in the
// block's shared register file, so device memory sees the LDE, the
// one-period tables and one 32-byte write a row.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned int u32;
typedef unsigned long long u64;

#define ZKL_M 11520u           // C = ZKL_M * 2^32 - 1
#define ZKL_ROUNDS 27          // Poseidon / ROM rounds of the scan blocks
#define ZKL_SCAN_BLOCK 128     // threads (rows) per scan block
#define ZKL_FLUSH 255          // EMIT products pending before a reduction

// the register form's opcodes and operand kinds (prove/cvm.py)
#define R_ADD 0
#define R_SUB 1
#define R_MUL 2
#define R_EMIT 3
#define RK_REG 0
#define RK_CUR 1
#define RK_NXT 2
#define RK_PER 3
#define RK_PLAST 4
#define RK_CONST 5

// ---------------------------------------------------------------------------
// word arithmetic (as in csrc/poseidon12.cu; the same PTX, instruction for
// instruction, where the name is the same)
// ---------------------------------------------------------------------------

// (r0, r1, r2, r3) += (lo(x0*y0), hi(x0*y0), lo(x1*y1), hi(x1*y1)); the
// carry-out is added to cnt
__device__ __forceinline__ void chain2(u32 &r0, u32 &r1, u32 &r2, u32 &r3,
                                       u32 &cnt, u32 x0, u32 y0, u32 x1,
                                       u32 y1) {
    asm volatile(
        "mad.lo.cc.u32  %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %8, %3;\n\t"
        "addc.u32       %4, %4, 0;"
        : "+r"(r0), "+r"(r1), "+r"(r2), "+r"(r3), "+r"(cnt)
        : "r"(x0), "r"(y0), "r"(x1), "r"(y1));
}

// A product accumulator: partial products a_i*b_j with i+j even go to e
// (word positions 0..7), those with i+j odd to o (positions 1..6), chain
// carries to counters at positions 5, 6, 7 and 8 (at most 2 each per
// product).
struct acc_t {
    u32 e[8], o[6], c5, c6, c7, c8;
};

__device__ __forceinline__ void acc_zero(acc_t &s) {
#pragma unroll
    for (int i = 0; i < 8; i++) s.e[i] = 0;
#pragma unroll
    for (int i = 0; i < 6; i++) s.o[i] = 0;
    s.c5 = s.c6 = s.c7 = s.c8 = 0;
}

// s holds x (canonical) and nothing else
__device__ __forceinline__ void acc_set(acc_t &s, const uint4 x) {
    acc_zero(s);
    s.e[0] = x.x;
    s.e[1] = x.y;
    s.e[2] = x.z;
    s.e[3] = x.w;
}

// s += a * b
__device__ __forceinline__ void mac_aligned(acc_t &s, const uint4 a,
                                            const uint4 b) {
    // a0b0 @0, a1b1 @2, a2b2 @4, a3b3 @6 -> carry at 8
    asm volatile(
        "mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %16, %7;\n\t"
        "addc.u32       %8, %8, 0;"
        : "+r"(s.e[0]), "+r"(s.e[1]), "+r"(s.e[2]), "+r"(s.e[3]),
          "+r"(s.e[4]), "+r"(s.e[5]), "+r"(s.e[6]), "+r"(s.e[7]),
          "+r"(s.c8)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w),
          "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));
    // a0b2 @2, a1b3 @4 and a2b0 @2, a3b1 @4 -> carries at 6
    chain2(s.e[2], s.e[3], s.e[4], s.e[5], s.c6, a.x, b.z, a.y, b.w);
    chain2(s.e[2], s.e[3], s.e[4], s.e[5], s.c6, a.z, b.x, a.w, b.y);
    // a0b1 @1, a1b2 @3, a2b3 @5 and a1b0 @1, a2b1 @3, a3b2 @5 -> carries
    // at 7
    asm volatile(
        "mad.lo.cc.u32  %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %12, %5;\n\t"
        "addc.u32       %6, %6, 0;\n\t"
        "mad.lo.cc.u32  %0, %9, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %8, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %10, %5;\n\t"
        "addc.u32       %6, %6, 0;"
        : "+r"(s.o[0]), "+r"(s.o[1]), "+r"(s.o[2]), "+r"(s.o[3]),
          "+r"(s.o[4]), "+r"(s.o[5]), "+r"(s.c7)
        : "r"(a.x), "r"(b.y), "r"(a.y), "r"(b.z), "r"(a.z), "r"(b.w),
          "r"(a.w), "r"(b.x));
    // a0b3 @3 and a3b0 @3 -> carries at 5
    asm volatile(
        "mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32       %2, %2, 0;\n\t"
        "mad.lo.cc.u32  %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "addc.u32       %2, %2, 0;"
        : "+r"(s.o[2]), "+r"(s.o[3]), "+r"(s.c5)
        : "r"(a.x), "r"(b.w), "r"(a.w), "r"(b.x));
}

// w (eight words) and top = the value of s
__device__ __forceinline__ void acc_words(acc_t &s, u32 (&w)[8],
                                          u32 &top) {
    asm volatile(
        "add.cc.u32  %1, %1, %8;\n\t"
        "addc.cc.u32 %2, %2, %9;\n\t"
        "addc.cc.u32 %3, %3, %10;\n\t"
        "addc.cc.u32 %4, %4, %11;\n\t"
        "addc.cc.u32 %5, %5, %12;\n\t"
        "addc.cc.u32 %6, %6, %13;\n\t"
        "addc.cc.u32 %7, %7, %14;\n\t"
        "addc.u32    %0, %0, 0;\n\t"
        "add.cc.u32  %5, %5, %15;\n\t"
        "addc.cc.u32 %6, %6, %16;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "addc.u32    %0, %0, 0;"
        : "+r"(s.c8), "+r"(s.e[1]), "+r"(s.e[2]), "+r"(s.e[3]),
          "+r"(s.e[4]), "+r"(s.e[5]), "+r"(s.e[6]), "+r"(s.e[7])
        : "r"(s.o[0]), "r"(s.o[1]), "r"(s.o[2]), "r"(s.o[3]),
          "r"(s.o[4]), "r"(s.o[5]), "r"(s.c7), "r"(s.c5), "r"(s.c6));
#pragma unroll
    for (int i = 0; i < 8; i++) w[i] = s.e[i];
    top = s.c8;
}

// canonical (w + top * 2^256) mod p.  Fold 1 needs top * 11520 < 2^32;
// the callers keep w + top * 2^256 < 2^264 (top < 2^8), where the word
// model holds every instruction of it.
__device__ __forceinline__ uint4 reduce9(const u32 (&w)[8], u32 top) {
    const u32 m = ZKL_M;
    // fold 1: t = L + H*C = L + (H*m) << 32 - H, with L = w[0..3] and
    // H = (w[4..7], top)
    u32 t0 = w[0], t1 = w[1], t2 = w[2], t3 = w[3], t4 = 0, t5 = 0;
    asm volatile(
        "mad.lo.cc.u32  %1, %6, %11, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, %8, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, %8, %11, %4;\n\t"
        "madc.lo.u32    %5, %10, %11, %5;\n\t"
        "mad.lo.cc.u32  %2, %7, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %11, %4;\n\t"
        "madc.hi.u32    %5, %9, %11, %5;\n\t"
        "sub.cc.u32     %0, %0, %6;\n\t"
        "subc.cc.u32    %1, %1, %7;\n\t"
        "subc.cc.u32    %2, %2, %8;\n\t"
        "subc.cc.u32    %3, %3, %9;\n\t"
        "subc.cc.u32    %4, %4, %10;\n\t"
        "subc.u32       %5, %5, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5)
        : "r"(w[4]), "r"(w[5]), "r"(w[6]), "r"(w[7]), "r"(top), "r"(m));
    // fold 2: (k, u) = t[0..3] + (t4 + t5*2^32) * C; the bit k above
    // 2^128 is 0 or 1
    u32 k = 0;
    asm volatile(
        "mad.lo.cc.u32  %1, %5, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %7, %2;\n\t"
        "addc.cc.u32    %3, %3, 0;\n\t"
        "addc.u32       %4, %4, 0;\n\t"
        "mad.lo.cc.u32  %2, %6, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
        "addc.u32       %4, %4, 0;\n\t"
        "sub.cc.u32     %0, %0, %5;\n\t"
        "subc.cc.u32    %1, %1, %6;\n\t"
        "subc.cc.u32    %2, %2, 0;\n\t"
        "subc.cc.u32    %3, %3, 0;\n\t"
        "subc.u32       %4, %4, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(k)
        : "r"(t4), "r"(t5), "r"(m));
    // v = u + C with carry-out k2: the result is v when k or k2, else u
    u32 v0, v1, v2, v3, k2 = 0;
    asm volatile(
        "add.cc.u32  %0, %5, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %1, %6, 0x2CFF;\n\t"
        "addc.cc.u32 %2, %7, 0;\n\t"
        "addc.cc.u32 %3, %8, 0;\n\t"
        "addc.u32    %4, %4, 0;"
        : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3), "+r"(k2)
        : "r"(t0), "r"(t1), "r"(t2), "r"(t3));
    const bool sel = (k | k2) != 0;
    return make_uint4(sel ? v0 : t0, sel ? v1 : t1, sel ? v2 : t2,
                      sel ? v3 : t3);
}

__device__ __forceinline__ uint4 acc_reduce(acc_t &s) {
    u32 w[8], top;
    acc_words(s, w, top);
    return reduce9(w, top);
}

// x^2 as eight words and a top word (always 0, produced by the asm so that
// no literal meets an in/out operand)
__device__ __forceinline__ void square8(u32 (&r)[8], u32 &top,
                                        const uint4 x) {
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = 0;
    top = 0;
    asm volatile(
        "mul.lo.u32     %1, %9, %10;\n\t"
        "mul.hi.u32     %2, %9, %10;\n\t"
        "mul.lo.u32     %3, %10, %11;\n\t"
        "mul.hi.u32     %4, %10, %11;\n\t"
        "mul.lo.u32     %5, %11, %12;\n\t"
        "mul.hi.u32     %6, %11, %12;\n\t"
        "mad.lo.cc.u32  %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
        "addc.cc.u32    %6, %6, 0;\n\t"
        "addc.u32       %7, %7, 0;\n\t"
        "mad.lo.cc.u32  %3, %9, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %9, %12, %4;\n\t"
        "addc.cc.u32    %5, %5, 0;\n\t"
        "addc.cc.u32    %6, %6, 0;\n\t"
        "addc.u32       %7, %7, 0;\n\t"
        "add.cc.u32     %1, %1, %1;\n\t"
        "addc.cc.u32    %2, %2, %2;\n\t"
        "addc.cc.u32    %3, %3, %3;\n\t"
        "addc.cc.u32    %4, %4, %4;\n\t"
        "addc.cc.u32    %5, %5, %5;\n\t"
        "addc.cc.u32    %6, %6, %6;\n\t"
        "addc.u32       %7, %7, %7;\n\t"
        "mul.lo.u32     %0, %9, %9;\n\t"
        "mad.hi.cc.u32  %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %12, %7;\n\t"
        "addc.u32       %8, %8, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(top)
        : "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w));
}

// x^3 mod p for canonical x
__device__ __forceinline__ uint4 cube(const uint4 x) {
    u32 w[8], top;
    square8(w, top, x);
    const uint4 x2 = reduce9(w, top);
    acc_t s;
    acc_zero(s);
    mac_aligned(s, x2, x);
    return acc_reduce(s);
}

// a * b mod p
__device__ __forceinline__ uint4 mulmod(const uint4 a, const uint4 b) {
    acc_t s;
    acc_zero(s);
    mac_aligned(s, a, b);
    return acc_reduce(s);
}

// a + b mod p for canonical a, b: s = a + b with carry k; v = s + C with
// carry k2 (v = s - p mod 2^128); the result is v when k or k2, else s
__device__ __forceinline__ uint4 addmod(const uint4 a, const uint4 b) {
    u32 s0, s1, s2, s3, k = 0;
    asm volatile(
        "add.cc.u32  %0, %5, %9;\n\t"
        "addc.cc.u32 %1, %6, %10;\n\t"
        "addc.cc.u32 %2, %7, %11;\n\t"
        "addc.cc.u32 %3, %8, %12;\n\t"
        "addc.u32    %4, %4, 0;"
        : "=r"(s0), "=r"(s1), "=r"(s2), "=r"(s3), "+r"(k)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w),
          "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));
    u32 v0, v1, v2, v3, k2 = 0;
    asm volatile(
        "add.cc.u32  %0, %5, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 %1, %6, 0x2CFF;\n\t"
        "addc.cc.u32 %2, %7, 0;\n\t"
        "addc.cc.u32 %3, %8, 0;\n\t"
        "addc.u32    %4, %4, 0;"
        : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3), "+r"(k2)
        : "r"(s0), "r"(s1), "r"(s2), "r"(s3));
    const bool sel = (k | k2) != 0;
    return make_uint4(sel ? v0 : s0, sel ? v1 : s1, sel ? v2 : s2,
                      sel ? v3 : s3);
}

// a - b mod p for canonical a, b: d = a - b mod 2^128, nb = 1 - borrow;
// on a borrow the result is d + p - 2^128 = d - C (no borrow there: d
// > C), else d
__device__ __forceinline__ uint4 submod(const uint4 a, const uint4 b) {
    u32 d0, d1, d2, d3, nb = 1;
    asm volatile(
        "sub.cc.u32  %0, %5, %9;\n\t"
        "subc.cc.u32 %1, %6, %10;\n\t"
        "subc.cc.u32 %2, %7, %11;\n\t"
        "subc.cc.u32 %3, %8, %12;\n\t"
        "subc.u32    %4, %4, 0;"
        : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3), "+r"(nb)
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w),
          "r"(b.x), "r"(b.y), "r"(b.z), "r"(b.w));
    u32 v0, v1, v2, v3;
    asm volatile(
        "sub.cc.u32  %0, %4, 0xFFFFFFFF;\n\t"
        "subc.cc.u32 %1, %5, 0x2CFF;\n\t"
        "subc.cc.u32 %2, %6, 0;\n\t"
        "subc.cc.u32 %3, %7, 0;"
        : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
        : "r"(d0), "r"(d1), "r"(d2), "r"(d3));
    const bool sel = nb == 0;
    return make_uint4(sel ? v0 : d0, sel ? v1 : d1, sel ? v2 : d2,
                      sel ? v3 : d3);
}

// p - x mod p for canonical x (once a block: plain 64-bit C)
__device__ __forceinline__ uint4 negmod(const uint4 x) {
    if ((x.x | x.y | x.z | x.w) == 0) return x;
    const u64 pl = 0xFFFFD30000000001ULL, ph = 0xFFFFFFFFFFFFFFFFULL;
    const u64 xl = ((u64)x.y << 32) | x.x, xh = ((u64)x.w << 32) | x.z;
    const u64 rl = pl - xl;
    const u64 rh = ph - xh - (pl < xl ? 1ULL : 0ULL);
    return make_uint4((u32)rl, (u32)(rl >> 32), (u32)rh, (u32)(rh >> 32));
}

// eight 16-bit digits (two int4) -> four 32-bit words
__device__ __forceinline__ uint4 load_words(const int *p) {
    const int4 *q = reinterpret_cast<const int4 *>(p);
    const int4 a = q[0], b = q[1];
    return make_uint4(
        (u32)(a.x & 0xFFFF) | ((u32)a.y << 16),
        (u32)(a.z & 0xFFFF) | ((u32)a.w << 16),
        (u32)(b.x & 0xFFFF) | ((u32)b.y << 16),
        (u32)(b.z & 0xFFFF) | ((u32)b.w << 16));
}

__device__ __forceinline__ void store_words(int *p, const uint4 v) {
    int4 *q = reinterpret_cast<int4 *>(p);
    q[0] = make_int4((int)(v.x & 0xFFFF), (int)(v.x >> 16),
                     (int)(v.y & 0xFFFF), (int)(v.y >> 16));
    q[1] = make_int4((int)(v.z & 0xFFFF), (int)(v.z >> 16),
                     (int)(v.w & 0xFFFF), (int)(v.w >> 16));
}

// ---------------------------------------------------------------------------
// the generic program
// ---------------------------------------------------------------------------

// Where one thread's row lies: segment base, column stride, the row's and
// the next row's offsets, the periodic row.
struct row_t {
    const int *seg;
    long long sW, cur, nxt;
    const int *per;
    int period, rp;
    const int *plast;
};

__device__ __forceinline__ uint4 operand(const int enc, const uint4 *regs,
                                         const int T, const row_t &row,
                                         const uint4 *__restrict__ consts) {
    const int k = enc & 0xFFFFFF;
    switch (enc >> 24) {
    case RK_REG:
        return regs[k * T];
    case RK_CUR:
        return load_words(row.seg + k * row.sW + row.cur);
    case RK_NXT:
        return load_words(row.seg + k * row.sW + row.nxt);
    case RK_PER:
        return load_words(row.per + ((long long)k * row.period + row.rp) * 8);
    case RK_PLAST:
        return load_words(row.plast);
    default:
        return __ldg(consts + k);
    }
}

extern "C" __global__ void __launch_bounds__(128)
composition_generic_kernel(const int *__restrict__ lde, long long sS,
                           long long sW, long long sN, int N, int blowup,
                           const int *__restrict__ per, int period,
                           const int *__restrict__ plast,
                           const int *__restrict__ alphas, long long aS,
                           const int4 *__restrict__ code, int n_code,
                           const uint4 *__restrict__ consts,
                           int *__restrict__ out) {
    extern __shared__ uint4 regs_sh[];
    const int T = blockDim.x;
    const int r = blockIdx.x * T + threadIdx.x;
    const int s = blockIdx.y;
    if (r >= N) return;                  // no barrier in this kernel
    row_t row;
    row.seg = lde + s * sS;
    row.sW = sW;
    row.cur = r * sN;
    row.nxt = (long long)((r + blowup) % N) * sN;
    row.per = per;
    row.period = period;
    row.rp = r % period;
    row.plast = plast + (long long)r * 8;
    const int *al = alphas + s * aS;
    uint4 *regs = regs_sh + threadIdx.x;

    acc_t acc;
    acc_zero(acc);
    int pending = 0;
#pragma unroll 1
    for (int i = 0; i < n_code; i++) {
        const int4 ins = __ldg(code + i);
        const uint4 a = operand(ins.z, regs, T, row, consts);
        if (ins.x == R_EMIT) {
            mac_aligned(acc, load_words(al + ins.y * 8), a);
            if (++pending == ZKL_FLUSH) {
                acc_set(acc, acc_reduce(acc));
                pending = 0;
            }
            continue;
        }
        const uint4 b = operand(ins.w, regs, T, row, consts);
        uint4 v;
        if (ins.x == R_MUL) {
            v = mulmod(a, b);
        } else if (ins.x == R_ADD) {
            v = addmod(a, b);
        } else {
            v = submod(a, b);
        }
        regs[ins.y * T] = v;
    }
    store_words(out + ((long long)s * N + r) * 8, acc_reduce(acc));
}

// ---------------------------------------------------------------------------
// the round blocks
// ---------------------------------------------------------------------------

// One round block for one row: acc += sum_j gate_j (sum_i a_ji d_i - K_j),
// gate_j = gr_j(r mod period) * (GATED ? gate column : 1).  cols: the L
// lane columns; mds (L*L), al (27*L) and negk (27) in shared memory.
template <int L, bool GATED>
__device__ __forceinline__ void scan_block(acc_t &acc, const row_t &row,
                                           const int *cols, int gate_col,
                                           const uint4 *mds, const uint4 *al,
                                           const uint4 *negk,
                                           const int *__restrict__ gates) {
    uint4 d[L];
    {
        uint4 c[L];
#pragma unroll
        for (int i = 0; i < L; i++) {
            c[i] = cube(load_words(row.seg + cols[i] * row.sW + row.cur));
        }
#pragma unroll
        for (int i = 0; i < L; i++) {
            acc_t y;
            acc_zero(y);
#pragma unroll
            for (int j = 0; j < L; j++) mac_aligned(y, mds[i * L + j], c[j]);
            d[i] = acc_reduce(y);
        }
    }
#pragma unroll
    for (int i = 0; i < L; i++) {
        d[i] = submod(load_words(row.seg + cols[i] * row.sW + row.nxt), d[i]);
    }
    acc_t g;
    acc_zero(g);
#pragma unroll 1
    for (int j = 0; j < ZKL_ROUNDS; j++) {
        acc_t t;
        acc_set(t, negk[j]);
#pragma unroll
        for (int i = 0; i < L; i++) mac_aligned(t, al[j * L + i], d[i]);
        const uint4 gr = load_words(
            gates + ((long long)j * row.period + row.rp) * 8);
        if (GATED) {
            mac_aligned(g, gr, acc_reduce(t));
        } else {
            mac_aligned(acc, gr, acc_reduce(t));
        }
    }
    if (GATED) {
        const uint4 pa = load_words(row.seg + gate_col * row.sW + row.cur);
        mac_aligned(acc, pa, acc_reduce(g));
    }
}

// meta (int32): [pos_ix, rom_ix, pose_active, lane 0..11, rom 0..2]; an
// alpha offset < 0 leaves its block out.  tab (16-bit digits, 8 a value):
// Poseidon MDS (144), Poseidon rc (27*12), ROM MDS (9), ROM rc (27*3).
#define ZKL_META 18
#define ZKL_TAB_PRC 144
#define ZKL_TAB_RMDS (144 + 27 * 12)
#define ZKL_TAB_RRC (144 + 27 * 12 + 9)

extern "C" __global__ void __launch_bounds__(ZKL_SCAN_BLOCK)
composition_scan_kernel(const int *__restrict__ lde, long long sS,
                        long long sW, long long sN, int N, int shift,
                        const int *__restrict__ gates, int period,
                        const int *__restrict__ alphas, long long aS,
                        const int *__restrict__ tab,
                        const int *__restrict__ meta, int accumulate,
                        int *__restrict__ out) {
    __shared__ uint4 s_pmds[144], s_pal[ZKL_ROUNDS * 12], s_pk[ZKL_ROUNDS];
    __shared__ uint4 s_rmds[9], s_ral[ZKL_ROUNDS * 3], s_rk[ZKL_ROUNDS];
    __shared__ int s_meta[ZKL_META];
    const int s = blockIdx.y;
    const int *al = alphas + s * aS;
    if (threadIdx.x < ZKL_META) s_meta[threadIdx.x] = meta[threadIdx.x];
    const int pos_ix = meta[0], rom_ix = meta[1];
    for (int q = threadIdx.x; q < 144 + 9; q += blockDim.x) {
        if (q < 144) {
            s_pmds[q] = load_words(tab + q * 8);
        } else {
            s_rmds[q - 144] = load_words(tab + (ZKL_TAB_RMDS + q - 144) * 8);
        }
    }
    for (int q = threadIdx.x; q < ZKL_ROUNDS * 15; q += blockDim.x) {
        if (q < ZKL_ROUNDS * 12) {
            if (pos_ix >= 0) s_pal[q] = load_words(al + (pos_ix + q) * 8);
        } else if (rom_ix >= 0) {
            const int k = q - ZKL_ROUNDS * 12;
            s_ral[k] = load_words(al + (rom_ix + k) * 8);
        }
    }
    __syncthreads();
    // -K_j = -(sum_i a_ji rc_ji): thread j for Poseidon, 32 + j for ROM
    const int t = threadIdx.x;
    if (pos_ix >= 0 && t < ZKL_ROUNDS) {
        acc_t k;
        acc_zero(k);
        for (int i = 0; i < 12; i++) {
            mac_aligned(k, s_pal[t * 12 + i],
                        load_words(tab + (ZKL_TAB_PRC + t * 12 + i) * 8));
        }
        s_pk[t] = negmod(acc_reduce(k));
    }
    if (rom_ix >= 0 && t >= 32 && t < 32 + ZKL_ROUNDS) {
        const int j = t - 32;
        acc_t k;
        acc_zero(k);
        for (int i = 0; i < 3; i++) {
            mac_aligned(k, s_ral[j * 3 + i],
                        load_words(tab + (ZKL_TAB_RRC + j * 3 + i) * 8));
        }
        s_rk[j] = negmod(acc_reduce(k));
    }
    __syncthreads();

    const int r = blockIdx.x * blockDim.x + t;
    if (r >= N) return;
    row_t row;
    row.seg = lde + s * sS;
    row.sW = sW;
    row.cur = r * sN;
    row.nxt = (long long)((r + shift) % N) * sN;
    row.per = gates;
    row.period = period;
    row.rp = r % period;
    row.plast = nullptr;
    int *o = out + ((long long)s * N + r) * 8;
    acc_t acc;
    if (accumulate) {
        acc_set(acc, load_words(o));
    } else {
        acc_zero(acc);
    }
    if (pos_ix >= 0) {
        scan_block<12, true>(acc, row, s_meta + 3, s_meta[2], s_pmds, s_pal,
                             s_pk, gates);
    }
    if (rom_ix >= 0) {
        scan_block<3, false>(acc, row, s_meta + 15, -1, s_rmds, s_ral, s_rk,
                             gates);
    }
    store_words(o, acc_reduce(acc));
}

// ---------------------------------------------------------------------------
// launchers: on the given stream, no synchronisation, no allocation;
// return cudaGetLastError() as an int (0 = launched)
// ---------------------------------------------------------------------------

// lde strides sS, sW, sN in int32 elements (digits of one value
// contiguous); out (S, N, 8) contiguous; aS the alphas' segment stride
// (0: one row of alphas for every segment).
extern "C" int composition_generic_launch(
    const void *lde, long long sS, long long sW, long long sN, int S, int N,
    int blowup, const void *per, int period, const void *plast,
    const void *alphas, long long aS, const void *code, int n_code,
    const void *consts, int n_regs, int threads, void *out, void *stream) {
    if (S == 0 || N == 0) return 0;
    if (S < 0 || N < 0 || S > 65535 || period <= 0 || n_code < 0
        || n_regs < 0 || threads <= 0 || threads > 128 || threads % 32) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)n_regs * threads * sizeof(uint4);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            composition_generic_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((N + threads - 1) / threads), (unsigned)S);
    composition_generic_kernel<<<grid, threads, smem,
                                 (cudaStream_t)stream>>>(
        (const int *)lde, sS, sW, sN, N, blowup, (const int *)per, period,
        (const int *)plast, (const int *)alphas, aS, (const int4 *)code,
        n_code, (const uint4 *)consts, (int *)out);
    return (int)cudaGetLastError();
}

extern "C" int composition_scan_launch(
    const void *lde, long long sS, long long sW, long long sN, int S, int N,
    int shift, const void *gates, int period, const void *alphas,
    long long aS, const void *tab, const void *meta, int accumulate,
    void *out, void *stream) {
    if (S == 0 || N == 0) return 0;
    if (S < 0 || N < 0 || S > 65535 || period <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((unsigned)((N + ZKL_SCAN_BLOCK - 1) / ZKL_SCAN_BLOCK),
                    (unsigned)S);
    composition_scan_kernel<<<grid, ZKL_SCAN_BLOCK, 0,
                              (cudaStream_t)stream>>>(
        (const int *)lde, sS, sW, sN, N, shift, (const int *)gates, period,
        (const int *)alphas, aS, (const int *)tab, (const int *)meta,
        accumulate, (int *)out);
    return (int)cudaGetLastError();
}
