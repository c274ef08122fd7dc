// poseidon12: the full Poseidon2 t=12 permutation over the f128 field
// p = 2^128 - 45*2^40 + 1.
//
// Replaces the Pallas kernel of the JAX package
// (zklisp_tpu/crypto/poseidon_pallas.py, _permute_fn / its inner `kernel`,
// both the VPU and the MXU-MDS lowering: one function, identical output).
//
// Per round: x^3 on all 12 lanes, then the 12x12 MDS product plus the
// round constant.  Input and output are (B, 12, 8) int32 tensors of
// 16-bit little-endian digits, contiguous; `rounds`, the MDS (12,12,8)
// and the round constants (rounds,12,8) are runtime arguments in the
// same digit layout, so a change of round count never meets a stale
// build.  The ragged edge (B not a multiple of the block) is masked
// here; the caller pads nothing.
//
// What bounds it.  Integer multiply-adds at large batches: a state moves
// 768 bytes but needs, per round, 12 squarings, 12 multiplies and 144 MDS
// products of 128x128 -> 256 bits and 36 reductions.  Latency at small
// batches: the main path issues ~170 launches per segment of at most
// 16,384 states (Merkle levels, FRI layers, coin draws), down to one
// state, and there the time is one state's 27 dependent rounds.
//
// The kernel the wrapper launches (poseidon12_launch ->
// poseidon12_team_kernel):
//
//  * A team of 12 threads carries one state; thread k holds lane k in
//    registers across rounds and computes MDS row k.  Per round it cubes
//    its lane into the team's slot of a shared-memory cube buffer (two
//    buffers, alternating by round, so one __syncthreads per round
//    suffices), then forms its row from all 12 cubes.  That cuts one
//    state's serial chain twelvefold and gives a launch twelve times as
//    many threads.  Threads past B run every round on zeros (they take
//    part in every barrier) and neither load nor store.  Teams of 1, 3,
//    4 and 6 threads (several lanes and rows per thread) were slower or
//    no faster at every batch (timed with the word-offset chains that
//    preceded acc_t, below).
//  * A lane is four 32-bit words.  Products and sums are carry chains in
//    inline PTX (mad.lo.cc / madc.hi.cc / addc.cc), one chain per asm
//    statement, since the carry flag does not live across statements.
//    An MDS row accumulates its 12 products and the round constant
//    without reduction in acc_t: partial products a_i*b_j with i+j even
//    go to word pairs aligned at 0, those with i+j odd to pairs aligned
//    at 1, so ptxas turns each (lo, hi) pair into one IMAD.WIDE.U32 with
//    carry and moves no word between pairs (chains that alternate the
//    pairing measured 1.2x slower: a third of their instructions were
//    moves).  Chain carries go to four counter words, folded in once per
//    row: 12*(p-1)^2 + (p-1) < 2^260 fits in nine words.  The square
//    shares its cross products.
//  * One reduction per row and per cube step: 2^128 = C (mod p) with
//    C = 45*2^40 - 1 = 11520*2^32 - 1, so h*C = (h*11520) << 32 - h: two
//    such folds and one conditional subtract, in words.
//  * The MDS (rows padded to 13 entries against bank conflicts) and the
//    round constants are staged in shared memory by each block.
//  * An asm input whose value equals the starting value of an in/out
//    operand (a literal 0 against a zeroed word) may share that operand's
//    register, so no literal is passed where an asm writes before it
//    reads: square8 produces its own top word.
//
// The word arithmetic is modelled instruction by instruction, carries
// included, in tests/test_torch_poseidon12_words.py.
//
// poseidon12_launch_one_thread keeps the port's first kernel (one thread
// per state, 64-bit words, emulated carries) as the yardstick that the
// team kernel is timed against; nothing but the smoke run calls it.

#include <cstdint>
#include <cuda_runtime.h>

typedef unsigned long long u64;

#define ZKL_C128 0x2CFFFFFFFFFFULL   // C = 45*2^40 - 1 = 2^128 mod p
#define ZKL_BLOCK 128

struct fe {
    u64 lo, hi;
};

__device__ __forceinline__ u64 addc(u64 a, u64 b, u64 &carry) {
    u64 s = a + b;
    carry += (s < a) ? 1ULL : 0ULL;
    return s;
}

// w[0..4] += a * b   (a, b < 2^128; w is a 320-bit accumulator)
__device__ __forceinline__ void mac(u64 (&w)[5], const fe a, const fe b) {
    u64 p00l = a.lo * b.lo, p00h = __umul64hi(a.lo, b.lo);
    u64 p01l = a.lo * b.hi, p01h = __umul64hi(a.lo, b.hi);
    u64 p10l = a.hi * b.lo, p10h = __umul64hi(a.hi, b.lo);
    u64 p11l = a.hi * b.hi, p11h = __umul64hi(a.hi, b.hi);
    // the four words of the product
    u64 c1 = 0;
    u64 r1 = addc(p00h, p01l, c1);
    r1 = addc(r1, p10l, c1);
    u64 c2 = 0;
    u64 r2 = addc(p01h, p10h, c2);
    r2 = addc(r2, p11l, c2);
    r2 = addc(r2, c1, c2);
    u64 r3 = p11h + c2;                 // product < 2^256: cannot wrap
    // accumulate with carries
    u64 ca = 0;
    w[0] = addc(w[0], p00l, ca);
    u64 cb = 0;
    w[1] = addc(w[1], ca, cb);
    w[1] = addc(w[1], r1, cb);
    ca = 0;
    w[2] = addc(w[2], cb, ca);
    w[2] = addc(w[2], r2, ca);
    cb = 0;
    w[3] = addc(w[3], ca, cb);
    w[3] = addc(w[3], r3, cb);
    w[4] += cb;
}

// canonical (w mod p) for a 320-bit value with w[4] < 2^8
__device__ __forceinline__ fe reduce5(const u64 (&w)[5]) {
    const u64 C = ZKL_C128;
    // fold 1: (w0,w1) + (w2 + w3*2^64 + w4*2^128) * C  ->  (t0,t1,t2)
    u64 q0l = w[2] * C, q0h = __umul64hi(w[2], C);
    u64 q1l = w[3] * C, q1h = __umul64hi(w[3], C);
    u64 q2 = w[4] * C;                  // < 2^54
    u64 ca = 0;
    u64 t0 = addc(w[0], q0l, ca);
    u64 cb = 0;
    u64 t1 = addc(w[1], ca, cb);
    t1 = addc(t1, q0h, cb);
    t1 = addc(t1, q1l, cb);
    u64 t2 = q1h + q2 + cb;             // < 2^55
    // fold 2: (t0,t1) + t2 * C, with t2 * C < 2^101
    u64 ul = t2 * C, uh = __umul64hi(t2, C);
    ca = 0;
    u64 r0 = addc(t0, ul, ca);
    cb = 0;
    u64 r1 = addc(t1, ca, cb);
    r1 = addc(r1, uh, cb);
    if (cb) {
        // wrapped past 2^128: the remainder is < 2^101, so adding C
        // for the lost 2^128 cannot wrap again
        ca = 0;
        r0 = addc(r0, C, ca);
        r1 += ca;
    }
    // p = 2^128 - C: r >= p  <=>  r1 all ones and r0 >= 2^64 - C
    if (r1 == ~0ULL && r0 >= (0ULL - C)) {
        r0 += C;                        // r - p = r + C - 2^128
        r1 = 0;
    }
    fe out;
    out.lo = r0;
    out.hi = r1;
    return out;
}

__device__ __forceinline__ fe mulmod(const fe a, const fe b) {
    u64 w[5] = {0, 0, 0, 0, 0};
    mac(w, a, b);
    return reduce5(w);
}

__device__ __forceinline__ u64 pack4(const int4 v) {
    return ((u64)(v.x & 0xFFFF)) | ((u64)(v.y & 0xFFFF) << 16)
         | ((u64)(v.z & 0xFFFF) << 32) | ((u64)(v.w & 0xFFFF) << 48);
}

__device__ __forceinline__ int4 unpack4(const u64 x) {
    int4 v;
    v.x = (int)(x & 0xFFFF);
    v.y = (int)((x >> 16) & 0xFFFF);
    v.z = (int)((x >> 32) & 0xFFFF);
    v.w = (int)((x >> 48) & 0xFFFF);
    return v;
}

extern "C" __global__ void __launch_bounds__(ZKL_BLOCK)
poseidon12_kernel(const int4 *__restrict__ in, int4 *__restrict__ out,
                  const int4 *__restrict__ mds, const int4 *__restrict__ rc,
                  long long B, int rounds) {
    // shared: 144 MDS entries, then rounds*12 round constants, as
    // (lo, hi) pairs of 64-bit words; then the block's states, word w of
    // lane i of thread t at st[(2*i + w) * ZKL_BLOCK + t] (each thread
    // reads and writes only its own column: no bank conflicts, no
    // synchronisation after the constants are in place)
    extern __shared__ u64 sm[];
    const int nconst = 144 + rounds * 12;
    for (int k = threadIdx.x; k < nconst; k += blockDim.x) {
        const int4 *src = (k < 144) ? (mds + 2 * k) : (rc + 2 * (k - 144));
        sm[2 * k] = pack4(src[0]);
        sm[2 * k + 1] = pack4(src[1]);
    }
    __syncthreads();

    const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    u64 *st = sm + 2 * nconst + threadIdx.x;

    const int4 *src = in + b * 24;
#pragma unroll
    for (int k = 0; k < 24; k++) {
        st[k * ZKL_BLOCK] = pack4(src[k]);
    }

    for (int r = 0; r < rounds; r++) {
        // x^3 on every lane, kept in registers for the whole MDS layer
        fe t[12];
#pragma unroll
        for (int i = 0; i < 12; i++) {
            fe x;
            x.lo = st[(2 * i) * ZKL_BLOCK];
            x.hi = st[(2 * i + 1) * ZKL_BLOCK];
            t[i] = mulmod(mulmod(x, x), x);
        }
        const u64 *rcr = sm + 288 + r * 24;
        // one MDS row per iteration, deliberately not unrolled: the body
        // (12 multiply-accumulates and one reduction) stays small enough
        // for the instruction cache and the register file
#pragma unroll 1
        for (int i = 0; i < 12; i++) {
            const u64 *row = sm + 24 * i;
            u64 w[5] = {rcr[2 * i], rcr[2 * i + 1], 0, 0, 0};
#pragma unroll
            for (int j = 0; j < 12; j++) {
                fe m;
                m.lo = row[2 * j];
                m.hi = row[2 * j + 1];
                mac(w, m, t[j]);
            }
            const fe y = reduce5(w);
            st[(2 * i) * ZKL_BLOCK] = y.lo;
            st[(2 * i + 1) * ZKL_BLOCK] = y.hi;
        }
    }

    int4 *dst = out + b * 24;
#pragma unroll
    for (int k = 0; k < 24; k++) {
        dst[k] = unpack4(st[k * ZKL_BLOCK]);
    }
}

// The yardstick: the one-thread-per-state kernel above, as the port's
// first slice shipped it.  Same contract as poseidon12_launch.
extern "C" int poseidon12_launch_one_thread(const void *in, void *out,
                                            const void *mds, const void *rc,
                                            long long B, int rounds,
                                            void *stream) {
    if (B == 0) return 0;
    const size_t smem = ((144 + (size_t)rounds * 12) * 2
                         + 24 * (size_t)ZKL_BLOCK) * sizeof(u64);
    if (B < 0 || rounds <= 0 || smem > 48 * 1024) {
        return (int)cudaErrorInvalidValue;
    }
    const unsigned grid = (unsigned)((B + ZKL_BLOCK - 1) / ZKL_BLOCK);
    poseidon12_kernel<<<grid, ZKL_BLOCK, smem, (cudaStream_t)stream>>>(
        (const int4 *)in, (int4 *)out, (const int4 *)mds, (const int4 *)rc,
        B, rounds);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The team kernel: 32-bit words, PTX carry chains, 12 threads per state.
// ---------------------------------------------------------------------------

typedef unsigned int u32;

#define ZKL_M 11520u           // C = ZKL_M * 2^32 - 1
#define ZKL_TEAM 12            // threads per state
#define ZKL_STATES 10          // states per block (120 threads)

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

// A row accumulator whose 64-bit partial products always land on the same
// aligned register pairs: products a_i*b_j with i+j even go to e (word
// positions 0..7, pairs from 0), those with i+j odd to o (positions 1..6,
// pairs from 1), so every (lo, hi) pair is one wide multiply-add and no
// word moves between pairs.  Chain carries go to counters at positions
// 5, 6, 7 and 8 (at most 2 each per product).
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

// canonical (w + top * 2^256) mod p, for w + top * 2^256 < 2^260
__device__ __forceinline__ uint4 reduce9(const u32 (&w)[8], u32 top) {
    const u32 m = ZKL_M;
    // fold 1: t = L + H*C = L + (H*m) << 32 - H, with L = w[0..3] and
    // H = (w[4..7], top) < 2^132; t < 2^178 fits six words
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
    // fold 2: (k, u) = t[0..3] + (t4 + t5*2^32) * C < 2^128 + 2^96, so the
    // bit k above 2^128 is 0 or 1
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
    // v = u + C with carry-out k2.  k = 1: the value is u + C (u < 2^96,
    // so v < p and k2 = 0).  k = 0: u >= p exactly when k2 = 1, and then
    // u - p = v.  So the result is v when k or k2, else u.
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

// x^2 as eight words and a top word (always 0, but produced by the asm:
// an asm input that equals the starting value of an in/out operand, such
// as a literal 0 against a zeroed word, may be given that operand's
// register, so no literal is ever passed to reduce9): the six cross
// products once, doubled, plus the four squares
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
    acc_words(s, w, top);               // x2 * x < 2^256: top is 0
    return reduce9(w, top);
}

// eight 16-bit digits (two int4) <-> four 32-bit words
__device__ __forceinline__ uint4 load_words(const int4 *p) {
    const int4 a = p[0], b = p[1];
    return make_uint4(
        (u32)(a.x & 0xFFFF) | ((u32)a.y << 16),
        (u32)(a.z & 0xFFFF) | ((u32)a.w << 16),
        (u32)(b.x & 0xFFFF) | ((u32)b.y << 16),
        (u32)(b.z & 0xFFFF) | ((u32)b.w << 16));
}

__device__ __forceinline__ void store_words(int4 *p, const uint4 v) {
    p[0] = make_int4((int)(v.x & 0xFFFF), (int)(v.x >> 16),
                     (int)(v.y & 0xFFFF), (int)(v.y >> 16));
    p[1] = make_int4((int)(v.z & 0xFFFF), (int)(v.z >> 16),
                     (int)(v.w & 0xFFFF), (int)(v.w >> 16));
}

// One state per team of 12 threads: thread k owns lane k and MDS row k.
// At least 8 blocks per SM (960 threads) leaves ptxas 64 registers.
extern "C" __global__ void __launch_bounds__(ZKL_TEAM * ZKL_STATES, 8)
poseidon12_team_kernel(const int4 *__restrict__ in, int4 *__restrict__ out,
                       const int4 *__restrict__ mds,
                       const int4 *__restrict__ rc, long long B,
                       int rounds) {
    // shared: MDS [12][13] (rows padded against bank conflicts), round
    // constants [rounds][12], cubes [2][ZKL_STATES][12], each entry four
    // words
    extern __shared__ uint4 sh[];
    uint4 *s_mds = sh;
    uint4 *s_rc = sh + 12 * 13;
    uint4 *s_cube = s_rc + rounds * 12;
    const int nconst = 144 + rounds * 12;
    for (int q = threadIdx.x; q < nconst; q += blockDim.x) {
        if (q < 144) {
            s_mds[(q / 12) * 13 + q % 12] = load_words(mds + 2 * q);
        } else {
            s_rc[q - 144] = load_words(rc + 2 * (q - 144));
        }
    }
    const int team = threadIdx.x / ZKL_TEAM;
    const int k = threadIdx.x - team * ZKL_TEAM;
    const long long b = (long long)blockIdx.x * ZKL_STATES + team;
    const bool live = b < B;
    uint4 x = live ? load_words(in + b * 24 + 2 * k) : make_uint4(0, 0, 0, 0);
    const uint4 *mrow = s_mds + k * 13;
    __syncthreads();

    for (int r = 0; r < rounds; r++) {
        uint4 *cb = s_cube + ((r & 1) * ZKL_STATES + team) * 12;
        cb[k] = cube(x);
        __syncthreads();
        // row k: round constant + sum_j mds[k][j] * cube_j, reduced once
        const uint4 c = s_rc[r * 12 + k];
        acc_t s;
        acc_zero(s);
        s.e[0] = c.x;
        s.e[1] = c.y;
        s.e[2] = c.z;
        s.e[3] = c.w;
#pragma unroll
        for (int j = 0; j < 12; j++) mac_aligned(s, mrow[j], cb[j]);
        u32 w[8], top;
        acc_words(s, w, top);
        x = reduce9(w, top);
    }
    if (live) store_words(out + b * 24 + 2 * k, x);
}

// The wrapper's entry.  One kernel for every batch: 12 threads per state
// measured fastest at every batch size the main path gives it, from 1
// state (the serial chain of one state's rounds is shortest) to 65,536
// (teams of 4, 6 and 12 ran within 5% of one another there), so the
// launcher has no rule to pick by.  Launches on the given stream,
// does not synchronise, allocates nothing; returns cudaGetLastError() as
// an int (0 = launched).
extern "C" int poseidon12_launch(const void *in, void *out, const void *mds,
                                 const void *rc, long long B, int rounds,
                                 void *stream) {
    if (B == 0) return 0;
    const size_t smem = (12 * 13 + (size_t)rounds * 12
                         + 2 * ZKL_STATES * 12) * sizeof(uint4);
    if (B < 0 || rounds <= 0 || smem > 48 * 1024) {    // rounds <= 223
        return (int)cudaErrorInvalidValue;
    }
    const long long grid = (B + ZKL_STATES - 1) / ZKL_STATES;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    poseidon12_team_kernel<<<(unsigned)grid, ZKL_TEAM * ZKL_STATES, smem,
                             (cudaStream_t)stream>>>(
        (const int4 *)in, (int4 *)out, (const int4 *)mds, (const int4 *)rc,
        B, rounds);
    return (int)cudaGetLastError();
}
