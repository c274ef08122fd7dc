// poseidon12: the full Poseidon2 t=12 permutation over the f128 field
// p = 2^128 - 45*2^40 + 1, one CUDA thread per state.
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
// What bounds it: integer multiplies.  A state moves 768 bytes but needs
// 168 field multiplies per round (24 for the cubes, 144 for the MDS),
// each a 128x128->256-bit schoolbook product of four 64x64 multiplies
// (lo and hi halves), so the kernel sits far on the operations side of
// the card's roofline.  What the design does about it: a lane is two
// 64-bit words; an MDS row accumulates 12 unreduced 256-bit products in
// five words and is reduced ONCE (2^128 = C mod p with the 46-bit
// C = 45*2^40 - 1: two folds and one conditional subtract); the MDS and
// round constants sit in shared memory where a warp reads one entry as a
// broadcast; the state rests in shared memory between layers so that
// only the 12 cubes are live in registers during the MDS layer, whose
// row loop is kept rolled (a fully unrolled round needed 255 registers
// and spilled).  Nothing here is tuned further.

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

// Plain C entry point (loaded with ctypes).  Launches on the given
// stream, does not synchronise, allocates nothing; returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int poseidon12_launch(const void *in, void *out, const void *mds,
                                 const void *rc, long long B, int rounds,
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
