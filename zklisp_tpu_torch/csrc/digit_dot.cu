// digit_dot: exact product of 8-bit digit planes on the integer tensor cores.
//
//   C[m, n] = sum_k A[m, k] * Wt[n, k]        A (M, K), Wt (N, K) 8-bit,
//                                             C (M, N) int32
//
// Replaces the Pallas probe kernel of the JAX package
// (scripts/exp_pallas_int8_dot.py, `kernel` inside `make`: one dot of 8-bit
// planes with 32-bit accumulation inside a kernel) and stands under every
// digit-plane product of field/mxu.py (`field_matmul`): the four-step NTT
// stages and the DEEP coefficient dot.  The callers keep K * 255^2 < 2^31,
// so signed 32-bit accumulation equals the unsigned sum.
//
// What bounds it: operations at the main path's NTT shapes (K = 512 or 2048
// against N = 2048 or 8192: 2*M*K*N integer operations at the card's
// 1,979 T/s dense INT8 rate outweigh the M*K + N*K + 4*M*N bytes), bytes at
// the DEEP shape (N = 32: the (M, K) operand is read once and that is the
// whole cost).
//
// The kernel the wrapper launches (digit_dot_launch) is built from Hopper's
// asynchronous parts, so that loads, products and stores overlap:
//
//  * A block computes a 128 x BN tile of C (BN = 256, 128, or 32 for
//    N <= 32, the DEEP dot: see launch_tc) with two roles: warp 8 is the
//    producer, warps 0-7 are two consumer warpgroups of 64 rows each.
//  * The producer's one thread issues TMA loads (cp.async.bulk.tensor) of
//    a 128 x 128-byte box of A and a BN x 128-byte box of Wt into a ring of
//    STAGES shared-memory stages.  Each stage has a "full" mbarrier (armed
//    with the stage's byte count: the TMA completes it) and an "empty" one
//    (the eight consumer warps arrive when their products have read it).
//    Boxes past M, N or K are filled with zeros by the TMA unit, which
//    gives the ragged edges for free.
//  * The boxes land in the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B);
//    each consumer warpgroup reads them through wgmma shared-memory
//    descriptors of the same swizzle (layout type 1, 8-row groups 1024 B
//    apart) and issues four wgmma.mma_async m64nBNk32 .s32.u8.u8 (or
//    .s8.s8) per stage, the descriptor's start address stepping 32 bytes
//    inside the swizzle row.  One group of products stays in flight while
//    the previous stage is released.  Both operands are K-major, the only
//    form 8-bit wgmma takes: that is why the weights arrive as (N, K).
//  * The s32 sums stay in registers until the end, then go through shared
//    memory (the drained ring, rows padded by 8 words so the fragment
//    writes hit 32 banks) and out as 16-byte stores, consecutive threads on
//    consecutive 16 bytes of a row: coalesced, masked at the ragged edges
//    (4-byte stores when N is not a multiple of 4).
//  * Shared memory: 193 KB for 128 x 256 tiles (4 stages, one block per
//    SM), 97 KB for 128 x 128 (3 stages) and 81 KB for 128 x 32 (4
//    stages), where two blocks fit on an SM and one block's epilogue
//    overlaps the other's main loop.
//
// The tensor maps are encoded on the host for each launch by
// cuTensorMapEncodeTiled, a driver-API function, fetched once through
// cudaGetDriverEntryPoint (nothing links against libcuda).  The kernel
// needs more than 48 KB of dynamic shared memory: the first launch of each
// tile on a device raises the kernel's limit with cudaFuncSetAttribute,
// whose error code is returned like the launch's.  The SM count that picks
// the tile is read once per device too, so a launch pays only its two map
// encodings on the host.
//
// The kernel the port shipped first (mma.sync.m16n8k32, one K step of 64
// bytes staged with 16-byte register loads between two __syncthreads, no
// overlap) stays in this file unchanged as a yardstick, behind its own
// entry point digit_dot_launch_mma_sync: chip_smoke.py times it beside the
// kernel above at the main path's shapes in one run.  The wrapper never
// calls it.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ===========================================================================
// The yardstick: the port's first kernel, unchanged (mma.sync.m16n8k32 from
// padded shared-memory rows, synchronous loads).
// ===========================================================================

constexpr int THREADS = 256;     // 8 warps
constexpr int BK = 64;           // bytes of K staged per step
constexpr int LDS = BK + 16;     // shared row stride (bytes), 20 words

template <bool SIGNED>
__device__ __forceinline__ void mma_m16n8k32(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    if (SIGNED) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
              "r"(b[0]), "r"(b[1]));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
              "r"(b[0]), "r"(b[1]));
    }
}

// ROWS x BK bytes of a K-contiguous matrix `g` (nrows x K) -> shared, as
// 16-byte vectors (4 per row); out-of-range vectors are zeros.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint8_t *s, const uint8_t *g,
                                          int row0, int nrows, int k0,
                                          int K) {
    for (int v = threadIdx.x; v < ROWS * (BK / 16); v += THREADS) {
        const int r = v / (BK / 16);
        const int kv = (v % (BK / 16)) * 16;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < nrows && k0 + kv < K) {
            val = *reinterpret_cast<const uint4 *>(
                g + (size_t)(row0 + r) * (size_t)K + (size_t)(k0 + kv));
        }
        *reinterpret_cast<uint4 *>(s + r * LDS + kv) = val;
    }
}

// Block tile: (WARPS_M * 32) rows x (WARPS_N * NT * 8) columns.
template <bool SIGNED, int WARPS_M, int WARPS_N, int NT>
__global__ void __launch_bounds__(THREADS)
digit_dot_kernel(const uint8_t *__restrict__ A,
                 const uint8_t *__restrict__ Wt, int *__restrict__ C,
                 int M, int N, int K) {
    static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
    constexpr int BM = WARPS_M * 32;
    constexpr int BN = WARPS_N * NT * 8;
    __shared__ __align__(16) uint8_t sA[BM * LDS];
    __shared__ __align__(16) uint8_t sB[BN * LDS];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp % WARPS_M;
    const int wn = warp / WARPS_M;
    const int g = lane >> 2;          // fragment row / column group
    const int t = lane & 3;           // position inside the group
    const int bm0 = blockIdx.x * BM;
    const int bn0 = blockIdx.y * BN;

    int acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; mt++)
#pragma unroll
        for (int nt = 0; nt < NT; nt++)
#pragma unroll
            for (int i = 0; i < 4; i++) acc[mt][nt][i] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
        load_tile<BM>(sA, A, bm0, M, k0, K);
        load_tile<BN>(sB, Wt, bn0, N, k0, K);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            // A fragment: a0 (row g, k 4t..4t+3), a1 (row g+8, same k),
            // a2 (row g, k+16), a3 (row g+8, k+16)
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; mt++) {
                const uint8_t *p =
                    sA + (wm * 32 + mt * 16 + g) * LDS + kk + t * 4;
                a[mt][0] = *reinterpret_cast<const uint32_t *>(p);
                a[mt][1] = *reinterpret_cast<const uint32_t *>(p + 8 * LDS);
                a[mt][2] = *reinterpret_cast<const uint32_t *>(p + 16);
                a[mt][3] =
                    *reinterpret_cast<const uint32_t *>(p + 8 * LDS + 16);
            }
#pragma unroll
            for (int nt = 0; nt < NT; nt++) {
                // B fragment: b0 (column g, k 4t..4t+3), b1 (k+16)
                const uint8_t *q =
                    sB + (wn * NT * 8 + nt * 8 + g) * LDS + kk + t * 4;
                uint32_t b[2];
                b[0] = *reinterpret_cast<const uint32_t *>(q);
                b[1] = *reinterpret_cast<const uint32_t *>(q + 16);
#pragma unroll
                for (int mt = 0; mt < 2; mt++) {
                    mma_m16n8k32<SIGNED>(acc[mt][nt], a[mt], b);
                }
            }
        }
        __syncthreads();
    }

    // C fragment: c0, c1 (row g, columns 2t, 2t+1), c2, c3 (row g+8)
#pragma unroll
    for (int mt = 0; mt < 2; mt++) {
#pragma unroll
        for (int nt = 0; nt < NT; nt++) {
            const int col = bn0 + wn * NT * 8 + nt * 8 + t * 2;
#pragma unroll
            for (int h = 0; h < 2; h++) {
                const int row = bm0 + wm * 32 + mt * 16 + g + h * 8;
                if (row < M) {
                    int *dst = C + (size_t)row * (size_t)N + col;
                    if (col < N) dst[0] = acc[mt][nt][2 * h];
                    if (col + 1 < N) dst[1] = acc[mt][nt][2 * h + 1];
                }
            }
        }
    }
}

template <bool SIGNED>
cudaError_t launch_mma(const uint8_t *A, const uint8_t *Wt, int *C, int M,
                       int N, int K, cudaStream_t stream) {
    if (N <= 32) {
        dim3 grid((M + 255) / 256, (N + 31) / 32);
        digit_dot_kernel<SIGNED, 8, 1, 4>
            <<<grid, THREADS, 0, stream>>>(A, Wt, C, M, N, K);
    } else {
        dim3 grid((M + 127) / 128, (N + 127) / 128);
        if (grid.y > 65535u) return cudaErrorInvalidValue;
        digit_dot_kernel<SIGNED, 4, 2, 8>
            <<<grid, THREADS, 0, stream>>>(A, Wt, C, M, N, K);
    }
    return cudaGetLastError();
}

// ===========================================================================
// TMA + mbarrier ring + wgmma: the kernel the wrapper launches.
// ===========================================================================

constexpr int TC_BM = 128;                 // rows of A per block
constexpr int TC_BK = 128;                 // bytes of K per stage: one
                                           // 128-byte swizzle row
constexpr int TC_CONSUMERS = 2;            // warpgroups of 64 rows
constexpr int TC_THREADS = TC_CONSUMERS * 128 + 32;   // + a producer warp

template <int BN, int STAGES>
struct TcTile {
    static constexpr int A_BYTES = TC_BM * TC_BK;
    static constexpr int STAGE_BYTES = (TC_BM + BN) * TC_BK;
    static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
    static constexpr int LDC = BN + 8;          // staging row, in words
    static constexpr int STAGING_BYTES = TC_CONSUMERS * 64 * LDC * 4;
    // 1024 of slack to align the ring (the swizzle repeats every 1024 B),
    // then the ring, then a full and an empty barrier per stage
    static constexpr int SMEM = 1024 + RING_BYTES + 2 * STAGES * 8;
    static_assert(STAGING_BYTES <= RING_BYTES, "staging fits the ring");
    static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                  "every box starts on a swizzle atom");
};

__device__ __forceinline__ void mbar_init(uint64_t *bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits for the phase after `parity` to complete.  A wait that outlasts
// 2^24 polls (far beyond any load or product) traps, so that a fault ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t *bar, uint32_t parity) {
    uint32_t done;
    for (uint32_t polls = 0;; polls++) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (done) return;
        if (polls == (1u << 24)) __trap();
    }
}

__device__ __forceinline__ void mbar_arrive(uint64_t *bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t *bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// box at (k byte, row) of `map` -> shared `dst`; completes on `bar`
__device__ __forceinline__ void tma_load(void *dst, const CUtensorMap *map,
                                         int k, int row, uint64_t *bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(k), "r"(row), "r"(smem_u32(bar))
        : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address >> 4 (bits 0-13), leading offset 1 (unused by
// this layout), stride between 8-row groups 1024 B >> 4 (bits 32-45),
// base offset 0 (boxes start on 1024-byte boundaries), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(const uint8_t *p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving accumulator accesses across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; i++) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B^T for one 64 x 32 x 32 step; T is the digit type, "u8" or
// "s8".  Thread i of the warpgroup holds, for each 8-column group j, d[4j],
// d[4j+1] at row 16*(i/32) + (i%32)/4, columns 8j + 2*(i%4) + {0, 1}, and
// d[4j+2], d[4j+3] eight rows below.
#define DD_WGMMA_N32(T)                                              \
    asm volatile(                                                    \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n32k32.s32." T "." T " {"   \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
        "%8, %9, %10, %11, %12, %13, %14, %15"                       \
        "}, %16, %17, p;\n}\n"                                       \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),            \
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),            \
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),          \
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])         \
        : "l"(da), "l"(db), "r"(1))

// the same for 64 x 128 x 32
#define DD_WGMMA_N128(T)                                             \
    asm volatile(                                                    \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                 \
        "wgmma.mma_async.sync.aligned.m64n128k32.s32." T "." T " {"  \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                   \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                   \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                   \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                   \
        "%56, %57, %58, %59, %60, %61, %62, %63"                     \
        "}, %64, %65, p;\n}\n"                                       \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),            \
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),            \
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),          \
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),        \
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),        \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),        \
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),        \
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),        \
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),        \
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),        \
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),        \
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),        \
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),        \
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),        \
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),        \
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])         \
        : "l"(da), "l"(db), "r"(1))

// and for 64 x 256 x 32
#define DD_WGMMA_N256(T)                                         \
    asm volatile(                                                \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"            \
        "wgmma.mma_async.sync.aligned.m64n256k32.s32." T "." T " {"\
        "%0, %1, %2, %3, %4, %5, %6, %7, "                       \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                 \
        "%16, %17, %18, %19, %20, %21, %22, %23, "               \
        "%24, %25, %26, %27, %28, %29, %30, %31, "               \
        "%32, %33, %34, %35, %36, %37, %38, %39, "               \
        "%40, %41, %42, %43, %44, %45, %46, %47, "               \
        "%48, %49, %50, %51, %52, %53, %54, %55, "               \
        "%56, %57, %58, %59, %60, %61, %62, %63, "               \
        "%64, %65, %66, %67, %68, %69, %70, %71, "               \
        "%72, %73, %74, %75, %76, %77, %78, %79, "               \
        "%80, %81, %82, %83, %84, %85, %86, %87, "               \
        "%88, %89, %90, %91, %92, %93, %94, %95, "               \
        "%96, %97, %98, %99, %100, %101, %102, %103, "           \
        "%104, %105, %106, %107, %108, %109, %110, %111, "       \
        "%112, %113, %114, %115, %116, %117, %118, %119, "       \
        "%120, %121, %122, %123, %124, %125, %126, %127"         \
        "}, %128, %129, p;\n}\n"                                 \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),        \
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),        \
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),      \
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),    \
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),    \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),    \
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),    \
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),    \
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),    \
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),    \
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),    \
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),    \
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),    \
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),    \
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),    \
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),    \
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),    \
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),    \
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),    \
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),    \
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),    \
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),    \
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),    \
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),    \
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),    \
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),\
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),\
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),\
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),\
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),\
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),\
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127]) \
        : "l"(da), "l"(db), "r"(1))

template <bool SIGNED, int BN>
__device__ __forceinline__ void wgmma_step(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
    if constexpr (BN == 32) {
        if constexpr (SIGNED) DD_WGMMA_N32("s8"); else DD_WGMMA_N32("u8");
    } else if constexpr (BN == 128) {
        if constexpr (SIGNED) DD_WGMMA_N128("s8"); else DD_WGMMA_N128("u8");
    } else {
        static_assert(BN == 256, "wgmma widths: 32, 128, 256");
        if constexpr (SIGNED) DD_WGMMA_N256("s8"); else DD_WGMMA_N256("u8");
    }
}

// BLOCKS_PER_SM: how many blocks the tile's shared memory lets an SM hold
// (the register limit follows from it)
template <bool SIGNED, int BN, int STAGES, int BLOCKS_PER_SM>
__global__ void __launch_bounds__(TC_THREADS, BLOCKS_PER_SM)
digit_dot_tc_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB,
                    int *__restrict__ C, int M, int N, int K) {
    using T = TcTile<BN, STAGES>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t *ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t *full = reinterpret_cast<uint64_t *>(ring + T::RING_BYTES);
    uint64_t *empty = full + STAGES;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int m0 = blockIdx.x * TC_BM;
    const int n0 = blockIdx.y * BN;
    const int nk = (K + TC_BK - 1) / TC_BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; s++) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], TC_CONSUMERS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == TC_CONSUMERS * 4) {
        // producer: stage s takes K step k once the consumers released
        // step k - STAGES (the first pass through the ring waits on nothing)
        if (lane == 0) {
            for (int k = 0; k < nk; k++) {
                const int s = k % STAGES;
                mbar_wait(&empty[s], ((k / STAGES) & 1) ^ 1);
                uint8_t *st = ring + s * T::STAGE_BYTES;
                mbar_expect_tx(&full[s], T::STAGE_BYTES);
                tma_load(st, &tmA, k * TC_BK, m0, &full[s]);
                tma_load(st + T::A_BYTES, &tmB, k * TC_BK, n0, &full[s]);
            }
        }
        return;
    }

    // consumers: warpgroup wg owns rows m0 + 64*wg .. + 63 of the tile
    const int wg = warp >> 2;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; i++) acc[i] = 0;
    for (int k = 0; k < nk; k++) {
        const int s = k % STAGES;
        mbar_wait(&full[s], (k / STAGES) & 1);
        const uint8_t *sa = ring + s * T::STAGE_BYTES + wg * 64 * TC_BK;
        const uint8_t *sb = ring + s * T::STAGE_BYTES + T::A_BYTES;
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TC_BK / 32; kk++) {
            wgmma_step<SIGNED, BN>(acc, smem_desc(sa + kk * 32),
                                   smem_desc(sb + kk * 32));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // step k - 1's products are done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(acc);
        if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);

    // epilogue: every consumer is past its last product, so the ring is
    // free; each warpgroup stages its 64 x BN sums there
    asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS * 128) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    int *stg = reinterpret_cast<int *>(ring) + wg * 64 * T::LDC;
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; j++) {
        *reinterpret_cast<int2 *>(stg + r0 * T::LDC + 8 * j + c0) =
            make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2 *>(stg + (r0 + 8) * T::LDC + 8 * j + c0) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");

    const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
    constexpr int VPR = BN / 4;                 // 16-byte vectors per row
    for (int v = threadIdx.x & 127; v < 64 * VPR; v += 128) {
        const int r = v / VPR;
        const int c = (v % VPR) * 4;
        const int row = m0 + wg * 64 + r;
        const int col = n0 + c;
        if (row >= M || col >= N) continue;
        const int4 val = *reinterpret_cast<const int4 *>(stg + r * T::LDC + c);
        int *dst = C + (size_t)row * (size_t)N + col;
        if (vec) {
            *reinterpret_cast<int4 *>(dst) = val;
        } else {
            dst[0] = val.x;
            if (col + 1 < N) dst[1] = val.y;
            if (col + 2 < N) dst[2] = val.z;
            if (col + 3 < N) dst[3] = val.w;
        }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap *, CUtensorMapDataType,
                                  cuuint32_t, void *, const cuuint64_t *,
                                  const cuuint64_t *, const cuuint32_t *,
                                  const cuuint32_t *, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void *p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiledFn>(p);
        }
    }
    return fn;
}

// Map of a K-contiguous (rows, K) byte matrix in boxes of box_rows x TC_BK
// bytes, 128-byte swizzle; reads past the matrix fill zeros.  Returns 0,
// a positive CUDA error, or minus the driver's CUresult.
int encode_map(CUtensorMap *map, const void *base, int rows, int K,
               int box_rows) {
    const EncodeTiledFn fn = tensor_map_encoder();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)TC_BK, (cuuint32_t)box_rows};
    const cuuint32_t elem_strides[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                          const_cast<void *>(base), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Per-device values read once per process (devices past the table are
// read on every launch).
constexpr int MAX_DEVICES = 64;

template <bool SIGNED, int BN, int STAGES, int BLOCKS_PER_SM>
int launch_tc_tile(const uint8_t *A, const uint8_t *Wt, int *C, int M,
                   int N, int K, int dev, cudaStream_t stream) {
    using T = TcTile<BN, STAGES>;
    static std::atomic<bool> smem_set[MAX_DEVICES];
    auto kernel = digit_dot_tc_kernel<SIGNED, BN, STAGES, BLOCKS_PER_SM>;
    const dim3 grid((M + TC_BM - 1) / TC_BM, (N + BN - 1) / BN);
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    int err = encode_map(&ta, A, M, K, TC_BM);
    if (err == 0) err = encode_map(&tb, Wt, N, K, BN);
    if (err != 0) return err;
    if (dev >= MAX_DEVICES || !smem_set[dev].load()) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (e != cudaSuccess) return (int)e;
        if (dev < MAX_DEVICES) smem_set[dev].store(true);
    }
    kernel<<<grid, TC_THREADS, T::SMEM, stream>>>(ta, tb, C, M, N, K);
    return (int)cudaGetLastError();
}

// SM count of device `dev` -> *sms; returns the CUDA error code
int sm_count(int dev, int *sms) {
    static std::atomic<int> cache[MAX_DEVICES];
    if (dev < MAX_DEVICES && (*sms = cache[dev].load()) > 0) return 0;
    const cudaError_t e =
        cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < MAX_DEVICES) cache[dev].store(*sms);
    return (int)e;
}

// Tile choice.  N <= 32 (the DEEP dot): 128 x 32, 4 stages, two blocks per
// SM (a wider tile would multiply zeros and stage more weights).  A grid
// that fills every SM at least twice over with 128 x 256 tiles takes those
// (4 stages, 193 KB, one block per SM): half the operand bytes per product
// of the 128 x 128 tile.  Smaller grids take 128 x 128 tiles (3 stages,
// 97 KB, two blocks per SM): more blocks, and one block's epilogue
// overlaps the other's main loop.
template <bool SIGNED>
int launch_tc(const uint8_t *A, const uint8_t *Wt, int *C, int M, int N,
              int K, cudaStream_t stream) {
    int dev = 0, sms = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err == 0 && N <= 32) {
        return launch_tc_tile<SIGNED, 32, 4, 2>(A, Wt, C, M, N, K, dev,
                                                stream);
    }
    if (err == 0) err = sm_count(dev, &sms);
    if (err != 0) return err;
    const long long wide_tiles =
        (long long)((M + TC_BM - 1) / TC_BM) * ((N + 255) / 256);
    if (wide_tiles >= 2LL * sms) {
        return launch_tc_tile<SIGNED, 256, 4, 1>(A, Wt, C, M, N, K, dev,
                                                 stream);
    }
    return launch_tc_tile<SIGNED, 128, 3, 2>(A, Wt, C, M, N, K, dev, stream);
}

// the operands' contract of both entry points
bool valid(const void *A, const void *Wt, const void *C, int M, int N,
           int K) {
    return M > 0 && N > 0 && K > 0 && (K % 32) == 0 &&
           (reinterpret_cast<uintptr_t>(A) & 15u) == 0 &&
           (reinterpret_cast<uintptr_t>(Wt) & 15u) == 0 &&
           (reinterpret_cast<uintptr_t>(C) & 3u) == 0;
}

}  // namespace

// A (M, K) and Wt (N, K) 8-bit, both K-contiguous and 16-byte aligned, K a
// multiple of 32; C (M, N) int32.  The wrapper's entry point: the TMA +
// wgmma kernel.  Returns 0 once the kernel is launched, else a positive
// CUDA error code or minus the CUresult of a failed tensor-map encoding.
extern "C" int digit_dot_launch(const void *A, const void *Wt, void *C,
                                int M, int N, int K, int is_signed,
                                void *stream) {
    if (!valid(A, Wt, C, M, N, K)) return (int)cudaErrorInvalidValue;
    const uint8_t *a = static_cast<const uint8_t *>(A);
    const uint8_t *w = static_cast<const uint8_t *>(Wt);
    int *c = static_cast<int *>(C);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_signed ? launch_tc<true>(a, w, c, M, N, K, s)
                     : launch_tc<false>(a, w, c, M, N, K, s);
}

// The same contract and function through the yardstick, the port's first
// kernel (mma.sync, no pipeline); only chip_smoke.py calls it.  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int digit_dot_launch_mma_sync(const void *A, const void *Wt,
                                         void *C, int M, int N, int K,
                                         int is_signed, void *stream) {
    if (!valid(A, Wt, C, M, N, K)) return (int)cudaErrorInvalidValue;
    const uint8_t *a = static_cast<const uint8_t *>(A);
    const uint8_t *w = static_cast<const uint8_t *>(Wt);
    int *c = static_cast<int *>(C);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(is_signed ? launch_mma<true>(a, w, c, M, N, K, s)
                           : launch_mma<false>(a, w, c, M, N, K, s));
}
