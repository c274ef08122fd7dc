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
// The instruction is mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 (the
// s8 form is the template's other value).  "row.col" wants both operands
// with K contiguous, which is why the weights arrive transposed (N, K).
//
// What bounds it: operations at the main path's NTT shapes (K = 512 or 2048
// against N = 2048 or 8192: 2*M*K*N integer operations at the card's
// 1,979 T/s dense INT8 rate outweigh the M*K + N*K + 4*M*N bytes), bytes at
// the DEEP shape (N = 32: the (M, K) operand is read once and that is the
// whole cost).  This version is the simple one: a block of 8 warps stages a
// BM x 64 tile of A and a BN x 64 tile of Wt in shared memory with 16-byte
// loads, every warp holds a 32 x (NT*8) tile of C in registers, and the
// fragments are read from shared memory as 32-bit words (rows padded to 80
// bytes, which spreads the 8 rows x 4 words of one fragment read over all
// 32 banks).  No wgmma, TMA or pipelining: the loads and the mma's of one
// K step do not overlap.  Two tile shapes: 128 x 128 for wide N, 256 x 32
// for N <= 32 (the DEEP dot), where a 128-wide tile would multiply zeros.
//
// Edges: rows past M or N load as zeros and are not stored; K must be a
// multiple of 32 (the wrapper pads with zeros), and a K step past K loads
// zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
cudaError_t launch(const uint8_t *A, const uint8_t *Wt, int *C, int M, int N,
                   int K, cudaStream_t stream) {
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

}  // namespace

// A (M, K) and Wt (N, K) 8-bit, both K-contiguous and 16-byte aligned, K a
// multiple of 32; C (M, N) int32.  Returns the CUDA error code of the
// launch (0 = launched).
extern "C" int digit_dot_launch(const void *A, const void *Wt, void *C,
                                int M, int N, int K, int is_signed,
                                void *stream) {
    if (M <= 0 || N <= 0 || K <= 0 || (K % 32) != 0 ||
        (reinterpret_cast<uintptr_t>(A) & 15u) != 0 ||
        (reinterpret_cast<uintptr_t>(Wt) & 15u) != 0 ||
        (reinterpret_cast<uintptr_t>(C) & 3u) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const uint8_t *a = static_cast<const uint8_t *>(A);
    const uint8_t *w = static_cast<const uint8_t *>(Wt);
    int *c = static_cast<int *>(C);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(is_signed ? launch<true>(a, w, c, M, N, K, s)
                           : launch<false>(a, w, c, M, N, K, s));
}
