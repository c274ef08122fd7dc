// Native host kernels for f128 trace generation.
//
// The trace *content* generation is host-side (mirroring the reference,
// whose Rust backend fills traces on CPU; SURVEY.md §7.3).  These kernels
// accelerate the sequential host loops that Python cannot vectorize:
//   * the t=3 ROM accumulator chain across levels (rom.rs RomTraceBuilder)
//   * per-level t=12 Poseidon permutations with recorded round states
//     (trace/poseidon.rs apply_level_absorb)
//   * batch modular multiply for general host-side field math
//
// Field: p = 2^128 - 45*2^40 + 1 (winterfell f128).  Elements cross the
// FFI boundary as 16-byte little-endian values.
//
// Build: g++ -O3 -shared -fPIC (no external deps); loaded via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// C = 45*2^40 - 1 = 0x2CFFFFFFFFFF
static const u128 C128 = (((u128)0x2CFFULL) << 32) | 0xFFFFFFFFULL;
// p = 2^128 - C
static const u128 P_LO_MASK = ~(u128)0;

static inline u128 make_p() { return (u128)0 - C128; }  // 2^128 - C mod 2^128

// Modular reduction of a 256-bit value (hi:lo) mod p, using
// 2^128 ≡ C (mod p).
static inline u128 reduce256(u128 hi, u128 lo) {
    // fold 1: hi * C + lo  (hi*C < 2^174)
    u64 h_lo = (u64)hi, h_hi = (u64)(hi >> 64);
    // C fits in 46 bits
    u64 c = (u64)C128;
    u128 p0 = (u128)h_lo * c;            // < 2^110
    u128 p1 = (u128)h_hi * c;            // < 2^110, shifted by 64
    u128 mid = p1 + (p0 >> 64);
    u128 sum_lo = ((u128)(u64)p0) + lo;  // may wrap past 2^128
    u128 carry = (mid >> 64);
    if (sum_lo < lo) carry += 1;         // wrap of low-part addition
    u128 add_a = mid << 64;
    u128 t_lo = add_a + sum_lo;          // low 128 of hi*C + lo
    if (t_lo < add_a) carry += 1;        // wrap of the final addition
    // value = carry*2^128 + t_lo;  carry < 2^47
    // fold 2: carry * C + t_lo
    u128 t2 = (u128)(u64)carry * (u128)(u64)C128;  // carry<2^47, C<2^46 -> <2^93
    u128 r = t_lo + t2;
    if (r < t_lo) {
        // wrapped: add C once more
        r += C128;
    }
    const u128 P = make_p();
    if (r >= P) r -= P;
    return r;
}

static inline u128 mulmod(u128 a, u128 b) {
    u64 a0 = (u64)a, a1 = (u64)(a >> 64);
    u64 b0 = (u64)b, b1 = (u64)(b >> 64);
    u128 p00 = (u128)a0 * b0;
    u128 p01 = (u128)a0 * b1;
    u128 p10 = (u128)a1 * b0;
    u128 p11 = (u128)a1 * b1;
    // 256-bit accumulate
    u128 mid = p01 + p10;                  // may carry
    u128 mid_carry = (mid < p01) ? ((u128)1 << 64) : 0;
    u128 lo = p00 + (mid << 64);
    u128 lo_carry = (lo < p00) ? 1 : 0;
    u128 hi = p11 + (mid >> 64) + mid_carry + lo_carry;
    return reduce256(hi, lo);
}

static inline u128 addmod(u128 a, u128 b) {
    const u128 P = make_p();
    u128 s = a + b;
    if (s < a) {           // wrapped past 2^128: add C
        s += C128;
        if (s >= P) s -= P;
        return s;
    }
    if (s >= P) s -= P;
    return s;
}

static inline u128 load_le(const uint8_t* p) {
    u128 v;
    memcpy(&v, p, 16);     // little-endian host assumed (x86-64 / aarch64)
    return v;
}

static inline void store_le(uint8_t* p, u128 v) {
    memcpy(p, &v, 16);
}

extern "C" {

// out[i] = a[i] * b[i] mod p
void f128_mul_batch(const uint8_t* a, const uint8_t* b, uint8_t* out,
                    size_t n) {
    for (size_t i = 0; i < n; i++) {
        store_le(out + 16 * i,
                 mulmod(load_le(a + 16 * i), load_le(b + 16 * i)));
    }
}

// out[i] = a[i] + b[i] mod p
void f128_add_batch(const uint8_t* a, const uint8_t* b, uint8_t* out,
                    size_t n) {
    for (size_t i = 0; i < n; i++) {
        store_le(out + 16 * i,
                 addmod(load_le(a + 16 * i), load_le(b + 16 * i)));
    }
}

// ROM t=3 accumulator chain (rom.rs RomTraceBuilder semantics).
//
// enc: levels*2 elements [enc0_l, enc1_l]; mds: 9; rc: rounds*3.
// states_out: levels*(rounds+1)*3 elements — state before each round
// (j = 0..rounds-1) plus the final state per level.  s0 chains across
// levels.
// Like rom_chain but starting the s0 lane from a caller-provided value
// (streamed per-segment trace builds restart the chain mid-program).
void rom_chain_from(const uint8_t* enc, const uint8_t* mds,
                    const uint8_t* rc, size_t levels, size_t rounds,
                    const uint8_t* s0_init, uint8_t* states_out) {
    u128 m[9];
    for (int i = 0; i < 9; i++) m[i] = load_le(mds + 16 * i);
    u128 s0_prev = load_le(s0_init);
    for (size_t lvl = 0; lvl < levels; lvl++) {
        u128 s[3] = {s0_prev, load_le(enc + 16 * (2 * lvl)),
                     load_le(enc + 16 * (2 * lvl + 1))};
        uint8_t* base = states_out + 16 * 3 * (rounds + 1) * lvl;
        for (size_t j = 0; j < rounds; j++) {
            for (int i = 0; i < 3; i++)
                store_le(base + 16 * (3 * j + i), s[i]);
            u128 s3[3];
            for (int i = 0; i < 3; i++) {
                u128 v2 = mulmod(s[i], s[i]);
                s3[i] = mulmod(v2, s[i]);
            }
            const uint8_t* rcj = rc + 16 * 3 * j;
            u128 y[3];
            for (int i = 0; i < 3; i++) {
                u128 acc = mulmod(m[3 * i], s3[0]);
                acc = addmod(acc, mulmod(m[3 * i + 1], s3[1]));
                acc = addmod(acc, mulmod(m[3 * i + 2], s3[2]));
                y[i] = addmod(acc, load_le(rcj + 16 * i));
            }
            s[0] = y[0]; s[1] = y[1]; s[2] = y[2];
        }
        for (int i = 0; i < 3; i++)
            store_le(base + 16 * (3 * rounds + i), s[i]);
        s0_prev = s[0];
    }
}

void rom_chain(const uint8_t* enc, const uint8_t* mds, const uint8_t* rc,
               size_t levels, size_t rounds, uint8_t* states_out) {
    uint8_t zero[16] = {0};
    rom_chain_from(enc, mds, rc, levels, rounds, zero, states_out);
}

// Batched t=12 Poseidon2 permutations with recorded round states.
//
// inputs: levels*12 initial states; mds: 144; rc: rounds*12.
// states_out: levels*(rounds+1)*12 — state before each round plus final.
void poseidon12_levels(const uint8_t* inputs, const uint8_t* mds,
                       const uint8_t* rc, size_t levels, size_t rounds,
                       uint8_t* states_out) {
    u128 m[144];
    for (int i = 0; i < 144; i++) m[i] = load_le(mds + 16 * i);
    for (size_t lvl = 0; lvl < levels; lvl++) {
        u128 s[12];
        for (int i = 0; i < 12; i++)
            s[i] = load_le(inputs + 16 * (12 * lvl + i));
        uint8_t* base = states_out + 16 * 12 * (rounds + 1) * lvl;
        for (size_t j = 0; j < rounds; j++) {
            for (int i = 0; i < 12; i++)
                store_le(base + 16 * (12 * j + i), s[i]);
            u128 s3[12];
            for (int i = 0; i < 12; i++) {
                u128 v2 = mulmod(s[i], s[i]);
                s3[i] = mulmod(v2, s[i]);
            }
            const uint8_t* rcj = rc + 16 * 12 * j;
            u128 y[12];
            for (int i = 0; i < 12; i++) {
                u128 acc = 0;
                const u128* row = m + 12 * i;
                for (int k = 0; k < 12; k++)
                    acc = addmod(acc, mulmod(row[k], s3[k]));
                y[i] = addmod(acc, load_le(rcj + 16 * i));
            }
            for (int i = 0; i < 12; i++) s[i] = y[i];
        }
        for (int i = 0; i < 12; i++)
            store_le(base + 16 * (12 * rounds + i), s[i]);
    }
}

// One contiguous range of the t=12 batch (worker body; see
// poseidon12_batch below for the threaded dispatcher).
static void poseidon12_range(const u128* m, const uint8_t* inputs,
                             const uint8_t* rc, size_t lo, size_t hi,
                             size_t rounds, uint8_t* out) {
    for (size_t b = lo; b < hi; b++) {
        u128 s[12];
        for (int i = 0; i < 12; i++)
            s[i] = load_le(inputs + 16 * (12 * b + i));
        for (size_t j = 0; j < rounds; j++) {
            u128 s3[12];
            for (int i = 0; i < 12; i++) {
                u128 v2 = mulmod(s[i], s[i]);
                s3[i] = mulmod(v2, s[i]);
            }
            const uint8_t* rcj = rc + 16 * 12 * j;
            u128 y[12];
            for (int i = 0; i < 12; i++) {
                u128 acc = 0;
                const u128* row = m + 12 * i;
                for (int k = 0; k < 12; k++)
                    acc = addmod(acc, mulmod(row[k], s3[k]));
                y[i] = addmod(acc, load_le(rcj + 16 * i));
            }
            for (int i = 0; i < 12; i++) s[i] = y[i];
        }
        for (int i = 0; i < 12; i++)
            store_le(out + 16 * (12 * b + i), s[i]);
    }
}

// Batched t=12 permutations, final states only (digest workloads:
// Fiat-Shamir draws, grinding, Merkle hashing on the host path).
// Large batches split across hardware threads (ctypes releases the
// GIL around the call, so the split is a real speedup).
void poseidon12_batch(const uint8_t* inputs, const uint8_t* mds,
                      const uint8_t* rc, size_t batch, size_t rounds,
                      uint8_t* out) {
    u128 m[144];
    for (int i = 0; i < 144; i++) m[i] = load_le(mds + 16 * i);
    size_t hw = std::thread::hardware_concurrency();
    size_t nthreads = (batch >= 512 && hw > 1)
        ? std::min<size_t>(hw, 8) : 1;
    if (nthreads <= 1) {
        poseidon12_range(m, inputs, rc, 0, batch, rounds, out);
        return;
    }
    std::vector<std::thread> ts;
    size_t per = (batch + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; t++) {
        size_t lo = t * per;
        size_t hi = std::min(batch, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(poseidon12_range, m, inputs, rc, lo, hi,
                        rounds, out);
    }
    for (auto& th : ts) th.join();
}

}  // extern "C"
