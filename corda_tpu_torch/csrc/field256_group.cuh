// 256-bit prime-field arithmetic spread over a group of TPI lanes of a
// warp (wei_ladder.cu, ed_ladder.cu, ed_ends.cu, wei_ends.cu): one field
// element per group, lane g holding words g*WPL .. g*WPL + WPL - 1 of it.
//
// The representation and contracts are field256.cuh's (8 x 32-bit words,
// fully reduced to [0, m) for the modulus m, p or the group order n;
// gfe_mul, the R = 2^256 Montgomery product, needs a * b < m * 2^256),
// with the words spread over the group instead of held by one thread.
// Every gfe_* result is < m; gfe_mul takes one operand up to 2^256 - 1
// if the other is < m (wei_ends.cu multiplies raw record values so), and
// gfe_sqr needs a < m. That holds for the secp moduli close to 2^256 and
// for p = 2^255 - 19 (where a + b < 2p < 2^256 never carries out of the
// top word either). gfe_add and gfe_sub serve any domain; the Edwards
// kernels (ed_ladder.cu, ed_ends.cu) multiply with gfe_mul_25519, the
// special-form product mod 2^255 - 19 of plain (not Montgomery) values,
// and ed_ends.cu squares with gfe_sqr_25519. gfe_sqr, the Montgomery
// square, is held against gfe_mul on the host, but no kernel takes it:
// in wei_ends.cu's power it ran ~5% slower than gfe_mul(a, a) on the
// H100 (PERF.md). Nothing is kept in memory: every function works in
// registers, and lanes exchange words by shuffle within the group.
//
// Carries between lanes. Each operation first adds (or subtracts) within
// every lane, then resolves the carries between lanes once: a lane reports
// whether its words generate a carry out (gen) and whether they would pass
// an incoming one on (prop: all ones after an add, all zeros after a
// subtract; never both), by two ballots of the warp, shifted down to the
// group's first lane. The carry into lane i is then bit i of
// ((G << 1) + P) ^ P, and bit TPI is the carry out of the element
// (group_carries); the warp's later groups sit above bit TPI, and since
// carries only move up, they change none of bits 0..TPI. gfe_mul keeps
// one lazy carry word per lane through its eight rounds and resolves
// once at the end.
//
// Cost per lane: gfe_mul is 8 rounds of 3 shuffles (b[i] broadcast, m
// broadcast, the accumulator's shift down one lane) and 2 * WPL 32x32->64
// multiply-adds, then 1 shuffle and 4 ballots (the carries, the
// conditional subtract of p): 16 dependent shuffles. gfe_sqr gathers the
// operand (8 independent shuffles), forms 4.5 * WPL products, and reduces
// a lane's WPL words per round: TPI rounds of 2 * WPL shuffles (m
// broadcast, the shift down one lane), 8 dependent shuffles in all, then
// 2 shuffles and 4 ballots; gfe_mul_25519 16 independent shuffles (the
// operands), 8 * WPL products, 2 shuffles and 4 ballots; gfe_sqr_25519
// 8 shuffles (the operand), 16 selects, 4.5 * WPL products, 2 shuffles
// and 4 ballots; gfe_add and gfe_sub 4 ballots each. TPI = 4 serves two
// words per lane with the same shuffles and ran 5-16% faster than TPI =
// 8 on the H100 (PERF.md); gfe_mul_25519 needs WPL >= 2, the squarings
// an even WPL. ptxas already overlaps independent calls: interleaving
// them by hand measured slower.
//
// Every lane of the warp must reach every call (the shuffles and ballots
// use the full mask): no call may sit behind a lane-dependent branch.

#pragma once

#include "field256.cuh"

#define TPI 4                        // lanes per field element: 4 (8: not the 25519 ops)
#define WPL (NW / TPI)               // words per lane
#define FULL_WARP 0xffffffffu

// a lane's view of the field: its words of p, and where it sits
struct GroupField {
    uint32_t p[WPL];   // words g*WPL .. g*WPL + WPL - 1 of p
    uint32_t pinv;     // -p^-1 mod 2^32
    int g;             // lane within the group
    int base;          // the group's first lane within the warp
};

// this lane's words of an 8-word constant (unrolled selects: a constant
// indexed by lane would be copied to local memory)
__device__ __forceinline__ void lane_words(uint32_t r[WPL], const uint32_t w[NW], int g) {
#pragma unroll
    for (int i = 0; i < NW; ++i)
        if (i / WPL == g) r[i % WPL] = w[i];
}

template <class Params>
__device__ __forceinline__ GroupField group_field(const Params& P) {
    GroupField F;
    const int lane = threadIdx.x % 32;
    F.g = lane % TPI;
    F.base = lane - F.g;
    F.pinv = P.pinv;
    lane_words(F.p, P.p, F.g);
    return F;
}

// r = c ? a : b, c the same in every lane of the group (r may alias either)
__device__ __forceinline__ void lane_select(uint32_t r[WPL], bool c, const uint32_t a[WPL],
                                            const uint32_t b[WPL]) {
#pragma unroll
    for (int k = 0; k < WPL; ++k) r[k] = c ? a[k] : b[k];
}

// carry into each lane of the group (bit i for lane i, bit TPI out of the
// top; higher bits are meaningless) from every lane's generate and
// propagate flags
__device__ __forceinline__ uint32_t group_carries(bool gen, bool prop, const GroupField& F) {
    const uint32_t G = __ballot_sync(FULL_WARP, gen) >> F.base;
    const uint32_t Pr = __ballot_sync(FULL_WARP, prop) >> F.base;
    return ((G << 1) + Pr) ^ Pr;
}

__device__ __forceinline__ void add_bit(uint32_t r[WPL], uint32_t bit) {
    uint64_t c = bit;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        c += r[k];
        r[k] = (uint32_t)c;
        c >>= 32;
    }
}

__device__ __forceinline__ void sub_bit(uint32_t r[WPL], uint32_t bit) {
    uint64_t br = bit;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        const uint64_t x = (uint64_t)r[k] - br;
        r[k] = (uint32_t)x;
        br = (x >> 32) & 1;
    }
}

// r = t - p if t (with the bit `hi` at 2^256) >= p, else t
__device__ __forceinline__ void gfe_cond_sub_p(uint32_t r[WPL], const uint32_t t[WPL],
                                               uint32_t hi, const GroupField& F) {
    uint32_t d[WPL];
    uint64_t br = 0;
    uint32_t nz = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        const uint64_t x = (uint64_t)t[k] - F.p[k] - br;
        d[k] = (uint32_t)x;
        br = (x >> 32) & 1;
        nz |= d[k];
    }
    const uint32_t bin = group_carries(br != 0, nz == 0, F);
    sub_bit(d, (bin >> F.g) & 1);
    const bool use_d = hi != 0 || ((bin >> TPI) & 1) == 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) r[k] = use_d ? d[k] : t[k];
}

__device__ __forceinline__ void gfe_add(uint32_t r[WPL], const uint32_t a[WPL],
                                        const uint32_t b[WPL], const GroupField& F) {
    uint32_t s[WPL];
    uint64_t c = 0;
    uint32_t ones = FULL_WARP;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        c += (uint64_t)a[k] + b[k];
        s[k] = (uint32_t)c;
        c >>= 32;
        ones &= s[k];
    }
    const uint32_t cin = group_carries(c != 0, ones == FULL_WARP, F);
    add_bit(s, (cin >> F.g) & 1);
    gfe_cond_sub_p(r, s, (cin >> TPI) & 1, F);
}

__device__ __forceinline__ void gfe_sub(uint32_t r[WPL], const uint32_t a[WPL],
                                        const uint32_t b[WPL], const GroupField& F) {
    uint32_t d[WPL];
    uint64_t br = 0;
    uint32_t nz = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        const uint64_t x = (uint64_t)a[k] - b[k] - br;
        d[k] = (uint32_t)x;
        br = (x >> 32) & 1;
        nz |= d[k];
    }
    const uint32_t bin = group_carries(br != 0, nz == 0, F);
    sub_bit(d, (bin >> F.g) & 1);
    const uint32_t mask = 0u - ((bin >> TPI) & 1);   // add p back on borrow
    uint64_t c = 0;
    uint32_t ones = FULL_WARP;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        c += (uint64_t)d[k] + (F.p[k] & mask);
        d[k] = (uint32_t)c;
        c >>= 32;
        ones &= d[k];
    }
    const uint32_t cin = group_carries(c != 0, ones == FULL_WARP, F);
    add_bit(d, (cin >> F.g) & 1);   // the carry out of the top cancels the borrow
#pragma unroll
    for (int k = 0; k < WPL; ++k) r[k] = d[k];
}

// Montgomery product a*b*2^-256 mod p, CIOS over the group: round i
// broadcasts b's word i, adds a*b[i] and m*p (m from lane 0's low word)
// within each lane, and shifts the accumulator down one word, the lane's
// low word moving to the lane below. The carries out of a lane's words
// stay in its lazy carry word c (at most 3) until the end.
__device__ __forceinline__ void gfe_mul(uint32_t r[WPL], const uint32_t a[WPL],
                                        const uint32_t b[WPL], const GroupField& F) {
    uint32_t t[WPL];
#pragma unroll
    for (int k = 0; k < WPL; ++k) t[k] = 0;
    uint32_t c = 0;   // carry at the word above the lane's top word
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const uint32_t bi = __shfl_sync(FULL_WARP, b[i % WPL], i / WPL, TPI);
        uint64_t x = 0;
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
            x += (uint64_t)a[k] * bi + t[k];
            t[k] = (uint32_t)x;
            x >>= 32;
        }
        const uint32_t m = __shfl_sync(FULL_WARP, t[0], 0, TPI) * F.pinv;
        uint64_t y = 0;
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
            y += (uint64_t)m * F.p[k] + t[k];
            t[k] = (uint32_t)y;
            y >>= 32;
        }
        const uint32_t up = __shfl_down_sync(FULL_WARP, t[0], 1, TPI);
        const uint64_t top = (uint64_t)(F.g == TPI - 1 ? 0u : up) + x + y + c;
#pragma unroll
        for (int k = 0; k + 1 < WPL; ++k) t[k] = t[k + 1];
        t[WPL - 1] = (uint32_t)top;
        c = (uint32_t)(top >> 32);
    }
    // the value is sum(t) + sum(c at the word above each lane) < 2p: add
    // the lane below's carry, then resolve; the top lane's carry is the bit
    // at 2^256, which gen carries out of the element
    const uint32_t below = __shfl_up_sync(FULL_WARP, c, 1, TPI);
    uint64_t z = F.g == 0 ? 0u : below;
    uint32_t ones = FULL_WARP;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        z += t[k];
        t[k] = (uint32_t)z;
        z >>= 32;
        ones &= t[k];
    }
    const bool gen = z != 0 || (F.g == TPI - 1 && c != 0);
    const uint32_t cin = group_carries(gen, !gen && ones == FULL_WARP, F);
    add_bit(t, (cin >> F.g) & 1);
    gfe_cond_sub_p(r, t, (cin >> TPI) & 1, F);
}

// The special form p = 2^255 - 19 (gfe_mul_25519, gfe_sqr_25519): each
// lane forms its own columns c = g*WPL + j of the product with the high
// half folded in (2^256 = 38 mod p), f_c < 2^74, and sums them into
// L[WPL + 2] = sum_j f_c 2^(32j) (< 2^(32 WPL + 42)).

// L += f 2^(32j), f's four words
__device__ __forceinline__ void add_column(uint32_t L[WPL + 2], const uint32_t f[4], int j) {
    uint64_t z = 0;
#pragma unroll
    for (int w = j; w < WPL + 2; ++w) {
        z += (uint64_t)L[w] + (w - j < 4 ? f[w - j] : 0u);
        L[w] = (uint32_t)z;
        z >>= 32;
    }
}

// r = the group's sum of every lane's L mod p, below p: each lane keeps
// its WPL words and hands the rest to the lane above; the top lane splits
// at 2^255 and hands lane 0 19 times the rest. One carry resolution
// leaves the value below 2^255 + 2^235 < 2p, one conditional subtract
// below p.
__device__ __forceinline__ void fold_25519(uint32_t r[WPL], uint32_t L[WPL + 2],
                                           const GroupField& F) {
    static_assert(WPL >= 2, "a lane's carry to the next must fit its words");
    uint64_t hi = (uint64_t)L[WPL] | ((uint64_t)L[WPL + 1] << 32);
    if (F.g == TPI - 1) {    // split at 2^255
        hi = (hi << 1) | (L[WPL - 1] >> 31);
        L[WPL - 1] &= 0x7fffffffu;
    }
    const int below = (F.g + TPI - 1) % TPI;
    uint64_t in = __shfl_sync(FULL_WARP, (uint32_t)hi, below, TPI) |
                  ((uint64_t)__shfl_sync(FULL_WARP, (uint32_t)(hi >> 32), below, TPI) << 32);
    if (F.g == 0) in *= 19;   // the top lane's rest, at 2^255
    uint32_t t[WPL];
    uint64_t z = (uint64_t)L[0] + (uint32_t)in;
    t[0] = (uint32_t)z;
    z = (z >> 32) + L[1] + (in >> 32);
    t[1] = (uint32_t)z;
    z >>= 32;
    uint32_t ones = t[0] & t[1];
#pragma unroll
    for (int k = 2; k < WPL; ++k) {
        z += L[k];
        t[k] = (uint32_t)z;
        z >>= 32;
        ones &= t[k];
    }
    const bool gen = z != 0;
    const uint32_t cin = group_carries(gen, !gen && ones == FULL_WARP, F);
    add_bit(t, (cin >> F.g) & 1);
    gfe_cond_sub_p(r, t, 0, F);
}

// Product a*b mod p for p = 2^255 - 19 in the plain domain (no 2^-256;
// a, b < p, result < p), with no serial round. Every lane gathers all of
// a and b by shuffle, a rotated to start at its own words
// (a'_k = a_((g*WPL + k) mod 8)), and forms its own columns c = g*WPL + j:
//   f_c = sum_k m_k a'_k b_((j - k) mod 8),  m_k = 38 where the term lies
// in the high half (g*WPL + k < 8 and k > j), else 1,
// 8 products per column, the same work in every lane. The factor of a
// product group k in [h*WPL, h*WPL + WPL) with h >= 1 is the lane's m_h
// = 38 if g + h < TPI, so a lane sums each group first and scales it
// once. Then fold_25519.
__device__ __forceinline__ void gfe_mul_25519(uint32_t r[WPL], const uint32_t a[WPL],
                                              const uint32_t b[WPL], const GroupField& F) {
    uint32_t A[NW], B[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
        A[k] = __shfl_sync(FULL_WARP, a[k % WPL], (F.g + k / WPL) % TPI, TPI);
        B[k] = __shfl_sync(FULL_WARP, b[k % WPL], k / WPL, TPI);
    }
    uint32_t L[WPL + 2];
#pragma unroll
    for (int w = 0; w < WPL + 2; ++w) L[w] = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
        uint64_t w0 = 0, w1 = 0, w2 = 0;   // f_c by 32-bit words of its terms
#pragma unroll
        for (int h = 0; h < TPI; ++h) {
            uint64_t s = 0;    // the group's sum, with its carry word s2
            uint32_t s2 = 0;
#pragma unroll
            for (int k = h * WPL; k < h * WPL + WPL; ++k) {
                const uint64_t pr = (uint64_t)A[k] * B[(j - k + NW) % NW];
                if (h == 0) {    // factor known here: 38 for k > j
                    const uint32_t m = k > j ? 38u : 1u;
                    w0 += (uint64_t)(uint32_t)pr * m;
                    w1 += (pr >> 32) * m;
                } else {
                    s += pr;
                    s2 += s < pr;
                }
            }
            if (h > 0) {
                const uint32_t m = F.g + h < TPI ? 38u : 1u;
                w0 += (uint64_t)(uint32_t)s * m;
                w1 += (s >> 32) * m;
                w2 += (uint64_t)s2 * m;
            }
        }
        w1 += w0 >> 32;
        w2 += w1 >> 32;
        const uint32_t f[4] = {(uint32_t)w0, (uint32_t)w1, (uint32_t)w2, (uint32_t)(w2 >> 32)};
        add_column(L, f, j);
    }
    fold_25519(r, L, F);
}

// Square a^2 mod p for p = 2^255 - 19 in the plain domain (a < p, result
// < p): gfe_mul_25519's columns from one gather, each cross product
// formed once. Every lane gathers a (8 shuffles) and rotates it by half
// its first column, rot = g*WPL/2, with selects: A_k = a_((rot + k) mod 8).
// Then a_i a_i' with i + i' = c (mod 8), c = 2 rot + j, is A_k A_k' with
// k + k' = j (mod 8), the same pairs in every lane:
//   f_c = sum over k <= k', k + k' = j (mod 8) of m A_k A_k',
// 5 products for even j and 4 for odd (36 over the 8 columns), each
// cross product (k < k') doubled, and m = 38 where the pair lies in the
// high half: k + k' = j + 8 with neither index wrapped, rot + k' < 8
// (per lane for k' > 7 - rot, known for the rest). Then fold_25519.
__device__ __forceinline__ void gfe_sqr_25519(uint32_t r[WPL], const uint32_t a[WPL],
                                              const GroupField& F) {
    static_assert(WPL % 2 == 0, "the rotation is half a lane's first column");
    const int rot = F.g * WPL / 2;
    uint32_t A[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) A[k] = __shfl_sync(FULL_WARP, a[k % WPL], k / WPL, TPI);
#pragma unroll
    for (int step = 1; step < NW / 2; step <<= 1) {   // rot < TPI * WPL / 2 = 4
        uint32_t R[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) R[k] = (rot & step) ? A[(k + step) % NW] : A[k];
#pragma unroll
        for (int k = 0; k < NW; ++k) A[k] = R[k];
    }
    uint32_t L[WPL + 2];
#pragma unroll
    for (int w = 0; w < WPL + 2; ++w) L[w] = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
        uint64_t w0 = 0, w1 = 0;   // f_c by 32-bit words of its terms
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            const int k2 = (j - k + NW) % NW;
            if (k > k2) continue;
            const uint64_t pr = (uint64_t)A[k] * A[k2];
            const uint32_t twice = k < k2 ? 2u : 1u;
            uint32_t m = twice;
            if (k + k2 == j + NW) m = rot + k2 < NW ? 38u * twice : twice;
            w0 += (uint64_t)(uint32_t)pr * m;
            w1 += (pr >> 32) * m;
        }
        w1 += w0 >> 32;
        const uint32_t f[4] = {(uint32_t)w0, (uint32_t)w1, (uint32_t)(w1 >> 32), 0u};
        add_column(L, f, j);
    }
    fold_25519(r, L, F);
}

// Montgomery square a^2 * 2^-256 mod p for the secp moduli (a < p, result
// < p), in place of gfe_mul(a, a): gfe_sqr_25519's pairs, unfolded, and a
// reduction a lane's digit at a time. Lane g gathers a rotated by rot =
// g*WPL/2 (A_k = a_((rot + k) mod 8)) and forms the product's low columns
// c = g*WPL + j and high columns c + 8 from the same pairs in every lane,
// k <= k' with k + k' = j (mod 8), each cross product doubled: a pair is
// in the high column where k + k' = j + 8 and neither index wrapped, rot +
// k' < 8 (36 products over the 16 columns). A lane's low columns sum to
// lo at word g*WPL with its excess c at the word above, its high columns
// to hi at word 8 + g*WPL. Then TPI rounds of Montgomery reduction by a
// digit of WPL words: lane 0 forms m = D * (-p^-1) mod 2^(32 WPL) from its
// digit D (exact: nothing lies below it), every lane adds m times its
// words of p, and the sum moves down one lane, each lane's words above
// its digit and its lazy carry c joining the low words of the lane above
// as they come down. After the rounds the lanes hold (low half + M p) /
// 2^256, and adding hi gives (a^2 + M p) / 2^256 < a^2 / 2^256 + p < 2p;
// then gfe_mul's carry resolution and conditional subtract.
__device__ __forceinline__ void gfe_sqr(uint32_t r[WPL], const uint32_t a[WPL],
                                        const GroupField& F) {
    static_assert(WPL == 2, "the reduction's digit is a lane's two words (64-bit m)");
    const int rot = F.g * WPL / 2;
    uint32_t A[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) A[k] = __shfl_sync(FULL_WARP, a[k % WPL], k / WPL, TPI);
#pragma unroll
    for (int step = 1; step < NW / 2; step <<= 1) {   // rot < TPI * WPL / 2 = 4
        uint32_t R[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) R[k] = (rot & step) ? A[(k + step) % NW] : A[k];
#pragma unroll
        for (int k = 0; k < NW; ++k) A[k] = R[k];
    }
    uint32_t lo[WPL + 2], hi[WPL + 2];
#pragma unroll
    for (int w = 0; w < WPL + 2; ++w) lo[w] = hi[w] = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
        uint64_t l0 = 0, l1 = 0, h0 = 0, h1 = 0;   // the columns by 32-bit words of their terms
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            const int k2 = (j - k + NW) % NW;
            if (k > k2) continue;
            const uint64_t pr = (uint64_t)A[k] * A[k2];
            const uint32_t twice = k < k2 ? 2u : 1u;
            const uint64_t w0 = (uint64_t)(uint32_t)pr * twice, w1 = (pr >> 32) * twice;
            if (k + k2 == j + NW && rot + k2 < NW) {
                h0 += w0;
                h1 += w1;
            } else {
                l0 += w0;
                l1 += w1;
            }
        }
        l1 += l0 >> 32;
        h1 += h0 >> 32;
        const uint32_t fl[4] = {(uint32_t)l0, (uint32_t)l1, (uint32_t)(l1 >> 32), 0u};
        const uint32_t fh[4] = {(uint32_t)h0, (uint32_t)h1, (uint32_t)(h1 >> 32), 0u};
        add_column(lo, fl, j);
        add_column(hi, fh, j);
    }

    uint32_t t[WPL] = {lo[0], lo[1]};
    uint64_t c = (uint64_t)lo[WPL + 1] << 32 | lo[WPL];   // < 2^37
    // -p^-1 mod 2^64 in lane 0 (its words of p are p's low ones), by one
    // Newton step on p^-1 mod 2^32
    const uint64_t p64 = (uint64_t)F.p[1] << 32 | F.p[0], x = 0u - F.pinv;
    const uint64_t pinv = 0 - x * (2 - p64 * x);
#pragma unroll
    for (int i = 0; i < TPI; ++i) {
        const uint64_t m64 = ((uint64_t)t[1] << 32 | t[0]) * pinv;   // lane 0's is m
        const uint32_t m[WPL] = {__shfl_sync(FULL_WARP, (uint32_t)m64, 0, TPI),
                                 __shfl_sync(FULL_WARP, (uint32_t)(m64 >> 32), 0, TPI)};
        uint32_t s[2 * WPL];   // t + m * (this lane's words of p) < 2^128
#pragma unroll
        for (int k = 0; k < WPL; ++k) {
            s[k] = t[k];
            s[WPL + k] = 0;
        }
#pragma unroll
        for (int i2 = 0; i2 < WPL; ++i2) {
            uint64_t x = 0;
#pragma unroll
            for (int k = 0; k < WPL; ++k) {
                x += (uint64_t)m[i2] * F.p[k] + s[i2 + k];
                s[i2 + k] = (uint32_t)x;
                x >>= 32;
            }
            s[i2 + WPL] = (uint32_t)x;
        }
        uint64_t z = 0;
#pragma unroll
        for (int k = 0; k < WPL; ++k) {   // the lane above's low words come down
            const uint32_t up = __shfl_down_sync(FULL_WARP, s[k], 1, TPI);
            z += (uint64_t)(F.g == TPI - 1 ? 0u : up) + s[WPL + k] + (uint32_t)(c >> (32 * k));
            t[k] = (uint32_t)z;
            z >>= 32;
        }
        c = z;
    }

    // + the high half, then the value is sum(u) + sum(L at the word above
    // each lane) < 2p: add the lane below's L and resolve, the top lane's
    // L being the bit at 2^256, as in gfe_mul
    uint32_t u[WPL];
    uint64_t z = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        z += (uint64_t)t[k] + hi[k];
        u[k] = (uint32_t)z;
        z >>= 32;
    }
    const uint64_t L = c + z + ((uint64_t)hi[WPL + 1] << 32 | hi[WPL]);
    const uint32_t b0 = __shfl_up_sync(FULL_WARP, (uint32_t)L, 1, TPI);
    const uint32_t b1 = __shfl_up_sync(FULL_WARP, (uint32_t)(L >> 32), 1, TPI);
    z = F.g == 0 ? 0u : b0;
    z += u[0];
    u[0] = (uint32_t)z;
    z = (z >> 32) + (F.g == 0 ? 0u : b1) + u[1];
    u[1] = (uint32_t)z;
    z >>= 32;
    const bool gen = z != 0 || (F.g == TPI - 1 && L != 0);
    const uint32_t cin = group_carries(gen, !gen && (u[0] & u[1]) == FULL_WARP, F);
    add_bit(u, (cin >> F.g) & 1);
    gfe_cond_sub_p(r, u, (cin >> TPI) & 1, F);
}

// ---------------------------------------------------------------------------
// comparisons, the same answer in every lane of the group (one ballot;
// gfe_lt two)

__device__ __forceinline__ bool gfe_is_zero(const uint32_t a[WPL], const GroupField& F) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) x |= a[k];
    return ((__ballot_sync(FULL_WARP, x != 0) >> F.base) & ((1u << TPI) - 1)) == 0;
}

__device__ __forceinline__ bool gfe_eq(const uint32_t a[WPL], const uint32_t b[WPL],
                                       const GroupField& F) {
    uint32_t x[WPL];
#pragma unroll
    for (int k = 0; k < WPL; ++k) x[k] = a[k] ^ b[k];
    return gfe_is_zero(x, F);
}

// a < b for any a, b < 2^256: the borrow out of a - b
__device__ __forceinline__ bool gfe_lt(const uint32_t a[WPL], const uint32_t b[WPL],
                                       const GroupField& F) {
    uint64_t br = 0;
    uint32_t nz = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        const uint64_t x = (uint64_t)a[k] - b[k] - br;
        nz |= (uint32_t)x;
        br = (x >> 32) & 1;
    }
    return (group_carries(br != 0, nz == 0, F) >> TPI) & 1;
}

// ---------------------------------------------------------------------------
// entry and exit: lane 0 of each group runs field256.cuh's one-thread
// conversions, and the words move by shuffle

// lane 0's 8 words -> each lane's WPL words
__device__ __forceinline__ void group_scatter(uint32_t r[WPL], const uint32_t w[NW],
                                              const GroupField& F) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const uint32_t v = __shfl_sync(FULL_WARP, w[i], 0, TPI);
        if (i / WPL == F.g) r[i % WPL] = v;
    }
}

// each lane's WPL words -> all 8 words, in every lane of the group
__device__ __forceinline__ void group_gather(uint32_t w[NW], const uint32_t r[WPL],
                                             const GroupField& F) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __shfl_sync(FULL_WARP, r[i % WPL], i / WPL, TPI);
}

// [22, B] digits of column col (R = 2^264 domain) -> this lane's words
template <class Params>
__device__ __forceinline__ void group_load_coord(uint32_t r[WPL], const int32_t* src, int batch,
                                                 int col, const Params& P, const GroupField& F) {
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = 0;
    if (F.g == 0) load_coord(w, src, batch, col, P);
    group_scatter(r, w, F);
}

// this lane's words -> canonical [22, B] digits of column col, written
// by lane 0 where `live`
template <class Params>
__device__ __forceinline__ void group_store_coord(int32_t* dst, const uint32_t a[WPL], int batch,
                                                  int col, bool live, const Params& P,
                                                  const GroupField& F) {
    uint32_t w[NW];
    group_gather(w, a, F);
    if (F.g == 0 && live) store_coord(dst, w, batch, col, P);
}

// 32 big-endian bytes -> this lane's words of the value
__device__ __forceinline__ void group_load_be32(uint32_t r[WPL], const uint8_t* b,
                                                const GroupField& F) {
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        const uint8_t* q = b + 28 - 4 * (F.g * WPL + k);
        r[k] = (uint32_t)q[3] | (uint32_t)q[2] << 8 | (uint32_t)q[1] << 16 | (uint32_t)q[0] << 24;
    }
}
