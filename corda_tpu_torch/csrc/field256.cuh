// 256-bit prime-field arithmetic for one thread: the domain conversions
// at entry and exit of the lane-group kernels (wei_ladder.cu,
// ed_ladder.cu, ed_ends.cu, wei_ends.cu), which run them on lane 0 of each
// group (field256_group.cuh holds the arithmetic spread over the group),
// and the byte and digit formats they read and write.
//
// A field element is 8 x 32-bit words, always fully reduced to [0, p);
// fe_mul is the R = 2^256 Montgomery product. The functions are
// templates over the kernel's parameter struct, which must provide
//   p[NW]      the modulus (odd, 2^255 <= p < 2^256)
//   one[NW]    2^256 mod p: the fold constant
//   c_in[NW]   the multiplier from the interface's 2^264 domain to the
//              kernel's: 2^248 for the 2^256 Montgomery domain
//              (wei_ladder.cu), 2^-8 mod p for plain values (ed_ladder.cu,
//              ed_ends.cu)
//   c_out[NW]  back: 2^264 mod p, or 2^520 mod p
//   pinv       -p^-1 mod 2^32
//
// fe_mul returns a value < p whenever a * b < p * 2^256, which holds
// when one operand is < p and the other < 2^256: at entry the folded
// value (< 2^256) times c_in (< p), at exit a kernel's result (< p)
// times c_out (< p), for p close to 2^256 (the secp curves) and for
// p = 2^255 - 19 alike.

#pragma once

#include <stdint.h>

#define NLIMB 22
#define NW 8                 // 32-bit words per field element

// r = t - p if t (with top carry word `hi`) >= p, else t
template <class Params>
__device__ __forceinline__ void cond_sub_p(uint32_t r[NW], const uint32_t t[NW],
                                           uint32_t hi, const Params& P) {
    uint32_t d[NW];
    uint64_t br = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t x = (uint64_t)t[j] - P.p[j] - br;
        d[j] = (uint32_t)x;
        br = (x >> 32) & 1;
    }
    const bool use_d = hi != 0 || br == 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = use_d ? d[j] : t[j];
}

// Montgomery product a*b*2^-256 mod p (CIOS); a, b < 2^256 with
// a * b < p * 2^256, result < p
template <class Params>
__device__ __forceinline__ void fe_mul(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW], const Params& P) {
    uint32_t t[NW + 2];
#pragma unroll
    for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            c += (uint64_t)a[j] * b[i] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NW];
        t[NW] = (uint32_t)c;
        t[NW + 1] = (uint32_t)(c >> 32);
        const uint32_t m = t[0] * P.pinv;
        c = ((uint64_t)m * P.p[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < NW; ++j) {
            c += (uint64_t)m * P.p[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[NW];
        t[NW - 1] = (uint32_t)c;
        t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
    }
    cond_sub_p(r, t, t[NW], P);
}

// ---------------------------------------------------------------------------
// domain conversion at entry and exit

// [22, B] digits (R = 2^264 domain, bounded non-negative) -> 8 words in
// the kernel's domain (c_in), fully reduced
template <class Params>
__device__ __forceinline__ void load_coord(uint32_t r[NW], const int32_t* src,
                                           int batch, int col, const Params& P) {
    uint32_t v[NW + 1];
#pragma unroll
    for (int j = 0; j <= NW; ++j) v[j] = 0;
#pragma unroll
    for (int i = 0; i < NLIMB; ++i) {
        const int bit = 12 * i;
        const int w = bit >> 5;
        const uint64_t sh = (uint64_t)(uint32_t)src[i * batch + col] << (bit & 31);
        uint64_t c = (uint64_t)v[w] + (uint32_t)sh;
        v[w] = (uint32_t)c;
        c = (c >> 32) + (sh >> 32);
#pragma unroll
        for (int k = w + 1; k <= NW; ++k) {
            c += v[k];
            v[k] = (uint32_t)c;
            c >>= 32;
        }
    }
    // fold the word above 2^256 back in: 2^256 == one (mod p). Digits
    // < 2^31 give v < 2^284; four folds bring the top word to 0 when
    // 2^256 mod p < 2^225 (secp256r1, secp256k1, ed25519). Then
    // v < 2^256, and one conditional subtract leaves it below
    // max(p, 2^256 - p) < 2^256, which fe_mul by c_in (< p) takes
#pragma unroll
    for (int f = 0; f < 4; ++f) {
        const uint32_t h = v[NW];
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            c += (uint64_t)h * P.one[j] + v[j];
            v[j] = (uint32_t)c;
            c >>= 32;
        }
        v[NW] = (uint32_t)c;
    }
    uint32_t red[NW];
    cond_sub_p(red, v, 0, P);
    fe_mul(r, red, P.c_in, P);   // e.g. x * 2^264 * 2^248 / 2^256 = x * 2^256
}

// 8 words (any value < 2^256) -> canonical [22, B] digits of that value
__device__ __forceinline__ void store_digits(int32_t* dst, const uint32_t r[NW], int batch,
                                             int col) {
#pragma unroll
    for (int i = 0; i < NLIMB; ++i) {
        const int bit = 12 * i;
        const int w = bit >> 5;
        const int s = bit & 31;
        uint32_t d = w < NW ? r[w] >> s : 0;
        if (s > 20 && w + 1 < NW) d |= r[w + 1] << (32 - s);
        dst[i * batch + col] = (int32_t)(d & 0xFFF);
    }
}

// 8 words (the kernel's domain) -> canonical [22, B] digits (R = 2^264 domain)
template <class Params>
__device__ __forceinline__ void store_coord(int32_t* dst, const uint32_t a[NW],
                                            int batch, int col, const Params& P) {
    uint32_t r[NW];
    fe_mul(r, a, P.c_out, P);    // e.g. x * 2^256 * 2^264 / 2^256 = x * 2^264
    store_digits(dst, r, batch, col);
}

// ---------------------------------------------------------------------------
// a record's bytes in, for lane 0's raw values (ed_ends.cu's scalars)

// 32 big-endian bytes -> 8 little-endian words
__device__ __forceinline__ void load_be32(uint32_t r[NW], const uint8_t* b) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        const uint8_t* q = b + 28 - 4 * j;
        r[j] = (uint32_t)q[3] | (uint32_t)q[2] << 8 | (uint32_t)q[1] << 16 | (uint32_t)q[0] << 24;
    }
}
