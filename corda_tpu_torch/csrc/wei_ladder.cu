// Double-scalar ladders R = u1*G + u2*Q on a short-Weierstrass curve
// (secp256r1, secp256k1) for Hopper (sm_90a), one signature per thread.
//
// Replaces (corda_tpu/crypto/pallas_ec.py):
//   wei_ladder_windowed_kernel  <- wei_ladder_windowed_pallas (w = 4,
//       66 windows: 4 complete doublings + one add from the constant G
//       table + one add from the per-signature Q table, 14 adds to build)
//   wei_ladder_kernel           <- wei_ladder_pallas (plain Shamir bit
//       ladder over {inf, G, Q, G+Q}, 264 doublings + 264 selected adds)
//
// Interface (the same as the TPU kernels): u1, u2 are canonical [22, B]
// int32 radix-2^12 digit arrays (batch minor); qx_m, qy_m are affine
// coordinates in the R = 2^264 Montgomery domain with bounded
// non-negative digits. Outputs X, Y, Z are canonical [22, B] digits of
// the projective result in that same R = 2^264 domain, so the ECDSA
// epilogue (ecdsa.py) runs unchanged on either the kernel or its plain
// torch version.
//
// Inside, field elements are 8 x 32-bit words in the R = 2^256
// Montgomery domain, always fully reduced to [0, p). Entry converts
// each coordinate with one fold + one Montgomery multiply by 2^248;
// exit multiplies by 2^264 mod p and splits into 12-bit digits. The
// complete RCB15 formulas (Algorithm 1, generic a, including the
// multiplies by a) are kept: completeness is what makes accept/reject
// at infinity exact.
//
// What bounds it on this card: 32-bit integer multiply throughput. A field
// multiply is 8x8 + 8x8 + 8 32x32->64 partial products (~264 IMAD-rate
// instructions); an RCB15 add is 17 of them; a windowed ladder is 410
// adds, a plain one 529. Memory traffic is 616 bytes per signature, so
// the bound is the SM's IMAD rate, never bandwidth. The design spends
// nothing else: no data-dependent branches (the complete formulas absorb
// infinity), 64-bit multiply-accumulate carry chains in registers, curve
// constants passed by value (uniform, so they read from the constant
// bank as instruction operands), the G table in shared memory (digits
// diverge across a warp, which the constant cache would serialise), and
// the per-signature Q table in local memory (measured faster than a
// dynamic shared-memory copy; see PERF.md).
// Occupancy is low at the ECDSA chunk size (4096 threads = 32 blocks of
// 128 on 132 SMs); spreading one signature over several threads is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define NLIMB 22
#define NW 8                 // 32-bit words per field element
#define PT (3 * NW)          // words per projective point
#define GSTRIDE (PT + 1)     // padded G-table entry stride (bank spread)
#define BLOCK 128

struct CurveParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: Montgomery 1, also the fold constant
    uint32_t c_in[NW];       // 2^248: 2^264-domain -> 2^256-domain multiplier
    uint32_t c_out[NW];      // 2^264 mod p: 2^256-domain -> 2^264-domain multiplier
    uint32_t a[NW];          // a * 2^256 mod p
    uint32_t b3[NW];         // 3b * 2^256 mod p
    uint32_t pinv;           // -p^-1 mod 2^32
    uint32_t g[16][PT];      // G multiples 0..15, projective, entry 0 = infinity
};

// ---------------------------------------------------------------------------
// field arithmetic, 8 x 32-bit words, values in [0, p)

// r = t - p if t (with top carry word `hi`) >= p, else t
__device__ __forceinline__ void cond_sub_p(uint32_t r[NW], const uint32_t t[NW],
                                           uint32_t hi, const CurveParams& P) {
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

// Montgomery product a*b*2^-256 mod p (CIOS); a, b < 2^256, result < p
__device__ __forceinline__ void fe_mul(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW], const CurveParams& P) {
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

__device__ __forceinline__ void fe_add(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW], const CurveParams& P) {
    uint32_t s[NW];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        c += (uint64_t)a[j] + b[j];
        s[j] = (uint32_t)c;
        c >>= 32;
    }
    cond_sub_p(r, s, (uint32_t)c, P);
}

__device__ __forceinline__ void fe_sub(uint32_t r[NW], const uint32_t a[NW],
                                       const uint32_t b[NW], const CurveParams& P) {
    uint32_t d[NW];
    uint64_t br = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t x = (uint64_t)a[j] - b[j] - br;
        d[j] = (uint32_t)x;
        br = (x >> 32) & 1;
    }
    const uint32_t mask = 0u - (uint32_t)br;   // add p back on borrow
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        c += (uint64_t)d[j] + (P.p[j] & mask);
        r[j] = (uint32_t)c;
        c >>= 32;
    }
}

// ---------------------------------------------------------------------------
// complete projective addition, RCB15 Algorithm 1 (generic a);
// the same operation sequence as ec.wei_add. out may alias either input.

__device__ __forceinline__ void wei_add(uint32_t out[PT], const uint32_t p1[PT],
                                        const uint32_t p2[PT], const CurveParams& P) {
    const uint32_t* X1 = p1;
    const uint32_t* Y1 = p1 + NW;
    const uint32_t* Z1 = p1 + 2 * NW;
    const uint32_t* X2 = p2;
    const uint32_t* Y2 = p2 + NW;
    const uint32_t* Z2 = p2 + 2 * NW;
    uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], t5[NW];
    uint32_t X3[NW], Y3[NW], Z3[NW];

    fe_mul(t0, X1, X2, P);
    fe_mul(t1, Y1, Y2, P);
    fe_mul(t2, Z1, Z2, P);
    fe_add(t3, X1, Y1, P);
    fe_add(t4, X2, Y2, P);
    fe_mul(t3, t3, t4, P);
    fe_add(t4, t0, t1, P);
    fe_sub(t3, t3, t4, P);
    fe_add(t4, X1, Z1, P);
    fe_add(t5, X2, Z2, P);
    fe_mul(t4, t4, t5, P);
    fe_add(t5, t0, t2, P);
    fe_sub(t4, t4, t5, P);
    fe_add(t5, Y1, Z1, P);
    fe_add(X3, Y2, Z2, P);
    fe_mul(t5, t5, X3, P);
    fe_add(X3, t1, t2, P);
    fe_sub(t5, t5, X3, P);
    fe_mul(Z3, t4, P.a, P);
    fe_mul(X3, t2, P.b3, P);
    fe_add(Z3, X3, Z3, P);
    fe_sub(X3, t1, Z3, P);
    fe_add(Z3, t1, Z3, P);
    fe_mul(Y3, X3, Z3, P);
    fe_add(t1, t0, t0, P);
    fe_add(t1, t1, t0, P);
    fe_mul(t2, t2, P.a, P);
    fe_mul(t4, t4, P.b3, P);
    fe_add(t1, t1, t2, P);
    fe_sub(t2, t0, t2, P);
    fe_mul(t2, t2, P.a, P);
    fe_add(t4, t4, t2, P);
    fe_mul(t0, t1, t4, P);
    fe_add(Y3, Y3, t0, P);
    fe_mul(t0, t5, t4, P);
    fe_mul(X3, t3, X3, P);
    fe_sub(X3, X3, t0, P);
    fe_mul(t0, t3, t1, P);
    fe_mul(Z3, t5, Z3, P);
    fe_add(Z3, Z3, t0, P);

#pragma unroll
    for (int j = 0; j < NW; ++j) {
        out[j] = X3[j];
        out[NW + j] = Y3[j];
        out[2 * NW + j] = Z3[j];
    }
}

// ---------------------------------------------------------------------------
// domain conversion at entry and exit

// [22, B] digits (R = 2^264 domain, bounded non-negative) -> 8 words in
// the R = 2^256 domain, fully reduced
__device__ __forceinline__ void load_coord(uint32_t r[NW], const int32_t* src,
                                           int batch, int col, const CurveParams& P) {
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
    // < 2^31 give v < 2^284; four folds bring the top word to 0 for
    // both curves (2^256 mod p < 2^225), then v < 2^256 < 2p.
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
    fe_mul(r, red, P.c_in, P);   // x * 2^264 * 2^248 / 2^256 = x * 2^256
}

// 8 words (R = 2^256 domain) -> canonical [22, B] digits (R = 2^264 domain)
__device__ __forceinline__ void store_coord(int32_t* dst, const uint32_t a[NW],
                                            int batch, int col, const CurveParams& P) {
    uint32_t r[NW];
    fe_mul(r, a, P.c_out, P);    // x * 2^256 * 2^264 / 2^256 = x * 2^264
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

__device__ __forceinline__ void load_g_table(uint32_t* gsh, const CurveParams& P) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e)
#pragma unroll
            for (int k = 0; k < PT; ++k) gsh[e * GSTRIDE + k] = P.g[e][k];
    }
    __syncthreads();
}

__device__ __forceinline__ void copy_pt(uint32_t dst[PT], const uint32_t* src) {
#pragma unroll
    for (int k = 0; k < PT; ++k) dst[k] = src[k];
}

__device__ __forceinline__ void load_q(uint32_t q[PT], const int32_t* qx, const int32_t* qy,
                                       int batch, int col, const CurveParams& P) {
    load_coord(q, qx, batch, col, P);
    load_coord(q + NW, qy, batch, col, P);
#pragma unroll
    for (int j = 0; j < NW; ++j) q[2 * NW + j] = P.one[j];
}

__device__ __forceinline__ void store_pt(int32_t* X, int32_t* Y, int32_t* Z,
                                         const uint32_t acc[PT], int batch, int col,
                                         const CurveParams& P) {
    store_coord(X, acc, batch, col, P);
    store_coord(Y, acc + NW, batch, col, P);
    store_coord(Z, acc + 2 * NW, batch, col, P);
}

// ---------------------------------------------------------------------------
// kernels

// Each kernel walks one schedule of complete additions with a single
// wei_add call site (acc = acc + operand, the operand chosen per step);
// the branches depend on the step only, so they are uniform across a
// warp. One call site keeps the kernel small: inlining the ~7k
// instruction add at every site of the loop nest multiplied ptxas time.

// windowed schedule: 14 adds build Q multiples 2..15 (acc += Q), then
// per 4-bit window (66, most significant first) 4 doublings, + G[d1],
// + Q[d2]
#define W_BUILD 14
#define W_STEPS (W_BUILD + 66 * 6)

__global__ void __launch_bounds__(BLOCK)
wei_ladder_windowed_kernel(const CurveParams P, const int32_t* __restrict__ u1,
                           const int32_t* __restrict__ u2, const int32_t* __restrict__ qx,
                           const int32_t* __restrict__ qy, int32_t* __restrict__ X,
                           int32_t* __restrict__ Y, int32_t* __restrict__ Z, int batch) {
    __shared__ uint32_t gsh[16 * GSTRIDE];
    load_g_table(gsh, P);
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t qt[16][PT];             // per-signature Q multiples, local memory
    uint32_t acc[PT], op[PT];
    load_q(acc, qx, qy, batch, col, P);
    copy_pt(qt[0], P.g[0]);          // infinity
    copy_pt(qt[1], acc);
#pragma unroll 1
    for (int step = 0; step < W_STEPS; ++step) {
        if (step < W_BUILD) {
            copy_pt(op, qt[1]);
        } else {
            if (step == W_BUILD) copy_pt(acc, P.g[0]);
            const int win = (step - W_BUILD) / 6;          // 0 = top window
            const int kind = (step - W_BUILD) % 6;         // 0-3 double, 4 G, 5 Q
            const int limb = NLIMB - 1 - win / 3;
            const int shift = 8 - 4 * (win % 3);
            if (kind < 4) {
                copy_pt(op, acc);
            } else if (kind == 4) {
                const int d1 = ((uint32_t)u1[limb * batch + col] >> shift) & 15;
                copy_pt(op, gsh + d1 * GSTRIDE);
            } else {
                const int d2 = ((uint32_t)u2[limb * batch + col] >> shift) & 15;
                copy_pt(op, qt[d2]);
            }
        }
        wei_add(acc, acc, op, P);
        if (step < W_BUILD) copy_pt(qt[step + 2], acc);
    }
    store_pt(X, Y, Z, acc, batch, col, P);
}

// plain schedule: one add builds G+Q, then per scalar bit (264, most
// significant first) a doubling and an add of {inf, G, Q, G+Q}[bit(u1)
// + 2 bit(u2)]
#define P_STEPS (1 + 2 * NLIMB * 12)

__global__ void __launch_bounds__(BLOCK)
wei_ladder_kernel(const CurveParams P, const int32_t* __restrict__ u1,
                  const int32_t* __restrict__ u2, const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy, int32_t* __restrict__ X,
                  int32_t* __restrict__ Y, int32_t* __restrict__ Z, int batch) {
    __shared__ uint32_t gsh[16 * GSTRIDE];
    load_g_table(gsh, P);
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t tab[4][PT];
    uint32_t acc[PT], op[PT];
    copy_pt(tab[0], P.g[0]);
    copy_pt(tab[1], P.g[1]);
    load_q(tab[2], qx, qy, batch, col, P);
    copy_pt(acc, P.g[1]);
#pragma unroll 1
    for (int step = 0; step < P_STEPS; ++step) {
        if (step == 0) {
            copy_pt(op, tab[2]);
        } else {
            if (step == 1) copy_pt(acc, P.g[0]);
            const int bit = NLIMB * 12 - 1 - (step - 1) / 2;
            if ((step - 1) % 2 == 0) {
                copy_pt(op, acc);
            } else {
                const int limb = bit / 12, sh = bit % 12;
                const int idx = (((uint32_t)u1[limb * batch + col] >> sh) & 1) |
                                ((((uint32_t)u2[limb * batch + col] >> sh) & 1) << 1);
                copy_pt(op, tab[idx]);
            }
        }
        wei_add(acc, acc, op, P);
        if (step == 0) copy_pt(tab[3], acc);
    }
    store_pt(X, Y, Z, acc, batch, col, P);
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Each entry launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

extern "C" int corda_wei_params_words(void) {
    return (int)(sizeof(CurveParams) / sizeof(uint32_t));
}

extern "C" const char* corda_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int corda_wei_ladder(int windowed, const uint32_t* params, const int32_t* u1,
                                const int32_t* u2, const int32_t* qx, const int32_t* qy,
                                int32_t* X, int32_t* Y, int32_t* Z, int batch, void* stream) {
    CurveParams P;
    memcpy(&P, params, sizeof(CurveParams));
    cudaGetLastError();   // clear any stale error from earlier work
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((batch + BLOCK - 1) / BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    if (windowed) {
        wei_ladder_windowed_kernel<<<grid, BLOCK, 0, s>>>(P, u1, u2, qx, qy, X, Y, Z, batch);
    } else {
        wei_ladder_kernel<<<grid, BLOCK, 0, s>>>(P, u1, u2, qx, qy, X, Y, Z, batch);
    }
    return (int)cudaGetLastError();
}
