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
// exit multiplies by 2^264 mod p and splits into 12-bit digits (the
// field arithmetic and these conversions are in field256.cuh, shared
// with ed_ladder.cu). The complete RCB15 formulas (Algorithm 1, generic a, including the
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
#include <string.h>

#include "field256.cuh"

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
// entry and exit (load_coord / store_coord: field256.cuh)

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
    load_table16<PT, GSTRIDE>(gsh, P.g);
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t qt[16][PT];             // per-signature Q multiples, local memory
    uint32_t acc[PT], op[PT];
    load_q(acc, qx, qy, batch, col, P);
    copy_words<PT>(qt[0], P.g[0]);          // infinity
    copy_words<PT>(qt[1], acc);
#pragma unroll 1
    for (int step = 0; step < W_STEPS; ++step) {
        if (step < W_BUILD) {
            copy_words<PT>(op, qt[1]);
        } else {
            if (step == W_BUILD) copy_words<PT>(acc, P.g[0]);
            const int win = (step - W_BUILD) / 6;          // 0 = top window
            const int kind = (step - W_BUILD) % 6;         // 0-3 double, 4 G, 5 Q
            const int limb = NLIMB - 1 - win / 3;
            const int shift = 8 - 4 * (win % 3);
            if (kind < 4) {
                copy_words<PT>(op, acc);
            } else if (kind == 4) {
                const int d1 = ((uint32_t)u1[limb * batch + col] >> shift) & 15;
                copy_words<PT>(op, gsh + d1 * GSTRIDE);
            } else {
                const int d2 = ((uint32_t)u2[limb * batch + col] >> shift) & 15;
                copy_words<PT>(op, qt[d2]);
            }
        }
        wei_add(acc, acc, op, P);
        if (step < W_BUILD) copy_words<PT>(qt[step + 2], acc);
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
    load_table16<PT, GSTRIDE>(gsh, P.g);
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t tab[4][PT];
    uint32_t acc[PT], op[PT];
    copy_words<PT>(tab[0], P.g[0]);
    copy_words<PT>(tab[1], P.g[1]);
    load_q(tab[2], qx, qy, batch, col, P);
    copy_words<PT>(acc, P.g[1]);
#pragma unroll 1
    for (int step = 0; step < P_STEPS; ++step) {
        if (step == 0) {
            copy_words<PT>(op, tab[2]);
        } else {
            if (step == 1) copy_words<PT>(acc, P.g[0]);
            const int bit = NLIMB * 12 - 1 - (step - 1) / 2;
            if ((step - 1) % 2 == 0) {
                copy_words<PT>(op, acc);
            } else {
                const int limb = bit / 12, sh = bit % 12;
                const int idx = (((uint32_t)u1[limb * batch + col] >> sh) & 1) |
                                ((((uint32_t)u2[limb * batch + col] >> sh) & 1) << 1);
                copy_words<PT>(op, tab[idx]);
            }
        }
        wei_add(acc, acc, op, P);
        if (step == 0) copy_words<PT>(tab[3], acc);
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
