// Double-scalar ladders R = s*B + k*A on ed25519 (twisted Edwards,
// a = -1) for Hopper (sm_90a), one signature per thread.
//
// Replaces (corda_tpu/crypto/pallas_ec.py):
//   ed_ladder_windowed_kernel  <- ed_ladder_windowed_pallas (w = 4,
//       14 adds build A multiples 2..15, then 66 windows: 4 unified
//       doublings + one add from the constant B table + one add from the
//       per-signature A table)
//   ed_ladder_kernel           <- ed_ladder_pallas (plain bit ladder over
//       {0, B, A, B+A}, one add builds B+A, then 264 doublings + 264
//       selected adds)
//
// Interface (the same as the TPU kernels): s, k are canonical [22, B]
// int32 radix-2^12 digit arrays (batch minor; s is the raw 256-bit
// signature scalar, never reduced mod L, so every digit bit is
// scanned); ax_m, ay_m are the affine A (the verifier passes -A) in the
// R = 2^264 Montgomery domain with bounded non-negative digits. Outputs
// X, Y, Z, T are canonical [22, B] digits of the extended result in
// that same domain, so the ed25519 epilogue (eddsa.py) runs unchanged on
// either the kernel or its plain torch version.
//
// Field elements are 8 x 32-bit words in the R = 2^256 Montgomery
// domain, fully reduced to [0, p), with the arithmetic and the domain
// conversions of field256.cuh (shared with wei_ladder.cu). The generic
// CIOS multiply is exact for p = 2^255 - 19 because every multiply has
// an operand below p; a special-form reduction (multiply the high half
// by 38) is later work. The unified add-2008-hwcd-3 formulas (8
// multiplies + 1 by 2d) are complete on ed25519 (d is not a square):
// doublings use the same add, as the TPU kernels do, there are no
// data-dependent branches, and rows whose A failed to decode run on
// harmlessly and are masked by the caller.
//
// What bounds it on this card: 32-bit integer multiply throughput. A
// field multiply is ~264 IMAD-rate instructions; an add is 9 of them; a
// windowed ladder is 410 adds, a plain one 529. Memory traffic is 704
// bytes per signature, so the bound is the SM's IMAD rate, never
// bandwidth. As in wei_ladder.cu: constants by value (uniform), the B
// table in shared memory (digits diverge across a warp), the
// per-signature A table in local memory, and one ed_add call site per
// kernel.

#include <cuda_runtime.h>
#include <string.h>

#include "field256.cuh"

#define PT4 (4 * NW)         // words per extended point (X, Y, Z, T)
#define BSTRIDE (PT4 + 1)    // padded B-table entry stride (bank spread)
#define BLOCK 128

struct EdParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: Montgomery 1, also the fold constant
    uint32_t c_in[NW];       // 2^248: 2^264-domain -> 2^256-domain multiplier
    uint32_t c_out[NW];      // 2^264 mod p: 2^256-domain -> 2^264-domain multiplier
    uint32_t d2[NW];         // 2d * 2^256 mod p
    uint32_t pinv;           // -p^-1 mod 2^32
    uint32_t b[16][PT4];     // B multiples 0..15 as (x, y, 1, xy), entry 0 = identity
};

// ---------------------------------------------------------------------------
// unified extended addition, add-2008-hwcd-3 with a = -1; the same
// operation sequence as ec.ed_add. out may alias either input.

__device__ __forceinline__ void ed_add(uint32_t out[PT4], const uint32_t p1[PT4],
                                       const uint32_t p2[PT4], const EdParams& P) {
    const uint32_t* X1 = p1;
    const uint32_t* Y1 = p1 + NW;
    const uint32_t* Z1 = p1 + 2 * NW;
    const uint32_t* T1 = p1 + 3 * NW;
    const uint32_t* X2 = p2;
    const uint32_t* Y2 = p2 + NW;
    const uint32_t* Z2 = p2 + 2 * NW;
    const uint32_t* T2 = p2 + 3 * NW;
    uint32_t a[NW], b[NW], c[NW], d[NW], t0[NW], t1[NW];

    fe_sub(t0, Y1, X1, P);
    fe_sub(t1, Y2, X2, P);
    fe_mul(a, t0, t1, P);         // A = (Y1 - X1)(Y2 - X2)
    fe_add(t0, Y1, X1, P);
    fe_add(t1, Y2, X2, P);
    fe_mul(b, t0, t1, P);         // B = (Y1 + X1)(Y2 + X2)
    fe_mul(c, T1, T2, P);
    fe_mul(c, c, P.d2, P);        // C = T1 T2 2d
    fe_mul(d, Z1, Z2, P);
    fe_add(d, d, d, P);           // D = 2 Z1 Z2
    fe_sub(t0, b, a, P);          // E = B - A
    fe_add(t1, b, a, P);          // H = B + A
    fe_sub(a, d, c, P);           // F = D - C
    fe_add(b, d, c, P);           // G = D + C
    fe_mul(out, t0, a, P);            // X3 = E F
    fe_mul(out + NW, b, t1, P);       // Y3 = G H
    fe_mul(out + 2 * NW, a, b, P);    // Z3 = F G
    fe_mul(out + 3 * NW, t0, t1, P);  // T3 = E H
}

// ---------------------------------------------------------------------------
// entry and exit (load_coord / store_coord: field256.cuh)

// affine A from [22, B] digits -> extended (x, y, 1, xy), 2^256 domain
__device__ __forceinline__ void load_a(uint32_t a[PT4], const int32_t* ax, const int32_t* ay,
                                       int batch, int col, const EdParams& P) {
    load_coord(a, ax, batch, col, P);
    load_coord(a + NW, ay, batch, col, P);
#pragma unroll
    for (int j = 0; j < NW; ++j) a[2 * NW + j] = P.one[j];
    fe_mul(a + 3 * NW, a, a + NW, P);
}

__device__ __forceinline__ void store_ext(int32_t* X, int32_t* Y, int32_t* Z, int32_t* T,
                                          const uint32_t acc[PT4], int batch, int col,
                                          const EdParams& P) {
    store_coord(X, acc, batch, col, P);
    store_coord(Y, acc + NW, batch, col, P);
    store_coord(Z, acc + 2 * NW, batch, col, P);
    store_coord(T, acc + 3 * NW, batch, col, P);
}

// ---------------------------------------------------------------------------
// kernels: each walks one schedule of unified additions with a single
// ed_add call site (acc = acc + operand, the operand chosen per step;
// the branches depend on the step only, so they are uniform across a
// warp), as in wei_ladder.cu

// windowed schedule: 14 adds build A multiples 2..15 (acc += A), then
// per 4-bit window (66, most significant first) 4 doublings, + B[d_s],
// + A[d_k]
#define W_BUILD 14
#define W_STEPS (W_BUILD + 66 * 6)

__global__ void __launch_bounds__(BLOCK)
ed_ladder_windowed_kernel(const EdParams P, const int32_t* __restrict__ s,
                          const int32_t* __restrict__ k, const int32_t* __restrict__ ax,
                          const int32_t* __restrict__ ay, int32_t* __restrict__ X,
                          int32_t* __restrict__ Y, int32_t* __restrict__ Z,
                          int32_t* __restrict__ T, int batch) {
    __shared__ uint32_t bsh[16 * BSTRIDE];
    load_table16<PT4, BSTRIDE>(bsh, P.b);
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t at[16][PT4];            // per-signature A multiples, local memory
    uint32_t acc[PT4], op[PT4];
    load_a(acc, ax, ay, batch, col, P);
    copy_words<PT4>(at[0], P.b[0]);  // identity
    copy_words<PT4>(at[1], acc);
#pragma unroll 1
    for (int step = 0; step < W_STEPS; ++step) {
        if (step < W_BUILD) {
            copy_words<PT4>(op, at[1]);
        } else {
            if (step == W_BUILD) copy_words<PT4>(acc, P.b[0]);
            const int win = (step - W_BUILD) / 6;          // 0 = top window
            const int kind = (step - W_BUILD) % 6;         // 0-3 double, 4 B, 5 A
            const int limb = NLIMB - 1 - win / 3;
            const int shift = 8 - 4 * (win % 3);
            if (kind < 4) {
                copy_words<PT4>(op, acc);
            } else if (kind == 4) {
                const int ds = ((uint32_t)s[limb * batch + col] >> shift) & 15;
                copy_words<PT4>(op, bsh + ds * BSTRIDE);
            } else {
                const int dk = ((uint32_t)k[limb * batch + col] >> shift) & 15;
                copy_words<PT4>(op, at[dk]);
            }
        }
        ed_add(acc, acc, op, P);
        if (step < W_BUILD) copy_words<PT4>(at[step + 2], acc);
    }
    store_ext(X, Y, Z, T, acc, batch, col, P);
}

// plain schedule: one add builds B+A, then per scalar bit (264, most
// significant first) a doubling and an add of {0, B, A, B+A}[bit(s)
// + 2 bit(k)]
#define P_STEPS (1 + 2 * NLIMB * 12)

__global__ void __launch_bounds__(BLOCK)
ed_ladder_kernel(const EdParams P, const int32_t* __restrict__ s,
                 const int32_t* __restrict__ k, const int32_t* __restrict__ ax,
                 const int32_t* __restrict__ ay, int32_t* __restrict__ X,
                 int32_t* __restrict__ Y, int32_t* __restrict__ Z,
                 int32_t* __restrict__ T, int batch) {
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;

    uint32_t tab[4][PT4];
    uint32_t acc[PT4], op[PT4];
    copy_words<PT4>(tab[0], P.b[0]);
    copy_words<PT4>(tab[1], P.b[1]);
    load_a(tab[2], ax, ay, batch, col, P);
    copy_words<PT4>(acc, P.b[1]);
#pragma unroll 1
    for (int step = 0; step < P_STEPS; ++step) {
        if (step == 0) {
            copy_words<PT4>(op, tab[2]);
        } else {
            if (step == 1) copy_words<PT4>(acc, P.b[0]);
            const int bit = NLIMB * 12 - 1 - (step - 1) / 2;
            if ((step - 1) % 2 == 0) {
                copy_words<PT4>(op, acc);
            } else {
                const int limb = bit / 12, sh = bit % 12;
                const int idx = (((uint32_t)s[limb * batch + col] >> sh) & 1) |
                                ((((uint32_t)k[limb * batch + col] >> sh) & 1) << 1);
                copy_words<PT4>(op, tab[idx]);
            }
        }
        ed_add(acc, acc, op, P);
        if (step == 0) copy_words<PT4>(tab[3], acc);
    }
    store_ext(X, Y, Z, T, acc, batch, col, P);
}

// ---------------------------------------------------------------------------
// C interface (ctypes). The entry launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

extern "C" int corda_ed_params_words(void) {
    return (int)(sizeof(EdParams) / sizeof(uint32_t));
}

extern "C" const char* corda_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// registers, stack bytes, static shared bytes and resident warps per SM
// of the kernel that corda_ed_ladder(windowed, params, ...) launches
extern "C" int corda_ed_kernel_info(int windowed, const uint32_t* params, int* out) {
    (void)params;
    const void* fn = windowed ? (const void*)ed_ladder_windowed_kernel : (const void*)ed_ladder_kernel;
    cudaFuncAttributes a;
    int blocks = 0;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, BLOCK, 0);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = blocks * BLOCK / 32;
    return (int)e;
}

extern "C" int corda_ed_ladder(int windowed, const uint32_t* params, const int32_t* s,
                               const int32_t* k, const int32_t* ax, const int32_t* ay,
                               int32_t* X, int32_t* Y, int32_t* Z, int32_t* T, int batch,
                               void* stream) {
    EdParams P;
    memcpy(&P, params, sizeof(EdParams));
    cudaGetLastError();   // clear any stale error from earlier work
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((batch + BLOCK - 1) / BLOCK);
    cudaStream_t st = (cudaStream_t)stream;
    if (windowed) {
        ed_ladder_windowed_kernel<<<grid, BLOCK, 0, st>>>(P, s, k, ax, ay, X, Y, Z, T, batch);
    } else {
        ed_ladder_kernel<<<grid, BLOCK, 0, st>>>(P, s, k, ax, ay, X, Y, Z, T, batch);
    }
    return (int)cudaGetLastError();
}
