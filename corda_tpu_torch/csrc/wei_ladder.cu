// Double-scalar ladders R = u1*G + u2*Q on a short-Weierstrass curve
// (secp256r1, secp256k1) for Hopper (sm_90a), one signature per group of
// TPI = 4 lanes.
//
// Replaces (corda_tpu/crypto/pallas_ec.py):
//   wei_ladder_windowed_kernel  <- wei_ladder_windowed_pallas (w = 4,
//       66 windows: 4 doublings + one add from the constant G table + one
//       add from the per-signature Q table, 14 adds to build)
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
// Montgomery domain, always fully reduced to [0, p), spread over the
// signature's group: lane g holds words 2g and 2g + 1 of every
// coordinate (field256_group.cuh). Entry and exit convert on the group's lane 0
// with field256.cuh's one-thread load_coord / store_coord. The complete
// RCB15 formulas dedicated to the curve's a (add and doubling; the
// CurveParams word a_zero picks the kernels' instantiation) make
// accept/reject at infinity exact with no branch.
//
// What bounds it on this card: the dependent chain of each field
// multiply. A 4,096-row chunk at one signature per thread was 128 warps,
// one on each of 128 of the card's 528 schedulers, every IMAD and carry
// of the CIOS chain waiting out its latency. A group of 4 lanes per
// signature makes the chunk 512 warps, about one per scheduler on all
// 132 SMs, and cuts each lane's chain to a quarter; the price is 3
// shuffles per multiply round (the shuffle pipe runs at half the IMAD
// rate) and the ballots that resolve carries between lanes. 8 lanes (one
// word each, 1,024 warps) ran 5-16% slower: the same shuffles then serve
// half the words. Memory traffic is 616 bytes per signature and never
// binds. The tables are per-lane words in shared memory (no local
// memory), laid out so that each warp access covers 32 consecutive words
// whatever entry each group reads.

#include <cuda_runtime.h>
#include <string.h>

#include "group_points.cuh"

#define PT (3 * NW)          // words per projective point
#define LPT (3 * WPL)        // a point's words in one lane
#define BLOCK 64
#define WARPS (BLOCK / 32)

struct CurveParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: Montgomery 1, also the fold constant
    uint32_t c_in[NW];       // 2^248: 2^264-domain -> 2^256-domain multiplier
    uint32_t c_out[NW];      // 2^264 mod p: 2^256-domain -> 2^264-domain multiplier
    uint32_t bm[NW];         // b * 2^256 mod p (a = -3) or 3b * 2^256 mod p (a = 0)
    uint32_t a_zero;         // 1: a = 0 (secp256k1), 0: a = -3 (secp256r1)
    uint32_t pinv;           // -p^-1 mod 2^32
    uint32_t g[16][PT];      // G multiples 0..15, projective, entry 0 = infinity
};

// a lane's constants: the field, and its words of bm
struct Curve {
    GroupField F;
    uint32_t bm[WPL];
};

__device__ __forceinline__ Curve curve_consts(const CurveParams& P) {
    Curve C;
    C.F = group_field(P);
    lane_words(C.bm, P.bm, C.F.g);
    return C;
}

// ---------------------------------------------------------------------------
// complete projective formulas of Renes, Costello and Batina (2016) for
// prime-order curves: addition, Algorithm 4 (a = -3) or 7 (a = 0), and
// doubling, Algorithm 6 (a = -3) or 9 (a = 0). Both are complete, so
// infinity (0 : 1 : 0) needs no branch. out may alias an input.

template <bool A0>
__device__ __forceinline__ void wei_add(uint32_t out[LPT], const uint32_t p1[LPT],
                                        const uint32_t p2[LPT], const Curve& C) {
    const GroupField& F = C.F;
    const uint32_t* X1 = p1;
    const uint32_t* Y1 = p1 + WPL;
    const uint32_t* Z1 = p1 + 2 * WPL;
    const uint32_t* X2 = p2;
    const uint32_t* Y2 = p2 + WPL;
    const uint32_t* Z2 = p2 + 2 * WPL;
    uint32_t t0[WPL], t1[WPL], t2[WPL], t3[WPL], t4[WPL];
    uint32_t X3[WPL], Y3[WPL], Z3[WPL];

    // steps 1-18, common to both
    gfe_mul(t0, X1, X2, F);
    gfe_mul(t1, Y1, Y2, F);
    gfe_mul(t2, Z1, Z2, F);
    gfe_add(t3, X1, Y1, F);
    gfe_add(t4, X2, Y2, F);
    gfe_mul(t3, t3, t4, F);
    gfe_add(t4, t0, t1, F);
    gfe_sub(t3, t3, t4, F);
    gfe_add(t4, Y1, Z1, F);
    gfe_add(X3, Y2, Z2, F);
    gfe_mul(t4, t4, X3, F);
    gfe_add(X3, t1, t2, F);
    gfe_sub(t4, t4, X3, F);
    gfe_add(X3, X1, Z1, F);
    gfe_add(Y3, X2, Z2, F);
    gfe_mul(X3, X3, Y3, F);
    gfe_add(Y3, t0, t2, F);
    gfe_sub(Y3, X3, Y3, F);
    if (A0) {   // Algorithm 7, steps 19-33; bm = 3b
        gfe_add(X3, t0, t0, F);
        gfe_add(t0, X3, t0, F);
        gfe_mul(t2, C.bm, t2, F);
        gfe_add(Z3, t1, t2, F);
        gfe_sub(t1, t1, t2, F);
        gfe_mul(Y3, C.bm, Y3, F);
        gfe_mul(X3, t4, Y3, F);
        gfe_mul(t2, t3, t1, F);
        gfe_sub(X3, t2, X3, F);
        gfe_mul(Y3, Y3, t0, F);
        gfe_mul(t1, t1, Z3, F);
        gfe_add(Y3, t1, Y3, F);
        gfe_mul(t0, t0, t3, F);
        gfe_mul(Z3, Z3, t4, F);
        gfe_add(Z3, Z3, t0, F);
    } else {    // Algorithm 4, steps 19-43; bm = b
        gfe_mul(Z3, C.bm, t2, F);
        gfe_sub(X3, Y3, Z3, F);
        gfe_add(Z3, X3, X3, F);
        gfe_add(X3, X3, Z3, F);
        gfe_sub(Z3, t1, X3, F);
        gfe_add(X3, t1, X3, F);
        gfe_mul(Y3, C.bm, Y3, F);
        gfe_add(t1, t2, t2, F);
        gfe_add(t2, t1, t2, F);
        gfe_sub(Y3, Y3, t2, F);
        gfe_sub(Y3, Y3, t0, F);
        gfe_add(t1, Y3, Y3, F);
        gfe_add(Y3, t1, Y3, F);
        gfe_add(t1, t0, t0, F);
        gfe_add(t0, t1, t0, F);
        gfe_sub(t0, t0, t2, F);
        gfe_mul(t1, t4, Y3, F);
        gfe_mul(t2, t0, Y3, F);
        gfe_mul(Y3, X3, Z3, F);
        gfe_add(Y3, Y3, t2, F);
        gfe_mul(X3, t3, X3, F);
        gfe_sub(X3, X3, t1, F);
        gfe_mul(Z3, t4, Z3, F);
        gfe_mul(t1, t3, t0, F);
        gfe_add(Z3, Z3, t1, F);
    }
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        out[k] = X3[k];
        out[WPL + k] = Y3[k];
        out[2 * WPL + k] = Z3[k];
    }
}

template <bool A0>
__device__ __forceinline__ void wei_dbl(uint32_t out[LPT], const uint32_t p1[LPT], const Curve& C) {
    const GroupField& F = C.F;
    const uint32_t* X = p1;
    const uint32_t* Y = p1 + WPL;
    const uint32_t* Z = p1 + 2 * WPL;
    uint32_t t0[WPL], t1[WPL], t2[WPL], X3[WPL], Y3[WPL], Z3[WPL];

    if (A0) {   // Algorithm 9; bm = 3b
        gfe_mul(t0, Y, Y, F);
        gfe_add(Z3, t0, t0, F);
        gfe_add(Z3, Z3, Z3, F);
        gfe_add(Z3, Z3, Z3, F);
        gfe_mul(t1, Y, Z, F);
        gfe_mul(t2, Z, Z, F);
        gfe_mul(t2, C.bm, t2, F);
        gfe_mul(X3, t2, Z3, F);
        gfe_add(Y3, t0, t2, F);
        gfe_mul(Z3, t1, Z3, F);
        gfe_add(t1, t2, t2, F);
        gfe_add(t2, t1, t2, F);
        gfe_sub(t0, t0, t2, F);
        gfe_mul(Y3, t0, Y3, F);
        gfe_add(Y3, X3, Y3, F);
        gfe_mul(t1, X, Y, F);
        gfe_mul(X3, t0, t1, F);
        gfe_add(X3, X3, X3, F);
    } else {    // Algorithm 6; bm = b
        uint32_t t3[WPL];
        gfe_mul(t0, X, X, F);
        gfe_mul(t1, Y, Y, F);
        gfe_mul(t2, Z, Z, F);
        gfe_mul(t3, X, Y, F);
        gfe_add(t3, t3, t3, F);
        gfe_mul(Z3, X, Z, F);
        gfe_add(Z3, Z3, Z3, F);
        gfe_mul(Y3, C.bm, t2, F);
        gfe_sub(Y3, Y3, Z3, F);
        gfe_add(X3, Y3, Y3, F);
        gfe_add(Y3, X3, Y3, F);
        gfe_sub(X3, t1, Y3, F);
        gfe_add(Y3, t1, Y3, F);
        gfe_mul(Y3, X3, Y3, F);
        gfe_mul(X3, X3, t3, F);
        gfe_add(t3, t2, t2, F);
        gfe_add(t2, t2, t3, F);
        gfe_mul(Z3, C.bm, Z3, F);
        gfe_sub(Z3, Z3, t2, F);
        gfe_sub(Z3, Z3, t0, F);
        gfe_add(t3, Z3, Z3, F);
        gfe_add(Z3, Z3, t3, F);
        gfe_add(t3, t0, t0, F);
        gfe_add(t0, t3, t0, F);
        gfe_sub(t0, t0, t2, F);
        gfe_mul(t0, t0, Z3, F);
        gfe_add(Y3, Y3, t0, F);
        gfe_mul(t0, Y, Z, F);
        gfe_add(t0, t0, t0, F);
        gfe_mul(Z3, t0, Z3, F);
        gfe_sub(X3, X3, Z3, F);
        gfe_mul(Z3, t0, t1, F);
        gfe_add(Z3, Z3, Z3, F);
        gfe_add(Z3, Z3, Z3, F);
    }
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        out[k] = X3[k];
        out[WPL + k] = Y3[k];
        out[2 * WPL + k] = Z3[k];
    }
}

// ---------------------------------------------------------------------------
// points: entry and exit (tables: group_points.cuh)

__device__ __forceinline__ void load_q(uint32_t q[LPT], const int32_t* qx, const int32_t* qy,
                                       int batch, int col, const CurveParams& P,
                                       const GroupField& F) {
    group_load_coord(q, qx, batch, col, P, F);
    group_load_coord(q + WPL, qy, batch, col, P, F);
    lane_words(q + 2 * WPL, P.one, F.g);
}

__device__ __forceinline__ void store_pt(int32_t* X, int32_t* Y, int32_t* Z,
                                         const uint32_t acc[LPT], int batch, int col, bool live,
                                         const CurveParams& P, const GroupField& F) {
    group_store_coord(X, acc, batch, col, live, P, F);
    group_store_coord(Y, acc + WPL, batch, col, live, P, F);
    group_store_coord(Z, acc + 2 * WPL, batch, col, live, P, F);
}

// ---------------------------------------------------------------------------
// kernels, one instantiation per value of a (A0: a = 0)

// Each kernel walks one schedule with a single wei_add and a single
// wei_dbl call site (acc = acc + operand, the operand chosen per step;
// acc = 2 acc); the branches depend on the step only, so they are
// uniform across a warp.

// windowed schedule: 14 adds build Q multiples 2..15 (acc += Q), then
// per 4-bit window (66, most significant first) 4 doublings, + G[d1],
// + Q[d2]
#define W_BUILD 14
#define W_STEPS (W_BUILD + 66 * 6)

template <bool A0>
__global__ void __launch_bounds__(BLOCK)
wei_ladder_windowed_kernel(const CurveParams P, const int32_t* __restrict__ u1,
                           const int32_t* __restrict__ u2, const int32_t* __restrict__ qx,
                           const int32_t* __restrict__ qy, int32_t* __restrict__ X,
                           int32_t* __restrict__ Y, int32_t* __restrict__ Z, int batch) {
    __shared__ uint32_t gsh[WARPS][16 * LPT * 32];   // G multiples, per lane
    __shared__ uint32_t qsh[WARPS][16 * LPT * 32];   // Q multiples, per lane
    uint32_t* gt = gsh[threadIdx.x / 32];
    uint32_t* qt = qsh[threadIdx.x / 32];
    const Curve C = curve_consts(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);

    uint32_t acc[LPT], op[LPT];
#pragma unroll
    for (int e = 0; e < 16; ++e) {   // unrolled: constant indices into P
        const_point<3>(op, P.g[e], C.F.g);
        tab_put<LPT>(gt, e, op);
    }
    const_point<3>(op, P.g[0], C.F.g);
    tab_put<LPT>(qt, 0, op);                        // infinity
    load_q(acc, qx, qy, batch, col, P, C.F);
    tab_put<LPT>(qt, 1, acc);
#pragma unroll 1
    for (int step = 0; step < W_STEPS; ++step) {
        if (step < W_BUILD) {
            tab_get<LPT>(op, qt, 1);
        } else {
            const int win = (step - W_BUILD) / 6;          // 0 = top window
            const int kind = (step - W_BUILD) % 6;         // 0-3 double, 4 G, 5 Q
            if (kind < 4) {
                if (step == W_BUILD) const_point<3>(acc, P.g[0], C.F.g);
                wei_dbl<A0>(acc, acc, C);
                continue;
            }
            const int limb = NLIMB - 1 - win / 3;
            const int shift = 8 - 4 * (win % 3);
            const int32_t* u = kind == 4 ? u1 : u2;
            const int d = ((uint32_t)u[limb * batch + col] >> shift) & 15;
            tab_get<LPT>(op, kind == 4 ? gt : qt, d);
        }
        wei_add<A0>(acc, acc, op, C);
        if (step < W_BUILD) tab_put<LPT>(qt, step + 2, acc);
    }
    store_pt(X, Y, Z, acc, batch, col, live, P, C.F);
}

// plain schedule: one add builds G+Q, then per scalar bit (264, most
// significant first) a doubling and an add of {inf, G, Q, G+Q}[bit(u1)
// + 2 bit(u2)]
#define P_STEPS (1 + 2 * NLIMB * 12)

template <bool A0>
__global__ void __launch_bounds__(BLOCK)
wei_ladder_kernel(const CurveParams P, const int32_t* __restrict__ u1,
                  const int32_t* __restrict__ u2, const int32_t* __restrict__ qx,
                  const int32_t* __restrict__ qy, int32_t* __restrict__ X,
                  int32_t* __restrict__ Y, int32_t* __restrict__ Z, int batch) {
    __shared__ uint32_t tsh[WARPS][4 * LPT * 32];    // {inf, G, Q, G+Q}, per lane
    uint32_t* tab = tsh[threadIdx.x / 32];
    const Curve C = curve_consts(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);

    uint32_t acc[LPT], op[LPT];
    const_point<3>(op, P.g[0], C.F.g);
    tab_put<LPT>(tab, 0, op);
    const_point<3>(acc, P.g[1], C.F.g);
    tab_put<LPT>(tab, 1, acc);
    load_q(op, qx, qy, batch, col, P, C.F);
    tab_put<LPT>(tab, 2, op);
#pragma unroll 1
    for (int step = 0; step < P_STEPS; ++step) {
        if (step > 0) {
            const int bit = NLIMB * 12 - 1 - (step - 1) / 2;
            if ((step - 1) % 2 == 0) {
                if (step == 1) const_point<3>(acc, P.g[0], C.F.g);
                wei_dbl<A0>(acc, acc, C);
                continue;
            }
            const int limb = bit / 12, sh = bit % 12;
            const int idx = (((uint32_t)u1[limb * batch + col] >> sh) & 1) |
                            ((((uint32_t)u2[limb * batch + col] >> sh) & 1) << 1);
            tab_get<LPT>(op, tab, idx);
        }
        wei_add<A0>(acc, acc, op, C);
        if (step == 0) tab_put<LPT>(tab, 3, acc);
    }
    store_pt(X, Y, Z, acc, batch, col, live, P, C.F);
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

typedef void (*LadderKernel)(const CurveParams, const int32_t*, const int32_t*, const int32_t*,
                             const int32_t*, int32_t*, int32_t*, int32_t*, int);

// the instantiation for the schedule and the curve's a
static LadderKernel ladder_kernel(int windowed, const CurveParams& P) {
    if (windowed) return P.a_zero ? wei_ladder_windowed_kernel<true> : wei_ladder_windowed_kernel<false>;
    return P.a_zero ? wei_ladder_kernel<true> : wei_ladder_kernel<false>;
}

// registers, stack bytes, static shared bytes and resident warps per SM
// of the kernel that corda_wei_ladder(windowed, params, ...) launches
extern "C" int corda_wei_kernel_info(int windowed, const uint32_t* params, int* out) {
    CurveParams P;
    memcpy(&P, params, sizeof(CurveParams));
    const void* fn = (const void*)ladder_kernel(windowed, P);
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

extern "C" int corda_wei_ladder(int windowed, const uint32_t* params, const int32_t* u1,
                                const int32_t* u2, const int32_t* qx, const int32_t* qy,
                                int32_t* X, int32_t* Y, int32_t* Z, int batch, void* stream) {
    CurveParams P;
    memcpy(&P, params, sizeof(CurveParams));
    cudaGetLastError();   // clear any stale error from earlier work
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(((long long)batch * TPI + BLOCK - 1) / BLOCK));
    ladder_kernel(windowed, P)<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P, u1, u2, qx, qy, X, Y, Z,
                                                                         batch);
    return (int)cudaGetLastError();
}
