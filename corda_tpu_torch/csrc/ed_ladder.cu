// Double-scalar ladders R = s*B + k*A on ed25519 (twisted Edwards,
// a = -1) for Hopper (sm_90a), one signature per group of TPI = 4 lanes.
//
// Replaces (corda_tpu/crypto/pallas_ec.py):
//   ed_ladder_windowed_kernel  <- ed_ladder_windowed_pallas (w = 4,
//       14 adds build A multiples 2..15, then 66 windows: 4 doublings +
//       one add from the constant B table + one add from the
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
// Inside, field elements are 8 x 32-bit words of plain integers mod p,
// fully reduced to [0, p), spread over the signature's group: lane g
// holds words 2g and 2g + 1 of every coordinate. The multiply is
// field256_group.cuh's special form for p = 2^255 - 19 (gfe_mul_25519:
// the lanes gather both operands and each forms its own words of the
// product with the high half folded in as 38x, no serial round), the
// adds and subtracts that file's gfe_add / gfe_sub. Entry and exit
// convert on the group's lane 0 with field256.cuh's one-thread
// load_coord / store_coord, whose Montgomery multiply by c_in = 2^-8
// and c_out = 2^520 takes the 2^264 domain to the plain one and back.
//
// Formulas (Hisil-Wong-Carter-Dawson 2008, a = -1), all complete on
// ed25519 (-1 is a square, d is not), so the identity, A of order 2 or
// 4, and the s = L and s + L rows need no branch, and rows whose A
// failed to decode run on harmlessly and are masked by the caller:
//   - doubling dbl-2008-hwcd: 4 squares + 3 multiplies, + 1 for T, which
//     a step computes only where an add follows (or at the end);
//   - addition add-2008-hwcd-3 of a cached operand (Y - X, Y + X, 2Z,
//     2dT): 7 multiplies + 1 for T; a B entry is affine and cached on
//     the host as (y - x, y + x, 2dxy), so its add skips Z1 * 2Z2 (6 + 1).
// Each kernel has one add and one doubling call site, and its branches
// depend on the step only (uniform across a warp): zero digits and bits
// add the identity, as the TPU kernels do.
//
// What bounds it on this card: the dependent chain of each field
// multiply. At one signature per thread a 4,096-row chunk was 128
// warps, on 128 of the card's 528 schedulers; a group of 4 lanes per
// signature makes it 512 warps on all 132 SMs and cuts each lane's
// share of a multiply to a quarter. The special-form multiply then
// takes 18 shuffles and 4 ballots, about 4 of them in sequence, where
// the group's CIOS (wei_ladder.cu) chains 8 rounds of 3 shuffles. Memory
// traffic is 704 bytes per signature and never binds. The per-signature
// A table (and the plain ladder's {0, B, A, B+A}) is per-lane words in
// shared memory (group_points.cuh: no local memory, no barrier); the
// constant B table is in shared memory once per block, read at each
// group's own digit.

#include <cuda_runtime.h>
#include <string.h>

#include "group_points.cuh"

#define EPT (4 * WPL)        // an extended or cached point's words in one lane
#define BPT (3 * WPL)        // a B entry's words in one lane
#define BLOCK 64
#define WARPS (BLOCK / 32)

struct EdParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: the entry fold constant
    uint32_t c_in[NW];       // 2^-8 mod p: 2^264-domain -> plain, by load_coord's fe_mul
    uint32_t c_out[NW];      // 2^520 mod p: plain -> 2^264-domain, by store_coord's fe_mul
    uint32_t d2[NW];         // 2d mod p
    uint32_t pinv;           // -p^-1 mod 2^32 (the one-thread fe_mul at entry and exit)
    uint32_t b[16][3 * NW];  // B multiples 0..15 as (y - x, y + x, 2dxy), entry 0 = identity
};

// ---------------------------------------------------------------------------
// formulas. A point is extended (X, Y, Z, T) with T = XY/Z, or cached
// (Y - X, Y + X, 2Z, 2dT) as a table entry; out may alias the input.

// acc + q, q cached; affine: Z2 = 1 and q's 2Z words are not read.
// add-2008-hwcd-3; T3 only with want_t.
__device__ __forceinline__ void ed_add(uint32_t out[EPT], const uint32_t p1[EPT],
                                       const uint32_t q[EPT], bool affine, bool want_t,
                                       const GroupField& F) {
    const uint32_t* X1 = p1;
    const uint32_t* Y1 = p1 + WPL;
    const uint32_t* Z1 = p1 + 2 * WPL;
    const uint32_t* T1 = p1 + 3 * WPL;
    uint32_t a[WPL], b[WPL], c[WPL], d[WPL], e[WPL], h[WPL];

    gfe_sub(e, Y1, X1, F);
    gfe_mul_25519(a, e, q, F);                          // A = (Y1 - X1)(Y2 - X2)
    gfe_add(h, Y1, X1, F);
    gfe_mul_25519(b, h, q + WPL, F);                    // B = (Y1 + X1)(Y2 + X2)
    gfe_mul_25519(c, T1, q + 3 * WPL, F);               // C = T1 2d T2
    if (affine) {
        gfe_add(d, Z1, Z1, F);                          // D = 2 Z1
    } else {
        gfe_mul_25519(d, Z1, q + 2 * WPL, F);           // D = Z1 2 Z2
    }
    gfe_sub(e, b, a, F);                                // E = B - A
    gfe_add(h, b, a, F);                                // H = B + A
    gfe_sub(a, d, c, F);                                // F = D - C
    gfe_add(b, d, c, F);                                // G = D + C
    gfe_mul_25519(out, e, a, F);                        // X3 = E F
    gfe_mul_25519(out + WPL, b, h, F);                  // Y3 = G H
    gfe_mul_25519(out + 2 * WPL, a, b, F);              // Z3 = F G
    if (want_t) gfe_mul_25519(out + 3 * WPL, e, h, F);  // T3 = E H
}

// 2 p1, dbl-2008-hwcd with a = -1 (T1 is not read). E, G as there; the
// code holds -F and -H, so every output is negated: the same point.
// T3 only with want_t.
__device__ __forceinline__ void ed_dbl(uint32_t out[EPT], const uint32_t p1[EPT], bool want_t,
                                       const GroupField& F) {
    const uint32_t* X = p1;
    const uint32_t* Y = p1 + WPL;
    const uint32_t* Z = p1 + 2 * WPL;
    uint32_t xx[WPL], yy[WPL], c[WPL], e[WPL], g[WPL], h[WPL];

    gfe_add(e, X, Y, F);
    gfe_mul_25519(xx, X, X, F);
    gfe_mul_25519(yy, Y, Y, F);
    gfe_mul_25519(c, Z, Z, F);
    gfe_mul_25519(e, e, e, F);                          // (X + Y)^2
    gfe_add(c, c, c, F);                                // C = 2 Z^2
    gfe_add(h, xx, yy, F);                              // -H = X^2 + Y^2
    gfe_sub(g, yy, xx, F);                              // G = Y^2 - X^2
    gfe_sub(e, e, h, F);                                // E = 2XY
    gfe_sub(c, c, g, F);                                // -F = C - G
    gfe_mul_25519(out, e, c, F);                        // -X3 = E (-F)
    gfe_mul_25519(out + WPL, h, g, F);                  // -Y3 = G (-H)
    gfe_mul_25519(out + 2 * WPL, g, c, F);              // -Z3 = (-F) G
    if (want_t) gfe_mul_25519(out + 3 * WPL, e, h, F);  // -T3 = E (-H)
}

// extended -> cached (c must not alias p)
__device__ __forceinline__ void ed_cache(uint32_t c[EPT], const uint32_t p[EPT],
                                         const EdParams& P, const GroupField& F) {
    uint32_t d2[WPL];
    lane_words(d2, P.d2, F.g);
    gfe_sub(c, p + WPL, p, F);
    gfe_add(c + WPL, p + WPL, p, F);
    gfe_add(c + 2 * WPL, p + 2 * WPL, p + 2 * WPL, F);
    gfe_mul_25519(c + 3 * WPL, p + 3 * WPL, d2, F);
}

// ---------------------------------------------------------------------------
// points: constants, the B table, entry and exit

// this lane's words of 1
__device__ __forceinline__ void lane_one(uint32_t r[WPL], int g) {
#pragma unroll
    for (int k = 0; k < WPL; ++k) r[k] = g == 0 && k == 0;
}

// this lane's words of the extended identity (0, 1, 1, 0)
__device__ __forceinline__ void ext_identity(uint32_t pt[EPT], int g) {
#pragma unroll
    for (int k = 0; k < WPL; ++k) pt[k] = pt[3 * WPL + k] = 0;
    lane_one(pt + WPL, g);
    lane_one(pt + 2 * WPL, g);
}

// this lane's words of a constant B entry (y - x, y + x, 2dxy) in
// cached form, 2Z = 2
__device__ __forceinline__ void b_cached(uint32_t c[EPT], const uint32_t w[3 * NW],
                                         const GroupField& F) {
    uint32_t one[WPL];
    lane_words(c, w, F.g);
    lane_words(c + WPL, w + NW, F.g);
    lane_words(c + 3 * WPL, w + 2 * NW, F.g);
    lane_one(one, F.g);
    gfe_add(c + 2 * WPL, one, one, F);
}

// The constant B table once per block in shared memory: word i (< BPT)
// of entry e for lane g of a group at (i * 16 + e) * TPI + g, so a
// warp's groups reading different entries mostly hit different banks.
__device__ __forceinline__ void b_table_load(uint32_t* sh, const EdParams& P) {
    if (threadIdx.x == 0) {   // unrolled: constant indices into P
#pragma unroll
        for (int e = 0; e < 16; ++e)
#pragma unroll
            for (int w = 0; w < 3 * NW; ++w) {
                const int i = w / NW * WPL + w % WPL;
                sh[(i * 16 + e) * TPI + (w % NW) / WPL] = P.b[e][w];
            }
    }
    __syncthreads();
}

// entry e of the B table in cached form (the 2Z words are not set:
// the add takes it as affine)
__device__ __forceinline__ void b_table_get(uint32_t c[EPT], const uint32_t* sh, int e, int g) {
#pragma unroll
    for (int i = 0; i < BPT; ++i) c[i < 2 * WPL ? i : i + WPL] = sh[(i * 16 + e) * TPI + g];
}

// affine A from [22, B] digits -> extended (x, y, 1, xy), 2^256 domain
__device__ __forceinline__ void load_a(uint32_t a[EPT], const int32_t* ax, const int32_t* ay,
                                       int batch, int col, const EdParams& P,
                                       const GroupField& F) {
    group_load_coord(a, ax, batch, col, P, F);
    group_load_coord(a + WPL, ay, batch, col, P, F);
    lane_one(a + 2 * WPL, F.g);
    gfe_mul_25519(a + 3 * WPL, a, a + WPL, F);
}

__device__ __forceinline__ void store_ext(int32_t* X, int32_t* Y, int32_t* Z, int32_t* T,
                                          const uint32_t acc[EPT], int batch, int col, bool live,
                                          const EdParams& P, const GroupField& F) {
    group_store_coord(X, acc, batch, col, live, P, F);
    group_store_coord(Y, acc + WPL, batch, col, live, P, F);
    group_store_coord(Z, acc + 2 * WPL, batch, col, live, P, F);
    group_store_coord(T, acc + 3 * WPL, batch, col, live, P, F);
}

// ---------------------------------------------------------------------------
// kernels: each walks one schedule with a single ed_add and a single
// ed_dbl call site (acc = acc + operand, the operand chosen per step;
// acc = 2 acc); the branches depend on the step only, so they are
// uniform across a warp, as in wei_ladder.cu

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
    __shared__ uint32_t bsh[16 * BPT * TPI];          // B multiples, once per block
    __shared__ uint32_t ash[WARPS][16 * EPT * 32];    // A multiples, cached, per lane
    b_table_load(bsh, P);
    uint32_t* at = ash[threadIdx.x / 32];
    const GroupField F = group_field(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);

    uint32_t acc[EPT], op[EPT];
    ext_identity(acc, F.g);
    ed_cache(op, acc, P, F);
    tab_put<EPT>(at, 0, op);
    load_a(acc, ax, ay, batch, col, P, F);
    ed_cache(op, acc, P, F);
    tab_put<EPT>(at, 1, op);
#pragma unroll 1
    for (int step = 0; step < W_STEPS; ++step) {
        bool affine = true, want_t = true;
        if (step < W_BUILD) {
            tab_get<EPT>(op, at, 1);                      // A, Z = 1
        } else {
            const int win = (step - W_BUILD) / 6;         // 0 = top window
            const int kind = (step - W_BUILD) % 6;        // 0-3 double, 4 B, 5 A
            if (kind < 4) {
                if (step == W_BUILD) ext_identity(acc, F.g);
                ed_dbl(acc, acc, kind == 3, F);           // T where the adds follow
                continue;
            }
            const int limb = NLIMB - 1 - win / 3;
            const int shift = 8 - 4 * (win % 3);
            const int32_t* u = kind == 4 ? s : k;
            const int d = ((uint32_t)u[limb * batch + col] >> shift) & 15;
            if (kind == 4) {
                b_table_get(op, bsh, d, F.g);
            } else {
                tab_get<EPT>(op, at, d);
                affine = false;
                want_t = step == W_STEPS - 1;             // a doubling follows
            }
        }
        ed_add(acc, acc, op, affine, want_t, F);
        if (step < W_BUILD) {
            ed_cache(op, acc, P, F);
            tab_put<EPT>(at, step + 2, op);
        }
    }
    store_ext(X, Y, Z, T, acc, batch, col, live, P, F);
}

// plain schedule: one add builds A+B, then per scalar bit (264, most
// significant first) a doubling and an add of {0, B, A, B+A}[bit(s)
// + 2 bit(k)]
#define P_STEPS (1 + 2 * NLIMB * 12)

__global__ void __launch_bounds__(BLOCK)
ed_ladder_kernel(const EdParams P, const int32_t* __restrict__ s,
                 const int32_t* __restrict__ k, const int32_t* __restrict__ ax,
                 const int32_t* __restrict__ ay, int32_t* __restrict__ X,
                 int32_t* __restrict__ Y, int32_t* __restrict__ Z,
                 int32_t* __restrict__ T, int batch) {
    __shared__ uint32_t tsh[WARPS][4 * EPT * 32];     // {0, B, A, B+A}, cached, per lane
    uint32_t* tab = tsh[threadIdx.x / 32];
    const GroupField F = group_field(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);

    uint32_t acc[EPT], op[EPT];
    ext_identity(acc, F.g);
    ed_cache(op, acc, P, F);
    tab_put<EPT>(tab, 0, op);
    b_cached(op, P.b[1], F);
    tab_put<EPT>(tab, 1, op);
    load_a(acc, ax, ay, batch, col, P, F);
    ed_cache(op, acc, P, F);
    tab_put<EPT>(tab, 2, op);
#pragma unroll 1
    for (int step = 0; step < P_STEPS; ++step) {
        bool affine = true, want_t = true;
        if (step == 0) {
            tab_get<EPT>(op, tab, 1);                     // acc = A + B
        } else {
            if ((step - 1) % 2 == 0) {
                if (step == 1) ext_identity(acc, F.g);
                ed_dbl(acc, acc, true, F);                // an add follows
                continue;
            }
            const int bit = NLIMB * 12 - 1 - (step - 1) / 2;
            const int limb = bit / 12, sh = bit % 12;
            const int idx = (((uint32_t)s[limb * batch + col] >> sh) & 1) |
                            ((((uint32_t)k[limb * batch + col] >> sh) & 1) << 1);
            tab_get<EPT>(op, tab, idx);
            affine = false;
            want_t = step == P_STEPS - 1;                 // a doubling follows
        }
        ed_add(acc, acc, op, affine, want_t, F);
        if (step == 0) {
            ed_cache(op, acc, P, F);
            tab_put<EPT>(tab, 3, op);
        }
    }
    store_ext(X, Y, Z, T, acc, batch, col, live, P, F);
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
    const dim3 grid((unsigned)(((long long)batch * TPI + BLOCK - 1) / BLOCK));
    cudaStream_t st = (cudaStream_t)stream;
    if (windowed) {
        ed_ladder_windowed_kernel<<<grid, BLOCK, 0, st>>>(P, s, k, ax, ay, X, Y, Z, T, batch);
    } else {
        ed_ladder_kernel<<<grid, BLOCK, 0, st>>>(P, s, k, ax, ay, X, Y, Z, T, batch);
    }
    return (int)cudaGetLastError();
}
