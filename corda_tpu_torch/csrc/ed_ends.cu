// The ed25519 verify program around its ladder (ed_ladder.cu) for Hopper
// (sm_90a), one row per group of TPI = 4 lanes: the prologue decodes A
// from its record, the epilogue maps the ladder's result to affine and
// compares it with R.
//
// Replaces no Pallas kernel. In the reference the whole verification is
// one jitted XLA program (corda_tpu/crypto/batch_verifier.py:9-11,
// modmath.py:3-5), whose Fermat powers and square root are device loops
// (lax.scan in modmath.mont_pow_const); the port ran those as host-issued
// torch ops, ~75,000 per 4,096-row chunk. Kernels, with their plain
// torch versions in crypto/eddsa.py:
//   ed_prologue_kernel  <- eddsa.ed_decompress_neg_batch + the unpacking
//       of ed25519_verify_packed (reference eddsa.py:100)
//   ed_epilogue_kernel  <- ec.ed_ext_to_affine + the compare of
//       ed25519_verify_batch (reference eddsa.py:43, ec.py:404)
//
// Interface. Records are [B, 128] uint8, s | k | A.y | R.y, 32 bytes
// big-endian each, the sign bits stripped (encodings.stage_ed25519_packed).
// The prologue returns s and k as canonical [22, B] digits (s raw, never
// reduced mod L), -A as canonical [22, B] digits of the ladder's R = 2^264
// Montgomery domain, and ok[B] = valid_in and the decoding's verdict (y <
// p, A on the curve, not x = 0 with the sign bit set). The epilogue takes
// the ladder's extended X, Y, Z in that domain (T is not read) and
// returns verdict[B] = ok, the canonical affine y equal to the raw R.y
// (a non-canonical R.y >= p never is), and x's parity equal to R's sign
// bit.
//
// Inside, as in ed_ladder.cu, field elements are plain integers mod p,
// fully reduced, spread over the row's group (field256_group.cuh: lane g
// holds words 2g and 2g + 1), multiplied by the special-form
// gfe_mul_25519 and squared by gfe_sqr_25519. Each lane loads its own
// words of A.y and R.y from the record; the entries of X, Y, Z and the
// exits of -A.x, A.y convert on the group's lane 0 (group_load_coord with
// c_in = 2^-8, group_store_coord with c_out = 2^520). Comparisons are
// ballots over the group (gfe_lt, gfe_eq, gfe_is_zero), x's parity lane
// 0's low bit; lane 0 writes s, k, ok and verdict. The square root's
// power (p - 5)/8 = 2^252 - 3 and the inverse's p - 2 = 2^255 - 21 are
// fixed addition chains sharing z^11 and z^(2^250 - 1): 251 squarings
// and 11 multiplies, or 254 and 11.
//
// What bounds them on this card: the dependent chain of ~270 field
// operations per row. A 4,096-row chunk is 512 warps on all 132 SMs;
// each lane's share of a multiply is a quarter, its steps about 4
// dependent shuffle and ballot rounds, and a squaring forms 9 products
// per lane from one gather, where a multiply forms 16 from two. The
// ~400-500 bytes per row never bind. Past the ragged edge a group
// computes on the last row (every lane must reach every exchange) and
// writes nothing.

#include <cuda_runtime.h>
#include <string.h>

#include "group_points.cuh"

#define REC 128              // bytes per record
#define BLOCK 64             // threads: 16 rows

struct EdEndsParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: load_coord's fold constant
    uint32_t c_in[NW];       // 2^-8 mod p: 2^264 domain -> plain (load_coord's fe_mul)
    uint32_t c_out[NW];      // 2^520 mod p: plain -> 2^264 domain (store_coord's fe_mul)
    uint32_t pinv;           // -p^-1 mod 2^32 (the one-thread fe_mul at entry and exit)
    uint32_t d[NW];          // d
    uint32_t sqrt_m1[NW];    // sqrt(-1) = 2^((p - 1)/4)
};

// r = a^(2^k), k >= 1 squarings (r may alias a)
__device__ __forceinline__ void sqr_n(uint32_t r[WPL], const uint32_t a[WPL], int k,
                                      const GroupField& F) {
    gfe_sqr_25519(r, a, F);
#pragma unroll 1
    for (int i = 1; i < k; ++i) gfe_sqr_25519(r, r, F);
}

// z^11 and z^(2^250 - 1), the common part of both chains
__device__ __forceinline__ void chain_250(uint32_t z11[WPL], uint32_t t250[WPL],
                                          const uint32_t z[WPL], const GroupField& F) {
    uint32_t t0[WPL], t1[WPL], t2[WPL];
    gfe_sqr_25519(t0, z, F);                            // z^2
    sqr_n(t1, t0, 2, F);                                // z^8
    gfe_mul_25519(t1, t1, z, F);                        // z^9
    gfe_mul_25519(z11, t0, t1, F);                      // z^11
    gfe_sqr_25519(t0, z11, F);                          // z^22
    gfe_mul_25519(t0, t0, t1, F);                       // z^(2^5 - 1)
    sqr_n(t1, t0, 5, F);
    gfe_mul_25519(t0, t1, t0, F);                       // z^(2^10 - 1)
    sqr_n(t1, t0, 10, F);
    gfe_mul_25519(t1, t1, t0, F);                       // z^(2^20 - 1)
    sqr_n(t2, t1, 20, F);
    gfe_mul_25519(t1, t2, t1, F);                       // z^(2^40 - 1)
    sqr_n(t1, t1, 10, F);
    gfe_mul_25519(t0, t1, t0, F);                       // z^(2^50 - 1)
    sqr_n(t1, t0, 50, F);
    gfe_mul_25519(t1, t1, t0, F);                       // z^(2^100 - 1)
    sqr_n(t2, t1, 100, F);
    gfe_mul_25519(t1, t2, t1, F);                       // z^(2^200 - 1)
    sqr_n(t1, t1, 50, F);
    gfe_mul_25519(t250, t1, t0, F);                     // z^(2^250 - 1)
}

// ---------------------------------------------------------------------------
// kernels

__global__ void __launch_bounds__(BLOCK)
ed_prologue_kernel(const EdEndsParams P, const uint8_t* __restrict__ packed,
                   const int32_t* __restrict__ a_sign, const bool* __restrict__ valid_in,
                   int32_t* __restrict__ s, int32_t* __restrict__ k, int32_t* __restrict__ nax,
                   int32_t* __restrict__ nay, bool* __restrict__ ok, int batch) {
    const GroupField F = group_field(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);
    const uint8_t* rec = packed + (size_t)col * REC;
    if (F.g == 0 && live) {                             // the raw scalars
        uint32_t w[NW];
        load_be32(w, rec);
        store_digits(s, w, batch, col);
        load_be32(w, rec + 32);
        store_digits(k, w, batch, col);
    }

    uint32_t y[WPL], one[WPL] = {F.g == 0};             // this lane's words of 1
    group_load_be32(y, rec + 64, F);
    const bool ok_y = gfe_lt(y, F.p, F);
    lane_select(y, ok_y, y, one);                       // benign y = 1 for the math

    uint32_t y2[WPL], u[WPL], v[WPL], v3[WPL], t[WPL], w[WPL], c[WPL];
    lane_words(c, P.d, F.g);
    gfe_sqr_25519(y2, y, F);
    gfe_sub(u, y2, one, F);                             // y^2 - 1
    gfe_mul_25519(v, y2, c, F);
    gfe_add(v, v, one, F);                              // d y^2 + 1
    gfe_sqr_25519(t, v, F);
    gfe_mul_25519(v3, t, v, F);                         // v^3
    gfe_sqr_25519(t, v3, F);
    gfe_mul_25519(t, t, v, F);                          // v^7
    gfe_mul_25519(t, u, t, F);                          // u v^7
    uint32_t z11[WPL];
    chain_250(z11, w, t, F);
    sqr_n(w, w, 2, F);
    gfe_mul_25519(w, w, t, F);                          // (u v^7)^(2^252 - 3)
    uint32_t cand[WPL];
    gfe_mul_25519(cand, u, v3, F);
    gfe_mul_25519(cand, cand, w, F);                    // u v^3 (u v^7)^((p - 5)/8)

    gfe_sqr_25519(t, cand, F);
    gfe_mul_25519(t, v, t, F);                          // v cand^2
    const bool is_pos = gfe_eq(t, u, F);
    uint32_t zero[WPL] = {}, neg_u[WPL];
    gfe_sub(neg_u, zero, u, F);
    const bool eq_neg = gfe_eq(t, neg_u, F);            // every lane reaches the ballot
    const bool is_neg = !is_pos && eq_neg;
    uint32_t x[WPL];
    lane_words(c, P.sqrt_m1, F.g);
    gfe_mul_25519(x, cand, c, F);
    lane_select(x, is_pos, cand, x);

    const bool x_zero = gfe_is_zero(x, F);
    const uint32_t x_odd = __shfl_sync(FULL_WARP, x[0], 0, TPI) & 1;
    const int32_t sign = a_sign[col];
    // A.x has parity == sign; the verifier wants -A, so take the root
    // whose parity differs from sign (0 stays 0)
    uint32_t nx[WPL];
    gfe_sub(nx, zero, x, F);
    lane_select(nx, (int32_t)x_odd == sign, nx, x);
    group_store_coord(nax, nx, batch, col, live, P, F);
    group_store_coord(nay, y, batch, col, live, P, F);
    if (F.g == 0 && live)
        ok[col] = valid_in[col] && ok_y && (is_pos || is_neg) && !(x_zero && sign == 1);
}

__global__ void __launch_bounds__(BLOCK)
ed_epilogue_kernel(const EdEndsParams P, const int32_t* __restrict__ X,
                   const int32_t* __restrict__ Y, const int32_t* __restrict__ Z,
                   const uint8_t* __restrict__ packed, const int32_t* __restrict__ exp_sign,
                   const bool* __restrict__ ok, bool* __restrict__ verdict, int batch) {
    const GroupField F = group_field(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);
    uint32_t x[WPL], y[WPL], z[WPL], z11[WPL], zi[WPL];
    group_load_coord(x, X, batch, col, P, F);
    group_load_coord(y, Y, batch, col, P, F);
    group_load_coord(z, Z, batch, col, P, F);
    chain_250(z11, zi, z, F);
    sqr_n(zi, zi, 5, F);
    gfe_mul_25519(zi, zi, z11, F);                      // Z^(p - 2) = 1/Z (0 for Z = 0)
    gfe_mul_25519(x, x, zi, F);                         // affine x
    gfe_mul_25519(y, y, zi, F);                         // affine y
    uint32_t ry[WPL];
    group_load_be32(ry, packed + (size_t)col * REC + 96, F);
    const bool y_eq = gfe_eq(y, ry, F);
    const uint32_t x_odd = __shfl_sync(FULL_WARP, x[0], 0, TPI) & 1;
    if (F.g == 0 && live) verdict[col] = ok[col] && y_eq && (int32_t)x_odd == exp_sign[col];
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Each launch entry launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

extern "C" int corda_ed_ends_params_words(void) {
    return (int)(sizeof(EdEndsParams) / sizeof(uint32_t));
}

extern "C" const char* corda_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// registers, stack bytes, static shared bytes and resident warps per SM
// of the prologue (which = 0) or the epilogue (which = 1)
extern "C" int corda_ed_ends_kernel_info(int which, const uint32_t* params, int* out) {
    (void)params;
    const void* fn = which ? (const void*)ed_epilogue_kernel : (const void*)ed_prologue_kernel;
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

// TPI threads per row
static dim3 grid_of(int batch) {
    return dim3((unsigned)(((long long)batch * TPI + BLOCK - 1) / BLOCK));
}

extern "C" int corda_ed_prologue(const uint32_t* params, const uint8_t* packed,
                                 const int32_t* a_sign, const bool* valid_in, int32_t* s,
                                 int32_t* k, int32_t* nax, int32_t* nay, bool* ok, int batch,
                                 void* stream) {
    EdEndsParams P;
    memcpy(&P, params, sizeof(EdEndsParams));
    cudaGetLastError();   // clear any stale error from earlier work
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    ed_prologue_kernel<<<grid_of(batch), BLOCK, 0, (cudaStream_t)stream>>>(
        P, packed, a_sign, valid_in, s, k, nax, nay, ok, batch);
    return (int)cudaGetLastError();
}

extern "C" int corda_ed_epilogue(const uint32_t* params, const int32_t* X, const int32_t* Y,
                                 const int32_t* Z, const uint8_t* packed,
                                 const int32_t* exp_sign, const bool* ok, bool* verdict,
                                 int batch, void* stream) {
    EdEndsParams P;
    memcpy(&P, params, sizeof(EdEndsParams));
    cudaGetLastError();
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    ed_epilogue_kernel<<<grid_of(batch), BLOCK, 0, (cudaStream_t)stream>>>(
        P, X, Y, Z, packed, exp_sign, ok, verdict, batch);
    return (int)cudaGetLastError();
}
