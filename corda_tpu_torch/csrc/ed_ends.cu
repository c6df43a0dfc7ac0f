// The ed25519 verify program around its ladder (ed_ladder.cu) for Hopper
// (sm_90a), one row per thread: the prologue decodes A from its record,
// the epilogue maps the ladder's result to affine and compares it with R.
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
// Inside, field elements are 8 x 32-bit words in the R = 2^256
// Montgomery domain, fully reduced (field256.cuh's fe_mul and helpers);
// load_coord and store_coord convert from and to the ladder's 2^264
// domain. The square root's power (p - 5)/8 = 2^252 - 3 and the inverse's
// p - 2 = 2^255 - 21 are fixed addition chains sharing z^11 and
// z^(2^250 - 1): 251 squarings and 11 multiplies, or 254 and 11.
//
// What bounds them on this card: IMAD-rate multiplies, ~270-280 per row
// in a serial chain (each power step needs the last). At one row per
// thread a 4,096-row chunk is 128 warps, one per scheduler on a quarter
// of the card, so each warp's dependent chain sets the time, not the IMAD
// rate. The ~400-500 bytes per row never bind. Spreading a row over a
// lane group, as the ladders do, or fusing these into the ladders' entry
// and exit is later work.

#include <cuda_runtime.h>
#include <string.h>

#include "field256.cuh"

#define REC 128              // bytes per record
#define BLOCK 64

struct EdEndsParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: Montgomery 1, also load_coord's fold constant
    uint32_t c_in[NW];       // 2^248: 2^264 domain -> 2^256 (load_coord)
    uint32_t c_out[NW];      // 2^264 mod p: 2^256 domain -> 2^264 (store_coord)
    uint32_t pinv;           // -p^-1 mod 2^32
    uint32_t r2[NW];         // 2^512 mod p: plain -> 2^256 domain
    uint32_t dm[NW];         // d * 2^256 mod p
    uint32_t sqrt_m1[NW];    // sqrt(-1) * 2^256 mod p
};

// z^11 and z^(2^250 - 1), the common part of both chains (Montgomery domain)
__device__ __forceinline__ void chain_250(uint32_t z11[NW], uint32_t t250[NW],
                                          const uint32_t z[NW], const EdEndsParams& P) {
    uint32_t t0[NW], t1[NW], t2[NW];
    fe_mul(t0, z, z, P);                                // z^2
    fe_sqr_n(t1, t0, 2, P);                             // z^8
    fe_mul(t1, t1, z, P);                               // z^9
    fe_mul(z11, t0, t1, P);                             // z^11
    fe_mul(t0, z11, z11, P);                            // z^22
    fe_mul(t0, t0, t1, P);                              // z^(2^5 - 1)
    fe_sqr_n(t1, t0, 5, P);
    fe_mul(t0, t1, t0, P);                              // z^(2^10 - 1)
    fe_sqr_n(t1, t0, 10, P);
    fe_mul(t1, t1, t0, P);                              // z^(2^20 - 1)
    fe_sqr_n(t2, t1, 20, P);
    fe_mul(t1, t2, t1, P);                              // z^(2^40 - 1)
    fe_sqr_n(t1, t1, 10, P);
    fe_mul(t0, t1, t0, P);                              // z^(2^50 - 1)
    fe_sqr_n(t1, t0, 50, P);
    fe_mul(t1, t1, t0, P);                              // z^(2^100 - 1)
    fe_sqr_n(t2, t1, 100, P);
    fe_mul(t1, t2, t1, P);                              // z^(2^200 - 1)
    fe_sqr_n(t1, t1, 50, P);
    fe_mul(t250, t1, t0, P);                            // z^(2^250 - 1)
}

// ---------------------------------------------------------------------------
// kernels

__global__ void __launch_bounds__(BLOCK)
ed_prologue_kernel(const EdEndsParams P, const uint8_t* __restrict__ packed,
                   const int32_t* __restrict__ a_sign, const bool* __restrict__ valid_in,
                   int32_t* __restrict__ s, int32_t* __restrict__ k, int32_t* __restrict__ nax,
                   int32_t* __restrict__ nay, bool* __restrict__ ok, int batch) {
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;
    const uint8_t* rec = packed + (size_t)col * REC;
    uint32_t y[NW], t[NW];
    load_be32(t, rec);
    store_digits(s, t, batch, col);
    load_be32(t, rec + 32);
    store_digits(k, t, batch, col);

    load_be32(y, rec + 64);
    const bool ok_y = fe_lt(y, P.p);
    uint32_t one[NW];
    fe_small(one, 1);
    fe_select(y, ok_y, y, one);                          // benign y = 1 for the math

    uint32_t ym[NW], y2[NW], u[NW], v[NW], v3[NW], w[NW];
    fe_mul(ym, y, P.r2, P);                              // y * 2^256
    fe_mul(y2, ym, ym, P);
    fe_sub(u, y2, P.one, P);                             // y^2 - 1
    fe_mul(v, y2, P.dm, P);
    fe_add(v, v, P.one, P);                              // d y^2 + 1
    fe_mul(t, v, v, P);
    fe_mul(v3, t, v, P);                                 // v^3
    fe_mul(t, v3, v3, P);
    fe_mul(t, t, v, P);                                  // v^7
    fe_mul(t, u, t, P);                                  // u v^7
    uint32_t z11[NW];
    chain_250(z11, w, t, P);
    fe_sqr_n(w, w, 2, P);
    fe_mul(w, w, t, P);                                  // (u v^7)^(2^252 - 3)
    uint32_t cand[NW];
    fe_mul(cand, u, v3, P);
    fe_mul(cand, cand, w, P);                            // u v^3 (u v^7)^((p - 5)/8)

    fe_mul(t, cand, cand, P);
    fe_mul(t, v, t, P);                                  // v cand^2
    const bool is_pos = fe_eq(t, u);
    uint32_t neg_u[NW];
    fe_neg(neg_u, u, P);
    const bool is_neg = !is_pos && fe_eq(t, neg_u);
    uint32_t x[NW];
    fe_mul(x, cand, P.sqrt_m1, P);
    fe_select(x, is_pos, cand, x);

    fe_mul(t, x, one, P);                                // x, plain: its parity
    const bool x_zero = fe_is_zero(t);
    const int32_t sign = a_sign[col];
    // A.x has parity == sign; the verifier wants -A, so take the root
    // whose parity differs from sign (0 stays 0)
    uint32_t nx[NW];
    fe_neg(nx, x, P);
    fe_select(nx, (int32_t)(t[0] & 1) == sign, nx, x);
    store_coord(nax, nx, batch, col, P);
    store_coord(nay, ym, batch, col, P);
    ok[col] = valid_in[col] && ok_y && (is_pos || is_neg) && !(x_zero && sign == 1);
}

__global__ void __launch_bounds__(BLOCK)
ed_epilogue_kernel(const EdEndsParams P, const int32_t* __restrict__ X,
                   const int32_t* __restrict__ Y, const int32_t* __restrict__ Z,
                   const uint8_t* __restrict__ packed, const int32_t* __restrict__ exp_sign,
                   const bool* __restrict__ ok, bool* __restrict__ verdict, int batch) {
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;
    uint32_t x[NW], y[NW], z[NW], z11[NW], zi[NW], one[NW];
    load_coord(x, X, batch, col, P);
    load_coord(y, Y, batch, col, P);
    load_coord(z, Z, batch, col, P);
    chain_250(z11, zi, z, P);
    fe_sqr_n(zi, zi, 5, P);
    fe_mul(zi, zi, z11, P);                              // Z^(p - 2) = 1/Z (0 for Z = 0)
    fe_small(one, 1);
    fe_mul(x, x, zi, P);
    fe_mul(x, x, one, P);                                // affine x, plain
    fe_mul(y, y, zi, P);
    fe_mul(y, y, one, P);                                // affine y, plain
    uint32_t ry[NW];
    load_be32(ry, packed + (size_t)col * REC + 96);
    verdict[col] = ok[col] && fe_eq(y, ry) && (int32_t)(x[0] & 1) == exp_sign[col];
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

static dim3 grid_of(int batch) { return dim3((unsigned)((batch + BLOCK - 1) / BLOCK)); }

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
