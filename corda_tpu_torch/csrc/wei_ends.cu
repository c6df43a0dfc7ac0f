// The ECDSA verify program around its ladder (wei_ladder.cu) on
// secp256r1 and secp256k1 for Hopper (sm_90a), one row per thread: the
// prologue checks a record and computes the ladder's scalars, the
// epilogue checks the ladder's result against r.
//
// Replaces no Pallas kernel. In the reference the whole verification is
// one jitted XLA program (corda_tpu/crypto/batch_verifier.py:9-11,
// modmath.py:3-5), whose Fermat inverse mod n is a device loop (lax.scan
// in modmath.mont_pow_const); the port ran it as host-issued torch ops,
// ~31,000 per 4,096-row chunk. Kernels, with their plain torch versions in
// crypto/ecdsa.py:
//   ecdsa_prologue_kernel  <- everything ecdsa_verify_packed does before
//       the ladder: the range and on-curve checks, the benign
//       substitution and ecdsa_scalars (reference ecdsa.py:113, :71-74)
//   ecdsa_epilogue_kernel  <- the checks after the ladder (reference
//       ecdsa.py:97-106)
//
// Interface. Records are [B, 160] uint8, z | r | s | qx | qy, 32 bytes
// big-endian each (encodings.stage_ecdsa_packed); z is the hash, not
// reduced mod n. The prologue returns u1 = z/s and u2 = r/s mod n as
// canonical [22, B] digits, Q as canonical [22, B] digits of the ladder's
// R = 2^264 Montgomery domain, and valid[B] = valid_in, 0 < r < n, 0 < s <
// n, both coordinates < p and Q on the curve; a row failing a check gets
// the benign s = 1, r = 1, Q = G, so the ladder runs on defined inputs.
// The epilogue takes the ladder's projective X, Y, Z in that domain (Y is
// not read) and returns verdict[B] = valid, R not at infinity, and r * Z
// == X or (r + n) * Z == X (mod p), the second only where r + n < p: x_R
// == r (mod n) without an inversion.
//
// Inside, field elements are 8 x 32-bit words in the R = 2^256
// Montgomery domain mod p or mod n, fully reduced (field256.cuh's fe_mul
// and helpers, one parameter set per modulus); load_coord and store_coord
// convert from and to the ladder's 2^264 domain. A Montgomery product of
// a plain value < 2^256 by a Montgomery one is plain and reduced: so z,
// raw, multiplies 1/s straight to u1, and r and r + n multiply Z straight
// to the values compared with X. The inverse of s is s^(n - 2), the
// exponent's bits read from the parameters, most significant first: 256
// squarings and a multiply per set bit.
//
// What bounds them on this card: IMAD-rate multiplies, ~400 per row in
// the prologue in a serial chain (each power step needs the last), 5 in
// the epilogue. At one row per thread a 4,096-row chunk is 128 warps, one
// per scheduler on a quarter of the card, so each warp's dependent chain
// sets the time, not the IMAD rate. The ~350-550 bytes per row never
// bind. Spreading a row over a lane group, as the ladders do, a window
// for the power, or fusing these into the ladders' entry and exit is
// later work.

#include <cuda_runtime.h>
#include <string.h>

#include "field256.cuh"

#define REC 160              // bytes per record
#define BLOCK 64

// arithmetic mod n: fe_mul's p and pinv, and the inverse's constants
struct ModN {
    uint32_t p[NW];          // n
    uint32_t pinv;           // -n^-1 mod 2^32
    uint32_t r2[NW];         // 2^512 mod n: plain -> 2^256 domain
    uint32_t one[NW];        // 2^256 mod n: Montgomery 1
    uint32_t e[NW];          // n - 2: the inverse's exponent
};

struct WeiEndsParams {
    uint32_t p[NW];
    uint32_t one[NW];        // 2^256 mod p: Montgomery 1, also load_coord's fold constant
    uint32_t c_in[NW];       // 2^248: 2^264 domain -> 2^256 (load_coord)
    uint32_t c_out[NW];      // 2^264 mod p: 2^256 domain -> 2^264 (store_coord)
    uint32_t pinv;           // -p^-1 mod 2^32
    uint32_t r2[NW];         // 2^512 mod p: plain -> 2^256 domain
    uint32_t am[NW];         // a * 2^256 mod p
    uint32_t bm[NW];         // b * 2^256 mod p
    uint32_t gx[NW];         // G, plain: the benign Q
    uint32_t gy[NW];
    ModN n;
};

// r = a^e mod n, Montgomery domain, for the exponent N.e (r must not alias a)
__device__ __forceinline__ void pow_n(uint32_t r[NW], const uint32_t a[NW], const ModN& N) {
    fe_copy(r, N.one);
#pragma unroll
    for (int j = NW - 1; j >= 0; --j) {          // unrolled: constant indices into N.e
        const uint32_t w = N.e[j];
#pragma unroll 1
        for (int b = 31; b >= 0; --b) {
            fe_mul(r, r, r, N);
            if ((w >> b) & 1) fe_mul(r, r, a, N);  // the same branch in every thread
        }
    }
}

// 0 < v < n
__device__ __forceinline__ bool in_range_n(const uint32_t v[NW], const ModN& N) {
    return !fe_is_zero(v) && fe_lt(v, N.p);
}

// ---------------------------------------------------------------------------
// kernels

__global__ void __launch_bounds__(BLOCK)
ecdsa_prologue_kernel(const WeiEndsParams P, const uint8_t* __restrict__ packed,
                      const bool* __restrict__ valid_in, int32_t* __restrict__ u1,
                      int32_t* __restrict__ u2, int32_t* __restrict__ qx,
                      int32_t* __restrict__ qy, bool* __restrict__ valid, int batch) {
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;
    const uint8_t* rec = packed + (size_t)col * REC;
    uint32_t z[NW], r[NW], s[NW], x[NW], y[NW];
    load_be32(z, rec);
    load_be32(r, rec + 32);
    load_be32(s, rec + 64);
    load_be32(x, rec + 96);
    load_be32(y, rec + 128);
    const bool r_ok = in_range_n(r, P.n);
    const bool s_ok = in_range_n(s, P.n);

    // on the curve: y^2 == x^3 + a x + b (mod p), Montgomery domain
    uint32_t xm[NW], ym[NW], lhs[NW], rhs[NW], t[NW];
    fe_mul(xm, x, P.r2, P);
    fe_mul(ym, y, P.r2, P);
    fe_mul(lhs, ym, ym, P);
    fe_mul(t, xm, xm, P);
    fe_mul(rhs, t, xm, P);
    fe_mul(t, xm, P.am, P);
    fe_add(rhs, rhs, t, P);
    fe_add(rhs, rhs, P.bm, P);
    const bool q_ok = fe_lt(x, P.p) && fe_lt(y, P.p) && fe_eq(lhs, rhs);

    // the benign substitution
    uint32_t one[NW];
    fe_small(one, 1);
    fe_select(s, s_ok, s, one);
    fe_select(r, r_ok, r, one);
    fe_select(x, q_ok, x, P.gx);
    fe_select(y, q_ok, y, P.gy);
    fe_mul(xm, x, P.r2, P);
    fe_mul(ym, y, P.r2, P);
    store_coord(qx, xm, batch, col, P);
    store_coord(qy, ym, batch, col, P);

    // u1 = z/s, u2 = r/s (mod n)
    uint32_t sm[NW], w[NW], u[NW];
    fe_mul(sm, s, P.n.r2, P.n);                          // s * 2^256 mod n
    pow_n(w, sm, P.n);                                   // 2^256 / s mod n
    fe_mul(u, z, w, P.n);                                // z / s, plain, reduced
    store_digits(u1, u, batch, col);
    fe_mul(u, r, w, P.n);
    store_digits(u2, u, batch, col);
    valid[col] = valid_in[col] && r_ok && s_ok && q_ok;
}

__global__ void __launch_bounds__(BLOCK)
ecdsa_epilogue_kernel(const WeiEndsParams P, const int32_t* __restrict__ X,
                      const int32_t* __restrict__ Y, const int32_t* __restrict__ Z,
                      const uint8_t* __restrict__ packed, const bool* __restrict__ valid,
                      bool* __restrict__ verdict, int batch) {
    (void)Y;
    const int col = blockIdx.x * BLOCK + threadIdx.x;
    if (col >= batch) return;
    uint32_t xm[NW], zm[NW], x[NW], one[NW];
    load_coord(xm, X, batch, col, P);
    load_coord(zm, Z, batch, col, P);
    fe_small(one, 1);
    fe_mul(x, xm, one, P);                               // X, plain
    uint32_t r[NW], c1[NW], t[NW];
    load_be32(r, packed + (size_t)col * REC + 32);
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {                       // c1 = r + n
        c += (uint64_t)r[j] + P.n.p[j];
        c1[j] = (uint32_t)c;
        c >>= 32;
    }
    const bool c1_ok = c == 0 && fe_lt(c1, P.p);
    fe_mul(t, r, zm, P);                                 // r * Z, plain
    const bool chk0 = fe_eq(t, x);
    fe_mul(t, c1, zm, P);                                // (r + n) * Z, plain
    const bool chk1 = c1_ok && fe_eq(t, x);
    verdict[col] = valid[col] && !fe_is_zero(zm) && (chk0 || chk1);
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Each launch entry launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).

extern "C" int corda_wei_ends_params_words(void) {
    return (int)(sizeof(WeiEndsParams) / sizeof(uint32_t));
}

extern "C" const char* corda_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// registers, stack bytes, static shared bytes and resident warps per SM
// of the prologue (which = 0) or the epilogue (which = 1)
extern "C" int corda_wei_ends_kernel_info(int which, const uint32_t* params, int* out) {
    (void)params;
    const void* fn = which ? (const void*)ecdsa_epilogue_kernel : (const void*)ecdsa_prologue_kernel;
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

extern "C" int corda_ecdsa_prologue(const uint32_t* params, const uint8_t* packed,
                                    const bool* valid_in, int32_t* u1, int32_t* u2, int32_t* qx,
                                    int32_t* qy, bool* valid, int batch, void* stream) {
    WeiEndsParams P;
    memcpy(&P, params, sizeof(WeiEndsParams));
    cudaGetLastError();   // clear any stale error from earlier work
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    ecdsa_prologue_kernel<<<grid_of(batch), BLOCK, 0, (cudaStream_t)stream>>>(
        P, packed, valid_in, u1, u2, qx, qy, valid, batch);
    return (int)cudaGetLastError();
}

extern "C" int corda_ecdsa_epilogue(const uint32_t* params, const int32_t* X, const int32_t* Y,
                                    const int32_t* Z, const uint8_t* packed, const bool* valid,
                                    bool* verdict, int batch, void* stream) {
    WeiEndsParams P;
    memcpy(&P, params, sizeof(WeiEndsParams));
    cudaGetLastError();
    if (batch <= 0) return (int)cudaErrorInvalidValue;
    ecdsa_epilogue_kernel<<<grid_of(batch), BLOCK, 0, (cudaStream_t)stream>>>(
        P, X, Y, Z, packed, valid, verdict, batch);
    return (int)cudaGetLastError();
}
