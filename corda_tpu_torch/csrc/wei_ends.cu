// The ECDSA verify program around its ladder (wei_ladder.cu) on
// secp256r1 and secp256k1 for Hopper (sm_90a), one row per group of TPI =
// 4 lanes: the prologue checks a record and computes the ladder's
// scalars, the epilogue checks the ladder's result against r.
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
// Inside, as in wei_ladder.cu, field elements are 8 x 32-bit words in the
// R = 2^256 Montgomery domain, fully reduced, spread over the row's group
// (field256_group.cuh: lane g holds words 2g and 2g + 1), on two fields:
// Fp (mod p) and Fn (mod n), multiplied and squared by gfe_mul (the
// group's dedicated gfe_sqr ran ~5% slower here on the H100, PERF.md).
// Each lane loads its own words of the record; the entries of X
// and Z and the exits of Q convert on the group's lane 0
// (group_load_coord, group_store_coord: field256.cuh's one-thread
// conversions, c_in = 2^248, c_out = 2^264 mod p); comparisons are
// ballots over the group (gfe_lt, gfe_eq, gfe_is_zero); lane 0 writes
// u1, u2, valid and verdict. A Montgomery product of a plain value <
// 2^256 by a Montgomery one is plain and reduced: so z, raw, multiplies
// 1/s straight to u1, and r and r + n multiply Z straight to the values
// compared with X. The inverse of s is s^(n - 2) by fixed 4-bit windows,
// most significant first: a table of s^0 .. s^15 per lane in shared
// memory (group_points.cuh's tab_put / tab_get: no bank conflict, no
// barrier), then per window 4 squarings and, where the window is not 0,
// a multiply by its entry; the windows are parameters, the same in every
// thread. 252 squarings, 14 table products and 55 (p256) or 61 (k1)
// multiplies, against 256 squarings and 169 or 196 multiplies bit by bit.
//
// What bounds them on this card: the prologue's dependent chain of ~340
// field operations per row (each power step needs the last), the
// epilogue's 5. A 4,096-row chunk is 512 warps on all 132 SMs; each
// lane's share of an operation is a quarter, but a multiply is 16
// dependent shuffle rounds and 4 ballots. The 210-514 bytes per row
// never bind. Past the ragged edge a group computes on the last row
// (every lane must reach every exchange) and writes nothing.

#include <cuda_runtime.h>
#include <string.h>

#include "group_points.cuh"

#define REC 160              // bytes per record
#define BLOCK 64             // threads: 16 rows
#define WARPS (BLOCK / 32)
#define WIN 4                // bits per window of the inverse's exponent

// arithmetic mod n: group_field's p and pinv, and the inverse's constants
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

// r = a^e mod n, Montgomery domain, for the exponent N.e by WIN-bit
// windows; tab holds this warp's (1 << WIN) entries of WPL words per lane
__device__ __forceinline__ void pow_n(uint32_t r[WPL], const uint32_t a[WPL], const ModN& N,
                                      const GroupField& F, uint32_t* tab) {
    uint32_t t[WPL];
    lane_words(t, N.one, F.g);
    tab_put<WPL>(tab, 0, t);
    tab_put<WPL>(tab, 1, a);
    gfe_mul(t, a, a, F);
    tab_put<WPL>(tab, 2, t);
#pragma unroll 1
    for (int e = 3; e < (1 << WIN); ++e) {
        gfe_mul(t, t, a, F);
        tab_put<WPL>(tab, e, t);
    }
    tab_get<WPL>(r, tab, N.e[NW - 1] >> (32 - WIN));
#pragma unroll 1
    for (int i = 256 / WIN - 2; i >= 0; --i) {
        uint32_t w = 0;                              // the exponent's word: selects, not
#pragma unroll                                       // an index into the parameters
        for (int j = 0; j < NW; ++j)
            if (j == i * WIN / 32) w = N.e[j];
        const uint32_t d = (w >> (i * WIN % 32)) & ((1u << WIN) - 1);
#pragma unroll
        for (int q = 0; q < WIN; ++q) gfe_mul(r, r, r, F);
        if (d) {                                     // the same branch in every thread
            tab_get<WPL>(t, tab, d);
            gfe_mul(r, r, t, F);
        }
    }
}

// 0 < v < n, in every lane
__device__ __forceinline__ bool in_range(const uint32_t v[WPL], const GroupField& F) {
    const bool zero = gfe_is_zero(v, F);
    const bool lt = gfe_lt(v, F.p, F);
    return !zero && lt;
}

// this lane's words -> canonical [22, B] digits of that value, by lane 0
// where `live`
__device__ __forceinline__ void group_store_digits(int32_t* dst, const uint32_t a[WPL],
                                                   int batch, int col, bool live,
                                                   const GroupField& F) {
    uint32_t w[NW];
    group_gather(w, a, F);
    if (F.g == 0 && live) store_digits(dst, w, batch, col);
}

// ---------------------------------------------------------------------------
// kernels

__global__ void __launch_bounds__(BLOCK)
ecdsa_prologue_kernel(const WeiEndsParams P, const uint8_t* __restrict__ packed,
                      const bool* __restrict__ valid_in, int32_t* __restrict__ u1,
                      int32_t* __restrict__ u2, int32_t* __restrict__ qx,
                      int32_t* __restrict__ qy, bool* __restrict__ valid, int batch) {
    __shared__ uint32_t tsh[WARPS][(1 << WIN) * WPL * 32];   // s^0 .. s^15, per lane
    const GroupField Fp = group_field(P), Fn = group_field(P.n);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);
    const uint8_t* rec = packed + (size_t)col * REC;
    uint32_t z[WPL], r[WPL], s[WPL], x[WPL], y[WPL];
    group_load_be32(z, rec, Fp);
    group_load_be32(r, rec + 32, Fp);
    group_load_be32(s, rec + 64, Fp);
    group_load_be32(x, rec + 96, Fp);
    group_load_be32(y, rec + 128, Fp);
    const bool r_ok = in_range(r, Fn);
    const bool s_ok = in_range(s, Fn);

    // on the curve: y^2 == x^3 + a x + b (mod p), Montgomery domain; x
    // and y raw (< 2^256) times r2 (< p) keep gfe_mul's contract
    uint32_t c[WPL], xm[WPL], ym[WPL], lhs[WPL], rhs[WPL], t[WPL];
    lane_words(c, P.r2, Fp.g);
    gfe_mul(xm, x, c, Fp);
    gfe_mul(ym, y, c, Fp);
    gfe_mul(lhs, ym, ym, Fp);
    gfe_mul(t, xm, xm, Fp);
    gfe_mul(rhs, t, xm, Fp);
    lane_words(c, P.am, Fp.g);
    gfe_mul(t, xm, c, Fp);
    gfe_add(rhs, rhs, t, Fp);
    lane_words(c, P.bm, Fp.g);
    gfe_add(rhs, rhs, c, Fp);
    const bool x_ok = gfe_lt(x, Fp.p, Fp);            // every lane reaches every ballot
    const bool y_ok = gfe_lt(y, Fp.p, Fp);
    const bool on_curve = gfe_eq(lhs, rhs, Fp);
    const bool q_ok = x_ok && y_ok && on_curve;

    // the benign substitution, and Q to the 2^256 domain and out
    const uint32_t one[WPL] = {Fp.g == 0};             // this lane's words of 1
    lane_select(s, s_ok, s, one);
    lane_select(r, r_ok, r, one);
    lane_words(c, P.gx, Fp.g);
    lane_select(x, q_ok, x, c);
    lane_words(c, P.gy, Fp.g);
    lane_select(y, q_ok, y, c);
    lane_words(c, P.r2, Fp.g);
    gfe_mul(xm, x, c, Fp);
    gfe_mul(ym, y, c, Fp);
    group_store_coord(qx, xm, batch, col, live, P, Fp);
    group_store_coord(qy, ym, batch, col, live, P, Fp);

    // u1 = z/s, u2 = r/s (mod n); z raw (< 2^256) times w (< n)
    uint32_t w[WPL], u[WPL];
    lane_words(c, P.n.r2, Fn.g);
    gfe_mul(t, s, c, Fn);                              // s * 2^256 mod n
    pow_n(w, t, P.n, Fn, tsh[threadIdx.x / 32]);       // 2^256 / s mod n
    gfe_mul(u, z, w, Fn);                              // z / s, plain, reduced
    group_store_digits(u1, u, batch, col, live, Fn);
    gfe_mul(u, r, w, Fn);
    group_store_digits(u2, u, batch, col, live, Fn);
    if (Fp.g == 0 && live) valid[col] = valid_in[col] && r_ok && s_ok && q_ok;
}

__global__ void __launch_bounds__(BLOCK)
ecdsa_epilogue_kernel(const WeiEndsParams P, const int32_t* __restrict__ X,
                      const int32_t* __restrict__ Y, const int32_t* __restrict__ Z,
                      const uint8_t* __restrict__ packed, const bool* __restrict__ valid,
                      bool* __restrict__ verdict, int batch) {
    (void)Y;
    const GroupField F = group_field(P);
    bool live;
    const int col = group_col<BLOCK>(batch, &live);
    uint32_t xm[WPL], zm[WPL], x[WPL];
    group_load_coord(xm, X, batch, col, P, F);
    group_load_coord(zm, Z, batch, col, P, F);
    const uint32_t one[WPL] = {F.g == 0};
    gfe_mul(x, xm, one, F);                            // X, plain

    // c1 = r + n, its carries resolved: the carry out of 2^256 and c1 < p
    // gate the second candidate
    uint32_t r[WPL], n[WPL], c1[WPL], t[WPL];
    group_load_be32(r, packed + (size_t)col * REC + 32, F);
    lane_words(n, P.n.p, F.g);
    uint64_t c = 0;
    uint32_t ones = FULL_WARP;
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
        c += (uint64_t)r[k] + n[k];
        c1[k] = (uint32_t)c;
        c >>= 32;
        ones &= c1[k];
    }
    const uint32_t cin = group_carries(c != 0, ones == FULL_WARP, F);
    add_bit(c1, (cin >> F.g) & 1);
    const bool c1_lt = gfe_lt(c1, F.p, F);
    const bool c1_ok = ((cin >> TPI) & 1) == 0 && c1_lt;

    // r and c1 (< 2^256, raw) times Z (< p); both checks in every row
    gfe_mul(t, r, zm, F);                              // r * Z, plain
    const bool chk0 = gfe_eq(t, x, F);
    gfe_mul(t, c1, zm, F);                             // (r + n) * Z, plain
    const bool chk1 = gfe_eq(t, x, F);
    const bool z_zero = gfe_is_zero(zm, F);
    if (F.g == 0 && live) verdict[col] = valid[col] && !z_zero && (chk0 || (c1_ok && chk1));
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

// TPI threads per row
static dim3 grid_of(int batch) {
    return dim3((unsigned)(((long long)batch * TPI + BLOCK - 1) / BLOCK));
}

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
