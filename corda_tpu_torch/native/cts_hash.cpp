// Native host-side codec and hashing of corda_tpu_torch: SHA-256,
// batched hashing, Merkle roots and proofs, the CTS codec, the ECDSA and
// ed25519 staging sweeps and the fused asset-contract sweep.
//
// The port's own copy of corda_tpu/native/cts_hash.cpp, byte for byte
// the same semantics: transaction ids are SHA-256 Merkle roots over
// component encodings (MerkleTree.kt:14-60: pairwise sha256(left||right),
// leaves zero-padded to a power of two), so the two packages' ids agree
// only if both codecs and both trees do. One native call replaces 2N-1
// Python-level hashlib round trips per tree.
//
// Semantics are LOCKED to the Python paths of corda_tpu_torch/core/
// serialization.py and crypto/{hashes,merkle,encodings}.py and
// finance/asset.py, which stay importable as the differential
// reference; tests/test_torch_native.py holds this library, those paths
// and both of the reference package's paths byte-equal. SHA-256 per
// FIPS 180-4 (public specification).
//
// Built at first use by corda_tpu_torch/native/build.py (g++, CPython C
// API only). Every function has internal linkage (anonymous namespace)
// except PyInit__cts_hash, so this library and the reference's load
// side by side in one process, each with its own codec configuration.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4)

static const uint32_t SHA256_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
    0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
    0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
    0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
    0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
    0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
    0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
    0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
    0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

#if defined(__x86_64__)
// Hardware SHA extension path (runtime-dispatched; the portable
// transform below stays the reference). The message schedule is the
// W4-chunk recurrence W4[g] = msg2(msg1(W4[g-4], W4[g-3]) +
// alignr(W4[g-1], W4[g-2], 4), W4[g-1]) — computed up front, then 16
// paired rnds2 rounds. Semantics pinned by the hashlib differential
// tests in tests/test_torch_native.py.
__attribute__((target("sha,sse4.1,ssse3")))
void sha256_blocks_shani(uint32_t state[8], const uint8_t* data,
                         size_t nblocks) {
    const __m128i MASK = _mm_set_epi64x(
        0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
    __m128i TMP = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(&state[0]));          // DCBA
    __m128i STATE1 = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(&state[4]));          // HGFE
    TMP = _mm_shuffle_epi32(TMP, 0xB1);                        // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);                  // EFGH
    __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);          // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);               // CDGH

    while (nblocks--) {
        const __m128i ABEF_SAVE = STATE0;
        const __m128i CDGH_SAVE = STATE1;
        __m128i w4[16];
        for (int g = 0; g < 4; g++) {
            w4[g] = _mm_shuffle_epi8(
                _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(data + 16 * g)),
                MASK);
        }
        for (int g = 4; g < 16; g++) {
            __m128i t = _mm_sha256msg1_epu32(w4[g - 4], w4[g - 3]);
            t = _mm_add_epi32(t, _mm_alignr_epi8(w4[g - 1], w4[g - 2], 4));
            w4[g] = _mm_sha256msg2_epu32(t, w4[g - 1]);
        }
        for (int g = 0; g < 16; g++) {
            __m128i MSG = _mm_add_epi32(
                w4[g],
                _mm_set_epi32(SHA256_K[4 * g + 3], SHA256_K[4 * g + 2],
                              SHA256_K[4 * g + 1], SHA256_K[4 * g]));
            STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
            MSG = _mm_shuffle_epi32(MSG, 0x0E);
            STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        }
        STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
        STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
        data += 64;
    }

    TMP = _mm_shuffle_epi32(STATE0, 0x1B);                     // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);                  // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);               // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);                  // HGFE
    _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), STATE0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), STATE1);
}

bool has_shani() {
    // raw cpuid, not __builtin_cpu_supports("sha"): older g++ (the
    // image ships 10.x) rejects "sha" as a feature name at compile
    // time, which used to fail the whole extension build — and a
    // failed build silently costs the native codec, not just SHA-NI.
    static const bool v = [] {
        unsigned a, b, c, d;
        if (!__get_cpuid_count(7, 0, &a, &b, &c, &d)) return false;
        const bool sha = (b >> 29) & 1;        // leaf 7 EBX bit 29
        if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
        const bool sse41 = (c >> 19) & 1;      // leaf 1 ECX bit 19
        const bool ssse3 = (c >> 9) & 1;       // leaf 1 ECX bit 9
        return sha && sse41 && ssse3;
    }();
    return v;
}
#else
bool has_shani() { return false; }
#endif

struct Sha256 {
    uint32_t state[8];
    uint64_t bitlen;
    uint8_t buffer[64];
    size_t buflen;

    Sha256() { reset(); }

    void reset() {
        static const uint32_t init[8] = {
            0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
        };
        std::memcpy(state, init, sizeof(init));
        bitlen = 0;
        buflen = 0;
    }

    static uint32_t rotr(uint32_t x, int n) {
        return (x >> n) | (x << (32 - n));
    }

    void transform(const uint8_t* chunk) {
#if defined(__x86_64__)
        if (has_shani()) {
            sha256_blocks_shani(state, chunk, 1);
            return;
        }
#endif
        const uint32_t* K = SHA256_K;
        uint32_t w[64];
        for (int i = 0; i < 16; i++) {
            w[i] = (uint32_t(chunk[i * 4]) << 24) |
                   (uint32_t(chunk[i * 4 + 1]) << 16) |
                   (uint32_t(chunk[i * 4 + 2]) << 8) |
                   uint32_t(chunk[i * 4 + 3]);
        }
        for (int i = 16; i < 64; i++) {
            uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                          (w[i - 15] >> 3);
            uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                          (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
        uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
        for (int i = 0; i < 64; i++) {
            uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            uint32_t ch = (e & f) ^ (~e & g);
            uint32_t t1 = h + S1 + ch + K[i] + w[i];
            uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
            uint32_t t2 = S0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        state[0] += a; state[1] += b; state[2] += c; state[3] += d;
        state[4] += e; state[5] += f; state[6] += g; state[7] += h;
    }

    void update(const uint8_t* data, size_t len) {
        bitlen += uint64_t(len) * 8;
        while (len > 0) {
            size_t take = 64 - buflen;
            if (take > len) take = len;
            std::memcpy(buffer + buflen, data, take);
            buflen += take;
            data += take;
            len -= take;
            if (buflen == 64) {
                transform(buffer);
                buflen = 0;
            }
        }
    }

    void finish(uint8_t out[32]) {
        // pad in place with memset, not byte-at-a-time update() calls:
        // ~55 un-inlined 1-byte updates per digest cost more than the
        // SHA-NI compression itself on the 64-byte messages the Merkle
        // interior is made of (bitlen is already final, so the buffer
        // writes below must bypass update's recounting)
        uint64_t bits = bitlen;
        buffer[buflen++] = 0x80;
        if (buflen > 56) {
            std::memset(buffer + buflen, 0, 64 - buflen);
            transform(buffer);
            buflen = 0;
        }
        std::memset(buffer + buflen, 0, 56 - buflen);
        for (int i = 0; i < 8; i++)
            buffer[56 + i] = uint8_t(bits >> (56 - 8 * i));
        transform(buffer);
        buflen = 0;
        for (int i = 0; i < 8; i++) {
            out[i * 4] = uint8_t(state[i] >> 24);
            out[i * 4 + 1] = uint8_t(state[i] >> 16);
            out[i * 4 + 2] = uint8_t(state[i] >> 8);
            out[i * 4 + 3] = uint8_t(state[i]);
        }
    }
};

void sha256_once(const uint8_t* data, size_t len, uint8_t out[32]) {
    Sha256 h;
    h.update(data, len);
    h.finish(out);
}

// ---------------------------------------------------------------------------
// Python surface

PyObject* py_sha256(PyObject*, PyObject* arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
    uint8_t out[32];
    sha256_once(static_cast<const uint8_t*>(view.buf), view.len, out);
    PyBuffer_Release(&view);
    return PyBytes_FromStringAndSize(reinterpret_cast<char*>(out), 32);
}

PyObject* py_sha256_many(PyObject*, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "sha256_many takes a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* result = PyList_New(n);
    if (!result) { Py_DECREF(seq); return nullptr; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) < 0) {
            Py_DECREF(result); Py_DECREF(seq); return nullptr;
        }
        uint8_t out[32];
        sha256_once(static_cast<const uint8_t*>(view.buf), view.len, out);
        PyBuffer_Release(&view);
        PyObject* b = PyBytes_FromStringAndSize(
            reinterpret_cast<char*>(out), 32);
        if (!b) { Py_DECREF(result); Py_DECREF(seq); return nullptr; }
        PyList_SET_ITEM(result, i, b);
    }
    Py_DECREF(seq);
    return result;
}

// MerkleTree.kt semantics shared by merkle_root / merkle_root_many:
// zero-pad to the next power of two, pairwise sha256(left || right) up
// to the root. `seq` is a PySequence_Fast of 32-byte leaves; 0 on
// success with the root in `out`, -1 with a Python error set.
static int merkle_root_of(PyObject* seq, uint8_t out[32]) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n == 0) {
        PyErr_SetString(PyExc_ValueError,
                        "cannot build a Merkle tree with no leaves");
        return -1;
    }
    size_t size = 1;
    while (size < size_t(n)) size *= 2;
    std::vector<uint8_t> level(size * 32, 0);   // zero padding built in
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) < 0) return -1;
        if (view.len != 32) {
            PyBuffer_Release(&view);
            PyErr_SetString(PyExc_ValueError, "leaves must be 32 bytes");
            return -1;
        }
        std::memcpy(&level[i * 32], view.buf, 32);
        PyBuffer_Release(&view);
    }
    while (size > 1) {
        for (size_t i = 0; i < size; i += 2) {
            uint8_t h[32];
            sha256_once(&level[i * 32], 64, h);
            std::memcpy(&level[(i / 2) * 32], h, 32);
        }
        size /= 2;
    }
    std::memcpy(out, level.data(), 32);
    return 0;
}

// merkle_root(leaves: sequence of 32-byte hashes) -> 32 bytes
PyObject* py_merkle_root(PyObject*, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "merkle_root takes a sequence");
    if (!seq) return nullptr;
    uint8_t out[32];
    int rc = merkle_root_of(seq, out);
    Py_DECREF(seq);
    if (rc < 0) return nullptr;
    return PyBytes_FromStringAndSize(reinterpret_cast<char*>(out), 32);
}

// merkle_root_many(leaf_lists: sequence of sequences of 32-byte
// hashes) -> [32 bytes, ...]. One C call computes every transaction
// id of an ingest batch (node/ingest.py batched Merkle-id stage)
// instead of a Python-level loop of per-tx calls.
PyObject* py_merkle_root_many(PyObject*, PyObject* arg) {
    PyObject* outer = PySequence_Fast(
        arg, "merkle_root_many takes a sequence of leaf sequences");
    if (!outer) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(outer);
    PyObject* result = PyList_New(n);
    if (!result) { Py_DECREF(outer); return nullptr; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* seq = PySequence_Fast(
            PySequence_Fast_GET_ITEM(outer, i),
            "merkle_root_many items must be sequences");
        if (!seq) { Py_DECREF(result); Py_DECREF(outer); return nullptr; }
        uint8_t out[32];
        int rc = merkle_root_of(seq, out);
        Py_DECREF(seq);
        if (rc < 0) { Py_DECREF(result); Py_DECREF(outer); return nullptr; }
        PyObject* b = PyBytes_FromStringAndSize(
            reinterpret_cast<char*>(out), 32);
        if (!b) { Py_DECREF(result); Py_DECREF(outer); return nullptr; }
        PyList_SET_ITEM(result, i, b);
    }
    Py_DECREF(outer);
    return result;
}

// Batch-signing shape (tx_signature.sign_tx_ids): build every tree
// level once, then emit each leaf's sibling path — (root, [path...])
// where path i is the concatenation of the 32-byte siblings bottom-up.
// One C call replaces 2N hashlib round trips plus N*log2(N) Python
// level lookups on the notary's reply-signing hot path.
PyObject* py_merkle_paths(PyObject*, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "merkle_paths takes a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n == 0) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError,
                        "cannot build a Merkle tree with no leaves");
        return nullptr;
    }
    size_t size = 1;
    while (size < size_t(n)) size *= 2;
    // levels[0] = padded leaves ... levels[d] = [root]
    std::vector<std::vector<uint8_t>> levels;
    levels.emplace_back(size * 32, 0);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_SIMPLE) < 0) {
            Py_DECREF(seq); return nullptr;
        }
        if (view.len != 32) {
            PyBuffer_Release(&view);
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "leaves must be 32 bytes");
            return nullptr;
        }
        std::memcpy(&levels[0][i * 32], view.buf, 32);
        PyBuffer_Release(&view);
    }
    Py_DECREF(seq);
    for (size_t w = size; w > 1; w /= 2) {
        const std::vector<uint8_t>& prev = levels.back();
        std::vector<uint8_t> next((w / 2) * 32);
        for (size_t i = 0; i < w; i += 2) {
            sha256_once(&prev[i * 32], 64, &next[(i / 2) * 32]);
        }
        levels.push_back(std::move(next));
    }
    size_t depth = levels.size() - 1;   // path length per leaf
    PyObject* paths = PyList_New(n);
    if (!paths) return nullptr;
    std::vector<uint8_t> path(depth * 32);
    for (Py_ssize_t i0 = 0; i0 < n; i0++) {
        size_t i = size_t(i0);
        for (size_t d = 0; d < depth; d++) {
            std::memcpy(&path[d * 32], &levels[d][(i ^ 1) * 32], 32);
            i /= 2;
        }
        PyObject* b = PyBytes_FromStringAndSize(
            reinterpret_cast<char*>(path.data()), depth * 32);
        if (!b) { Py_DECREF(paths); return nullptr; }
        PyList_SET_ITEM(paths, i0, b);
    }
    PyObject* root = PyBytes_FromStringAndSize(
        reinterpret_cast<char*>(levels.back().data()), 32);
    if (!root) { Py_DECREF(paths); return nullptr; }
    PyObject* out = PyTuple_Pack(2, root, paths);
    Py_DECREF(root);
    Py_DECREF(paths);
    return out;
}

// ---------------------------------------------------------------------------
// SHA-512 (FIPS 180-4) — one-shot, for the ed25519 staging sweep.

static const uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

static void sha512_once(const uint8_t* data, size_t len, uint8_t out[64]) {
    uint64_t st[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
        0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
        0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
    };
    // pad into a local message (staging rows are small: 96 + len)
    size_t total = len + 1 + 16;
    size_t blocks = (total + 127) / 128;
    std::vector<uint8_t> m(blocks * 128, 0);
    std::memcpy(m.data(), data, len);
    m[len] = 0x80;
    // 128-bit big-endian bit length (low 64 bits suffice here)
    uint64_t bits = uint64_t(len) * 8;
    for (int i = 0; i < 8; i++) {
        m[m.size() - 1 - i] = uint8_t(bits >> (8 * i));
    }
    for (size_t b = 0; b < blocks; b++) {
        const uint8_t* p = m.data() + b * 128;
        uint64_t w[80];
        for (int t = 0; t < 16; t++) {
            w[t] = 0;
            for (int k = 0; k < 8; k++) w[t] = (w[t] << 8) | p[t * 8 + k];
        }
        for (int t = 16; t < 80; t++) {
            uint64_t s0 = rotr64(w[t - 15], 1) ^ rotr64(w[t - 15], 8)
                          ^ (w[t - 15] >> 7);
            uint64_t s1 = rotr64(w[t - 2], 19) ^ rotr64(w[t - 2], 61)
                          ^ (w[t - 2] >> 6);
            w[t] = w[t - 16] + s0 + w[t - 7] + s1;
        }
        uint64_t a = st[0], bb = st[1], c = st[2], d = st[3];
        uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
        for (int t = 0; t < 80; t++) {
            uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
            uint64_t ch = (e & f) ^ (~e & g);
            uint64_t t1 = h + S1 + ch + SHA512_K[t] + w[t];
            uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
            uint64_t maj = (a & bb) ^ (a & c) ^ (bb & c);
            uint64_t t2 = S0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = bb; bb = a; a = t1 + t2;
        }
        st[0] += a; st[1] += bb; st[2] += c; st[3] += d;
        st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
    for (int i = 0; i < 8; i++) {
        for (int k = 0; k < 8; k++) {
            out[i * 8 + k] = uint8_t(st[i] >> (56 - 8 * k));
        }
    }
}

// ---------------------------------------------------------------------------
// 512-bit (little-endian bytes) mod the ed25519 group order
// L = 2^252 + c, c = 27742317777372353535851937790883648493.
//
// The fold uses 2^252 === -c (mod L): split x = hi*2^252 + lo and
// replace with the SIGNED value lo - hi*c; |x| shrinks by ~2^127 per
// fold, so three folds reduce any 512-bit input below 2^252 < L.
// Magnitudes live in 17 little-endian 32-bit limbs.

static const uint32_t ED_C_LIMBS[4] = {
    0x5cf5d3edU, 0x5812631aU, 0xa2f79cd6U, 0x14def9deU,
};
static const uint32_t ED_L_LIMBS[8] = {
    0x5cf5d3edU, 0x5812631aU, 0xa2f79cd6U, 0x14def9deU,
    0x00000000U, 0x00000000U, 0x00000000U, 0x10000000U,
};

#define ED_NLIMB 17

// a <=> b over ED_NLIMB limbs
static int ed_cmp(const uint32_t* a, const uint32_t* b) {
    for (int i = ED_NLIMB - 1; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

// out = a - b (requires a >= b)
static void ed_sub(const uint32_t* a, const uint32_t* b, uint32_t* out) {
    int64_t borrow = 0;
    for (int i = 0; i < ED_NLIMB; i++) {
        int64_t d = int64_t(a[i]) - b[i] - borrow;
        borrow = d < 0;
        if (d < 0) d += (int64_t(1) << 32);
        out[i] = uint32_t(d);
    }
}

static bool ed_is_zero_above(const uint32_t* a, int from) {
    for (int i = from; i < ED_NLIMB; i++) {
        if (a[i]) return false;
    }
    return true;
}

// digest64 (little-endian) mod L -> 32 bytes big-endian
static void mod_L_be(const uint8_t digest[64], uint8_t out_be[32]) {
    uint32_t x[ED_NLIMB] = {0};
    for (int i = 0; i < 16; i++) {
        x[i] = uint32_t(digest[i * 4]) | uint32_t(digest[i * 4 + 1]) << 8
               | uint32_t(digest[i * 4 + 2]) << 16
               | uint32_t(digest[i * 4 + 3]) << 24;
    }
    bool negative = false;
    // fold while anything lives at or above bit 252
    for (int rounds = 0; rounds < 8; rounds++) {
        if ((x[7] >> 28) == 0 && ed_is_zero_above(x, 8)) break;
        // hi = x >> 252 (shift = 7 limbs + 28 bits), lo = low 252 bits
        uint32_t hi[ED_NLIMB] = {0};
        for (int i = 0; i < ED_NLIMB - 7; i++) {
            uint32_t lo_part = x[i + 7] >> 28;
            uint32_t hi_part =
                (i + 8 < ED_NLIMB) ? (x[i + 8] << 4) : 0;
            hi[i] = lo_part | hi_part;
        }
        uint32_t lo[ED_NLIMB] = {0};
        for (int i = 0; i < 7; i++) lo[i] = x[i];
        lo[7] = x[7] & 0x0fffffffU;
        // prod = hi * c  (hi <= 2^260, c < 2^125 -> prod < 2^385)
        uint32_t prod[ED_NLIMB] = {0};
        for (int i = 0; i < ED_NLIMB; i++) {
            if (!hi[i]) continue;
            uint64_t carry = 0;
            for (int j = 0; j < 4 && i + j < ED_NLIMB; j++) {
                unsigned __int128 t =
                    (unsigned __int128)hi[i] * ED_C_LIMBS[j]
                    + prod[i + j] + carry;
                prod[i + j] = uint32_t(uint64_t(t) & 0xffffffffULL);
                carry = uint64_t(t >> 32);
            }
            for (int j = i + 4; j < ED_NLIMB && carry; j++) {
                uint64_t t = uint64_t(prod[j]) + carry;
                prod[j] = uint32_t(t & 0xffffffffULL);
                carry = t >> 32;
            }
        }
        // x = |lo - prod|, sign flips when prod > lo
        if (ed_cmp(lo, prod) >= 0) {
            ed_sub(lo, prod, x);
        } else {
            ed_sub(prod, lo, x);
            negative = !negative;
        }
    }
    // magnitude now < 2^252 < L; a negative value is L - magnitude
    if (negative && !ed_is_zero_above(x, 0)) {
        uint32_t l[ED_NLIMB] = {0};
        for (int i = 0; i < 8; i++) l[i] = ED_L_LIMBS[i];
        uint32_t r[ED_NLIMB];
        ed_sub(l, x, r);
        std::memcpy(x, r, sizeof(r));
    }
    for (int i = 0; i < 8; i++) {
        uint32_t limb = x[7 - i];
        out_be[i * 4] = uint8_t(limb >> 24);
        out_be[i * 4 + 1] = uint8_t(limb >> 16);
        out_be[i * 4 + 2] = uint8_t(limb >> 8);
        out_be[i * 4 + 3] = uint8_t(limb);
    }
}

// ---------------------------------------------------------------------------
// Batched ed25519 staging (encodings.stage_ed25519_packed semantics):
// per row s|k|A.y|R.y as 32-byte big-endian, plus sign bits + valid.

PyObject* py_stage_ed25519_many(PyObject*, PyObject* args) {
    PyObject* seq_obj; Py_ssize_t batch;
    if (!PyArg_ParseTuple(args, "On", &seq_obj, &batch)) return nullptr;
    PyObject* seq = PySequence_Fast(seq_obj, "expected a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > batch) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "more items than batch");
        return nullptr;
    }
    uint8_t benign[128];
    std::memset(benign, 0, 64);
    std::memset(benign + 64, 0, 64);
    benign[95] = 1;    // A.y = 1
    benign[127] = 1;   // R.y = 1
    PyObject* packed = PyBytes_FromStringAndSize(nullptr, batch * 128);
    PyObject* a_signs = PyList_New(batch);
    PyObject* r_signs = PyList_New(batch);
    PyObject* valid = PyList_New(batch);
    if (!packed || !a_signs || !r_signs || !valid) {
        Py_XDECREF(packed); Py_XDECREF(a_signs); Py_XDECREF(r_signs);
        Py_XDECREF(valid); Py_DECREF(seq);
        return nullptr;
    }
    uint8_t* out = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(packed));
    std::vector<uint8_t> msgbuf;
    for (Py_ssize_t row = 0; row < batch; row++) {
        uint8_t* rec = out + row * 128;
        bool ok = false;
        long a_sign = 0, r_sign = 0;
        if (row < n) {
            PyObject* item = PySequence_Fast_GET_ITEM(seq, row);
            PyObject* pub_o = PySequence_GetItem(item, 0);
            PyObject* sig_o = PySequence_GetItem(item, 1);
            PyObject* msg_o = PySequence_GetItem(item, 2);
            Py_buffer pub, sig, msg;
            bool pv = pub_o && sig_o && msg_o
                && PyObject_GetBuffer(pub_o, &pub, PyBUF_SIMPLE) == 0;
            bool sv = pv && PyObject_GetBuffer(sig_o, &sig, PyBUF_SIMPLE) == 0;
            bool mv = sv && PyObject_GetBuffer(msg_o, &msg, PyBUF_SIMPLE) == 0;
            if (mv && sig.len == 64 && pub.len == 32) {
                const uint8_t* sb = static_cast<const uint8_t*>(sig.buf);
                const uint8_t* pb = static_cast<const uint8_t*>(pub.buf);
                // k = sha512(R || A || M) mod L, big-endian out
                msgbuf.resize(64 + size_t(msg.len));
                std::memcpy(msgbuf.data(), sb, 32);
                std::memcpy(msgbuf.data() + 32, pb, 32);
                std::memcpy(msgbuf.data() + 64, msg.buf, msg.len);
                uint8_t digest[64];
                sha512_once(msgbuf.data(), msgbuf.size(), digest);
                mod_L_be(digest, rec + 32);
                // s: little-endian 32 -> big-endian
                for (int i = 0; i < 32; i++) rec[i] = sb[63 - i];
                // A.y / R.y: low 255 bits, little->big endian
                for (int i = 0; i < 32; i++) rec[64 + i] = pb[31 - i];
                rec[64] &= 0x7f;
                for (int i = 0; i < 32; i++) rec[96 + i] = sb[31 - i];
                rec[96] &= 0x7f;
                a_sign = (pb[31] >> 7) & 1;
                r_sign = (sb[31] >> 7) & 1;
                ok = true;
            }
            if (mv) PyBuffer_Release(&msg);
            if (sv) PyBuffer_Release(&sig);
            if (pv) PyBuffer_Release(&pub);
            Py_XDECREF(pub_o); Py_XDECREF(sig_o); Py_XDECREF(msg_o);
            if (PyErr_Occurred()) {
                Py_DECREF(packed); Py_DECREF(a_signs); Py_DECREF(r_signs);
                Py_DECREF(valid); Py_DECREF(seq);
                return nullptr;
            }
        }
        if (!ok) std::memcpy(rec, benign, 128);
        PyList_SET_ITEM(a_signs, row, PyLong_FromLong(a_sign));
        PyList_SET_ITEM(r_signs, row, PyLong_FromLong(r_sign));
        PyObject* flag = ok ? Py_True : Py_False;
        Py_INCREF(flag);
        PyList_SET_ITEM(valid, row, flag);
    }
    Py_DECREF(seq);
    PyObject* result = PyTuple_Pack(4, packed, a_signs, r_signs, valid);
    Py_DECREF(packed); Py_DECREF(a_signs); Py_DECREF(r_signs);
    Py_DECREF(valid);
    return result;
}

// ---------------------------------------------------------------------------
// Batched ECDSA staging (encodings.stage_ecdsa_packed semantics).
//
// Per row: z = sha256(message); STRICT DER parse of the signature
// (definite minimal lengths, minimal-magnitude non-negative integers,
// no trailing bytes — byte-for-byte the rules of
// encodings.parse_der_ecdsa, which is consensus-critical and
// differential-fuzzed against this in tests/test_torch_native.py); SEC1
// uncompressed public key (0x04 || 64 bytes). Output record is
// z|r|s|qx|qy as 32-byte big-endian each; malformed rows get the
// benign record with valid=false. Rows whose pubkey is COMPRESSED
// (0x02/0x03) need host field math to decompress — they are reported
// back for the Python path to patch.

// Strict DER length at b[i]; returns length or -1, advances *next.
static long der_len(const uint8_t* b, Py_ssize_t blen, Py_ssize_t i,
                    Py_ssize_t* next) {
    if (i >= blen) return -1;
    uint8_t first = b[i];
    if (first < 0x80) { *next = i + 1; return first; }
    int nlen = first & 0x7F;
    if (nlen == 0 || nlen > 2 || i + 1 + nlen > blen) return -1;
    long val = 0;
    for (int k = 0; k < nlen; k++) val = (val << 8) | b[i + 1 + k];
    if (val < 0x80 || (nlen == 2 && val < 0x100)) return -1;  // non-minimal
    *next = i + 1 + nlen;
    return val;
}

// Strict DER INTEGER at b[i] -> 32-byte BE into out (or fail).
// Returns false on malformed OR magnitude >= 2^256 (staging treats
// oversized r/s as invalid rows, same as the Python path's >>256).
static bool der_int256(const uint8_t* b, Py_ssize_t blen, Py_ssize_t i,
                       Py_ssize_t* next, uint8_t out[32]) {
    if (i >= blen || b[i] != 0x02) return false;
    Py_ssize_t j;
    long n = der_len(b, blen, i + 1, &j);
    if (n <= 0 || j + n > blen) return false;
    const uint8_t* body = b + j;
    if (body[0] & 0x80) return false;                        // negative
    if (n > 1 && body[0] == 0 && !(body[1] & 0x80)) return false;  // non-minimal
    // magnitude must fit 256 bits: <=32 bytes, or 33 with leading 0x00
    const uint8_t* mag = body;
    long mlen = n;
    if (mlen == 33 && mag[0] == 0) { mag++; mlen--; }
    if (mlen > 32) return false;
    std::memset(out, 0, 32);
    std::memcpy(out + (32 - mlen), mag, mlen);
    *next = j + n;
    return true;
}

PyObject* py_stage_ecdsa_many(PyObject*, PyObject* args) {
    PyObject* seq_obj; Py_ssize_t batch; Py_buffer g_rec;
    if (!PyArg_ParseTuple(args, "Ony*", &seq_obj, &batch, &g_rec))
        return nullptr;
    if (g_rec.len != 64) {
        PyBuffer_Release(&g_rec);
        PyErr_SetString(PyExc_ValueError, "g_rec must be 64 bytes");
        return nullptr;
    }
    PyObject* seq = PySequence_Fast(seq_obj, "expected a sequence");
    if (!seq) { PyBuffer_Release(&g_rec); return nullptr; }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (n > batch) {
        Py_DECREF(seq); PyBuffer_Release(&g_rec);
        PyErr_SetString(PyExc_ValueError, "more items than batch");
        return nullptr;
    }
    uint8_t benign[160];
    std::memset(benign, 0, 64);
    benign[63] = 1;                       // r = 1
    std::memset(benign + 64, 0, 32);
    benign[95] = 1;                       // s = 1
    std::memcpy(benign + 96, g_rec.buf, 64);
    PyObject* packed = PyBytes_FromStringAndSize(nullptr, batch * 160);
    PyObject* valid = PyList_New(batch);
    PyObject* fallback = PyList_New(0);
    if (!packed || !valid || !fallback) {
        Py_XDECREF(packed); Py_XDECREF(valid); Py_XDECREF(fallback);
        Py_DECREF(seq); PyBuffer_Release(&g_rec);
        return nullptr;
    }
    uint8_t* out = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(packed));
    for (Py_ssize_t row = 0; row < batch; row++) {
        uint8_t* rec = out + row * 160;
        bool ok = false;
        bool needs_python = false;
        if (row < n) {
            PyObject* item = PySequence_Fast_GET_ITEM(seq, row);
            PyObject* pub_o = PySequence_GetItem(item, 0);
            PyObject* sig_o = PySequence_GetItem(item, 1);
            PyObject* msg_o = PySequence_GetItem(item, 2);
            Py_buffer pub, sig, msg;
            bool views = pub_o && sig_o && msg_o
                && PyObject_GetBuffer(pub_o, &pub, PyBUF_SIMPLE) == 0;
            bool sv = views && PyObject_GetBuffer(sig_o, &sig, PyBUF_SIMPLE) == 0;
            bool mv = sv && PyObject_GetBuffer(msg_o, &msg, PyBUF_SIMPLE) == 0;
            if (mv) {
                const uint8_t* sb = static_cast<const uint8_t*>(sig.buf);
                uint8_t r32[32], s32[32];
                bool sig_ok = false;
                if (sig.len >= 2 && sb[0] == 0x30) {
                    Py_ssize_t i;
                    long total = der_len(sb, sig.len, 1, &i);
                    if (total >= 0 && i + total == sig.len) {
                        Py_ssize_t j;
                        if (der_int256(sb, sig.len, i, &j, r32)
                            && der_int256(sb, sig.len, j, &j, s32)
                            && j == sig.len) {
                            sig_ok = true;
                        }
                    }
                }
                const uint8_t* pb = static_cast<const uint8_t*>(pub.buf);
                if (sig_ok && pub.len == 65 && pb[0] == 0x04) {
                    sha256_once(static_cast<const uint8_t*>(msg.buf),
                                msg.len, rec);
                    std::memcpy(rec + 32, r32, 32);
                    std::memcpy(rec + 64, s32, 32);
                    std::memcpy(rec + 96, pb + 1, 64);
                    ok = true;
                } else if (sig_ok && pub.len == 33
                           && (pb[0] == 0x02 || pb[0] == 0x03)) {
                    needs_python = true;   // compressed: host sqrt
                }
            }
            if (mv) PyBuffer_Release(&msg);
            if (sv) PyBuffer_Release(&sig);
            if (views) PyBuffer_Release(&pub);
            Py_XDECREF(pub_o); Py_XDECREF(sig_o); Py_XDECREF(msg_o);
            if (PyErr_Occurred()) {
                Py_DECREF(packed); Py_DECREF(valid); Py_DECREF(fallback);
                Py_DECREF(seq); PyBuffer_Release(&g_rec);
                return nullptr;
            }
        }
        if (!ok) std::memcpy(rec, benign, 160);
        if (needs_python) {
            PyObject* idx = PyLong_FromSsize_t(row);
            if (!idx || PyList_Append(fallback, idx) < 0) {
                Py_XDECREF(idx);
                Py_DECREF(packed); Py_DECREF(valid); Py_DECREF(fallback);
                Py_DECREF(seq); PyBuffer_Release(&g_rec);
                return nullptr;
            }
            Py_DECREF(idx);
        }
        PyObject* flag = ok ? Py_True : Py_False;
        Py_INCREF(flag);
        PyList_SET_ITEM(valid, row, flag);
    }
    Py_DECREF(seq);
    PyBuffer_Release(&g_rec);
    PyObject* result = PyTuple_Pack(3, packed, valid, fallback);
    Py_DECREF(packed); Py_DECREF(valid); Py_DECREF(fallback);
    return result;
}

// ---------------------------------------------------------------------------
// Batched partial-Merkle-proof verification.
//
// Semantics locked to crypto/merkle.py PartialMerkleTree._root_for
// (PartialMerkleTree.kt:130 verify): walk known (index, hash) pairs up
// the padded tree, consuming proof hashes bottom-up left-to-right for
// missing siblings; reject on leaf-count mismatch, non-pow2 size,
// out-of-range index, exhausted or unused proof. Duplicate indices
// collapse last-wins exactly like dict(zip(indices, leaves)).

bool pmt_root_for(long tree_size,
                  const std::vector<long>& indices,
                  const std::vector<const uint8_t*>& leaves,
                  const std::vector<const uint8_t*>& proof,
                  uint8_t out_root[32]) {
    if (tree_size <= 0 || (tree_size & (tree_size - 1))) return false;
    if (indices.size() != leaves.size()) return false;
    if (indices.empty()) return false;   // a proof must prove something
    // dict(zip(indices, leaves)): insertion order, later wins
    std::vector<std::pair<long, std::array<uint8_t, 32>>> known;
    for (size_t k = 0; k < indices.size(); k++) {
        long idx = indices[k];
        if (idx < 0 || idx >= tree_size) return false;
        bool replaced = false;
        for (auto& kv : known) {
            if (kv.first == idx) {
                std::memcpy(kv.second.data(), leaves[k], 32);
                replaced = true;
                break;
            }
        }
        if (!replaced) {
            std::array<uint8_t, 32> h;
            std::memcpy(h.data(), leaves[k], 32);
            known.emplace_back(idx, h);
        }
    }
    std::sort(known.begin(), known.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    size_t proof_pos = 0;
    long size = tree_size;
    while (size > 1) {
        std::vector<std::pair<long, std::array<uint8_t, 32>>> next;
        for (size_t i = 0; i < known.size();) {
            long idx = known[i].first;
            long sib = idx ^ 1;
            uint8_t buf[64];
            std::array<uint8_t, 32> parent;
            if (i + 1 < known.size() && known[i + 1].first == sib) {
                std::memcpy(buf, known[i].second.data(), 32);
                std::memcpy(buf + 32, known[i + 1].second.data(), 32);
                i += 2;
            } else {
                if (proof_pos >= proof.size()) return false;
                const uint8_t* sh = proof[proof_pos++];
                if (idx % 2 == 0) {
                    std::memcpy(buf, known[i].second.data(), 32);
                    std::memcpy(buf + 32, sh, 32);
                } else {
                    std::memcpy(buf, sh, 32);
                    std::memcpy(buf + 32, known[i].second.data(), 32);
                }
                i += 1;
            }
            sha256_once(buf, 64, parent.data());
            next.emplace_back(idx / 2, parent);
        }
        known = std::move(next);
        size /= 2;
    }
    if (proof_pos != proof.size()) return false;
    std::memcpy(out_root, known[0].second.data(), 32);
    return true;
}

// collect a sequence of 32-byte bytes-likes into `out` pointer views;
// the Py_buffer views must stay alive while pointers are used
bool collect_hashes(PyObject* seq_obj, std::vector<Py_buffer>& views,
                    std::vector<const uint8_t*>& out) {
    PyObject* seq = PySequence_Fast(seq_obj, "expected a sequence of hashes");
    if (!seq) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_buffer view;
        if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(seq, i), &view,
                               PyBUF_SIMPLE) < 0) {
            Py_DECREF(seq);
            return false;
        }
        if (view.len != 32) {
            PyBuffer_Release(&view);
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError, "hashes must be 32 bytes");
            return false;
        }
        views.push_back(view);
        out.push_back(static_cast<const uint8_t*>(view.buf));
    }
    Py_DECREF(seq);
    return true;
}

// pmt_verify_many(items) -> list[bool]
// items: sequence of (tree_size, indices, proof_hashes, leaves, root)
PyObject* py_pmt_verify_many(PyObject*, PyObject* arg) {
    PyObject* seq = PySequence_Fast(arg, "pmt_verify_many takes a sequence");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* result = PyList_New(n);
    if (!result) { Py_DECREF(seq); return nullptr; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        PyObject* size_obj = PySequence_GetItem(item, 0);
        PyObject* idx_obj = PySequence_GetItem(item, 1);
        PyObject* proof_obj = PySequence_GetItem(item, 2);
        PyObject* leaves_obj = PySequence_GetItem(item, 3);
        PyObject* root_obj = PySequence_GetItem(item, 4);
        bool ok = false;
        bool error = false;
        if (size_obj && idx_obj && proof_obj && leaves_obj && root_obj) {
            long tree_size = PyLong_AsLong(size_obj);
            std::vector<long> indices;
            PyObject* idx_seq = PySequence_Fast(idx_obj, "indices");
            if (idx_seq && !(tree_size == -1 && PyErr_Occurred())) {
                Py_ssize_t ni = PySequence_Fast_GET_SIZE(idx_seq);
                indices.reserve(ni);
                for (Py_ssize_t k = 0; k < ni && !error; k++) {
                    long v = PyLong_AsLong(
                        PySequence_Fast_GET_ITEM(idx_seq, k));
                    if (v == -1 && PyErr_Occurred()) error = true;
                    indices.push_back(v);
                }
                std::vector<Py_buffer> views;
                std::vector<const uint8_t*> proof, leaves;
                Py_buffer root_view;
                bool have_root = false;
                if (!error && collect_hashes(proof_obj, views, proof) &&
                    collect_hashes(leaves_obj, views, leaves)) {
                    if (PyObject_GetBuffer(root_obj, &root_view,
                                           PyBUF_SIMPLE) == 0) {
                        have_root = true;
                        if (root_view.len == 32) {
                            uint8_t got[32];
                            ok = pmt_root_for(tree_size, indices, leaves,
                                              proof, got) &&
                                 std::memcmp(
                                     got, root_view.buf, 32) == 0;
                        }
                    } else {
                        error = true;
                    }
                } else {
                    error = PyErr_Occurred() != nullptr;
                }
                for (auto& v : views) PyBuffer_Release(&v);
                if (have_root) PyBuffer_Release(&root_view);
            } else {
                error = true;
            }
            Py_XDECREF(idx_seq);
        } else {
            error = true;
        }
        Py_XDECREF(size_obj); Py_XDECREF(idx_obj); Py_XDECREF(proof_obj);
        Py_XDECREF(leaves_obj); Py_XDECREF(root_obj);
        if (error && PyErr_Occurred()) {
            Py_DECREF(result); Py_DECREF(seq);
            return nullptr;
        }
        PyObject* b = ok ? Py_True : Py_False;
        Py_INCREF(b);
        PyList_SET_ITEM(result, i, b);
    }
    Py_DECREF(seq);
    return result;
}

// ---------------------------------------------------------------------------
// CTS codec — the native form of core/serialization.py's
// encode/decode. The byte format and every determinism rule (minimal
// varints, map keys sorted by encoded bytes, whitelist-only object
// decode) are LOCKED to the pure-Python reference; differential fuzz
// in tests/test_torch_native.py drives both over random object graphs and
// mutated byte strings. Configured once per process via cts_configure
// with the Python-side registry objects, so registration and cache
// invalidation stay single-sourced in Python.

struct CtsState {
    PyObject* err = nullptr;           // SerializationError
    PyObject* enc_cache = nullptr;     // dict type -> (header, custom, fields)
    PyObject* enc_resolver = nullptr;  // callable type -> info|None
    PyObject* registry_by_tag = nullptr;   // dict tag -> cls
    PyObject* custom_dec = nullptr;        // dict tag -> callable
    PyObject* construct = nullptr;     // _decode_dataclass(cls, kwargs)
    PyObject* unknown_getter = nullptr;    // _unknown_tag_handler()
    PyObject* varint_abs = nullptr;    // |int| -> varint bytes (big ints)
};
static CtsState g_cts;

static int cts_err(const char* msg) {
    PyErr_SetString(g_cts.err ? g_cts.err : PyExc_ValueError, msg);
    return -1;
}

struct CtsBuf {
    std::vector<uint8_t> v;
    void push(uint8_t b) { v.push_back(b); }
    void append(const void* p, size_t n) {
        const uint8_t* q = static_cast<const uint8_t*>(p);
        v.insert(v.end(), q, q + n);
    }
};

static void cts_put_varint(CtsBuf& out, uint64_t n) {
    while (true) {
        uint8_t b = n & 0x7F;
        n >>= 7;
        if (n) {
            out.push(b | 0x80);
        } else {
            out.push(b);
            return;
        }
    }
}

// mirrors serialization.py MAX_DEPTH: the nesting accept/reject
// decision must be implementation-independent
static const int CTS_MAX_DEPTH = 500;

static int cts_enc(PyObject* obj, CtsBuf& out, int depth);

static int cts_enc_int(PyObject* obj, CtsBuf& out) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (!overflow) {
        if (v == -1 && PyErr_Occurred()) return -1;
        if (v >= 0) {
            out.push(0x03);
            cts_put_varint(out, static_cast<uint64_t>(v));
        } else {
            out.push(0x04);
            // -v overflows at LLONG_MIN; -(v+1)+1 stays in range
            cts_put_varint(out, static_cast<uint64_t>(-(v + 1)) + 1);
        }
        return 0;
    }
    // beyond 64 bits: sign from Python, payload via the helper
    PyObject* zero = PyLong_FromLong(0);
    if (zero == nullptr) return -1;
    int neg = PyObject_RichCompareBool(obj, zero, Py_LT);
    Py_DECREF(zero);
    if (neg < 0) return -1;
    out.push(neg ? 0x04 : 0x03);
    PyObject* payload = PyObject_CallFunctionObjArgs(
        g_cts.varint_abs, obj, nullptr);
    if (payload == nullptr) return -1;
    char* p;
    Py_ssize_t n;
    if (PyBytes_AsStringAndSize(payload, &p, &n) < 0) {
        Py_DECREF(payload);
        return -1;
    }
    out.append(p, static_cast<size_t>(n));
    Py_DECREF(payload);
    return 0;
}

static int cts_enc_object(PyObject* obj, CtsBuf& out, int depth) {
    PyObject* tp = reinterpret_cast<PyObject*>(Py_TYPE(obj));
    // info = (header_bytes, custom_or_None, ((name_bytes, name), ...)).
    // STRONG ref for the duration: nested encoding runs arbitrary
    // Python (custom encoders, property getters) that may invalidate
    // the shared cache entry — a borrowed `info` would be freed under
    // us (round-5 review: reproduced as an interpreter abort).
    PyObject* info = PyDict_GetItemWithError(g_cts.enc_cache, tp);
    if (info != nullptr) {
        Py_INCREF(info);   // borrowed from the cache -> strong
    } else {
        if (PyErr_Occurred()) return -1;
        // cache miss: KEEP the resolver call's strong reference (and
        // check Py_None while still holding it) — the previous
        // decref-then-refetch relied on the resolver having stored the
        // tuple in the cache, a latent use-after-free if it ever
        // returned an uncached tuple (round-5 advisor).
        info = PyObject_CallFunctionObjArgs(g_cts.enc_resolver, tp, nullptr);
        if (info == nullptr) return -1;
        if (info == Py_None) {
            Py_DECREF(info);
            PyErr_Format(
                g_cts.err, "type %s is not canonically serializable",
                Py_TYPE(obj)->tp_name);
            return -1;
        }
    }
    PyObject* header = PyTuple_GET_ITEM(info, 0);
    PyObject* custom = PyTuple_GET_ITEM(info, 1);
    PyObject* fields = PyTuple_GET_ITEM(info, 2);
    char* hp;
    Py_ssize_t hn;
    if (PyBytes_AsStringAndSize(header, &hp, &hn) < 0) {
        Py_DECREF(info);
        return -1;
    }
    out.append(hp, static_cast<size_t>(hn));
    if (custom != Py_None) {
        PyObject* payload =
            PyObject_CallFunctionObjArgs(custom, obj, nullptr);
        int rc = payload == nullptr ? -1 : cts_enc(payload, out, depth + 1);
        Py_XDECREF(payload);
        Py_DECREF(info);
        return rc;
    }
    Py_ssize_t nf = PyTuple_GET_SIZE(fields);
    for (Py_ssize_t i = 0; i < nf; i++) {
        PyObject* pair = PyTuple_GET_ITEM(fields, i);
        PyObject* name_bytes = PyTuple_GET_ITEM(pair, 0);
        PyObject* name = PyTuple_GET_ITEM(pair, 1);
        char* np;
        Py_ssize_t nn;
        if (PyBytes_AsStringAndSize(name_bytes, &np, &nn) < 0) {
            Py_DECREF(info);
            return -1;
        }
        out.append(np, static_cast<size_t>(nn));
        PyObject* value = PyObject_GetAttr(obj, name);
        if (value == nullptr) {
            Py_DECREF(info);
            return -1;
        }
        int rc = cts_enc(value, out, depth + 1);
        Py_DECREF(value);
        if (rc < 0) {
            Py_DECREF(info);
            return -1;
        }
    }
    Py_DECREF(info);
    return 0;
}

static int cts_enc(PyObject* obj, CtsBuf& out, int depth) {
    if (depth > CTS_MAX_DEPTH) return cts_err("nesting too deep");
    if (Py_EnterRecursiveCall(" in CTS encode")) return -1;
    int rc = -1;
    if (obj == Py_None) {
        out.push(0x00);
        rc = 0;
    } else if (obj == Py_True) {
        out.push(0x01);
        rc = 0;
    } else if (obj == Py_False) {
        out.push(0x02);
        rc = 0;
    } else if (PyLong_Check(obj)) {
        rc = cts_enc_int(obj, out);
    } else if (PyBytes_Check(obj)) {
        char* p;
        Py_ssize_t n;
        PyBytes_AsStringAndSize(obj, &p, &n);
        out.push(0x05);
        cts_put_varint(out, static_cast<uint64_t>(n));
        out.append(p, static_cast<size_t>(n));
        rc = 0;
    } else if (PyByteArray_Check(obj)) {
        out.push(0x05);
        Py_ssize_t n = PyByteArray_GET_SIZE(obj);
        cts_put_varint(out, static_cast<uint64_t>(n));
        out.append(PyByteArray_AS_STRING(obj), static_cast<size_t>(n));
        rc = 0;
    } else if (PyUnicode_Check(obj)) {
        Py_ssize_t n;
        const char* p = PyUnicode_AsUTF8AndSize(obj, &n);
        if (p != nullptr) {
            out.push(0x06);
            cts_put_varint(out, static_cast<uint64_t>(n));
            out.append(p, static_cast<size_t>(n));
            rc = 0;
        }
    } else if (PyList_Check(obj) || PyTuple_Check(obj)) {
        // snapshot: nested encoding runs arbitrary Python that could
        // mutate a list mid-walk (tuples return themselves, no copy)
        PyObject* snap = PySequence_Tuple(obj);
        if (snap != nullptr) {
            Py_ssize_t n = PyTuple_GET_SIZE(snap);
            out.push(0x07);
            cts_put_varint(out, static_cast<uint64_t>(n));
            rc = 0;
            for (Py_ssize_t i = 0; i < n; i++) {
                if (cts_enc(PyTuple_GET_ITEM(snap, i), out,
                            depth + 1) < 0) {
                    rc = -1;
                    break;
                }
            }
            Py_DECREF(snap);
        }
    } else if (PyDict_Check(obj)) {
        out.push(0x08);
        cts_put_varint(out, static_cast<uint64_t>(PyDict_Size(obj)));
        std::vector<std::pair<std::string, std::string>> entries;
        entries.reserve(static_cast<size_t>(PyDict_Size(obj)));
        // snapshot for the same reason: PyDict_Next during reentrant
        // mutation is undefined behaviour
        PyObject* items = PyDict_Items(obj);
        rc = items == nullptr ? -1 : 0;
        Py_ssize_t n_items =
            items == nullptr ? 0 : PyList_GET_SIZE(items);
        for (Py_ssize_t j = 0; rc == 0 && j < n_items; j++) {
            PyObject* pair = PyList_GET_ITEM(items, j);
            CtsBuf kb, vb;
            if (cts_enc(PyTuple_GET_ITEM(pair, 0), kb, depth + 1) < 0 ||
                cts_enc(PyTuple_GET_ITEM(pair, 1), vb, depth + 1) < 0) {
                rc = -1;
                break;
            }
            entries.emplace_back(
                std::string(kb.v.begin(), kb.v.end()),
                std::string(vb.v.begin(), vb.v.end()));
        }
        Py_XDECREF(items);
        if (rc == 0) {
            // pair<string,string> sorts key-bytes-then-value-bytes —
            // exactly the reference's sorted((encode(k), encode(v)))
            std::sort(entries.begin(), entries.end());
            for (auto& e : entries) {
                out.append(e.first.data(), e.first.size());
                out.append(e.second.data(), e.second.size());
            }
        }
    } else if (PyFrozenSet_Check(obj)) {
        out.push(0x07);
        std::vector<std::string> items;
        PyObject* it = PyObject_GetIter(obj);
        rc = it == nullptr ? -1 : 0;
        if (it != nullptr) {
            PyObject* elem;
            while ((elem = PyIter_Next(it)) != nullptr) {
                CtsBuf eb;
                int erc = cts_enc(elem, eb, depth + 1);
                Py_DECREF(elem);
                if (erc < 0) {
                    rc = -1;
                    break;
                }
                items.emplace_back(eb.v.begin(), eb.v.end());
            }
            Py_DECREF(it);
            if (PyErr_Occurred()) rc = -1;
        }
        if (rc == 0) {
            std::sort(items.begin(), items.end());
            cts_put_varint(out, static_cast<uint64_t>(items.size()));
            for (auto& e : items) out.append(e.data(), e.size());
        }
    } else {
        rc = cts_enc_object(obj, out, depth);
    }
    Py_LeaveRecursiveCall();
    return rc;
}

// -- decoder ---------------------------------------------------------------

struct CtsRd {
    const uint8_t* p;
    Py_ssize_t n;
    Py_ssize_t i;
};

// Reads one varint; values that fit uint64 return via `out`. A wider
// value (the reference allows up to 640 bits) returns a Python int via
// `big` instead — callers using the value as a LENGTH treat that as
// out-of-bounds.
static int cts_rd_varint(CtsRd& r, uint64_t& out, PyObject** big) {
    int shift = 0;
    uint64_t val = 0;
    Py_ssize_t start = r.i;
    if (big != nullptr) *big = nullptr;
    while (true) {
        if (r.i >= r.n) return cts_err("truncated varint");
        uint8_t b = r.p[r.i++];
        if (shift < 64) val |= static_cast<uint64_t>(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            if (b == 0 && shift) return cts_err("non-minimal varint");
            if (shift >= 64 || (shift > 56 && (b >> (64 - shift)) != 0)) {
                // overflows uint64: rebuild exactly like the reference
                PyObject* acc = PyLong_FromLong(0);
                int s2 = 0;
                for (Py_ssize_t j = start; j < r.i && acc != nullptr; j++) {
                    PyObject* part =
                        PyLong_FromUnsignedLongLong(r.p[j] & 0x7F);
                    PyObject* shamt =
                        part == nullptr ? nullptr : PyLong_FromLong(s2);
                    PyObject* sh = shamt == nullptr
                        ? nullptr
                        : PyNumber_Lshift(part, shamt);
                    Py_XDECREF(part);
                    Py_XDECREF(shamt);
                    PyObject* merged = sh == nullptr
                        ? nullptr
                        : PyNumber_Or(acc, sh);
                    Py_XDECREF(sh);
                    Py_DECREF(acc);
                    acc = merged;
                    s2 += 7;
                }
                if (acc == nullptr) return -1;
                if (big == nullptr) {
                    Py_DECREF(acc);
                    return cts_err("length varint out of range");
                }
                *big = acc;
                return 0;
            }
            out = val;
            return 0;
        }
        shift += 7;
        if (shift > 640) return cts_err("varint too long");
    }
}

static PyObject* cts_dec(CtsRd& r, int depth);

// serialization.py _tuplify: lists (recursively) become tuples at
// dataclass-construction boundaries; everything else passes through.
// Pure C, GIL held, no callbacks — nothing can mutate mid-walk.
static PyObject* cts_tuplify(PyObject* v) {
    if (!PyList_Check(v)) return Py_NewRef(v);
    Py_ssize_t n = PyList_GET_SIZE(v);
    PyObject* t = PyTuple_New(n);
    if (t == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = cts_tuplify(PyList_GET_ITEM(v, i));
        if (item == nullptr) {
            Py_DECREF(t);
            return nullptr;
        }
        PyTuple_SET_ITEM(t, i, item);
    }
    return t;
}

static PyObject* cts_dec_str(CtsRd& r, const char* truncated_msg) {
    uint64_t n;
    if (cts_rd_varint(r, n, nullptr) < 0) return nullptr;
    if (n > static_cast<uint64_t>(r.n - r.i)) {
        cts_err(truncated_msg);
        return nullptr;
    }
    PyObject* s = PyUnicode_DecodeUTF8(
        reinterpret_cast<const char*>(r.p + r.i),
        static_cast<Py_ssize_t>(n), nullptr);
    if (s == nullptr) {
        PyErr_Clear();
        cts_err("invalid utf-8 in str");
        return nullptr;
    }
    r.i += static_cast<Py_ssize_t>(n);
    return s;
}

static PyObject* cts_dec_object(CtsRd& r, int depth) {
    PyObject* tname = cts_dec_str(r, "truncated tag");
    if (tname == nullptr) return nullptr;
    PyObject* cls = PyDict_GetItemWithError(g_cts.registry_by_tag, tname);
    if (cls == nullptr && PyErr_Occurred()) {
        Py_DECREF(tname);
        return nullptr;
    }
    int has_custom = PyDict_Contains(g_cts.custom_dec, tname);
    if (has_custom < 0) {
        Py_DECREF(tname);
        return nullptr;
    }
    if (cls == nullptr) {
        PyObject* handler =
            PyObject_CallFunctionObjArgs(g_cts.unknown_getter, nullptr);
        if (handler == nullptr) {
            Py_DECREF(tname);
            return nullptr;
        }
        if (handler == Py_None || has_custom) {
            Py_DECREF(handler);
            PyErr_Format(g_cts.err, "unknown object tag '%U'", tname);
            Py_DECREF(tname);
            return nullptr;
        }
        // field map -> handler(tname, kwargs)
        uint64_t nf;
        if (cts_rd_varint(r, nf, nullptr) < 0) {
            Py_DECREF(handler);
            Py_DECREF(tname);
            return nullptr;
        }
        PyObject* kwargs = PyDict_New();
        for (uint64_t k = 0; kwargs != nullptr && k < nf; k++) {
            PyObject* name = cts_dec(r, depth + 1);
            PyObject* value = name == nullptr ? nullptr : cts_dec(r, depth + 1);
            if (value == nullptr ||
                PyDict_SetItem(kwargs, name, value) < 0) {
                Py_XDECREF(name);
                Py_XDECREF(value);
                Py_CLEAR(kwargs);
                break;
            }
            Py_DECREF(name);
            Py_DECREF(value);
        }
        PyObject* obj = kwargs == nullptr
            ? nullptr
            : PyObject_CallFunctionObjArgs(handler, tname, kwargs, nullptr);
        Py_XDECREF(kwargs);
        Py_DECREF(handler);
        Py_DECREF(tname);
        return obj;
    }
    if (has_custom) {
        PyObject* dec = PyDict_GetItemWithError(g_cts.custom_dec, tname);
        Py_DECREF(tname);
        if (dec == nullptr) return nullptr;
        // strong ref: the payload decode below runs arbitrary Python
        // that could replace this registry entry (round-5 review)
        Py_INCREF(dec);
        PyObject* payload = cts_dec(r, depth + 1);
        PyObject* obj = payload == nullptr
            ? nullptr
            : PyObject_CallFunctionObjArgs(dec, payload, nullptr);
        Py_XDECREF(payload);
        Py_DECREF(dec);
        return obj;
    }
    Py_DECREF(tname);
    Py_INCREF(cls);   // same hazard: field decoding may re-register
    uint64_t nf;
    if (cts_rd_varint(r, nf, nullptr) < 0) {
        Py_DECREF(cls);
        return nullptr;
    }
    PyObject* kwargs = PyDict_New();
    for (uint64_t k = 0; kwargs != nullptr && k < nf; k++) {
        PyObject* name = cts_dec(r, depth + 1);
        PyObject* value = name == nullptr ? nullptr : cts_dec(r, depth + 1);
        // tuplify HERE (construct is _construct_pretuplified): saves
        // the Python-side tuplify recursion and second kwargs dict
        PyObject* tupled = value == nullptr ? nullptr : cts_tuplify(value);
        Py_XDECREF(value);
        if (tupled == nullptr || PyDict_SetItem(kwargs, name, tupled) < 0) {
            Py_XDECREF(name);
            Py_XDECREF(tupled);
            Py_CLEAR(kwargs);
            break;
        }
        Py_DECREF(name);
        Py_DECREF(tupled);
    }
    PyObject* obj = kwargs == nullptr
        ? nullptr
        : PyObject_CallFunctionObjArgs(g_cts.construct, cls, kwargs, nullptr);
    Py_XDECREF(kwargs);
    Py_DECREF(cls);
    return obj;
}

static PyObject* cts_dec(CtsRd& r, int depth) {
    if (depth > CTS_MAX_DEPTH) {
        cts_err("nesting too deep");
        return nullptr;
    }
    if (Py_EnterRecursiveCall(" in CTS decode")) return nullptr;
    PyObject* result = nullptr;
    if (r.i >= r.n) {
        cts_err("truncated");
    } else {
        uint8_t tag = r.p[r.i++];
        switch (tag) {
            case 0x00:
                result = Py_NewRef(Py_None);
                break;
            case 0x01:
                result = Py_NewRef(Py_True);
                break;
            case 0x02:
                result = Py_NewRef(Py_False);
                break;
            case 0x03:
            case 0x04: {
                uint64_t v;
                PyObject* big = nullptr;
                if (cts_rd_varint(r, v, &big) == 0) {
                    if (big != nullptr) {
                        result = tag == 0x04
                            ? PyNumber_Negative(big)
                            : Py_NewRef(big);
                        Py_DECREF(big);
                    } else if (tag == 0x03) {
                        result = PyLong_FromUnsignedLongLong(v);
                    } else {
                        PyObject* pos = PyLong_FromUnsignedLongLong(v);
                        result =
                            pos == nullptr ? nullptr : PyNumber_Negative(pos);
                        Py_XDECREF(pos);
                    }
                }
                break;
            }
            case 0x05: {
                uint64_t n;
                if (cts_rd_varint(r, n, nullptr) == 0) {
                    if (n > static_cast<uint64_t>(r.n - r.i)) {
                        cts_err("truncated bytes");
                    } else {
                        result = PyBytes_FromStringAndSize(
                            reinterpret_cast<const char*>(r.p + r.i),
                            static_cast<Py_ssize_t>(n));
                        r.i += static_cast<Py_ssize_t>(n);
                    }
                }
                break;
            }
            case 0x06:
                result = cts_dec_str(r, "truncated str");
                break;
            case 0x07: {
                uint64_t n;
                if (cts_rd_varint(r, n, nullptr) == 0) {
                    result = PyList_New(0);
                    for (uint64_t k = 0; result != nullptr && k < n; k++) {
                        PyObject* item = cts_dec(r, depth + 1);
                        if (item == nullptr ||
                            PyList_Append(result, item) < 0) {
                            Py_XDECREF(item);
                            Py_CLEAR(result);
                            break;
                        }
                        Py_DECREF(item);
                    }
                }
                break;
            }
            case 0x08: {
                uint64_t n;
                if (cts_rd_varint(r, n, nullptr) == 0) {
                    result = PyDict_New();
                    for (uint64_t k = 0; result != nullptr && k < n; k++) {
                        PyObject* key = cts_dec(r, depth + 1);
                        PyObject* value =
                            key == nullptr ? nullptr : cts_dec(r, depth + 1);
                        if (value == nullptr ||
                            PyDict_SetItem(result, key, value) < 0) {
                            Py_XDECREF(key);
                            Py_XDECREF(value);
                            Py_CLEAR(result);
                            break;
                        }
                        Py_DECREF(key);
                        Py_DECREF(value);
                    }
                }
                break;
            }
            case 0x09:
                result = cts_dec_object(r, depth);
                break;
            default:
                PyErr_Format(g_cts.err, "unknown tag byte 0x%x", tag);
        }
    }
    Py_LeaveRecursiveCall();
    return result;
}

PyObject* py_cts_configure(PyObject*, PyObject* args) {
    PyObject *err, *cache, *resolver, *by_tag, *custom_dec, *construct,
        *unknown_getter, *varint_abs;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOO", &err, &cache, &resolver, &by_tag,
            &custom_dec, &construct, &unknown_getter, &varint_abs))
        return nullptr;
    // hold them forever (module lifetime); re-configure swaps cleanly
    Py_INCREF(err);
    Py_INCREF(cache);
    Py_INCREF(resolver);
    Py_INCREF(by_tag);
    Py_INCREF(custom_dec);
    Py_INCREF(construct);
    Py_INCREF(unknown_getter);
    Py_INCREF(varint_abs);
    Py_XDECREF(g_cts.err);
    Py_XDECREF(g_cts.enc_cache);
    Py_XDECREF(g_cts.enc_resolver);
    Py_XDECREF(g_cts.registry_by_tag);
    Py_XDECREF(g_cts.custom_dec);
    Py_XDECREF(g_cts.construct);
    Py_XDECREF(g_cts.unknown_getter);
    Py_XDECREF(g_cts.varint_abs);
    g_cts.err = err;
    g_cts.enc_cache = cache;
    g_cts.enc_resolver = resolver;
    g_cts.registry_by_tag = by_tag;
    g_cts.custom_dec = custom_dec;
    g_cts.construct = construct;
    g_cts.unknown_getter = unknown_getter;
    g_cts.varint_abs = varint_abs;
    Py_RETURN_NONE;
}

PyObject* py_cts_encode(PyObject*, PyObject* obj) {
    if (g_cts.err == nullptr) {
        PyErr_SetString(PyExc_RuntimeError, "cts_configure not called");
        return nullptr;
    }
    CtsBuf out;
    if (cts_enc(obj, out, 0) < 0) return nullptr;
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(out.v.data()),
        static_cast<Py_ssize_t>(out.v.size()));
}

PyObject* py_cts_decode(PyObject*, PyObject* arg) {
    if (g_cts.err == nullptr) {
        PyErr_SetString(PyExc_RuntimeError, "cts_configure not called");
        return nullptr;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
    CtsRd r{static_cast<const uint8_t*>(view.buf), view.len, 0};
    PyObject* result = cts_dec(r, 0);
    if (result != nullptr && r.i != r.n) {
        Py_CLEAR(result);
        cts_err("trailing bytes");
    }
    PyBuffer_Release(&view);
    return result;
}

// ---------------------------------------------------------------------------
// Fused asset contract sweep — the native form of
// finance/asset.py OnLedgerAsset.verify_fields (itself the single-pass
// mirror of the clause tree). Semantics are LOCKED to the Python
// implementation: check ORDER and "Failed requirement: ..." messages
// must match the clause stack exactly; the corrupted-transaction
// tests in tests/test_torch_native.py drive this path against the
// Python sweep and the reference package's. Composite-aware
// signer checks call back into Python (signed_by), everything else —
// command triage, token grouping, conservation sums, set building —
// runs in C: this loop is the notary flush's largest host slice.

struct AssetCtx {
    PyObject* cv;          // ContractViolation
    PyObject* signed_by;   // finance.asset.signed_by
    PyObject* token_of;    // callable state -> token
    PyObject* state_class;
    PyTypeObject* issue_t;
    PyTypeObject* move_t;
    PyTypeObject* exit_t;
};

static int asset_require(const AssetCtx& ctx, const char* msg, int cond) {
    if (cond > 0) return 0;
    if (cond == 0)
        PyErr_Format(ctx.cv, "Failed requirement: %s", msg);
    return -1;   // cond < 0: an error is already set
}

static int asset_signed_by(const AssetCtx& ctx, PyObject* key, PyObject* signers) {
    // fast path: the Python form's leaf pool always CONTAINS the
    // signers themselves (leaf_pool.add(s)), so direct membership is
    // a sound early accept; only misses (composite keys, leaf
    // fulfilment) pay the full Python check
    int direct = PySet_Contains(signers, key);
    if (direct != 0) return direct;   // 1 = signed, -1 = error
    PyObject* r =
        PyObject_CallFunctionObjArgs(ctx.signed_by, key, signers, nullptr);
    if (r == nullptr) return -1;
    int ok = PyObject_IsTrue(r);
    Py_DECREF(r);
    return ok;
}

// sum(s.amount.quantity for s in states); new ref or nullptr
static PyObject* asset_sum_quantities(const std::vector<PyObject*>& states) {
    PyObject* total = PyLong_FromLong(0);
    for (PyObject* s : states) {
        if (total == nullptr) return nullptr;
        PyObject* amount = PyObject_GetAttrString(s, "amount");
        PyObject* q =
            amount ? PyObject_GetAttrString(amount, "quantity") : nullptr;
        Py_XDECREF(amount);
        PyObject* next = q ? PyNumber_Add(total, q) : nullptr;
        Py_XDECREF(q);
        Py_DECREF(total);
        total = next;
    }
    return total;
}

// all(s.amount.quantity > 0 for s in states); 1/0/-1
static int asset_all_positive(const std::vector<PyObject*>& states) {
    for (PyObject* s : states) {
        PyObject* amount = PyObject_GetAttrString(s, "amount");
        PyObject* q =
            amount ? PyObject_GetAttrString(amount, "quantity") : nullptr;
        Py_XDECREF(amount);
        if (q == nullptr) return -1;
        PyObject* zero = PyLong_FromLong(0);
        int gt = zero ? PyObject_RichCompareBool(q, zero, Py_GT) : -1;
        Py_XDECREF(zero);
        Py_DECREF(q);
        if (gt <= 0) return gt;
    }
    return 1;
}

// {s.owner for s in inputs}: every owner signed (composite-aware)
static int asset_owners_signed(
    const AssetCtx& ctx, const std::vector<PyObject*>& inputs,
    PyObject* signers, const char* msg) {
    PyObject* owners = PySet_New(nullptr);
    if (owners == nullptr) return -1;
    for (PyObject* s : inputs) {
        PyObject* owner = PyObject_GetAttrString(s, "owner");
        if (owner == nullptr || PySet_Add(owners, owner) < 0) {
            Py_XDECREF(owner);
            Py_DECREF(owners);
            return -1;
        }
        Py_DECREF(owner);
    }
    int rc = 0;
    PyObject* it = PyObject_GetIter(owners);
    PyObject* owner;
    while (rc == 0 && it != nullptr &&
           (owner = PyIter_Next(it)) != nullptr) {
        rc = asset_require(ctx, msg, asset_signed_by(ctx, owner, signers));
        Py_DECREF(owner);
    }
    Py_XDECREF(it);
    Py_DECREF(owners);
    if (PyErr_Occurred()) rc = -1;
    return rc;
}

struct AssetCmd {
    PyObject* cmd;     // borrowed from the commands sequence
    PyObject* value;   // strong
    int kind;          // 0 issue, 1 move, 2 exit
};

static int asset_set_update(PyObject* set, PyObject* iterable) {
    PyObject* it = PyObject_GetIter(iterable);
    if (it == nullptr) return -1;
    PyObject* item;
    int rc = 0;
    while (rc == 0 && (item = PyIter_Next(it)) != nullptr) {
        rc = PySet_Add(set, item);
        Py_DECREF(item);
    }
    Py_DECREF(it);
    return PyErr_Occurred() ? -1 : rc;
}

// signers of a subset of commands as a fresh set
static PyObject* asset_signer_set(
    const std::vector<AssetCmd>& cmds, int kind /* -1 = all */) {
    PyObject* out = PySet_New(nullptr);
    for (const AssetCmd& c : cmds) {
        if (out == nullptr) break;
        if (kind >= 0 && c.kind != kind) continue;
        PyObject* signers = PyObject_GetAttrString(c.cmd, "signers");
        if (signers == nullptr || asset_set_update(out, signers) < 0) {
            Py_XDECREF(signers);
            Py_CLEAR(out);
            break;
        }
        Py_DECREF(signers);
    }
    return out;
}

// one group (AssetGroupClause dispatch); fills `processed`; 0/-1
static int asset_verify_group(
    const AssetCtx& ctx, PyObject* token,
    const std::vector<PyObject*>& inputs,
    const std::vector<PyObject*>& outputs,
    std::vector<AssetCmd>& cmds, PyObject* all_signers,
    std::vector<char>& processed) {
    bool any_issue = false;
    for (const AssetCmd& c : cmds) any_issue |= (c.kind == 0);
    if (any_issue && inputs.empty()) {               // IssueClause
        PyObject* out_sum = asset_sum_quantities(outputs);
        PyObject* zero = PyLong_FromLong(0);
        int pos = (out_sum && zero)
            ? PyObject_RichCompareBool(out_sum, zero, Py_GT) : -1;
        Py_XDECREF(out_sum);
        Py_XDECREF(zero);
        if (asset_require(ctx, "issued amount is positive", pos) < 0)
            return -1;
        if (asset_require(ctx, "output amounts are positive",
                          asset_all_positive(outputs)) < 0)
            return -1;
        PyObject* issuer = PyObject_GetAttrString(token, "issuer");
        PyObject* party =
            issuer ? PyObject_GetAttrString(issuer, "party") : nullptr;
        PyObject* ikey =
            party ? PyObject_GetAttrString(party, "owning_key") : nullptr;
        Py_XDECREF(issuer);
        Py_XDECREF(party);
        PyObject* issue_signers =
            ikey ? asset_signer_set(cmds, 0) : nullptr;
        int ok = issue_signers
            ? asset_signed_by(ctx, ikey, issue_signers) : -1;
        Py_XDECREF(ikey);
        Py_XDECREF(issue_signers);
        if (asset_require(ctx, "issue is signed by the issuer", ok) < 0)
            return -1;
        for (size_t i = 0; i < cmds.size(); i++)
            if (cmds[i].kind == 0) processed[i] = 1;
        return 0;
    }
    // group exits: exit commands whose amount.token == this token
    std::vector<size_t> group_exits;
    for (size_t i = 0; i < cmds.size(); i++) {
        if (cmds[i].kind != 2) continue;
        PyObject* amount = PyObject_GetAttrString(cmds[i].value, "amount");
        PyObject* tok =
            amount ? PyObject_GetAttrString(amount, "token") : nullptr;
        Py_XDECREF(amount);
        if (tok == nullptr) return -1;
        int eq = PyObject_RichCompareBool(tok, token, Py_EQ);
        Py_DECREF(tok);
        if (eq < 0) return -1;
        if (eq) group_exits.push_back(i);
    }
    if (!group_exits.empty()) {                      // ExitClause
        if (asset_require(ctx, "output amounts are positive",
                          asset_all_positive(outputs)) < 0)
            return -1;
        PyObject* in_sum = asset_sum_quantities(inputs);
        PyObject* out_sum =
            in_sum ? asset_sum_quantities(outputs) : nullptr;
        if (out_sum == nullptr) {   // sum error pending: stop here
            Py_XDECREF(in_sum);
            return -1;
        }
        PyObject* exited = PyLong_FromLong(0);
        for (size_t i : group_exits) {
            if (exited == nullptr) break;
            PyObject* amount =
                PyObject_GetAttrString(cmds[i].value, "amount");
            PyObject* q =
                amount ? PyObject_GetAttrString(amount, "quantity")
                       : nullptr;
            Py_XDECREF(amount);
            PyObject* next = q ? PyNumber_Add(exited, q) : nullptr;
            Py_XDECREF(q);
            Py_DECREF(exited);
            exited = next;
        }
        PyObject* diff = (in_sum && out_sum)
            ? PyNumber_Subtract(in_sum, out_sum) : nullptr;
        int eq = (diff && exited)
            ? PyObject_RichCompareBool(diff, exited, Py_EQ) : -1;
        Py_XDECREF(in_sum);
        Py_XDECREF(out_sum);
        Py_XDECREF(diff);
        Py_XDECREF(exited);
        if (asset_require(ctx, "exit conserves value", eq) < 0) return -1;
        // signers of THIS GROUP's exits only (the Python form's
        // {k for _, c in group_exits for k in c.signers})
        PyObject* exit_signers = PySet_New(nullptr);
        for (size_t i : group_exits) {
            if (exit_signers == nullptr) break;
            PyObject* signers =
                PyObject_GetAttrString(cmds[i].cmd, "signers");
            if (signers == nullptr ||
                asset_set_update(exit_signers, signers) < 0) {
                Py_XDECREF(signers);
                Py_CLEAR(exit_signers);
                break;
            }
            Py_DECREF(signers);
        }
        if (exit_signers == nullptr) return -1;   // error pending
        PyObject* issuer = PyObject_GetAttrString(token, "issuer");
        PyObject* party =
            issuer ? PyObject_GetAttrString(issuer, "party") : nullptr;
        PyObject* ikey =
            party ? PyObject_GetAttrString(party, "owning_key") : nullptr;
        Py_XDECREF(issuer);
        Py_XDECREF(party);
        int ok = ikey ? asset_signed_by(ctx, ikey, exit_signers) : -1;
        Py_XDECREF(ikey);
        Py_DECREF(exit_signers);
        if (asset_require(ctx, "exit is signed by the issuer", ok) < 0)
            return -1;
        if (asset_owners_signed(ctx, inputs, all_signers,
                                "exit is signed by every input owner") < 0)
            return -1;
        for (size_t i : group_exits) processed[i] = 1;
        return 0;
    }
    // MoveClause (unconditional fallthrough, as in the group clause)
    PyObject* in_sum = asset_sum_quantities(inputs);
    PyObject* out_sum = in_sum ? asset_sum_quantities(outputs) : nullptr;
    if (out_sum == nullptr) {   // sum errors surface first, like Python
        Py_XDECREF(in_sum);
        return -1;
    }
    if (asset_require(ctx, "output amounts are positive",
                      asset_all_positive(outputs)) < 0) {
        Py_DECREF(in_sum);
        Py_DECREF(out_sum);
        return -1;
    }
    int conserved = -1;
    if (in_sum && out_sum) {
        conserved = PyObject_RichCompareBool(in_sum, out_sum, Py_EQ);
        if (conserved > 0) {
            PyObject* zero = PyLong_FromLong(0);
            conserved = zero
                ? PyObject_RichCompareBool(in_sum, zero, Py_GT) : -1;
            Py_XDECREF(zero);
        }
    }
    Py_XDECREF(in_sum);
    Py_XDECREF(out_sum);
    if (asset_require(ctx, "value is conserved (inputs == outputs)",
                      conserved) < 0)
        return -1;
    if (asset_owners_signed(ctx, inputs, all_signers,
                            "move is signed by every input owner") < 0)
        return -1;
    for (size_t i = 0; i < cmds.size(); i++)
        if (cmds[i].kind == 1) processed[i] = 1;
    return 0;
}

PyObject* py_asset_verify_fields(PyObject*, PyObject* args) {
    PyObject *commands, *input_datas, *output_datas;
    AssetCtx ctx;
    PyObject *state_class, *issue_t, *move_t, *exit_t;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOOOO", &commands, &input_datas, &output_datas,
            &state_class, &issue_t, &move_t, &exit_t, &ctx.token_of,
            &ctx.signed_by, &ctx.cv))
        return nullptr;
    ctx.state_class = state_class;
    ctx.issue_t = reinterpret_cast<PyTypeObject*>(issue_t);
    ctx.move_t = reinterpret_cast<PyTypeObject*>(move_t);
    ctx.exit_t = reinterpret_cast<PyTypeObject*>(exit_t);

    // 1. triage asset commands (exact-type match, like `type(v) in`)
    std::vector<AssetCmd> cmds;
    PyObject* cseq = PySequence_Fast(commands, "commands");
    if (cseq == nullptr) return nullptr;
    bool failed = false;
    for (Py_ssize_t i = 0;
         !failed && i < PySequence_Fast_GET_SIZE(cseq); i++) {
        PyObject* c = PySequence_Fast_GET_ITEM(cseq, i);
        PyObject* v = PyObject_GetAttrString(c, "value");
        if (v == nullptr) {
            failed = true;
            break;
        }
        PyTypeObject* t = Py_TYPE(v);
        int kind = t == ctx.issue_t ? 0
            : t == ctx.move_t ? 1
            : t == ctx.exit_t ? 2 : -1;
        if (kind < 0) {
            Py_DECREF(v);
            continue;
        }
        cmds.push_back({c, v, kind});   // v stays strong
    }
    auto cleanup = [&]() {
        for (AssetCmd& c : cmds) Py_DECREF(c.value);
        Py_DECREF(cseq);
    };
    if (failed) {
        cleanup();
        return nullptr;
    }
    if (cmds.empty()) {
        PyErr_Format(ctx.cv,
                     "Failed requirement: an asset command is present");
        cleanup();
        return nullptr;
    }
    // 2. group states by token, inputs first then outputs (insertion
    // order == the order LedgerTransaction.group_states produces)
    PyObject* groups = PyDict_New();   // token -> (in_list, out_list)
    for (int which = 0; groups != nullptr && which < 2 && !failed;
         which++) {
        PyObject* seq = PySequence_Fast(
            which == 0 ? input_datas : output_datas, "state datas");
        if (seq == nullptr) {
            failed = true;
            break;
        }
        for (Py_ssize_t i = 0;
             !failed && i < PySequence_Fast_GET_SIZE(seq); i++) {
            PyObject* s = PySequence_Fast_GET_ITEM(seq, i);
            int isinst = PyObject_IsInstance(s, state_class);
            if (isinst < 0) {
                failed = true;
                break;
            }
            if (!isinst) continue;
            PyObject* tok;
            if (ctx.token_of == Py_None) {   // the default token key
                PyObject* amount = PyObject_GetAttrString(s, "amount");
                tok = amount
                    ? PyObject_GetAttrString(amount, "token") : nullptr;
                Py_XDECREF(amount);
            } else {
                tok = PyObject_CallFunctionObjArgs(
                    ctx.token_of, s, nullptr);
            }
            if (tok == nullptr) {
                failed = true;
                break;
            }
            PyObject* entry = PyDict_GetItemWithError(groups, tok);
            if (entry == nullptr) {
                if (PyErr_Occurred()) {
                    Py_DECREF(tok);
                    failed = true;
                    break;
                }
                entry = PyTuple_New(2);
                if (entry != nullptr) {
                    PyObject* a = PyList_New(0);
                    PyObject* b = PyList_New(0);
                    if (a == nullptr || b == nullptr) {
                        Py_XDECREF(a);
                        Py_XDECREF(b);
                        Py_CLEAR(entry);
                    } else {
                        PyTuple_SET_ITEM(entry, 0, a);
                        PyTuple_SET_ITEM(entry, 1, b);
                    }
                }
                if (entry == nullptr ||
                    PyDict_SetItem(groups, tok, entry) < 0) {
                    Py_XDECREF(entry);
                    Py_DECREF(tok);
                    failed = true;
                    break;
                }
                // the dict now holds a reference; our (about to be
                // dropped) pointer stays valid for this iteration —
                // no re-lookup, which could fail and return NULL
                Py_DECREF(entry);
            }
            Py_DECREF(tok);
            if (PyList_Append(PyTuple_GET_ITEM(entry, which), s) < 0) {
                failed = true;
                break;
            }
        }
        Py_DECREF(seq);
    }
    if (failed || groups == nullptr) {
        Py_XDECREF(groups);
        cleanup();
        return nullptr;
    }
    // 3. all command signers
    PyObject* all_signers = asset_signer_set(cmds, -1);
    if (all_signers == nullptr) {
        Py_DECREF(groups);
        cleanup();
        return nullptr;
    }
    // 4. per-group clause dispatch, insertion order
    std::vector<char> processed(cmds.size(), 0);
    PyObject *token, *entry;
    Py_ssize_t pos = 0;
    int rc = 0;
    while (rc == 0 && PyDict_Next(groups, &pos, &token, &entry)) {
        std::vector<PyObject*> ins, outs;
        PyObject* in_list = PyTuple_GET_ITEM(entry, 0);
        PyObject* out_list = PyTuple_GET_ITEM(entry, 1);
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(in_list); i++)
            ins.push_back(PyList_GET_ITEM(in_list, i));
        for (Py_ssize_t i = 0; i < PyList_GET_SIZE(out_list); i++)
            outs.push_back(PyList_GET_ITEM(out_list, i));
        rc = asset_verify_group(
            ctx, token, ins, outs, cmds, all_signers, processed);
    }
    Py_DECREF(all_signers);
    Py_DECREF(groups);
    if (rc < 0) {
        cleanup();
        return nullptr;
    }
    // 5. every asset command consumed by some clause
    std::string leftover;
    for (size_t i = 0; i < cmds.size(); i++) {
        if (processed[i]) continue;
        if (!leftover.empty()) leftover += ", ";
        leftover += Py_TYPE(cmds[i].value)->tp_name;
    }
    cleanup();
    if (!leftover.empty()) {
        PyErr_Format(ctx.cv, "commands not processed by any clause: %s",
                     leftover.c_str());
        return nullptr;
    }
    Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"asset_verify_fields", py_asset_verify_fields, METH_VARARGS,
     "Fused OnLedgerAsset field verification "
     "(finance/asset.py verify_fields semantics)."},
    {"cts_configure", py_cts_configure, METH_VARARGS,
     "Wire the CTS codec to the Python-side registry objects."},
    {"cts_encode", py_cts_encode, METH_O,
     "Canonical CTS encoding of a value (serialization.py semantics)."},
    {"cts_decode", py_cts_decode, METH_O,
     "Decode a CTS blob (whitelist-only; serialization.py semantics)."},
    {"pmt_verify_many", py_pmt_verify_many, METH_O,
     "Verify many partial-Merkle proofs: "
     "[(tree_size, indices, proof, leaves, root)] -> [bool]."},
    {"sha256", py_sha256, METH_O, "SHA-256 digest of a bytes-like."},
    {"sha256_many", py_sha256_many, METH_O,
     "SHA-256 digest of every item of a sequence of bytes-likes."},
    {"merkle_root", py_merkle_root, METH_O,
     "Root of the zero-padded pairwise-SHA-256 tree over 32-byte leaves."},
    {"merkle_root_many", py_merkle_root_many, METH_O,
     "Roots of many trees in one call: [leaf lists] -> [32-byte roots]."},
    {"merkle_paths", py_merkle_paths, METH_O,
     "(root, [sibling-path bytes per leaf]) for the zero-padded tree."},
    {"stage_ecdsa_many", py_stage_ecdsa_many, METH_VARARGS,
     "Stage [(pub, der_sig, msg)] into packed z|r|s|qx|qy records: "
     "(packed_bytes, [valid], [rows needing python decompression])."},
    {"stage_ed25519_many", py_stage_ed25519_many, METH_VARARGS,
     "Stage [(pub32, sig64, msg)] into packed s|k|A.y|R.y records: "
     "(packed_bytes, [a_sign], [r_sign], [valid])."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_cts_hash",
    "Native SHA-256 / Merkle kernels (host side).",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__cts_hash(void) {
    PyObject* m = PyModule_Create(&module);
    if (m != nullptr) {
        // codec ABI generation: serialization.py refuses to wire a
        // stale .so whose contract differs (2 = construct callable
        // receives PRE-TUPLIFIED kwargs). Bump on any change to the
        // cts_* calling conventions.
        PyModule_AddIntConstant(m, "cts_abi", 2);
        // whether this CPU takes the SHA-NI transform (chip_smoke.py
        // reports it: the two SHA-256 paths must hash alike)
        PyModule_AddIntConstant(m, "sha_ni", has_shani() ? 1 : 0);
    }
    return m;
}
