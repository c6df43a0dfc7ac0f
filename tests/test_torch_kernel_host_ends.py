"""The verify prologue and epilogue kernels, compiled as host C++.

There is no nvcc and no card on the CPU test machines, so this test
compiles `corda_tpu_torch/csrc/ed_ends.cu` and `wei_ends.cu` (with their
headers) with the host C++ compiler behind the shim of
`lane_group_emulator.py` and runs each kernel body as on the card, one
row per group of TPI lanes, each lane a coroutine of the emulator (every
group of the grid, those past the ragged edge too). The rows are those
of `testing/selfcheck.py`'s `*_prologue_rows` and `*_epilogue_rows`
(the crafted edge rows first, then staged requests) at B = 1 and B = 130
(a partial group, warp and block), the ECDSA prologue at B = 41 (its 39
distinct rows, and a partly filled last block; its 340 field operations
per row are the emulator's slowest). Every output must equal the plain
torch version's on the same rows: verdicts and raw digits exactly,
points after reduction mod p (the kernels return canonical digits, the
plain versions lazily reduced ones); the kernels' digits must be
canonical. Each source's dedicated squaring (gfe_sqr_25519 mod 2^255 -
19; the Montgomery gfe_sqr mod p and mod n of both secp curves) is held
against its multiply and Python ints on edge operands.

It checks the arithmetic, the power chains and windows, the domain
conversions, the byte order, the exchanges between lanes and the ragged
edge, not the GPU's compiler, which only chip_smoke.py and
tests/test_torch_gpu.py reach. Skips where no C++ compiler is installed.
"""

import random
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corda_tpu_torch.crypto import cuda_ec  # noqa: E402
from corda_tpu_torch.crypto import ecdsa as TE  # noqa: E402
from corda_tpu_torch.crypto import eddsa as TD  # noqa: E402
from corda_tpu_torch.crypto import limbs as L  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1  # noqa: E402
from corda_tpu_torch.testing import selfcheck  # noqa: E402
from lane_group_emulator import FIELD_BODY, build, compiler  # noqa: E402

# per source: (params struct, the prologue's call, the epilogue's call,
# its field multiply and square); in[i] and out[i] are the i-th input and
# output buffers
SOURCES = {
    "ed_ends": ("EdEndsParams",
                "ed_prologue_kernel(P, (const uint8_t*)in[0], (const int32_t*)in[1], "
                "(const bool*)in[2], (int32_t*)out[0], (int32_t*)out[1], (int32_t*)out[2], "
                "(int32_t*)out[3], (bool*)out[4], batch)",
                "ed_epilogue_kernel(P, (const int32_t*)in[0], (const int32_t*)in[1], "
                "(const int32_t*)in[2], (const uint8_t*)in[3], (const int32_t*)in[4], "
                "(const bool*)in[5], (bool*)out[0], batch)",
                "gfe_mul_25519", "gfe_sqr_25519"),
    "wei_ends": ("WeiEndsParams",
                 "ecdsa_prologue_kernel(P, (const uint8_t*)in[0], (const bool*)in[1], "
                 "(int32_t*)out[0], (int32_t*)out[1], (int32_t*)out[2], (int32_t*)out[3], "
                 "(bool*)out[4], batch)",
                 "ecdsa_epilogue_kernel(P, (const int32_t*)in[0], (const int32_t*)in[1], "
                 "(const int32_t*)in[2], (const uint8_t*)in[3], (const bool*)in[4], "
                 "(bool*)out[0], batch)",
                 "gfe_mul", "gfe_sqr"),
}

MAIN = r"""
static PARAMS P;
static int mode, batch;
static void *in[8], *out[8];

static void row_body() {
  if (mode == 0) PROLOGUE; else EPILOGUE;
}

FIELD_BODY

static void* read_buf(FILE* f, int* len) {
  if (fread(len, 4, 1, f) != 1) exit(3);
  void* b = calloc(*len + 1, 1);
  if (*len && fread(b, 1, *len, f) != (size_t)*len) exit(3);
  return b;
}

int main(int argc, char** argv) {
  mode = atoi(argv[1]);   // 0 prologue, 1 epilogue, 2 field operations
  FILE* f = fopen(argv[2], "rb");
  int words, n_in, n_out, len, out_len[8];
  if (fread(&batch, 4, 1, f) != 1 || fread(&words, 4, 1, f) != 1) return 3;
  if (words != (int)(sizeof(P) / 4) || fread(&P, sizeof(P), 1, f) != 1) return 4;
  if (fread(&n_in, 4, 1, f) != 1) return 3;
  for (int i = 0; i < n_in; ++i) in[i] = read_buf(f, &len);
  if (fread(&n_out, 4, 1, f) != 1) return 3;
  for (int i = 0; i < n_out; ++i) {
    if (fread(&out_len[i], 4, 1, f) != 1) return 3;
    out[i] = calloc(out_len[i] + 1, 1);
  }
  fclose(f);
  void (*body)() = row_body;
  if (mode == 2) {
    fop = (const int32_t*)in[0]; fa = (uint32_t*)in[1]; fb = (uint32_t*)in[2]; fr = (uint32_t*)out[0];
    body = field_body;
  }
  for (int blk = 0; blk * BLOCK < batch * TPI; ++blk)
    for (int t = 0; t < BLOCK; t += TPI) emu_run_group(blk, t, TPI, body);
  f = fopen(argv[3], "wb");
  for (int i = 0; i < n_out; ++i) fwrite(out[i], 1, out_len[i], f);
  fclose(f);
  return 0;
}
"""


def _build(cxx, name, d):
    params, prologue, epilogue, mul, sqr = SOURCES[name]
    main = (MAIN.replace("FIELD_BODY", FIELD_BODY).replace("FIELD_MUL", mul)
            .replace("FIELD_SQR", sqr).replace("PARAMS", params).replace("PROLOGUE", prologue)
            .replace("EPILOGUE", epilogue))
    return build(cxx, name, main, d)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """{source name: (host executable, work dir)}; the headers are
    included from csrc/ as nvcc includes them."""
    cxx = compiler()
    d = tmp_path_factory.mktemp("ends_host")
    return {name: (_build(cxx, name, d), d) for name in SOURCES}


def _run(host, name, mode, params, batch, ins, outs):
    """The kernel body on `batch` rows: ins are numpy arrays (their
    bytes in order), outs (dtype, shape) of the outputs; returns them."""
    exe, d = host[name]
    with open(d / "in.bin", "wb") as f:
        f.write(np.int32(batch).tobytes() + np.int32(params.size).tobytes() + params.tobytes())
        f.write(np.int32(len(ins)).tobytes())
        for a in ins:
            b = np.ascontiguousarray(a).tobytes()
            f.write(np.int32(len(b)).tobytes() + b)
        f.write(np.int32(len(outs)).tobytes())
        for dtype, shape in outs:
            f.write(np.int32(np.dtype(dtype).itemsize * int(np.prod(shape))).tobytes())
    subprocess.run([str(exe), str(mode), str(d / "in.bin"), str(d / "out.bin")],
                   check=True, timeout=300)
    raw = (d / "out.bin").read_bytes()
    got, off = [], 0
    for dtype, shape in outs:
        size = np.dtype(dtype).itemsize * int(np.prod(shape))
        got.append(np.frombuffer(raw[off:off + size], dtype).reshape(shape))
        off += size
    assert off == len(raw)
    return got


def _reduced(a, p):
    return [v % p for v in L.batch_to_ints(np.asarray(a))]


def _canonical(a, p):
    a = np.asarray(a)
    return a.min() >= 0 and a.max() < 4096 and max(L.batch_to_ints(a)) < p


BATCHES = [1, 130]
# the ECDSA prologue: its 39 distinct rows once, the last block part filled
ECDSA_PROLOGUE_BATCHES = [1, 41]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.mark.parametrize("batch", BATCHES)
def test_ed_prologue_kernel_on_host_matches_plain(host, batch):
    """ed_prologue_kernel on ed25519_prologue_rows (A.y = 0, 1, p - 1,
    y >= p, a y off the curve, each with sign 0 and 1; s = 2^256 - 1;
    valid_in False; staged requests with the edge rows; valid points of
    either square-root branch): s and k digits and ok exact, -A.x and
    A.y equal mod p and canonical; exact."""
    c = ED25519
    packed, a_sign, valid = selfcheck.ed25519_prologue_rows(batch, seed=11)
    d = (np.int32, (22, batch))
    got = _run(host, "ed_ends", 0, cuda_ec.ed_ends_params(), batch, [packed, a_sign, valid],
               [d, d, d, d, (np.bool_, (batch,))])
    want = [o.numpy() for o in TD.ed_prologue_plain(_t(packed), _t(a_sign), _t(valid))]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for g, w in zip(got[2:4], want[2:4]):
        assert _canonical(g, c.p)
        assert _reduced(g, c.p) == _reduced(w, c.p)
    assert got[4].tolist() == want[4].tolist()
    if batch > 1:
        assert 0 < int(got[4].sum()) < batch          # both verdicts occur


@pytest.mark.parametrize("batch", BATCHES)
def test_ed_epilogue_kernel_on_host_matches_plain(host, batch):
    """ed_epilogue_kernel on ed25519_epilogue_rows (matching R.y and
    sign, the sign flipped, R.y + p, ok False, Z = 0; lazily reduced
    digits on some rows): verdicts equal to the plain version's; exact."""
    c = ED25519
    R, packed, r_sign, ok = selfcheck.ed25519_epilogue_rows(batch, seed=12)
    (got,) = _run(host, "ed_ends", 1, cuda_ec.ed_ends_params(), batch,
                  [R[0], R[1], R[2], packed, r_sign, ok], [(np.bool_, (batch,))])
    want = TD.ed_epilogue_plain(tuple(_t(x) for x in R), _t(packed), _t(r_sign), _t(ok))
    assert got.tolist() == want.tolist()
    if batch > 1:
        assert 0 < int(got.sum()) < batch


def test_gfe_sqr_25519_on_host_matches_mul_and_ints(host):
    """field256_group.cuh's gfe_sqr_25519, each lane of a group holding
    its words (built in ed_ends.cu, which squares with it), on 0, 1,
    p - 1 = 2^255 - 20, p - 2, values of all-ones words below p (2^32k -
    1, p - 2^32k, 2^255 - 2^32k), 19, 38, values around 2^254 and
    seeded ones: equal to gfe_mul_25519(a, a) and to a^2 mod p from
    Python ints for every operand; exact."""
    p = ED25519.p
    rng = random.Random(29)
    vals = {0, 1, 2, p - 1, p - 2, (1 << 255) - 20, 19, 38, (1 << 254) - 1, 1 << 254,
            (p - 1) // 2, (p + 1) // 2}
    vals |= {(1 << (32 * k)) - 1 for k in range(1, 8)}
    vals |= {p - (1 << (32 * k)) for k in range(1, 8)}
    vals |= {(1 << 255) - (1 << (32 * k)) for k in range(1, 7)}
    vals |= {rng.randrange(p) for _ in range(64)}
    vals = sorted(v for v in vals if v < p)
    n = len(vals)
    words = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals], np.uint32)
    (got,) = _run(host, "ed_ends", 2, cuda_ec.ed_ends_params(), n,
                  [np.full(n, 3, np.int32), words, words], [(np.uint32, (n, 16))])
    ints = [[sum(int(w) << (32 * i) for i, w in enumerate(half)) for half in (row[:8], row[8:])]
            for row in got]
    bad = [(v, sq, mul) for v, (sq, mul) in zip(vals, ints) if not sq == mul == v * v % p]
    assert not bad, bad[:4]
    assert n > 90


def _square_operands(m: int, rng) -> list[int]:
    """0, 1, m - 1, m - 2, values of all-ones words below m (2^32k - 1,
    m - 2^32k, 2^256 - 2^32k mod m), 2^256 mod m, halves of m and 64
    seeded values."""
    vals = {0, 1, 2, m - 1, m - 2, (m - 1) // 2, (m + 1) // 2, (1 << 256) % m}
    vals |= {(1 << (32 * k)) - 1 for k in range(1, 8)}
    vals |= {m - (1 << (32 * k)) for k in range(1, 8)}
    vals |= {((1 << 256) - (1 << (32 * k))) % m for k in range(1, 8)}
    vals |= {rng.randrange(m) for _ in range(64)}
    return sorted(v for v in vals if v < m)


@pytest.mark.parametrize("modulus", ["p", "n"])
@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
def test_gfe_sqr_on_host_matches_mul_and_ints(host, curve, modulus):
    """field256_group.cuh's gfe_sqr, the Montgomery square (built in
    wei_ends.cu, which squares with it mod p and mod n), each lane of a
    group holding its words, on 0, 1, m - 1, m - 2, values of all-ones
    words below m, halves of m and 64 seeded values, for m = p and m = n:
    equal to gfe_mul(a, a) and to a^2 2^-256 mod m from Python ints for
    every operand; exact."""
    m = curve.p if modulus == "p" else curve.n
    vals = _square_operands(m, random.Random(31))
    n = len(vals)
    # WeiEndsParams with m in place of p: p is its first 8 words, pinv word 32
    params = cuda_ec.wei_ends_params(curve).copy()
    params[:8] = [(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    params[32] = (-pow(m, -1, 1 << 32)) % (1 << 32)
    words = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals], np.uint32)
    (got,) = _run(host, "wei_ends", 2, params, n,
                  [np.full(n, 3, np.int32), words, words], [(np.uint32, (n, 16))])
    ints = [[sum(int(w) << (32 * i) for i, w in enumerate(half)) for half in (row[:8], row[8:])]
            for row in got]
    rinv = pow(1 << 256, -1, m)
    bad = [(v, sq, mul) for v, (sq, mul) in zip(vals, ints) if not sq == mul == v * v * rinv % m]
    assert not bad, bad[:4]
    assert n > 90


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
@pytest.mark.parametrize("batch", ECDSA_PROLOGUE_BATCHES)
def test_ecdsa_prologue_kernel_on_host_matches_plain(host, curve, batch):
    """ecdsa_prologue_kernel on ecdsa_prologue_rows (z >= n and z =
    2^256 - 1, r or s 0, n, n - 1 or 2^256 - 1, coordinates >= p, Q off
    the curve, Q = G, the r + n row, valid_in False, staged requests):
    u1, u2 digits and valid exact, Q equal mod p and canonical; exact."""
    packed, valid = selfcheck.ecdsa_prologue_rows(curve, batch, seed=13)
    d = (np.int32, (22, batch))
    got = _run(host, "wei_ends", 0, cuda_ec.wei_ends_params(curve), batch, [packed, valid],
               [d, d, d, d, (np.bool_, (batch,))])
    want = [o.numpy() for o in TE.ecdsa_prologue_plain(curve, _t(packed), _t(valid))]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for g, w in zip(got[2:4], want[2:4]):
        assert _canonical(g, curve.p)
        assert _reduced(g, curve.p) == _reduced(w, curve.p)
    assert got[4].tolist() == want[4].tolist()
    if batch > 1:
        assert 0 < int(got[4].sum()) < batch


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
@pytest.mark.parametrize("batch", BATCHES)
def test_ecdsa_epilogue_kernel_on_host_matches_plain(host, curve, batch):
    """ecdsa_epilogue_kernel on ecdsa_epilogue_rows (x_R = r, x_R = r +
    n < p, r + n >= p gated, r = 2^256 - 1, a wrong r, Z = 0, valid
    False; lazily reduced digits on some rows): verdicts equal to the
    plain version's; exact."""
    R, packed, valid = selfcheck.ecdsa_epilogue_rows(curve, batch, seed=14)
    (got,) = _run(host, "wei_ends", 1, cuda_ec.wei_ends_params(curve), batch,
                  [R[0], R[1], R[2], packed, valid], [(np.bool_, (batch,))])
    want = TE.ecdsa_epilogue_plain(curve, tuple(_t(x) for x in R), _t(packed), _t(valid))
    assert got.tolist() == want.tolist()
    if batch > 1:
        assert 0 < int(got.sum()) < batch
