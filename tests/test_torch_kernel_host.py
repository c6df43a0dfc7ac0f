"""The CUDA ladder sources' arithmetic, compiled as host C++.

There is no nvcc and no card on the CPU test machines, so this test
compiles `corda_tpu_torch/csrc/wei_ladder.cu` and `ed_ladder.cu` (with
their headers) with the host C++ compiler behind the lane-group
emulator of `lane_group_emulator.py` and runs each kernel body on a
small batch. The results must equal refmath after normalisation and be
canonical 12-bit digits: exact, as integer arithmetic is.

Every kernel spreads a signature over a group of TPI lanes
(`field256_group.cuh`), each lane a coroutine of the emulator; it runs
every group of the grid, those past the ragged edge too. The Edwards
windowed kernel's constant B table, which thread 0 writes for the
whole block, is written before the first group's first exchange.

It checks the field arithmetic, the carry resolution between lanes, the
domain conversions, the table conventions, the schedules and the ragged
edge — not the GPU's compiler or memory model, which only chip_smoke.py
and tests/test_torch_gpu.py reach. Skips where no C++ compiler is
installed.
"""

import random
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from corda_tpu_torch.crypto import cuda_ec, refmath  # noqa: E402
from corda_tpu_torch.crypto import limbs as L  # noqa: E402
from corda_tpu_torch.crypto import modmath as M  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519, SECP256K1, SECP256R1  # noqa: E402
from lane_group_emulator import FIELD_BODY, build, compiler  # noqa: E402

# per source: (params struct, its size in words, number of outputs,
# plain kernel, windowed kernel, field multiply); the Weierstrass
# kernels' instantiation follows the curve's a, as corda_wei_ladder
# picks it; their multiply is Montgomery (a*b*2^-256), the Edwards
# kernels' special-form one plain (a*b)
SOURCES = {
    "wei_ladder": ("CurveParams", 426, 3,
                   "(P.a_zero ? wei_ladder_kernel<true> : wei_ladder_kernel<false>)",
                   "(P.a_zero ? wei_ladder_windowed_kernel<true> : wei_ladder_windowed_kernel<false>)",
                   "gfe_mul"),
    "ed_ladder": ("EdParams", 425, 4, "ed_ladder_kernel", "ed_ladder_windowed_kernel",
                  "gfe_mul_25519"),
}

MAIN = r"""
#ifdef TPI
#define EMU_LANES TPI
#else
#define EMU_LANES 1
#endif
static PARAMS P;
static int mode, batch;
static int32_t *in, *o[4];

static void ladder_body() {
  int32_t *a = in, *b = in + 22 * batch, *x = in + 44 * batch, *y = in + 66 * batch;
  if (mode == 0) PLAIN(P, a, b, x, y, OUTS, batch);
  else WINDOWED(P, a, b, x, y, OUTS, batch);
}

#ifdef TPI
FIELD_BODY
#endif

int main(int argc, char** argv) {
  mode = atoi(argv[1]);   // 0 plain, 1 windowed, 2 field operations
  FILE* f = fopen(argv[2], "rb");
  if (fread(&batch, 4, 1, f) != 1 || fread(&P, sizeof(P), 1, f) != 1) return 3;
  const int n_in = mode == 2 ? 17 * batch : 4 * 22 * batch;
  const int n_out = mode == 2 ? 16 * batch : NOUT * 22 * batch;
  in = (int32_t*)malloc(4 * n_in);
  if (fread(in, 4, n_in, f) != (size_t)n_in) return 3;
  fclose(f);
  int32_t* out = (int32_t*)calloc(n_out, 4);
  for (int i = 0; i < 4; ++i) o[i] = out + 22 * batch * i;
  void (*body)() = ladder_body;
#ifdef TPI
  fop = in; fa = (uint32_t*)in + batch; fb = fa + 8 * batch; fr = (uint32_t*)out;
  if (mode == 2) body = field_body;
#endif
  const int blocks = (batch * EMU_LANES + BLOCK - 1) / BLOCK;
  for (int blk = 0; blk < blocks; ++blk)
    for (int t = 0; t < BLOCK; t += EMU_LANES) emu_run_group(blk, t, EMU_LANES, body);
  f = fopen(argv[3], "wb");
  fwrite(out, 4, n_out, f);
  fclose(f);
  return (int)(sizeof(PARAMS) / 4) == WORDS ? 0 : 4;
}
"""


def _build(cxx, name, d):
    params, words, n_out, plain, windowed, mul = SOURCES[name]
    main = (MAIN.replace("FIELD_BODY", FIELD_BODY)
            .replace("PARAMS", params).replace("WORDS", str(words))
            .replace("NOUT", str(n_out)).replace("PLAIN", plain).replace("WINDOWED", windowed)
            .replace("OUTS", ", ".join(f"o[{i}]" for i in range(n_out)))
            .replace("FIELD_MUL", mul).replace("FIELD_SQR", mul.replace("mul", "sqr")))
    return build(cxx, name, main, d)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    """{source name: (host executable, work dir)}; the headers are
    included from csrc/ as nvcc includes them."""
    cxx = compiler()
    d = tmp_path_factory.mktemp("ladder_host")
    return {name: (_build(cxx, name, d), d) for name in SOURCES}


def _exec(emulator, name, mode, params, arrays, n_out_words):
    exe, d = emulator[name]
    with open(d / "in.bin", "wb") as f:
        f.write(np.int32(arrays[0].shape[-1]).tobytes())
        f.write(params.tobytes())
        for a in arrays:
            f.write(np.ascontiguousarray(a).astype(np.uint32).view(np.int32).tobytes())
    subprocess.run([str(exe), str(mode), str(d / "in.bin"), str(d / "out.bin")],
                   check=True, timeout=300)
    out = np.fromfile(d / "out.bin", dtype=np.int32)
    assert out.size == n_out_words
    return out


def _run(emulator, name, mode, params, args):
    n_out = SOURCES[name][2]
    batch = args[0].shape[1]
    out = _exec(emulator, name, mode, params, [a.astype(np.int32) for a in args], n_out * 22 * batch)
    return out.reshape(n_out, 22, batch)


def _lazy_mont(curve, vals, rng):
    """Montgomery coordinates as the torch to_mont leaves them (lazy,
    < 2p), and on rows 0-2 with k*p added (values up to 2^264, which the
    kernel folds) and one non-canonical digit (+4096 / -1)."""
    a = M.to_mont(curve.fp, torch.from_numpy(L.ints_to_batch(vals))).numpy()
    ints = L.batch_to_ints(a)
    for i in range(3):
        k = ((1 << 264) - 1 - ints[i]) // curve.p
        ints[i] += rng.randrange(k // 2, k + 1) * curve.p
    a = L.ints_to_batch(ints)
    a[0, :3] += 4096 * (a[1, :3] > 0)
    a[1, :3] -= (a[1, :3] > 0)
    return a


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _edge_operands(p: int, rng) -> list[int]:
    """Field elements whose sums, differences and products carry or
    borrow across every lane: 0, 1, p - 1, p - 2, runs of 0xFFFFFFFF
    words from the bottom (2^32k - 1) and from the top, 2^256 mod p,
    halves of p, and a few random values. For p = 2^255 - 19 also 19,
    38 and values around 2^254 and 2^255 - 2^32k, whose sums with each
    other and with p - 1 cross 2^255."""
    vals = {0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, (1 << 256) % p, p - (1 << 256) % p}
    vals |= {(1 << (32 * k)) - 1 for k in range(1, 8)}
    vals |= {p - (1 << (32 * k)) for k in range(1, 8)}
    vals |= {((1 << 256) - (1 << (32 * k))) % p for k in range(1, 8)}
    if p == ED25519.p:
        vals |= {19, 38, 39, (1 << 254) - 1, 1 << 254, (1 << 254) + 19}
        vals |= {(1 << 255) - (1 << (32 * k)) for k in range(1, 7)}
    vals |= {rng.randrange(p) for _ in range(4)}
    return sorted(v for v in vals if 0 <= v < p)


@pytest.mark.parametrize(
    "curve, source",
    [(SECP256R1, "wei_ladder"), (SECP256K1, "wei_ladder"), (ED25519, "ed_ladder")],
    ids=["p256", "k1", "ed25519"],
)
def test_group_field_ops_on_host_match_ints(emulator, curve, source):
    """field256_group.cuh's multiply, gfe_add and gfe_sub (a op b and
    b op a), each lane of a group holding its words, on operands whose
    carries and borrows ripple across every lane (p - 1, words of
    0xFFFFFFFF, a + b == p, a == b, 0; for ed25519 also 19, 38 and sums
    crossing 2^255), built in the kernel source that uses the curve,
    with its multiply (Montgomery gfe_mul for the secp curves,
    special-form gfe_mul_25519 for ed25519): equal to Python ints for
    every pair; exact."""
    p = curve.p
    rng = random.Random(5)
    vals = _edge_operands(p, rng)
    pairs = [(a, b) for a in vals for b in vals]
    cases = ([(0, a, b) for a, b in pairs] + [(1, a, b) for a, b in pairs]
             + [(1, a, (p - a) % p) for a in vals]                 # a + b == p
             + [(2, a, b) for a, b in pairs] + [(2, a, a) for a in vals])
    rinv = 1 if SOURCES[source][5] == "gfe_mul_25519" else pow(1 << 256, -1, p)

    def ref(op, a, b):
        return (a * b * rinv if op == 0 else a + b if op == 1 else a - b) % p

    want = [v for op, a, b in cases for v in (ref(op, a, b), ref(op, b, a))]
    ops = np.array([op for op, _, _ in cases], dtype=np.uint32)
    a_w = np.array([_words(a) for _, a, _ in cases], dtype=np.uint32)
    b_w = np.array([_words(b) for _, _, b in cases], dtype=np.uint32)
    params = cuda_ec.ed_kernel_params(curve) if source == "ed_ladder" else cuda_ec.kernel_params(curve)
    out = _exec(emulator, source, 2, params, [ops, a_w, b_w], 16 * len(cases))
    got = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in out.view(np.uint32).reshape(-1, 8)]
    bad = [(c, g, w) for c, g, w in zip([c for c in cases for _ in (0, 1)], got, want) if g != w]
    assert not bad, bad[:4]
    assert len(cases) > 1000


@pytest.mark.parametrize("curve", [SECP256R1, SECP256K1], ids=["p256", "k1"])
def test_kernel_source_on_host_matches_refmath(emulator, curve):
    """Both ladder kernels on 7 rows: random scalars, all-264-bit
    scalars, u1=0, u2=0, Q=G and u2 = n - u1 with Q=G (infinity), Q from
    the torch to_mont (lazily reduced digits); canonical output equal to
    refmath; exact. 7 rows leave the block's last group past the ragged
    edge."""
    rng = random.Random(17)
    G = (curve.gx, curve.gy)
    u1s = [rng.randrange(curve.n), rng.getrandbits(264), 0, 5, 3, rng.randrange(curve.n), 1]
    u2s = [rng.randrange(curve.n), rng.getrandbits(264), 6, 0, curve.n - 3, 0, 0]
    qs = [refmath.wei_mul(curve, rng.randrange(1, curve.n), G) for _ in range(4)] + [G, G, G]
    args = (L.ints_to_batch(u1s), L.ints_to_batch(u2s),
            _lazy_mont(curve, [q[0] for q in qs], rng), _lazy_mont(curve, [q[1] for q in qs], rng))
    assert max(L.batch_to_ints(args[2])) >> 263   # the fold path is exercised
    want = [
        refmath.wei_add(curve, refmath.wei_mul(curve, a, G), refmath.wei_mul(curve, b, q))
        for a, b, q in zip(u1s, u2s, qs)
    ]
    assert want[4] is None
    for mode in (0, 1):
        out = _run(emulator, "wei_ladder", mode, cuda_ec.kernel_params(curve), args)
        assert out.min() >= 0 and out.max() < 4096
        X, Y, Z = (L.batch_to_ints(o) for o in out)
        for i, w in enumerate(want):
            assert max(X[i], Y[i], Z[i]) < curve.p
            if w is None:
                assert (X[i], Z[i]) == (0, 0), (mode, i)
            else:
                zi = pow(Z[i], -1, curve.p)
                assert (X[i] * zi % curve.p, Y[i] * zi % curve.p) == w, (mode, i)


def test_ed_kernel_source_on_host_matches_refmath(emulator):
    """Both Edwards ladder kernels on 10 rows: random s < 2^256 and
    k < L, s = 0, k = 0, A = identity, s = L, s + L, scalars using all
    264 digit bits, A of order 2 and of order 4, A given as the torch
    to_mont leaves it (lazy digits, rows 0-2 up to 2^264); canonical
    output, X*Y == Z*T, and x = X/Z, y = Y/Z equal to refmath; exact.
    10 rows leave the block's last 6 groups past the ragged edge."""
    c = ED25519
    rng = random.Random(23)
    B = (c.gx, c.gy)
    sqrt_m1 = pow(2, (c.p - 1) // 4, c.p)
    pts = [refmath.ed_mul(c, rng.randrange(1, c.L), B) for _ in range(4)]
    s_vals = [rng.getrandbits(256), 0, rng.randrange(c.L), 7, c.L, c.L + 5,
              rng.getrandbits(264), rng.getrandbits(256), 3, rng.randrange(c.L)]
    k_vals = [rng.randrange(c.L), rng.randrange(c.L), 0, rng.randrange(c.L), 9,
              rng.randrange(c.L), rng.getrandbits(264), 5, 6, rng.randrange(c.L)]
    a_pts = [pts[0], pts[1], pts[2], (0, 1), pts[3], pts[0], pts[1],
             (0, c.p - 1), (sqrt_m1, 0), B]
    args = (L.ints_to_batch(s_vals), L.ints_to_batch(k_vals),
            _lazy_mont(c, [a[0] for a in a_pts], rng), _lazy_mont(c, [a[1] for a in a_pts], rng))
    assert max(L.batch_to_ints(args[2])) >> 263   # the fold path is exercised
    want = [refmath.ed_add(c, refmath.ed_mul(c, s, B), refmath.ed_mul(c, k, a))
            for s, k, a in zip(s_vals, k_vals, a_pts)]
    for mode in (0, 1):
        out = _run(emulator, "ed_ladder", mode, cuda_ec.ed_kernel_params(c), args)
        assert out.min() >= 0 and out.max() < 4096
        X, Y, Z, T = (L.batch_to_ints(o) for o in out)
        for i, w in enumerate(want):
            assert max(X[i], Y[i], Z[i], T[i]) < c.p
            assert X[i] * Y[i] % c.p == Z[i] * T[i] % c.p, (mode, i)
            zi = pow(Z[i], -1, c.p)
            assert (X[i] * zi % c.p, Y[i] * zi % c.p) == w, (mode, i)
