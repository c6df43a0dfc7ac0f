"""The CUDA ladder module on CPU tensors: dispatch, plain versions and
the host-side kernel constants.

On CPU tensors `wei_ladder` / `wei_ladder_windowed` run the plain torch
versions, which must equal the reference's XLA ladder over all 264
digit bits (the scan of the Pallas kernels). A request for the kernel
on a machine without CUDA raises; nothing falls back, and the launch
counters stay at 0. The kernels themselves are held against these plain
versions on the card by chip_smoke.py and tests/test_torch_gpu.py.
Integer arithmetic: exact equality.
"""

import dataclasses
import random
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from corda_tpu.crypto import ec as JE  # noqa: E402
from corda_tpu.crypto import limbs as JL  # noqa: E402
from corda_tpu.crypto import modmath as JM  # noqa: E402
from corda_tpu.crypto import refmath  # noqa: E402
from corda_tpu.crypto.curves import SECP256K1 as J_K1  # noqa: E402
from corda_tpu.crypto.curves import SECP256R1 as J_R1  # noqa: E402
from corda_tpu_torch.crypto import build, cuda_ec  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519 as T_ED  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256K1 as T_K1  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256R1 as T_R1  # noqa: E402

CURVES = {"p256": (J_R1, T_R1), "k1": (J_K1, T_K1)}


@partial(jax.jit, static_argnums=0)
def _jax_ladder264(curve, u1, u2, qx_m, qy_m):
    Q = JE.wei_affine_to_proj(curve.fp, qx_m, qy_m)
    return JE.wei_double_scalar_mul(curve, u1, u2, Q, nbits=264)


def _affine(curve, P):
    X, Y, Z = (JL.batch_to_ints(np.asarray(c)) for c in P)
    out = []
    for x, y, z in zip(X, Y, Z):
        z %= curve.p
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, curve.p)
            out.append(((x * zi) % curve.p, (y * zi) % curve.p))
    return out


def _inputs(jc, seed, B=6):
    rng = random.Random(seed)
    G = (jc.gx, jc.gy)
    u1s = [0, 9, rng.getrandbits(264), rng.randrange(jc.n), 3, rng.randrange(jc.n)]
    u2s = [4, 0, rng.getrandbits(264), rng.randrange(jc.n), jc.n - 3, rng.randrange(jc.n)]
    qs = [refmath.wei_mul(jc, rng.randrange(1, jc.n), G) for _ in range(4)] + [G, G]
    tm = jax.jit(JM.to_mont, static_argnums=0)
    qx = np.asarray(tm(jc.fp, JL.ints_to_batch([q[0] for q in qs])))
    qy = np.asarray(tm(jc.fp, JL.ints_to_batch([q[1] for q in qs])))
    args = (JL.ints_to_batch(u1s), JL.ints_to_batch(u2s), qx, qy)
    return args, (u1s, u2s, qs)


@pytest.mark.parametrize("name", list(CURVES))
def test_ladders_on_cpu_match_reference(name):
    """wei_ladder and wei_ladder_windowed on CPU tensors route to the
    plain versions and equal the reference's 264-bit XLA ladder and
    refmath after normalisation (edge rows: u1=0, u2=0, scalars using
    all 264 bits, Q=G, u2 = n - u1 with Q=G); exact. The launch
    counters stay at 0."""
    jc, tc = CURVES[name]
    args, (u1s, u2s, qs) = _inputs(jc, 21)
    want = _affine(jc, _jax_ladder264(jc, *args))
    G = (jc.gx, jc.gy)
    assert want == [
        refmath.wei_add(jc, refmath.wei_mul(jc, a, G), refmath.wei_mul(jc, b, q))
        for a, b, q in zip(u1s, u2s, qs)
    ]
    assert want[4] is None
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    before = (cuda_ec.wei_ladder_launches, cuda_ec.wei_ladder_windowed_launches)
    for fn in (cuda_ec.wei_ladder, cuda_ec.wei_ladder_windowed):
        assert _affine(jc, fn(tc, *t_args)) == want
    assert (cuda_ec.wei_ladder_launches, cuda_ec.wei_ladder_windowed_launches) == before == (0, 0)


def test_kernel_request_without_cuda_raises(monkeypatch):
    """The kernel entry points refuse CPU tensors, a CUDA tensor cannot
    exist without CUDA, and a missing nvcc is an error: no fallback."""
    args, _ = _inputs(J_R1, 22)
    t_args = [torch.from_numpy(np.array(a)) for a in args]
    for kern in (cuda_ec.wei_ladder_cuda, cuda_ec.wei_ladder_windowed_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kern(T_R1, *t_args)
    for kern in (cuda_ec.ed_ladder_cuda, cuda_ec.ed_ladder_windowed_cuda):
        with pytest.raises(ValueError, match="s is on cpu; the CUDA ladder needs a CUDA tensor"):
            kern(T_ED, *t_args)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cuda_ec.wei_ladder(T_R1, *(t.to("cuda") for t in t_args))
        with pytest.raises((RuntimeError, AssertionError)):
            cuda_ec.ed_ladder(T_ED, *(t.to("cuda") for t in t_args))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.nvcc_path()
    assert (cuda_ec.wei_ladder_launches, cuda_ec.wei_ladder_windowed_launches,
            cuda_ec.ed_ladder_launches, cuda_ec.ed_ladder_windowed_launches) == (0, 0, 0, 0)


def test_library_path_keys_on_shared_headers(tmp_path, monkeypatch):
    """A library is keyed on its source, every csrc/*.cuh beside it, the
    flags and nvcc's version (here a stand-in string: there is no nvcc):
    editing a shared header (or adding one) moves the path of every
    source that could include it; an unrelated file does not."""
    monkeypatch.setattr(build, "nvcc_version", lambda nvcc=None: "nvcc 12.8")
    for name in ("a.cu", "b.cu", "field.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    paths = {n: build.library_path(tmp_path / n) for n in ("a.cu", "b.cu")}
    assert paths["a.cu"].name.startswith("liba-") and paths["a.cu"] != paths["b.cu"]
    (tmp_path / "notes.txt").write_text("x")
    assert build.library_path(tmp_path / "a.cu") == paths["a.cu"]
    (tmp_path / "field.cuh").write_text("// edited\n")
    assert all(build.library_path(tmp_path / n) != paths[n] for n in paths)
    edited = build.library_path(tmp_path / "a.cu")
    (tmp_path / "more.cuh").write_text("// new header\n")
    assert build.library_path(tmp_path / "a.cu") != edited
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path(tmp_path / "a.cu") != edited
    flagged = build.library_path(tmp_path / "a.cu")
    monkeypatch.setattr(build, "nvcc_version", lambda nvcc=None: "nvcc 12.9")
    assert build.library_path(tmp_path / "a.cu") != flagged
    assert [s.name for s in build.sources()] == ["ed_ladder.cu", "wei_ladder.cu"]
    assert (build.CSRC_DIR / "field256.cuh").exists()
    assert (build.CSRC_DIR / "field256_group.cuh").exists()
    assert (build.CSRC_DIR / "group_points.cuh").exists()


def test_windowed_default_per_curve():
    """Per-curve ladder defaults as the reference (pallas_ec.py:76);
    an explicit choice wins; unknown tags get the plain ladder."""
    assert cuda_ec.use_windowed_ladder("p256") is True
    assert cuda_ec.use_windowed_ladder("k1") is False
    assert cuda_ec.use_windowed_ladder("ed25519") is False
    assert cuda_ec.use_windowed_ladder("other") is False
    assert cuda_ec.use_windowed_ladder("k1", windowed=True) is True
    assert cuda_ec.use_windowed_ladder("p256", windowed=False) is False
    assert cuda_ec.curve_tag(T_R1) == "p256" and cuda_ec.curve_tag(T_K1) == "k1"


@pytest.mark.parametrize("name", list(CURVES))
def test_kernel_params_layout(name):
    """The constants the kernel receives: p, 2^256 mod p, 2^248,
    2^264 mod p, the formulas' b multiple (b for p256's a = -3, 3b for
    k1's a = 0) in the 2^256 Montgomery domain, the a = 0 flag, -p^-1
    mod 2^32, and the G table (entry 0 = infinity, entry k = k*G affine,
    Z = 1) — checked against refmath; exact. A curve with another a has
    no kernel formulas and raises."""
    _, tc = CURVES[name]
    w = cuda_ec.kernel_params(tc)
    assert w.dtype == np.uint32 and w.size == 5 * 8 + 2 + 16 * 24 == 426

    def word_int(off):
        return sum(int(v) << (32 * i) for i, v in enumerate(w[off : off + 8]))

    p, R = tc.p, 1 << 256
    a_zero = name == "k1"
    assert tc.a % p == (0 if a_zero else p - 3)
    bm = 3 * tc.b if a_zero else tc.b
    assert [word_int(8 * k) for k in range(5)] == [
        p, R % p, 1 << 248, (1 << 264) % p, bm * R % p
    ]
    assert int(w[40]) == int(a_zero)
    assert (int(w[41]) * p) % (1 << 32) == (1 << 32) - 1
    g = 42
    assert [word_int(g + 8 * c) for c in range(3)] == [0, R % p, 0]
    P = None
    for k in range(1, 16):
        P = refmath.wei_add(tc, P, (tc.gx, tc.gy))
        e = g + 24 * k
        x, y, z = (word_int(e + 8 * c) for c in range(3))
        assert (x, y, z) == (P[0] * R % p, P[1] * R % p, R % p)
    other = dataclasses.replace(tc, name="a = 1", a=1)
    with pytest.raises(ValueError, match="a = 0 or a = -3"):
        cuda_ec.kernel_params(other)


def test_ed_kernel_params_layout():
    """The constants the Edwards kernel receives: p, 2^256 mod p (the
    entry fold), 2^-8 and 2^520 mod p (the 2^264 domain to the kernel's
    plain one and back, through Montgomery multiplies), 2d, -p^-1 mod
    2^32, and the B table cached for the mixed add (entry 0 = the
    identity as (1, 1, 0), entry j = j*B as (y - x, y + x, 2d*x*y)),
    all plain values mod p — 425 words, checked against refmath; exact."""
    w = cuda_ec.ed_kernel_params(T_ED)
    assert w.dtype == np.uint32 and w.size == 5 * 8 + 1 + 16 * 24 == 425

    def word_int(off):
        return sum(int(v) << (32 * i) for i, v in enumerate(w[off : off + 8]))

    p, R = T_ED.p, 1 << 256
    c_in, c_out = word_int(16), word_int(24)
    assert c_in * (1 << 264) * pow(R, -1, p) % p == 1            # 2^264 domain -> plain
    assert c_out * pow(R, -1, p) % p == (1 << 264) % p           # plain -> 2^264 domain
    assert [word_int(8 * k) for k in range(5)] == [
        p, R % p, pow(2, -8, p), pow(2, 520, p), 2 * T_ED.d % p
    ]
    assert (int(w[40]) * p) % (1 << 32) == (1 << 32) - 1
    b = 41
    assert [word_int(b + 8 * c) for c in range(3)] == [1, 1, 0]
    P = (0, 1)
    for j in range(1, 16):
        P = refmath.ed_add(T_ED, P, (T_ED.gx, T_ED.gy))
        x, y = P
        e = b + 24 * j
        assert [word_int(e + 8 * c) for c in range(3)] == [
            (y - x) % p, (y + x) % p, 2 * T_ED.d * x * y % p
        ]
