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
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cuda_ec.wei_ladder(T_R1, *(t.to("cuda") for t in t_args))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.nvcc_path()
    assert (cuda_ec.wei_ladder_launches, cuda_ec.wei_ladder_windowed_launches) == (0, 0)


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
    2^264 mod p, a and 3b in the 2^256 Montgomery domain, -p^-1 mod
    2^32, and the G table (entry 0 = infinity, entry k = k*G affine,
    Z = 1) — checked against refmath; exact."""
    _, tc = CURVES[name]
    w = cuda_ec.kernel_params(tc)
    assert w.dtype == np.uint32 and w.size == 6 * 8 + 1 + 16 * 24

    def word_int(off):
        return sum(int(v) << (32 * i) for i, v in enumerate(w[off : off + 8]))

    p, R = tc.p, 1 << 256
    assert [word_int(8 * k) for k in range(6)] == [
        p, R % p, 1 << 248, (1 << 264) % p, tc.a * R % p, 3 * tc.b * R % p
    ]
    assert (int(w[48]) * p) % (1 << 32) == (1 << 32) - 1
    g = 49
    assert [word_int(g + 8 * c) for c in range(3)] == [0, R % p, 0]
    P = None
    for k in range(1, 16):
        P = refmath.wei_add(tc, P, (tc.gx, tc.gy))
        e = g + 24 * k
        x, y, z = (word_int(e + 8 * c) for c in range(3))
        assert (x, y, z) == (P[0] * R % p, P[1] * R % p, R % p)
