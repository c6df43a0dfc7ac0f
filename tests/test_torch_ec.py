"""The port's Weierstrass point arithmetic against corda_tpu.crypto.ec.

Same inputs (from a seed) through both packages; points compare after
normalisation to affine or infinity, and limb arrays where the port
keeps the reference's algorithm. Integer arithmetic: exact equality.
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
from corda_tpu_torch.crypto import ec as TE  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256K1 as T_K1  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256R1 as T_R1  # noqa: E402

CURVES = {"p256": (J_R1, T_R1), "k1": (J_K1, T_K1)}


def _mont_batch(curve, pts):
    """Affine points (None = infinity) -> projective Montgomery numpy
    limbs, made by the reference's to_mont."""
    tm = jax.jit(JM.to_mont, static_argnums=0)
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return tuple(np.asarray(tm(curve.fp, JL.ints_to_batch(v))) for v in (xs, ys, zs))


def _affine(curve, P):
    """Projective Montgomery limbs -> affine ints per row, None at infinity."""
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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


@pytest.mark.parametrize("name", list(CURVES))
def test_wei_add_complete_matches_reference(name):
    """RCB15 complete addition: generic, P==Q, P==-Q, inf+P, P+inf,
    inf+inf — the port equals ec.wei_add limb for limb and refmath as
    points; exact."""
    jc, tc = CURVES[name]
    rng = random.Random(10)
    G = (jc.gx, jc.gy)
    P1 = refmath.wei_mul(jc, rng.randrange(1, jc.n), G)
    P2 = refmath.wei_mul(jc, rng.randrange(1, jc.n), G)
    neg1 = (P1[0], jc.p - P1[1])
    cases = [(P1, P2), (P1, P1), (P1, neg1), (None, P1), (P1, None),
             (None, None), (G, G), (P2, P1)]
    A = _mont_batch(jc, [a for a, _ in cases])
    B = _mont_batch(jc, [b for _, b in cases])
    want = [np.asarray(c) for c in jax.jit(partial(JE.wei_add, jc))(A, B)]
    got = [c.numpy() for c in TE.wei_add(tc, tuple(map(_t, A)), tuple(map(_t, B)))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert _affine(jc, got) == [refmath.wei_add(jc, a, b) for a, b in cases]


@pytest.mark.parametrize("name", list(CURVES))
def test_window_tables_match_reference(name):
    """wei_window_tables: entry 0 = infinity, G multiples as host
    constants, Q multiples by a complete-add chain — equal to the
    reference's tables entry by entry; exact."""
    jc, tc = CURVES[name]
    rng = random.Random(12)
    qs = [refmath.wei_mul(jc, rng.randrange(1, jc.n), (jc.gx, jc.gy)) for _ in range(4)]
    Q = _mont_batch(jc, qs)
    jg, jq = JE.wei_window_tables(jc, Q, 4, 4)   # eager: jit costs ~40 s
    tg, tq = TE.wei_window_tables(tc, tuple(map(_t, Q)), 4, 4)
    assert len(tg) == len(jg) == 16 and len(tq) == len(jq) == 16
    for jt, tt in ((jg, tg), (jq, tq)):
        for je, te in zip(jt, tt):
            for a, b in zip(je, te):
                assert np.array_equal(np.asarray(a), b.numpy())
    assert TE._g_table_mont(tc, 16) == JE._g_table_mont(jc, 16)


@partial(jax.jit, static_argnums=(0, 4))
def _jax_dsm(curve, u1, u2, Q, nbits):
    return JE.wei_double_scalar_mul(curve, u1, u2, Q, nbits)


def _dsm_case(jc, seed, B=8):
    rng = random.Random(seed)
    G = (jc.gx, jc.gy)
    u1s = [rng.randrange(jc.n) for _ in range(B - 4)] + [0, 1, jc.n - 1, 5]
    u2s = [rng.randrange(jc.n) for _ in range(B - 4)] + [0, 0, jc.n - 1, jc.n - 5]
    qs = [refmath.wei_mul(jc, rng.randrange(1, jc.n), G) for _ in range(B - 1)] + [G]
    return JL.ints_to_batch(u1s), JL.ints_to_batch(u2s), _mont_batch(jc, qs), (u1s, u2s, qs)


@pytest.mark.parametrize("name", list(CURVES))
@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "windowed"])
def test_double_scalar_mul_matches_reference(name, windowed):
    """wei_double_scalar_mul[_windowed] at B=8, 256 bits, equal to the
    reference's XLA double-scalar multiply (the plain reference of the
    Pallas kernels) and to refmath after normalisation, including
    u1=u2=0 and u2 = n - u1 with Q=G (both infinity); exact."""
    jc, tc = CURVES[name]
    u1, u2, Q, (u1s, u2s, qs) = _dsm_case(jc, 11)
    want = _affine(jc, _jax_dsm(jc, u1, u2, Q, 256))
    fn = TE.wei_double_scalar_mul_windowed if windowed else TE.wei_double_scalar_mul
    got = _affine(jc, fn(tc, _t(u1), _t(u2), tuple(map(_t, Q)), 256))
    assert got == want
    G = (jc.gx, jc.gy)
    assert got == [
        refmath.wei_add(jc, refmath.wei_mul(jc, a, G), refmath.wei_mul(jc, b, q))
        for a, b, q in zip(u1s, u2s, qs)
    ]
    assert got[4] is None and got[7] is None


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CURVES))
def test_windowed_matches_reference_windowed(name):
    """The port's windowed ladder against the reference's own windowed
    XLA function (about 80 s of XLA compile per curve, hence slow);
    exact after normalisation."""
    jc, tc = CURVES[name]
    u1, u2, Q, _ = _dsm_case(jc, 13)
    want = _affine(jc, jax.jit(
        partial(JE.wei_double_scalar_mul_windowed, jc), static_argnums=(3,)
    )(u1, u2, Q, 256))
    got = _affine(jc, TE.wei_double_scalar_mul_windowed(
        tc, _t(u1), _t(u2), tuple(map(_t, Q)), 256
    ))
    assert got == want


def test_proj_to_affine_and_infinity():
    """wei_proj_to_affine and wei_is_infinity on a mixed batch; exact."""
    jc, tc = CURVES["p256"]
    G = (jc.gx, jc.gy)
    pts = [G, None, refmath.wei_mul(jc, 12345, G)]
    P = tuple(map(_t, _mont_batch(jc, pts)))
    inf = TE.wei_is_infinity(tc.fp, P).tolist()
    assert inf == [False, True, False]
    x, y = TE.wei_proj_to_affine(tc.fp, P)
    from corda_tpu_torch.crypto import modmath as TM

    xs = JL.batch_to_ints(TM.from_mont(tc.fp, x).numpy())
    ys = JL.batch_to_ints(TM.from_mont(tc.fp, y).numpy())
    assert (xs[0], ys[0]) == G and (xs[2], ys[2]) == pts[2]
    assert TE.wei_is_infinity(tc.fp, TE.wei_infinity(tc.fp, 2, "cpu")).tolist() == [True, True]
