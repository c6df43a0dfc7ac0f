"""The port's Edwards (ed25519) point arithmetic and ladders against
corda_tpu.crypto.ec and refmath.

Same inputs (from a seed) through both packages: ed_add limb for limb,
the window tables entry by entry, and the plain and windowed ladders —
on CPU tensors, the plain versions of the CUDA kernels, over all 264
digit bits as the kernels scan — as points after normalisation, against
the reference's XLA double-scalar multiplies and refmath. Integer
arithmetic: exact equality.
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
from corda_tpu.crypto.curves import ED25519 as JC  # noqa: E402
from corda_tpu_torch.crypto import cuda_ec  # noqa: E402
from corda_tpu_torch.crypto import ec as TE  # noqa: E402
from corda_tpu_torch.crypto import modmath as TM  # noqa: E402
from corda_tpu_torch.crypto.curves import ED25519 as TC  # noqa: E402

P = JC.p
BASE = (JC.gx, JC.gy)
SQRT_M1 = pow(2, (P - 1) // 4, P)
T2 = (0, P - 1)          # order 2
T4 = (SQRT_M1, 0)        # order 4


def _mont(vals):
    return np.asarray(jax.jit(JM.to_mont, static_argnums=0)(JC.fp, JL.ints_to_batch(vals)))


def _ext_batch(pts):
    """Affine points -> extended (X, Y, 1, XY) Montgomery numpy limbs,
    made by the reference's to_mont."""
    return tuple(_mont(v) for v in (
        [p[0] for p in pts], [p[1] for p in pts], [1] * len(pts), [p[0] * p[1] % P for p in pts]
    ))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _affine(pt):
    """Extended Montgomery limbs -> affine ints per row; X*Y == Z*T
    checked on the way."""
    X, Y, Z, T = (JL.batch_to_ints(np.asarray(c)) for c in pt)
    out = []
    for x, y, z, t in zip(X, Y, Z, T):
        assert (x * y - z * t) % P == 0
        zi = pow(z, -1, P)
        out.append(((x * zi) % P, (y * zi) % P))
    return out


def _points(seed, n):
    rng = random.Random(seed)
    return [refmath.ed_mul(JC, rng.randrange(1, JC.L), BASE) for _ in range(n)]


def test_ed_add_matches_reference():
    """Unified hwcd-3 addition: generic, P+P, P+(-P), identity+P,
    P+identity, identity+identity, small-order operands (order 2 and
    4, T4+T4 = T2, T2+P) — the port equals ec.ed_add limb for limb and
    refmath as points; exact."""
    P1, P2 = _points(30, 2)
    neg1 = ((P - P1[0]) % P, P1[1])
    ident = (0, 1)
    cases = [(P1, P2), (P1, P1), (P1, neg1), (ident, P1), (P1, ident), (ident, ident),
             (T2, P1), (T4, T4), (T4, P2), (BASE, BASE)]
    A = _ext_batch([a for a, _ in cases])
    B = _ext_batch([b for _, b in cases])
    want = [np.asarray(c) for c in jax.jit(partial(JE.ed_add, JC))(A, B)]
    got = [c.numpy() for c in TE.ed_add(TC, tuple(map(_t, A)), tuple(map(_t, B)))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert _affine(got) == [refmath.ed_add(JC, a, b) for a, b in cases]
    assert _affine(got)[7] == T2


def test_ed_window_tables_match_reference():
    """ed_window_tables: entry 0 the identity (0, 1, 1, 0), B multiples
    as host constants (x, y, 1, xy), A multiples by the chain
    a_tab[j] = a_tab[j-1] + A — equal to the reference's tables entry
    by entry; _b_table_mont equal, and in the kernel's 2^256 domain
    with r_bits=256; exact."""
    A = _ext_batch(_points(31, 3) + [T2])
    jb, ja = JE.ed_window_tables(JC, A, 4, 4)   # eager: jit costs more than it saves
    tb, ta = TE.ed_window_tables(TC, tuple(map(_t, A)), 4, 4)
    assert len(tb) == len(jb) == 16 and len(ta) == len(ja) == 16
    for jt, tt in ((jb, tb), (ja, ta)):
        for je, te in zip(jt, tt):
            for a, b in zip(je, te):
                assert np.array_equal(np.asarray(a), b.numpy())
    assert TE._b_table_mont(TC, 16) == JE._b_table_mont(JC, 16)
    R = 1 << 256
    pt = None
    for j, (x, y, t) in enumerate(TE._b_table_mont(TC, 16, r_bits=256), start=1):
        pt = BASE if pt is None else refmath.ed_add(JC, pt, BASE)
        assert (x, y, t) == (pt[0] * R % P, pt[1] * R % P, pt[0] * pt[1] * R % P), j


@partial(jax.jit, static_argnums=4)
def _jax_dsm(s, k, ax_m, ay_m, nbits):
    A = JE.ed_affine_to_ext(JC.fp, ax_m, ay_m)
    return JE.ed_double_scalar_mul(JC, s, k, A, nbits)


def _ladder_case(seed):
    """s, k, ax_m, ay_m for 8 rows: random s < 2^256 and k < L, s = 0,
    k = 0, A = identity, s = L, s + L, scalars using all 264 digit bits,
    A of order 2; A in the Montgomery domain as the reference's to_mont
    leaves it."""
    rng = random.Random(seed)
    pts = _points(seed, 4)
    ss = [rng.getrandbits(256), 0, 7, JC.L, JC.L + 5, rng.getrandbits(264), 9, rng.randrange(JC.L)]
    ks = [rng.randrange(JC.L), 6, 0, 3, rng.randrange(JC.L), rng.getrandbits(264), 4, rng.randrange(JC.L)]
    As = [pts[0], pts[1], pts[2], (0, 1), pts[3], pts[0], T2, T4]
    args = (JL.ints_to_batch(ss), JL.ints_to_batch(ks),
            _mont([a[0] for a in As]), _mont([a[1] for a in As]))
    want = [refmath.ed_add(JC, refmath.ed_mul(JC, s, BASE), refmath.ed_mul(JC, k, a))
            for s, k, a in zip(ss, ks, As)]
    return args, want


def test_ed_ladders_on_cpu_match_reference():
    """ed_ladder and ed_ladder_windowed on CPU tensors route to the plain
    versions and equal the reference's 264-bit XLA ladder (the scan of
    the Pallas kernels) and refmath after normalisation, edge rows
    included; the s = L row gives k*A and s + L gives what s gives;
    exact. The launch counters stay at 0."""
    args, want = _ladder_case(32)
    ref = _affine(_jax_dsm(*args, 264))
    assert ref == want
    assert want[3] == refmath.ed_mul(JC, 3, (0, 1)) == (0, 1)     # s = L, A = identity
    t_args = [_t(a) for a in args]
    before = (cuda_ec.ed_ladder_launches, cuda_ec.ed_ladder_windowed_launches)
    for fn in (cuda_ec.ed_ladder, cuda_ec.ed_ladder_windowed):
        assert _affine(fn(TC, *t_args)) == want
    assert (cuda_ec.ed_ladder_launches, cuda_ec.ed_ladder_windowed_launches) == before == (0, 0)


@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "windowed"])
def test_ed_double_scalar_mul_256_matches_refmath(windowed):
    """ec.ed_double_scalar_mul[_windowed] at the reference's XLA width
    (256 bits) on scalars below 2^256 equal refmath after
    normalisation; exact."""
    args, want = _ladder_case(33)
    keep = [i for i in range(8) if i != 5]          # row 5 uses 264 bits
    args = tuple(a[:, keep] for a in args)
    A = TE.ed_affine_to_ext(TC.fp, _t(args[2]), _t(args[3]))
    fn = TE.ed_double_scalar_mul_windowed if windowed else TE.ed_double_scalar_mul
    assert _affine(fn(TC, _t(args[0]), _t(args[1]), A, 256)) == [want[i] for i in keep]


def test_ed_windowed_matches_reference_windowed():
    """The port's windowed ladder against the reference's own windowed
    XLA function at 264 bits (about a minute of XLA compile); exact
    after normalisation."""
    args, _ = _ladder_case(34)

    @jax.jit
    def jax_windowed(s, k, ax_m, ay_m):
        A = JE.ed_affine_to_ext(JC.fp, ax_m, ay_m)
        return JE.ed_double_scalar_mul_windowed(JC, s, k, A, 264)

    want = _affine(jax_windowed(*args))
    assert _affine(cuda_ec.ed_ladder_windowed_plain(TC, *map(_t, args))) == want


def test_ed_ext_to_affine_and_identity():
    """ed_ext_to_affine equals the reference's limb for limb on a batch
    with Z != 1 (outputs of an add), and ed_identity is (0, 1, 1, 0);
    exact."""
    pts = _ext_batch(_points(35, 3) + [(0, 1)])
    summed = jax.jit(partial(JE.ed_add, JC))(pts, pts)
    want = [np.asarray(c) for c in jax.jit(JE.ed_ext_to_affine, static_argnums=0)(JC.fp, summed)]
    got = [c.numpy() for c in TE.ed_ext_to_affine(TC.fp, tuple(_t(c) for c in summed))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    xs = JL.batch_to_ints(TM.from_mont(TC.fp, torch.from_numpy(got[0])).numpy())
    ys = JL.batch_to_ints(TM.from_mont(TC.fp, torch.from_numpy(got[1])).numpy())
    assert (xs[3], ys[3]) == (0, 1)
    ident = TE.ed_identity(TC.fp, 2, "cpu")
    assert [JL.batch_to_ints(TM.from_mont(TC.fp, c).numpy()) for c in ident] == [[0, 0], [1, 1], [1, 1], [0, 0]]
