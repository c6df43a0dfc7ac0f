"""The port's torch field core against corda_tpu.crypto.modmath.

Same inputs (numpy, from a seed) through both packages. Integer
arithmetic has no tolerance: every comparison is exact equality of the
limb arrays (the port keeps the reference's algorithm, so even lazily
reduced outputs match digit for digit) and of canonical values.
"""

import random
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from corda_tpu.crypto import limbs as JL  # noqa: E402
from corda_tpu.crypto import modmath as JM  # noqa: E402
from corda_tpu.crypto.curves import SECP256K1, SECP256R1  # noqa: E402
from corda_tpu_torch import convert  # noqa: E402
from corda_tpu_torch.crypto import limbs as TL  # noqa: E402
from corda_tpu_torch.crypto import modmath as TM  # noqa: E402

MODULI = {
    "p256": SECP256R1.p,
    "n256": SECP256R1.n,
    "k1": SECP256K1.p,
    "nk1": SECP256K1.n,
}
B = 12


def _values(p: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    special = [0, 1, 2, p - 1, p - 2, p // 2]
    return special + [rng.randrange(p) for _ in range(B - len(special))]


@partial(jax.jit, static_argnums=0)
def _jax_inputs(ctx, x, y):
    """Montgomery inputs plus lazily reduced ones (add chains: < 4p,
    < 6p, < 12p, bounded limbs) — up to the bounds modmath.py:25-30
    allows a multiply."""
    xm, ym = JM.to_mont(ctx, x), JM.to_mont(ctx, y)
    l4 = JM.add_mod(ctx, xm, ym)
    l6 = JM.add_mod(ctx, l4, xm)
    l12 = JM.add_mod(ctx, JM.add_mod(ctx, l6, ym), l4)
    return xm, ym, l4, l6, l12


def _ops(M, ctx, xm, ym, l4, l6, l12, big):
    """The same operation list on either package's module M."""
    out = {
        "mont_mul": M.mont_mul(ctx, xm, ym),
        "mont_mul_lazy": M.mont_mul(ctx, l12, l6),
        "mont_sqr_lazy": M.mont_sqr(ctx, l12),
        "mont_mul_const": M.mont_mul_const(ctx, l12, ctx.r2_limbs),
        "add_mod": M.add_mod(ctx, l6, l4),
        "canon12": M.canon(ctx, l12, 12),
        "to_mont_big": M.to_mont(ctx, big),
        "from_mont": M.from_mont(ctx, l12),
        "mont_canon": M.mont_canon(ctx, l4, 4),
        "mont_inv": M.mont_inv(ctx, xm),
    }
    if ctx.sub_offset is not None:     # scalar-order fields never subtract
        out["sub_mod"] = M.sub_mod(ctx, l6, l4)
        out["neg_mod"] = M.neg_mod(ctx, l4)
    return out


@partial(jax.jit, static_argnums=0)
def _jax_ops(ctx, xm, ym, l4, l6, l12, big):
    return _ops(JM, ctx, xm, ym, l4, l6, l12, big)


@pytest.mark.parametrize("mod_name", list(MODULI))
def test_field_ops_match_reference(mod_name):
    """Every field op of the port equals modmath's, limb for limb, on
    random, edge (0, 1, p-1) and lazily reduced inputs; exact."""
    p = MODULI[mod_name]
    ctx_j = JM.MontCtx.make(p)
    ctx_t = TM.MontCtx.make(p)
    assert ctx_t == TM.MontCtx(**ctx_j.__dict__)   # host constants identical
    xs, ys = _values(p, 1), list(reversed(_values(p, 2)))
    rng = random.Random(3)
    bigs = [rng.randrange(1 << 264) for _ in range(B)]   # to_mont takes any < R
    x, y, big = (JL.ints_to_batch(v) for v in (xs, ys, bigs))
    ins = [np.asarray(a) for a in _jax_inputs(ctx_j, x, y)]
    want = {k: np.asarray(v) for k, v in _jax_ops(ctx_j, *ins, big).items()}
    t_ins = [convert.limbs_from_numpy(a, "cpu") for a in ins + [big]]
    got = {k: convert.limbs_to_numpy(v) for k, v in _ops(TM, ctx_t, *t_ins).items()}
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # and the values themselves (exact)
    R = 1 << 264
    prod = TL.batch_to_ints(got["mont_mul"])
    assert [v % p for v in prod] == [x_ * y_ * R % p for x_, y_ in zip(xs, ys)]
    inv = TL.batch_to_ints(got["mont_inv"])
    assert [v * pow(R, -1, p) % p for v in inv] == [pow(v, -1, p) if v else 0 for v in xs]


@pytest.mark.parametrize("mod_name", ["p256", "k1"])
def test_unpack_compare_select_match_reference(mod_name):
    """unpack_be32, lex_lt, nonzero, is_zero, eq and select equal the
    reference's outputs on the same random bytes; exact."""
    p = MODULI[mod_name]
    rng = np.random.default_rng(4)
    cols = rng.integers(0, 256, size=(32, B), dtype=np.int32)
    cols[:, 0] = 0                                   # zero value
    cols[:, 1] = np.frombuffer(p.to_bytes(32, "big"), np.uint8)   # == p
    cols[:, 2] = np.frombuffer((p - 1).to_bytes(32, "big"), np.uint8)
    p_limbs = tuple(int(v) for v in JL.int_to_limbs(p))
    mask = rng.integers(0, 2, size=B).astype(bool)

    def run(M, conv):
        u = M.unpack_be32(conv(cols))
        other = M.unpack_be32(conv(cols[::-1].copy()))
        return [
            u, M.lex_lt(u, p_limbs), M.nonzero(u), M.is_zero(u),
            M.eq(u, other), M.eq(u, u), M.select(conv(mask), u, other),
        ]

    want = [np.asarray(v) for v in run(JM, lambda a: jax.numpy.asarray(a))]
    got = [v.numpy() for v in run(TM, torch.from_numpy)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    assert TL.batch_to_ints(got[0]) == [
        int.from_bytes(bytes(cols[:, j].astype(np.uint8)), "big") for j in range(B)
    ]
    assert got[1].tolist()[:3] == [True, False, True]


def test_limbs_roundtrip_and_convert():
    """limbs.py is a copy: same digits; convert moves [22, B] both ways."""
    rng = random.Random(5)
    xs = [rng.randrange(1 << 264) for _ in range(B)]
    a = TL.ints_to_batch(xs)
    assert np.array_equal(a, JL.ints_to_batch(xs))
    assert TL.batch_to_ints(convert.limbs_to_numpy(convert.limbs_from_numpy(a, "cpu"))) == xs
    with pytest.raises(ValueError):
        convert.limbs_from_numpy(np.zeros((21, 3), np.int32), "cpu")
