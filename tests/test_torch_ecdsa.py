"""The port's ECDSA staging and packed verification against corda_tpu.

One corpus — the port's ECDSA build_requests plus hand-made packed
edge rows — goes through both packages: the packed bytes must be
identical, and the port's ecdsa_verify_packed(device="cpu") must equal
the reference's ecdsa_verify_packed(..., use_pallas=False) row by row.
Accept/reject is exact: no tolerance.
"""

import random
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from corda_tpu.crypto import encodings as JEnc  # noqa: E402
from corda_tpu.crypto import refmath  # noqa: E402
from corda_tpu.crypto.curves import SECP256K1 as J_K1  # noqa: E402
from corda_tpu.crypto.curves import SECP256R1 as J_R1  # noqa: E402
from corda_tpu.crypto.ecdsa import ecdsa_verify_packed as j_verify_packed  # noqa: E402
from corda_tpu_torch.crypto import encodings as TEnc  # noqa: E402
from corda_tpu_torch.crypto import schemes  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256K1 as T_K1  # noqa: E402
from corda_tpu_torch.crypto.curves import SECP256R1 as T_R1  # noqa: E402
from corda_tpu_torch.crypto.ecdsa import ecdsa_verify_packed as t_verify_packed  # noqa: E402
from corda_tpu_torch.testing.selfcheck import TAMPERED_KINDS, build_requests  # noqa: E402

CURVES = {
    "p256": (J_R1, T_R1, schemes.ECDSA_SECP256R1_SHA256),
    "k1": (J_K1, T_K1, schemes.ECDSA_SECP256K1_SHA256),
}
B = 16


def _items(sid, n, seed):
    reqs = build_requests(n, seed=seed, scheme_ids=(sid,))
    return [(r.key.data, r.signature, r.message) for r in reqs]


def _rec(z, r, s, qx, qy) -> np.ndarray:
    return np.frombuffer(
        b"".join(v.to_bytes(32, "big") for v in (z, r, s, qx, qy)), np.uint8
    )


def _edge_rows(c, rng):
    """Hand-made records (z|r|s|qx|qy) with their expected decisions."""
    G = (c.gx, c.gy)
    d = rng.randrange(1, c.n)
    Q = refmath.wei_mul(c, d, G)
    z = rng.randrange(1 << 256)
    k = rng.randrange(1, c.n)
    r = refmath.wei_mul(c, k, G)[0] % c.n
    s = pow(k, -1, c.n) * (z + r * d) % c.n
    x0 = 0                                         # a point with a small x
    while JEnc._sqrt_mod(x0 ** 3 + c.a * x0 + c.b, c.p) is None:
        x0 += 1
    y0 = JEnc._sqrt_mod(x0 ** 3 + c.a * x0 + c.b, c.p)
    rows = [
        (_rec(z, r, s, *Q), True),                 # a valid signature
        (_rec(z, 0, s, *Q), False),                # r = 0
        (_rec(z, c.n, s, *Q), False),              # r = n
        (_rec(z, r, c.n, *Q), False),              # s = n
        (_rec(z, r, 0, *Q), False),                # s = 0
        (_rec(z, r, s, x0 + c.p, y0), False),      # qx >= p, on the curve mod p
        (_rec(z, r, s, Q[0], (Q[1] + 1) % c.p), False),   # Q off the curve
        (_rec(z, r, s, Q[0], c.p), False),         # qy >= p
    ]
    # the c1 = r + n candidate: a point R with n <= x_R < p, r = x_R - n,
    # z = 0 and Q = (s / r) * R make u2 * Q = R, so x_R == r + n (mod p)
    # and the row verifies only through the c1_ok branch
    x = c.n + rng.randrange(1, 1 << 64)
    while True:
        y = JEnc._sqrt_mod(x ** 3 + c.a * x + c.b, c.p)
        if y is not None and x < c.p:
            break
        x += 1
    r1, s1 = x - c.n, rng.randrange(1, c.n)
    Q1 = refmath.wei_mul(c, s1 * pow(r1, -1, c.n) % c.n, (x, y))
    assert refmath.ecdsa_verify(c, Q1, 0, r1, s1)
    rows.append((_rec(0, r1, s1, *Q1), True))
    rows.append((_rec(1, r1, s1, *Q1), False))     # same row, wrong z
    return rows


@pytest.mark.parametrize("name", list(CURVES))
def test_staging_bytes_identical(name):
    """stage_ecdsa_packed: the port's Python loop and the reference
    (its native codec where built) give identical records and masks,
    padding included; exact."""
    jc, tc, sid = CURVES[name]
    items = _items(sid, 13, seed=5)
    items.append((items[0][0][:-1], items[0][1], b"bad key"))   # short SEC1
    items.append((b"\x02" + items[1][0][1:33], items[1][1], items[1][2]))  # compressed
    jp, jv = JEnc.stage_ecdsa_packed(jc, items, B)
    tp, tv = TEnc.stage_ecdsa_packed(tc, items, B)
    assert tp.shape == (B, TEnc.ECDSA_RECORD_BYTES)
    assert np.array_equal(np.asarray(jp), tp)
    assert np.array_equal(np.asarray(jv), tv)
    with pytest.raises(ValueError):
        TEnc.stage_ecdsa_packed(tc, items, len(items) - 1)


def test_der_and_sec1_codecs_match_reference():
    """parse/encode DER and SEC1 equal the reference's on valid and
    malformed encodings; exact."""
    rng = random.Random(6)
    for _ in range(20):
        r, s = rng.randrange(1, J_R1.n), rng.randrange(1, J_R1.n)
        der = TEnc.encode_der_ecdsa(r, s)
        assert der == JEnc.encode_der_ecdsa(r, s)
        assert TEnc.parse_der_ecdsa(der) == (r, s)
        for bad in (der[:-1], der + b"\x00", b"\x30" + der[1:2] + b"\x02\x00" + der[4:],
                    der[:2] + b"\x02\x21\x00" + der[4:]):
            assert TEnc.parse_der_ecdsa(bad) == JEnc.parse_der_ecdsa(bad)
    for jc, tc in ((J_R1, T_R1), (J_K1, T_K1)):
        P = refmath.wei_mul(jc, rng.randrange(1, jc.n), (jc.gx, jc.gy))
        enc = TEnc.encode_sec1_point(*P)
        comp = bytes([2 + (P[1] & 1)]) + P[0].to_bytes(32, "big")
        for data in (enc, comp, enc[:-1], b"\x05" + enc[1:], comp[:1] + b"\xff" * 32):
            assert TEnc.parse_sec1_point(tc, data) == JEnc.parse_sec1_point(jc, data)
            assert TEnc._sec1_bytes(tc, data) == JEnc._sec1_bytes(jc, data)


@partial(jax.jit, static_argnums=0)
def _jax_packed(curve, packed, valid):
    return j_verify_packed(curve, packed, valid, use_pallas=False)


@pytest.mark.parametrize("name", list(CURVES))
def test_verify_packed_matches_reference(name):
    """ecdsa_verify_packed on CPU tensors equals the reference's XLA path
    row by row on build_requests rows (tampered kinds 5/6/7, padding) and
    hand-made edge rows (r=0, r=n, s=n, s=0, qx>=p, off-curve Q, qy>=p,
    and a row accepted only through the r+n candidate); exact."""
    jc, tc, sid = CURVES[name]
    rng = random.Random(7)
    n_req = B - 10
    items = _items(sid, n_req, seed=8)
    packed, valid = TEnc.stage_ecdsa_packed(tc, items, n_req)
    edges = _edge_rows(jc, rng)
    packed = np.concatenate([packed, np.stack([r for r, _ in edges])])
    valid = np.concatenate([valid, np.ones(len(edges), bool)])
    packed, valid = packed[:B], valid[:B]
    assert packed.shape == (B, 160)
    want = np.asarray(_jax_packed(jc, packed, valid)).tolist()
    got = t_verify_packed(
        tc, torch.from_numpy(packed.copy()), torch.from_numpy(valid.copy())
    ).tolist()
    assert got == want
    expect = [i % 8 not in TAMPERED_KINDS for i in range(n_req)] + [e for _, e in edges]
    assert got == expect[:B]
    # both ladders give the same decisions
    plain = t_verify_packed(
        tc, torch.from_numpy(packed.copy()), torch.from_numpy(valid.copy()),
        windowed=False,
    ).tolist()
    assert plain == got
