"""The port's ed25519 staging, decoding and packed verification against
corda_tpu.

One corpus — ed25519 build_requests rows (tampered kinds 5/6/7), the
edge rows of selfcheck.ed25519_edge_requests (s + L, A.y >= p,
R.y >= p, A = identity, y = 1 with the sign bit, A off the curve,
small-order A) and malformed lengths — goes through both packages: the
staged bytes must be identical, and the port's ed_decompress_neg_batch
and ed25519_verify_packed on CPU tensors must equal the reference's XLA
versions (use_pallas=False) row by row, and the CPU reference's labels.
Accept/reject is exact: no tolerance.
"""

import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from corda_tpu.crypto import eddsa as JD  # noqa: E402
from corda_tpu.crypto import encodings as JEnc  # noqa: E402
from corda_tpu.crypto import limbs as JL  # noqa: E402
from corda_tpu.crypto import refmath  # noqa: E402
from corda_tpu.crypto import schemes as J_S  # noqa: E402
from corda_tpu.crypto.curves import ED25519 as JC  # noqa: E402
from corda_tpu_torch.crypto import eddsa as TD  # noqa: E402
from corda_tpu_torch.crypto import encodings as TEnc  # noqa: E402
from corda_tpu_torch.crypto import schemes  # noqa: E402
from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier  # noqa: E402
from corda_tpu_torch.testing.selfcheck import (  # noqa: E402
    TAMPERED_KINDS,
    build_requests,
    ed25519_edge_requests,
)

P = JC.p
ED = schemes.EDDSA_ED25519_SHA512


@pytest.fixture(scope="module")
def corpus():
    """(items, CPU labels): 10 build_requests rows, the edge rows, a
    short key and a short signature."""
    reqs = build_requests(10, seed=41, scheme_ids=(ED,))
    reqs += [r for _, r in ed25519_edge_requests(seed=42)]
    items = [(r.key.data, r.signature, r.message) for r in reqs]
    items.append((items[0][0][:31], items[0][1], items[0][2]))
    items.append((items[0][0], items[0][1][:63], items[0][2]))
    labels = [refmath.ed25519_verify(pub, msg, sig) for pub, sig, msg in items]
    assert labels[:10] == [i % 8 not in TAMPERED_KINDS for i in range(10)]
    assert labels == CpuBatchVerifier().verify_batch(reqs) + [False, False]
    return items, labels


def test_p_minus_boundaries():
    """_p_minus on 0, 1, 2, p-1, p-2, 2^255-20 and random values: the
    borrow chain gives canonical p - x (0 for x = 0), equal to the
    reference's limb for limb; exact."""
    rng = random.Random(40)
    vals = [0, 1, 2, P - 1, P - 2, 4095, 4096, (1 << 252) - 1] + [rng.randrange(P) for _ in range(8)]
    x = JL.ints_to_batch(vals)
    want = np.asarray(jax.jit(JD._p_minus)(x))
    got = TD._p_minus(torch.from_numpy(x)).numpy()
    assert np.array_equal(want, got)
    assert got.min() >= 0 and got.max() < 4096
    assert JL.batch_to_ints(got) == [(P - v) % P for v in vals]


def test_stage_packed_bytes_identical(corpus):
    """stage_ed25519_packed: the port's Python loop and the reference
    (its native codec where built) give identical records, sign bits and
    masks, padding and malformed rows included; exact."""
    items, _ = corpus
    B = len(items) + 3
    want = JEnc.stage_ed25519_packed(items, B)
    got = TEnc.stage_ed25519_packed(items, B)
    assert got[0].shape == (B, TEnc.ED25519_RECORD_BYTES)
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == g.dtype and np.array_equal(np.asarray(w), g)
    with pytest.raises(ValueError):
        TEnc.stage_ed25519_packed(items, len(items) - 1)


@jax.jit
def _jax_decompress(y_raw, a_sign):
    return JD.ed_decompress_neg_batch(y_raw, a_sign)


def test_decompress_matches_reference():
    """ed_decompress_neg_batch on valid points, both parities, the
    identity, y = 1 with the sign bit set, y = p - 1 (order 2), y = 0
    (order 4), y >= p and y off the curve: (-A.x, y, ok) equal to the
    reference's XLA function and to refmath.ed_decompress; exact."""
    rng = random.Random(43)
    cases = [(pt[1], pt[0] & 1) for pt in (
        refmath.ed_mul(JC, rng.randrange(1, JC.L), (JC.gx, JC.gy)) for _ in range(6))]
    cases[1] = (cases[1][0], cases[1][1] ^ 1)          # the other root's parity
    y_off = 2
    while refmath.ed_decompress(JC, y_off.to_bytes(32, "little")) is not None:
        y_off += 1
    sqrt_m1 = pow(2, (P - 1) // 4, P)
    cases += [(1, 0), (1, 1), (P - 1, 0), (0, sqrt_m1 & 1), (0, (sqrt_m1 & 1) ^ 1),
              (P, 0), (P + 5, 1), ((1 << 255) - 1, 0), (y_off, 0), (y_off, 1)]
    y_raw = JL.ints_to_batch([y for y, _ in cases])
    a_sign = np.array([s for _, s in cases], dtype=np.int32)
    want = [np.asarray(v) for v in _jax_decompress(y_raw, a_sign)]
    got = [v.numpy() for v in TD.ed_decompress_neg_batch(torch.from_numpy(y_raw), torch.from_numpy(a_sign))]
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    for i, (y, sign) in enumerate(cases):
        A = refmath.ed_decompress(JC, (y | (sign << 255)).to_bytes(32, "little"))
        assert bool(got[2][i]) == (A is not None), i
        if A is not None:
            assert JL.batch_to_ints(got[0][:, i:i + 1]) == [(P - A[0]) % P]
            assert JL.batch_to_ints(got[1][:, i:i + 1]) == [A[1]]


@jax.jit
def _jax_packed(packed, a_sign, r_sign, valid):
    return JD.ed25519_verify_packed(packed, a_sign, r_sign, valid, use_pallas=False)


def test_verify_packed_matches_reference(corpus):
    """ed25519_verify_packed on CPU tensors, with the default (plain) and
    the windowed ladder, equals the reference's XLA path and the CPU
    reference row by row on the whole corpus plus padding; exact."""
    items, labels = corpus
    B = len(items) + 2
    staged = TEnc.stage_ed25519_packed(items, B)
    want = np.asarray(_jax_packed(*(jnp.asarray(a) for a in staged))).tolist()
    assert want == labels + [False, False]
    for windowed in (None, True):
        got = TD.ed25519_verify_packed(*(torch.from_numpy(a.copy()) for a in staged), windowed=windowed)
        assert got.tolist() == want


def test_verify_batch_limb_level(corpus):
    """The limb-level ed25519_verify_batch on host-decoded -A
    (stage_ed25519_batch, equal to the reference's staging) gives the
    CPU reference's decisions; exact."""
    items, labels = corpus
    B = len(items) + 1
    staged = TEnc.stage_ed25519_batch(items, B)
    ref = JEnc.stage_ed25519_batch(items, B)
    assert staged.keys() == ref.keys()
    for key in staged:
        assert np.array_equal(np.asarray(ref[key]), staged[key]), key
    got = TD.ed25519_verify_batch(*(torch.from_numpy(staged[key].copy()) for key in (
        "s", "k", "nax", "nay", "exp_y", "exp_sign", "valid_in")))
    assert got.tolist() == labels + [False]


@pytest.mark.parametrize("openssl", [True, False], ids=["cryptography", "refmath"])
def test_keys_and_signatures_match_reference(monkeypatch, openssl):
    """ed25519 keys from a seed, rebuilt keys and signatures are the
    reference's, byte for byte, with the `cryptography` package and
    with the pure-python RFC 8032 path; each verifies in both packages;
    DEFAULT_SCHEME is ed25519 in both."""
    assert schemes.DEFAULT_SCHEME == J_S.DEFAULT_SCHEME == ED
    if not openssl:
        monkeypatch.setattr(schemes, "_HAVE_OPENSSL", False)
    for seed in (0, 1, 77, 2**64 - 1):
        kp = schemes.generate_keypair(seed=seed)
        jkp = J_S.generate_keypair(ED, seed=seed)
        assert kp.public.scheme_id == ED
        assert (kp.private.data, kp.public.data) == (jkp.private.data, jkp.public.data)
        assert schemes.keypair_from_private(ED, kp.private.data) == kp
        msg = seed.to_bytes(8, "big") * 3
        sig = kp.private.sign(msg)
        assert sig == jkp.private.sign(msg)
        assert schemes.verify_one(kp.public, sig, msg) and J_S.verify_one(jkp.public, sig, msg)
        assert not schemes.verify_one(kp.public, sig, msg + b"!")
    assert schemes._ed25519_sign_py(kp.private.data, kp.public.data, b"x") == kp.private.sign(b"x")
    assert schemes._ed25519_public_raw(kp.private.data) == kp.public.data
