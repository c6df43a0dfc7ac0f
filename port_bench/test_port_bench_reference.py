"""The plain reference and the generator: published vectors, the
construction labels, and a second witness (the program's own CPU
reference, refmath)."""

from __future__ import annotations

import hashlib

import pytest

from port_bench import ec_ref as R
from port_bench import traffic

CONFIG = {"schemes": list(R.SCHEMES), "message_bytes": 48, "signers_per_scheme": 8,
          "adversarial": {"wrong_message": 0.125, "flipped_byte": 0.125, "truncated": 0.125}}


def test_rfc8032_test_1():
    seed = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
    public = R.ed25519_public(seed)
    assert public.hex() == "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    sig = R.ed25519_sign(seed, public, b"")
    assert sig.hex() == (
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b")
    assert R.Reference().verify(R.ED25519, public, sig, b"")
    assert not R.Reference().verify(R.ED25519, public, sig, b"x")


def test_rfc6979_p256_sha256_sample():
    x = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721
    digest = hashlib.sha256(b"sample").digest()
    assert R.rfc6979_nonce(R.SECP256R1.n, x, digest) == (
        0xA6E3C57DD01ABE90086538398355DD4C3B17AA873382B0F24D6129493D8AAD60)
    r, s = R.der_decode(R.ecdsa_sign(R.P256, x, b"sample"))
    assert r == 0xEFD48B2AACB6A8FD1140DD9CD45E81D69D2C877B56AAF991C34D0EA84EAF3716
    assert s == 0xF7CB1C942D657C41D436C7A1B6E29F65F3E900DBB9AFF4064DC4AB2F843ACDA8
    public = R.ecdsa_public(R.P256, x)
    assert public[1:33].hex().upper() == (
        "60FED4BA255A9D31C961EB74C6356D68C049B8923B61FA6CE669622E60F29FB6")
    assert R.Reference().verify(R.P256, public, R.der_encode(r, s), b"sample")


@pytest.mark.parametrize("scheme", R.SCHEMES)
def test_reference_answers_equal_the_construction_labels(scheme):
    rows = traffic.scheme_rows(2**33 + 5, CONFIG, scheme, 64)
    kinds = {r.kind for r in rows}
    assert kinds == set(traffic.KINDS)
    ref = R.Reference()
    assert [ref.verify(r.scheme, r.key, r.signature, r.message) for r in rows] == [
        r.kind == "valid" for r in rows]


@pytest.mark.parametrize("scheme", R.SCHEMES)
def test_the_program_s_cpu_reference_sides_with_it(scheme):
    """A second witness: corda_tpu_torch's refmath (schemes.verify_one)
    gives every row the same verdict, edge rows included."""
    from corda_tpu_torch.crypto import schemes

    ids = {name: sid for sid, name in schemes.CODE_NAMES.items()}
    rows = traffic.scheme_rows(77, CONFIG, scheme, 32)
    base = next(r for r in rows if r.kind == "valid")
    edges = [base.signature[:-1] + bytes([base.signature[-1] ^ 1]), b"", b"\x30\x00",
             base.signature + b"\x00"]
    if scheme != R.ED25519:
        r_, s_ = R.der_decode(base.signature)
        c = R.CURVES[scheme]
        edges += [R.der_encode(r_, s_ + c.n), R.der_encode(r_, c.n - s_), R.der_encode(0, s_),
                  b"\x30\x81" + base.signature[1:]]
    else:
        s_ = int.from_bytes(base.signature[32:], "little")
        edges += [base.signature[:32] + (s_ + R.ED_L).to_bytes(32, "little")]
    rows += [traffic.Row(scheme, base.key, e, base.message, "edge") for e in edges]
    ref = R.Reference()
    for r in rows:
        want = schemes.verify_one(schemes.PublicKey(ids[scheme], r.key), r.signature, r.message)
        assert ref.verify(r.scheme, r.key, r.signature, r.message) == want, (r.kind, r.signature)


def test_the_same_seed_gives_the_same_traffic_and_sizes_hold_across_seeds():
    tf = {"rows_per_call": 96, "in_flight": 2, "callers": 1, "distinct_rows": 48,
          "call_layouts": 3, "mix": {R.ED25519: 1, R.K1: 1, R.P256: 1}}
    a, b = traffic.build(11, CONFIG, tf), traffic.build(11, CONFIG, tf)
    assert a.rows == b.rows and a.layouts == b.layouts
    c = traffic.build(2**40 + 11, CONFIG, tf)
    assert c.rows != a.rows
    for t in (a, c):
        assert [len(lay) for lay in t.layouts] == [96] * 3
        for lay in t.layouts:
            schemes_in = [t.rows[i].scheme for i in lay]
            assert sorted(schemes_in.count(s) for s in R.SCHEMES) == [32, 32, 32]
        assert sorted(r.kind for r in t.rows) == sorted(r.kind for r in a.rows)


def test_a_mix_outside_the_configuration_is_refused():
    tf = {"rows_per_call": 8, "in_flight": 1, "callers": 1, "distinct_rows": 8,
          "call_layouts": 1, "mix": {"RSA_SHA256": 1}}
    with pytest.raises(ValueError, match="does not verify"):
        traffic.build(1, CONFIG, tf)
