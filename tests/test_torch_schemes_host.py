"""RSA_SHA256 and SPHINCS256_SHA256 in the port against the reference.

Neither package has a device kernel for these schemes: both verify them
on the host (OpenSSL for RSA, sphincs.py for SPHINCS). Keys come from a
seed — RSA from one `cryptography` key that both packages load, since
deterministic RSA keygen is unsupported in both — and the port's keys,
signatures and per-row verdicts must equal the reference's exactly, over
valid, flipped, truncated, extended, wrong-message and wrong-key rows.
"""

from __future__ import annotations

import random
from functools import lru_cache

import pytest

pytest.importorskip("torch")
pytest.importorskip("cryptography")

import corda_tpu.crypto.schemes as rs  # noqa: E402
import corda_tpu.crypto.sphincs as rsphincs  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.crypto.schemes as ps  # noqa: E402
import corda_tpu_torch.crypto.sphincs as psphincs  # noqa: E402

MESSAGES = (b"", b"corda", bytes(range(200)))


@lru_cache(maxsize=None)
def rsa_der() -> bytes:
    """One RSA-2048 private key (PKCS#8 DER) that both packages load."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa

    sk = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    return sk.private_bytes(serialization.Encoding.DER, serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption())


@lru_cache(maxsize=None)
def keys(scheme: int):
    """(port KeyPair, reference KeyPair) of one scheme, from one seed."""
    if scheme == ps.RSA_SHA256:
        return ps.keypair_from_private(scheme, rsa_der()), rs.keypair_from_private(scheme, rsa_der())
    return ps.generate_keypair(scheme, seed=2024), rs.generate_keypair(scheme, seed=2024)


def _rows(scheme: int) -> list:
    """(public key bytes, signature, message) rows: per message a valid
    signature, then flipped, truncated, extended, wrong-message and
    wrong-key copies of it."""
    pk, _ = keys(scheme)
    other = (ps.keypair_from_private(scheme, rsa_der()).public.data[:-1] + b"\x00"
             if scheme == ps.RSA_SHA256 else ps.generate_keypair(scheme, seed=7).public.data)
    rng = random.Random(scheme)
    rows = []
    for msg in MESSAGES[:2] if scheme == ps.SPHINCS256_SHA256 else MESSAGES:
        sig = pk.private.sign(msg)
        pos = rng.randrange(len(sig))
        rows += [
            (pk.public.data, sig, msg),
            (pk.public.data, sig[:pos] + bytes([sig[pos] ^ 0x10]) + sig[pos + 1:], msg),
            (pk.public.data, sig[:-1] + bytes([sig[-1] ^ 1]), msg),
            (pk.public.data, sig[: len(sig) // 2], msg),
            (pk.public.data, sig + b"\x00", msg),
            (pk.public.data, sig, msg + b"!"),
            (other, sig, msg),
            (pk.public.data[:16], sig, msg),
        ]
    return rows


@pytest.mark.parametrize("scheme", [ps.RSA_SHA256, ps.SPHINCS256_SHA256], ids=["rsa", "sphincs"])
def test_keys_and_signatures_equal_the_reference(scheme):
    """Equal public keys from the same private material, and equal
    signature bytes (PKCS#1 v1.5 and this SPHINCS are deterministic)."""
    pk, rk = keys(scheme)
    assert pk.public.data == rk.public.data and pk.private.data == rk.private.data
    assert ps.keypair_from_private(scheme, pk.private.data).public == pk.public
    msg = b"one message"
    assert pk.private.sign(msg) == rk.private.sign(msg)


@pytest.mark.parametrize("scheme", [ps.RSA_SHA256, ps.SPHINCS256_SHA256], ids=["rsa", "sphincs"])
def test_verdicts_equal_the_reference_row_by_row(scheme):
    """verify_one of both packages, the port's CpuBatchVerifier and its
    card verifier's host rows (device="cpu") agree on every row; exactly
    the untouched rows verify."""
    rows = _rows(scheme)
    want = [rs.verify_one(rs.PublicKey(scheme, k), s, m) for k, s, m in rows]
    assert want == [i % 8 == 0 for i in range(len(rows))]
    assert [ps.verify_one(ps.PublicKey(scheme, k), s, m) for k, s, m in rows] == want
    reqs = [pbv.VerificationRequest(ps.PublicKey(scheme, k), s, m) for k, s, m in rows]
    assert pbv.CpuBatchVerifier().verify_batch(reqs) == want
    pv = pbv.CudaBatchVerifier(batch_sizes=(8,), device="cpu").verify_batch_async(reqs)
    assert pv.host_rows == list(range(len(rows))) and pv.skeleton() == want
    assert pv.result() == want


def test_sphincs_module_is_the_reference_construction():
    """The port's sphincs.py against the reference's on its own: keygen
    from a seed, a signature's bytes and size, and verify's decisions."""
    seed = bytes(range(32))
    assert psphincs.keygen(seed) == rsphincs.keygen(seed)
    sk, pk = psphincs.keygen(seed)
    sig = psphincs.sign(sk, b"m")
    assert sig == rsphincs.sign(sk, b"m") and len(sig) == 45_096
    assert psphincs.public_from_private(sk) == pk
    for s, m in ((sig, b"m"), (sig, b"n"), (sig[:-32], b"m"), (b"", b"m")):
        assert psphincs.verify(pk, s, m) == rsphincs.verify(pk, s, m)


def test_without_cryptography_rsa_raises(monkeypatch):
    """Without the `cryptography` package RSA raises UnsupportedScheme in
    keygen, signing and verification, as in the reference; SPHINCS needs
    only hashlib. COMPOSITE raises in verify_one either way."""
    pk, _ = keys(ps.RSA_SHA256)
    sig = pk.private.sign(b"m")
    monkeypatch.setattr(ps, "_HAVE_OPENSSL", False)
    with pytest.raises(ps.UnsupportedScheme):
        ps.generate_keypair(ps.RSA_SHA256)
    with pytest.raises(ps.UnsupportedScheme):
        ps.sign(pk.private, b"m")
    with pytest.raises(ps.UnsupportedScheme):
        ps.verify_one(pk.public, sig, b"m")
    sk = ps.generate_keypair(ps.SPHINCS256_SHA256, seed=3)
    assert ps.verify_one(sk.public, sk.private.sign(b"m"), b"m")
    with pytest.raises(ps.UnsupportedScheme):
        ps.verify_one(ps.PublicKey(ps.COMPOSITE_KEY, b"\x00" * 32), b"s", b"m")
