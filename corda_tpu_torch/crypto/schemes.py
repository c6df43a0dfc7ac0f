"""Signature scheme ids, keys, and host-side signing for the ECDSA path.

Port of corda_tpu/crypto/schemes.py for the two ECDSA schemes of
slice 1. The scheme ids are the reference's (Crypto.kt:78-184):

  id  code name                 in this slice
  1   RSA_SHA256                not ported
  2   ECDSA_SECP256K1_SHA256    signing, CPU reference, CUDA batch kernel
  3   ECDSA_SECP256R1_SHA256    signing, CPU reference, CUDA batch kernel
  4   EDDSA_ED25519_SHA512      next slice
  5   SPHINCS256_SHA256         not ported
  6   COMPOSITE                 not ported

Every entry point raises UnsupportedScheme for a scheme it does not
handle; nothing is routed elsewhere. The `cryptography` (OpenSSL)
package backs keygen and signing when present; without it, ECDSA signs
with an RFC 6979 deterministic nonce over refmath. Verification never
needs it: refmath is the bit-exactness anchor.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets as _secrets
from dataclasses import dataclass
from typing import Optional

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec as cec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    _HAVE_OPENSSL = True
except ImportError:   # gated dep: pure-python signing below
    hashes = cec = decode_dss_signature = None
    _HAVE_OPENSSL = False

from . import encodings, refmath
from .curves import SECP256K1, SECP256R1

RSA_SHA256 = 1
ECDSA_SECP256K1_SHA256 = 2
ECDSA_SECP256R1_SHA256 = 3
EDDSA_ED25519_SHA512 = 4
SPHINCS256_SHA256 = 5
COMPOSITE_KEY = 6

CODE_NAMES = {
    RSA_SHA256: "RSA_SHA256",
    ECDSA_SECP256K1_SHA256: "ECDSA_SECP256K1_SHA256",
    ECDSA_SECP256R1_SHA256: "ECDSA_SECP256R1_SHA256",
    EDDSA_ED25519_SHA512: "EDDSA_ED25519_SHA512",
    SPHINCS256_SHA256: "SPHINCS256_SHA256",
    COMPOSITE_KEY: "COMPOSITE",
}

WCURVE = {ECDSA_SECP256K1_SHA256: SECP256K1, ECDSA_SECP256R1_SHA256: SECP256R1}


class UnsupportedScheme(Exception):
    pass


def _curve(scheme_id: int):
    curve = WCURVE.get(scheme_id)
    if curve is None:
        name = CODE_NAMES.get(scheme_id, str(scheme_id))
        raise UnsupportedScheme(f"scheme {name} is not ported to corda_tpu_torch")
    return curve


def _rfc6979_nonce(curve, d: int, z: int) -> int:
    """Deterministic ECDSA nonce per RFC 6979 §3.2 (SHA-256, qlen=256)."""
    n = curve.n
    mac = lambda key, data: _hmac.new(key, data, hashlib.sha256).digest()  # noqa: E731
    x = d.to_bytes(32, "big")
    m = (z % n).to_bytes(32, "big")
    v = b"\x01" * 32
    key = b"\x00" * 32
    key = mac(key, v + b"\x00" + x + m)
    v = mac(key, v)
    key = mac(key, v + b"\x01" + x + m)
    v = mac(key, v)
    while True:
        v = mac(key, v)
        k = int.from_bytes(v, "big")
        if 1 <= k < n:
            return k
        key = mac(key, v + b"\x00")
        v = mac(key, v)


def _ecdsa_sign_py(curve, d: int, message: bytes) -> bytes:
    z = int.from_bytes(hashlib.sha256(message).digest(), "big")
    k = _rfc6979_nonce(curve, d, z)
    while True:
        pt = refmath.wei_mul(curve, k, (curve.gx, curve.gy))
        r = pt[0] % curve.n
        s = (pow(k, -1, curve.n) * (z + r * d)) % curve.n
        if r and s:   # zero r/s is cryptographically unreachable
            return encodings.encode_der_ecdsa(r, s)
        k = (k % (curve.n - 1)) + 1   # pragma: no cover - defensive


@dataclass(frozen=True)
class PublicKey:
    """Scheme-tagged public key; `data` is the SEC1 point encoding."""

    scheme_id: int
    data: bytes

    def __repr__(self) -> str:
        name = CODE_NAMES.get(self.scheme_id, str(self.scheme_id))
        return f"PublicKey({name}, {self.data.hex()[:16]}…)"


@dataclass(frozen=True)
class PrivateKey:
    scheme_id: int
    data: bytes            # 32-byte big-endian scalar
    public: PublicKey

    def sign(self, message: bytes) -> bytes:
        return sign(self, message)


@dataclass(frozen=True)
class KeyPair:
    private: PrivateKey
    public: PublicKey


def generate_keypair(scheme_id: int, seed: Optional[int] = None) -> KeyPair:
    """Generate (or deterministically derive, given seed) a key pair."""
    curve = _curve(scheme_id)
    if seed is not None:
        d = (seed % (curve.n - 1)) + 1
    elif _HAVE_OPENSSL:
        ccurve = cec.SECP256K1() if curve is SECP256K1 else cec.SECP256R1()
        d = cec.generate_private_key(ccurve).private_numbers().private_value
    else:
        d = _secrets.randbelow(curve.n - 1) + 1
    pt = refmath.wei_mul(curve, d, (curve.gx, curve.gy))
    pub = PublicKey(scheme_id, encodings.encode_sec1_point(*pt))
    return KeyPair(PrivateKey(scheme_id, d.to_bytes(32, "big"), pub), pub)


def sign(priv: PrivateKey, message: bytes) -> bytes:
    """Host-side signing; DER signatures as the verify path parses them."""
    curve = _curve(priv.scheme_id)
    d = int.from_bytes(priv.data, "big")
    if not _HAVE_OPENSSL:
        return _ecdsa_sign_py(curve, d, message)
    ccurve = cec.SECP256K1() if curve is SECP256K1 else cec.SECP256R1()
    der = cec.derive_private_key(d, ccurve).sign(message, cec.ECDSA(hashes.SHA256()))
    r, s = decode_dss_signature(der)
    return encodings.encode_der_ecdsa(r, s)


def verify_one(pub: PublicKey, signature: bytes, message: bytes) -> bool:
    """Host (CPU reference) verification of a single signature: pure
    python refmath, the semantics the batch kernels implement."""
    curve = _curve(pub.scheme_id)
    rs = encodings.parse_der_ecdsa(signature)
    pt = encodings.parse_sec1_point(curve, pub.data)
    if rs is None or pt is None:
        return False
    z = int.from_bytes(hashlib.sha256(message).digest(), "big")
    return refmath.ecdsa_verify(curve, pt, z, rs[0], rs[1])
