"""Signature scheme ids, keys, and host-side signing and verification.

Port of corda_tpu/crypto/schemes.py. The scheme ids are the
reference's (Crypto.kt:78-184):

  id  code name                 in the port
  1   RSA_SHA256                host only (OpenSSL), as in the reference
  2   ECDSA_SECP256K1_SHA256    signing, CPU reference, CUDA batch kernel
  3   ECDSA_SECP256R1_SHA256    signing, CPU reference, CUDA batch kernel
  4   EDDSA_ED25519_SHA512      the default scheme (Crypto.kt:171);
                                signing, CPU reference, CUDA batch kernel
  5   SPHINCS256_SHA256         host only (sphincs.py), as in the reference
  6   COMPOSITE                 composite.py; verify_one raises

Neither package has a device kernel for RSA or SPHINCS: their rows are
verified on the host (CudaBatchVerifier hands them to the CPU reference
after dispatching its device chunks). The `cryptography` (OpenSSL)
package backs keygen and signing when present; without it, ECDSA signs
with an RFC 6979 deterministic nonce over refmath and ed25519 per
RFC 8032 over refmath (byte-identical to OpenSSL's: ed25519 signing is
deterministic), and RSA raises UnsupportedScheme. Verification of the
EC schemes never needs it: refmath is the bit-exactness anchor. Keys
derived from a seed are the reference's for the same seed;
deterministic RSA keygen is unsupported, as in the reference.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets as _secrets
from dataclasses import dataclass
from typing import Optional

try:
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec as cec
    from cryptography.hazmat.primitives.asymmetric import ed25519 as ced
    from cryptography.hazmat.primitives.asymmetric import padding as cpad
    from cryptography.hazmat.primitives.asymmetric import rsa as crsa
    from cryptography.hazmat.primitives.asymmetric.utils import (
        decode_dss_signature,
    )

    _HAVE_OPENSSL = True
except ImportError:   # gated dep: pure-python signing below, RSA raises
    hashes = serialization = cec = ced = cpad = crsa = None
    decode_dss_signature = None
    _HAVE_OPENSSL = False

from . import encodings, refmath, sphincs
from .curves import ED25519, SECP256K1, SECP256R1

RSA_SHA256 = 1
ECDSA_SECP256K1_SHA256 = 2
ECDSA_SECP256R1_SHA256 = 3
EDDSA_ED25519_SHA512 = 4
SPHINCS256_SHA256 = 5
COMPOSITE_KEY = 6

DEFAULT_SCHEME = EDDSA_ED25519_SHA512

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
        raise UnsupportedScheme(f"scheme {name} is not an ECDSA scheme")
    return curve


def _require_openssl() -> None:
    if not _HAVE_OPENSSL:
        raise UnsupportedScheme("RSA_SHA256 requires the 'cryptography' package")


def _ed25519_expand(sk: bytes) -> tuple[int, bytes]:
    """RFC 8032 §5.1.5: the clamped secret scalar and the nonce prefix."""
    h = hashlib.sha512(sk).digest()
    a = bytearray(h[:32])
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little"), h[32:]


def _ed25519_public_raw(sk: bytes) -> bytes:
    a, _ = _ed25519_expand(sk)
    c = ED25519
    return refmath.ed_compress(c, refmath.ed_mul(c, a, (c.gx, c.gy)))


def _ed25519_sign_py(sk: bytes, pub: bytes, msg: bytes) -> bytes:
    """RFC 8032 §5.1.6 signing over refmath."""
    c = ED25519
    a, prefix = _ed25519_expand(sk)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % c.L
    big_r = refmath.ed_compress(c, refmath.ed_mul(c, r, (c.gx, c.gy)))
    k = int.from_bytes(hashlib.sha512(big_r + pub + msg).digest(), "little") % c.L
    s = (r + k * a) % c.L
    return big_r + s.to_bytes(32, "little")


def _ed25519_public(sk: bytes) -> bytes:
    if _HAVE_OPENSSL:
        return ced.Ed25519PrivateKey.from_private_bytes(sk).public_key().public_bytes_raw()
    return _ed25519_public_raw(sk)


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
    """Scheme-tagged public key; `data` is the scheme-native encoding:
    the SEC1 point (ECDSA), the 32-byte RFC 8032 encoding (ed25519), a
    DER SubjectPublicKeyInfo (RSA) or the 32-byte SPHINCS root."""

    scheme_id: int
    data: bytes

    def __hash__(self) -> int:
        # keys live in hot sets and dicts (required signers, identity
        # and key management): memoised, as the reference does
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.scheme_id, self.data))
            object.__setattr__(self, "_hash", h)
        return h

    def fingerprint(self) -> bytes:
        """SHA-256 of scheme id || key bytes (memoised): the identity
        service's key index."""
        fp = self.__dict__.get("_fp")
        if fp is None:
            fp = hashlib.sha256(bytes([self.scheme_id]) + self.data).digest()
            object.__setattr__(self, "_fp", fp)
        return fp

    def __repr__(self) -> str:
        name = CODE_NAMES.get(self.scheme_id, str(self.scheme_id))
        return f"PublicKey({name}, {self.data.hex()[:16]}…)"


@dataclass(frozen=True)
class PrivateKey:
    scheme_id: int
    data: bytes            # ECDSA: 32-byte big-endian scalar; ed25519: 32-byte seed;
                           # RSA: PKCS#8 DER; SPHINCS: 64-byte secret
    public: PublicKey

    def sign(self, message: bytes) -> bytes:
        return sign(self, message)


@dataclass(frozen=True)
class KeyPair:
    private: PrivateKey
    public: PublicKey


def generate_keypair(scheme_id: int = DEFAULT_SCHEME, seed: Optional[int] = None) -> KeyPair:
    """Generate (or deterministically derive, given seed) a key pair."""
    if scheme_id == EDDSA_ED25519_SHA512:
        if seed is not None:
            sk = hashlib.sha256(b"ed25519-seed" + seed.to_bytes(32, "big")).digest()
        elif _HAVE_OPENSSL:
            sk = ced.Ed25519PrivateKey.generate().private_bytes_raw()
        else:
            sk = _secrets.token_bytes(32)
        return keypair_from_private(scheme_id, sk)
    if scheme_id == RSA_SHA256:
        if seed is not None:
            raise UnsupportedScheme("deterministic RSA keygen not supported")
        _require_openssl()
        sk = crsa.generate_private_key(public_exponent=65537, key_size=2048)
        return keypair_from_private(scheme_id, sk.private_bytes(
            serialization.Encoding.DER,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ))
    if scheme_id == SPHINCS256_SHA256:
        seed_bytes = (
            seed.to_bytes(32, "big", signed=False) if seed is not None
            else _secrets.token_bytes(32)
        )
        sk, _ = sphincs.keygen(seed_bytes)
        return keypair_from_private(scheme_id, sk)
    curve = _curve(scheme_id)
    if seed is not None:
        d = (seed % (curve.n - 1)) + 1
    elif _HAVE_OPENSSL:
        ccurve = cec.SECP256K1() if curve is SECP256K1 else cec.SECP256R1()
        d = cec.generate_private_key(ccurve).private_numbers().private_value
    else:
        d = _secrets.randbelow(curve.n - 1) + 1
    return keypair_from_private(scheme_id, d.to_bytes(32, "big"))


def keypair_from_private(scheme_id: int, data: bytes) -> KeyPair:
    """Rebuild a KeyPair from its scheme-native private encoding."""
    if scheme_id == EDDSA_ED25519_SHA512:
        pub = PublicKey(scheme_id, _ed25519_public(data))
    elif scheme_id == RSA_SHA256:
        _require_openssl()
        sk = serialization.load_der_private_key(data, password=None)
        pub = PublicKey(scheme_id, sk.public_key().public_bytes(
            serialization.Encoding.DER, serialization.PublicFormat.SubjectPublicKeyInfo
        ))
    elif scheme_id == SPHINCS256_SHA256:
        pub = PublicKey(scheme_id, sphincs.public_from_private(data))
    else:
        curve = _curve(scheme_id)
        pt = refmath.wei_mul(curve, int.from_bytes(data, "big"), (curve.gx, curve.gy))
        pub = PublicKey(scheme_id, encodings.encode_sec1_point(*pt))
    return KeyPair(PrivateKey(scheme_id, data, pub), pub)


def sign(priv: PrivateKey, message: bytes) -> bytes:
    """Host-side signing; signature formats as the verify path parses
    them (DER for ECDSA, R || s for ed25519, PKCS#1 v1.5 for RSA)."""
    if priv.scheme_id == RSA_SHA256:
        _require_openssl()
        sk = serialization.load_der_private_key(priv.data, password=None)
        return sk.sign(message, cpad.PKCS1v15(), hashes.SHA256())
    if priv.scheme_id == SPHINCS256_SHA256:
        return sphincs.sign(priv.data, message)
    if priv.scheme_id == EDDSA_ED25519_SHA512:
        if not _HAVE_OPENSSL:
            return _ed25519_sign_py(priv.data, priv.public.data, message)
        return ced.Ed25519PrivateKey.from_private_bytes(priv.data).sign(message)
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
    python refmath for the EC schemes (the semantics the batch kernels
    implement), OpenSSL for RSA, sphincs.py for SPHINCS. COMPOSITE (and
    any unknown id) raises UnsupportedScheme, as in the reference."""
    if pub.scheme_id == EDDSA_ED25519_SHA512:
        return refmath.ed25519_verify(pub.data, message, signature)
    if pub.scheme_id == RSA_SHA256:
        _require_openssl()
        try:
            pk = serialization.load_der_public_key(pub.data)
            pk.verify(signature, message, cpad.PKCS1v15(), hashes.SHA256())
            return True
        except Exception:   # noqa: BLE001 - a bad key or signature is a reject
            return False
    if pub.scheme_id == SPHINCS256_SHA256:
        return sphincs.verify(pub.data, signature, message)
    curve = _curve(pub.scheme_id)
    rs = encodings.parse_der_ecdsa(signature)
    pt = encodings.parse_sec1_point(curve, pub.data)
    if rs is None or pt is None:
        return False
    z = int.from_bytes(hashlib.sha256(message).digest(), "big")
    return refmath.ecdsa_verify(curve, pt, z, rs[0], rs[1])
