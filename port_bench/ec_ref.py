"""Plain reference of the three signature schemes, in Python integers.

This is the yardstick that decides `correct`: it works out every
row's accept/reject again from the bytes the benchmark made, and it
signs those bytes in the first place. It imports nothing of the program
under test, nor numpy or torch: hashlib and Python integers only.

Semantics, as Corda's `Crypto.doVerify` states them for the schemes:

- ECDSA_SECP256R1_SHA256 and ECDSA_SECP256K1_SHA256 (SEC 1 v2 §4.1.4):
  the signature is a strict DER SEQUENCE of two INTEGERs (definite,
  minimal lengths; no negative or padded integer; no trailing byte);
  the key is a SEC1 point (0x04 uncompressed or 0x02/0x03 compressed),
  on the curve, coordinates below p; 1 <= r, s < n; z = SHA-256(message)
  as a 256-bit integer; accept iff x(z/s * G + r/s * Q) mod n == r.
- EDDSA_ED25519_SHA512 (RFC 8032 §5.1.7, cofactorless): a 64-byte
  signature R || S and a 32-byte key A decoded per §5.1.3 (y < p; x = 0
  with the sign bit set rejected); k = SHA-512(R || A || M) mod L;
  accept iff encode(S * B - k * A) == R, byte for byte. S is not checked
  against L (the i2p engine Corda uses does not).

Signing follows RFC 6979 (deterministic ECDSA nonces, HMAC-SHA-256)
and RFC 8032 §5.1.6, so the same seed gives the same signatures.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

P256 = "ECDSA_SECP256R1_SHA256"
K1 = "ECDSA_SECP256K1_SHA256"
ED25519 = "EDDSA_ED25519_SHA512"
SCHEMES = (P256, K1, ED25519)


@dataclass(frozen=True)
class Weierstrass:
    name: str
    p: int
    a: int
    b: int
    n: int
    gx: int
    gy: int


SECP256R1 = Weierstrass(
    "secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)
SECP256K1 = Weierstrass(
    "secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
CURVES = {P256: SECP256R1, K1: SECP256K1}

ED_P = 2**255 - 19
ED_L = 2**252 + 27742317777372353535851937790883648493
ED_D = -121665 * pow(121666, -1, ED_P) % ED_P
ED_D2 = 2 * ED_D % ED_P
ED_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
ED_BY = 46316835694926478169428394003475163141307993866256225615783033603165251855960
_SQRT_M1 = pow(2, (ED_P - 1) // 4, ED_P)

WINDOWS = 64            # fixed-base tables: 64 windows of 4 bits cover 256-bit scalars


# ---------------------------------------------------------------------------
# short Weierstrass curves, Jacobian coordinates (X/Z^2, Y/Z^3); None is the
# point at infinity


def _jdbl(c: Weierstrass, P):
    if P is None:
        return None
    X, Y, Z = P
    p = c.p
    if Y == 0:
        return None
    YY = Y * Y % p
    S = 4 * X * YY % p
    ZZ = Z * Z % p
    if c.a == 0:
        M = 3 * X * X % p
    else:
        M = (3 * X * X + c.a * ZZ * ZZ) % p
    X3 = (M * M - 2 * S) % p
    Y3 = (M * (S - X3) - 8 * YY * YY) % p
    return X3, Y3, 2 * Y * Z % p


def _jadd(c: Weierstrass, P, Q):
    """P + Q, both Jacobian."""
    if P is None:
        return Q
    if Q is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    p = c.p
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 * Z2Z2 % p
    S2 = Y2 * Z1 * Z1Z1 % p
    H = (U2 - U1) % p
    R = (S2 - S1) % p
    if H == 0:
        return _jdbl(c, P) if R == 0 else None
    HH = H * H % p
    HHH = H * HH % p
    V = U1 * HH % p
    X3 = (R * R - HHH - 2 * V) % p
    Y3 = (R * (V - X3) - S1 * HHH) % p
    return X3, Y3, Z1 * Z2 * H % p


def _jadd_affine(c: Weierstrass, P, q):
    """P (Jacobian) + q (affine (x, y))."""
    if P is None:
        return (q[0], q[1], 1)
    X1, Y1, Z1 = P
    p = c.p
    Z1Z1 = Z1 * Z1 % p
    U2 = q[0] * Z1Z1 % p
    S2 = q[1] * Z1 * Z1Z1 % p
    H = (U2 - X1) % p
    R = (S2 - Y1) % p
    if H == 0:
        return _jdbl(c, P) if R == 0 else None
    HH = H * H % p
    HHH = H * HH % p
    V = X1 * HH % p
    X3 = (R * R - HHH - 2 * V) % p
    Y3 = (R * (V - X3) - Y1 * HHH) % p
    return X3, Y3, Z1 * H % p


def _affine(c: Weierstrass, P) -> Optional[tuple[int, int]]:
    if P is None:
        return None
    X, Y, Z = P
    zi = pow(Z, -1, c.p)
    zi2 = zi * zi % c.p
    return X * zi2 % c.p, Y * zi2 * zi % c.p


def on_curve(c: Weierstrass, x: int, y: int) -> bool:
    return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0


@lru_cache(maxsize=None)
def _wei_base_table(c: Weierstrass) -> tuple:
    """table[i][j] = j * 16^i * G in affine form, j = 0..15 (j = 0 None)."""
    rows = []
    base = (c.gx, c.gy, 1)
    for _ in range(WINDOWS):
        row, acc = [None], None
        for _ in range(15):
            acc = _jadd(c, acc, base)
            row.append(_affine(c, acc))
        rows.append(tuple(row))
        for _ in range(4):
            base = _jdbl(c, base)
    return tuple(rows)


def wei_base_mul(c: Weierstrass, k: int):
    """k * G (Jacobian) for 0 <= k < 2^256, by the fixed-base table."""
    table = _wei_base_table(c)
    acc = None
    i = 0
    while k:
        d = k & 15
        if d:
            acc = _jadd_affine(c, acc, table[i][d])
        k >>= 4
        i += 1
    return acc


def _wei_multiples(c: Weierstrass, q: tuple[int, int]) -> list:
    """[None, Q, 2Q, ..., 15Q] in affine form."""
    out, acc = [None], None
    for _ in range(15):
        acc = _jadd_affine(c, acc, q)
        out.append(_affine(c, acc))
    return out


def wei_var_mul(c: Weierstrass, k: int, multiples: list):
    """k * Q (Jacobian) by 4-bit windows over Q's multiples."""
    acc = None
    for shift in range(max(k.bit_length() - 1, 0) // 4 * 4, -1, -4):
        for _ in range(4):
            acc = _jdbl(c, acc)
        d = (k >> shift) & 15
        if d:
            acc = _jadd_affine(c, acc, multiples[d])
    return acc


# ---------------------------------------------------------------------------
# encodings: strict DER, SEC1


def _der_length(b: bytes, i: int) -> Optional[tuple[int, int]]:
    """(length, index after it) of the DER length at b[i]; None where it
    is missing, indefinite, longer than two bytes or not minimal."""
    if i >= len(b):
        return None
    first = b[i]
    if first < 0x80:
        return first, i + 1
    count = first & 0x7F
    if count not in (1, 2) or i + 1 + count > len(b):
        return None
    value = int.from_bytes(b[i + 1 : i + 1 + count], "big")
    if value < 0x80 or (count == 2 and value < 0x100):
        return None
    return value, i + 1 + count


def _der_integer(b: bytes, i: int) -> Optional[tuple[int, int]]:
    if i >= len(b) or b[i] != 0x02:
        return None
    got = _der_length(b, i + 1)
    if got is None:
        return None
    n, j = got
    if n == 0 or j + n > len(b):
        return None
    body = b[j : j + n]
    if body[0] & 0x80:
        return None                 # negative
    if n > 1 and body[0] == 0 and not body[1] & 0x80:
        return None                 # a redundant leading zero
    return int.from_bytes(body, "big"), j + n


def der_decode(sig: bytes) -> Optional[tuple[int, int]]:
    """(r, s) of a strict DER ECDSA signature, None where malformed."""
    if len(sig) < 2 or sig[0] != 0x30:
        return None
    got = _der_length(sig, 1)
    if got is None:
        return None
    total, i = got
    if i + total != len(sig):
        return None
    got = _der_integer(sig, i)
    if got is None:
        return None
    r, i = got
    got = _der_integer(sig, i)
    if got is None:
        return None
    s, i = got
    return (r, s) if i == len(sig) else None


def der_encode(r: int, s: int) -> bytes:
    def integer(v: int) -> bytes:
        body = v.to_bytes(v.bit_length() // 8 + 1, "big")     # a leading 0 where the top bit is set
        return b"\x02" + _length(len(body)) + body

    def _length(n: int) -> bytes:
        return bytes([n]) if n < 0x80 else bytes([0x81, n])

    body = integer(r) + integer(s)
    return b"\x30" + _length(len(body)) + body


def sec1_decode(c: Weierstrass, data: bytes) -> Optional[tuple[int, int]]:
    """The affine point of a SEC1 encoding, None where it is not one on
    the curve (the point at infinity included)."""
    p = c.p
    if len(data) == 65 and data[0] == 0x04:
        x, y = int.from_bytes(data[1:33], "big"), int.from_bytes(data[33:], "big")
        if x >= p or y >= p or not on_curve(c, x, y):
            return None
        return x, y
    if len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= p:
            return None
        rhs = (x * x * x + c.a * x + c.b) % p
        y = pow(rhs, (p + 1) // 4, p)           # both curves have p = 3 mod 4
        if y * y % p != rhs:
            return None
        if y & 1 != data[0] & 1:
            y = (p - y) % p
        return x, y
    return None


def sec1_encode(x: int, y: int) -> bytes:
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


# ---------------------------------------------------------------------------
# ed25519, extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z, T = XY/Z


_ED_ZERO = (0, 1, 1, 0)


def _ed_add(P, Q):
    """add-2008-hwcd-3 (a = -1): complete on ed25519."""
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    p = ED_P
    A = (Y1 - X1) * (Y2 - X2) % p
    B = (Y1 + X1) * (Y2 + X2) % p
    C = T1 * ED_D2 * T2 % p
    D = 2 * Z1 * Z2 % p
    E, F, G, H = B - A, D - C, D + C, B + A
    return E * F % p, G * H % p, F * G % p, E * H % p


def _ed_dbl(P):
    """dbl-2008-hwcd (a = -1)."""
    X1, Y1, Z1, _ = P
    p = ED_P
    A = X1 * X1 % p
    B = Y1 * Y1 % p
    C = 2 * Z1 * Z1 % p
    H = A + B
    E = H - (X1 + Y1) * (X1 + Y1)
    G = A - B
    F = C + G
    return E * F % p, G * H % p, F * G % p, E * H % p


def _ed_point(x: int, y: int):
    return x, y, 1, x * y % ED_P


@lru_cache(maxsize=None)
def _ed_base_table() -> tuple:
    rows = []
    base = _ed_point(ED_BX, ED_BY)
    for _ in range(WINDOWS):
        row, acc = [None], _ED_ZERO
        for _ in range(15):
            acc = _ed_add(acc, base)
            row.append(_ed_normal(acc))
        rows.append(tuple(row))
        for _ in range(4):
            base = _ed_dbl(base)
    return tuple(rows)


def _ed_normal(P):
    X, Y, Z, _ = P
    zi = pow(Z, -1, ED_P)
    return _ed_point(X * zi % ED_P, Y * zi % ED_P)


def ed_base_mul(k: int):
    table = _ed_base_table()
    acc = _ED_ZERO
    i = 0
    while k:
        d = k & 15
        if d:
            acc = _ed_add(acc, table[i][d])
        k >>= 4
        i += 1
    return acc


def ed_var_mul(k: int, multiples: list):
    acc = _ED_ZERO
    for shift in range(max(k.bit_length() - 1, 0) // 4 * 4, -1, -4):
        for _ in range(4):
            acc = _ed_dbl(acc)
        d = (k >> shift) & 15
        if d:
            acc = _ed_add(acc, multiples[d])
    return acc


def _ed_multiples(point) -> list:
    out, acc = [None], _ED_ZERO
    for _ in range(15):
        acc = _ed_add(acc, point)
        out.append(acc)
    return out


def ed_encode(P) -> bytes:
    X, Y, Z, _ = P
    zi = pow(Z, -1, ED_P)
    x, y = X * zi % ED_P, Y * zi % ED_P
    return (y | (x & 1) << 255).to_bytes(32, "little")


def ed_decode(enc: bytes) -> Optional[tuple[int, int]]:
    """RFC 8032 §5.1.3; None where `enc` is no point."""
    if len(enc) != 32:
        return None
    y = int.from_bytes(enc, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    p = ED_P
    if y >= p:
        return None
    u = (y * y - 1) % p
    v = (ED_D * y * y + 1) % p
    x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
    vxx = v * x * x % p
    if vxx == (-u) % p:
        x = x * _SQRT_M1 % p
    elif vxx != u:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = p - x
    return x, y


# ---------------------------------------------------------------------------
# the verifier


class Reference:
    """Answers rows (scheme, key bytes, signature, message) one by one.
    Keys repeat across rows, so each key's decoding and multiples are
    kept (`_keys`); nothing about a signature or message is kept."""

    def __init__(self):
        self._keys: dict = {}

    def _key(self, scheme: str, key: bytes):
        got = self._keys.get((scheme, key))
        if got is None:
            if scheme == ED25519:
                pt = ed_decode(key)
                got = (False,) if pt is None else (True, _ed_multiples(_ed_point(-pt[0] % ED_P, pt[1])))
            else:
                c = CURVES[scheme]
                pt = sec1_decode(c, key)
                got = (False,) if pt is None else (True, _wei_multiples(c, pt))
            self._keys[(scheme, key)] = got
        return got

    def verify(self, scheme: str, key: bytes, sig: bytes, msg: bytes) -> bool:
        if scheme == ED25519:
            return self._verify_ed25519(key, sig, msg)
        if scheme in CURVES:
            return self._verify_ecdsa(CURVES[scheme], scheme, key, sig, msg)
        raise ValueError(f"no reference for scheme {scheme}")

    def _verify_ecdsa(self, c: Weierstrass, scheme: str, key: bytes, sig: bytes,
                      msg: bytes) -> bool:
        rs = der_decode(sig)
        if rs is None:
            return False
        k = self._key(scheme, key)
        if not k[0]:
            return False
        r, s = rs
        if not (1 <= r < c.n and 1 <= s < c.n):
            return False
        z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
        w = pow(s, -1, c.n)
        point = _jadd(c, wei_base_mul(c, z * w % c.n), wei_var_mul(c, r * w % c.n, k[1]))
        if point is None:
            return False
        return _affine(c, point)[0] % c.n == r

    def _verify_ed25519(self, key: bytes, sig: bytes, msg: bytes) -> bool:
        if len(sig) != 64 or len(key) != 32:
            return False
        k = self._key(ED25519, key)
        if not k[0]:
            return False
        s = int.from_bytes(sig[32:], "little")
        h = int.from_bytes(hashlib.sha512(sig[:32] + key + msg).digest(), "little") % ED_L
        point = _ed_add(ed_base_mul(s), ed_var_mul(h, k[1]))     # s*B + h*(-A)
        return ed_encode(point) == sig[:32]


def ecdsa_scalars(scheme: str, key: bytes, sig: bytes, msg: bytes) -> Optional[tuple[int, int]]:
    """(u1, u2) of a row whose signature and key decode and whose r and
    s lie in [1, n); None for a row the verification rejects before its
    double-scalar multiplication."""
    c = CURVES[scheme]
    rs = der_decode(sig)
    if rs is None or sec1_decode(c, key) is None:
        return None
    r, s = rs
    if not (1 <= r < c.n and 1 <= s < c.n):
        return None
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big")
    w = pow(s, -1, c.n)
    return z * w % c.n, r * w % c.n


def ed25519_scalars(key: bytes, sig: bytes, msg: bytes) -> Optional[tuple[int, int, bool]]:
    """(S, k, key decodes) of a row of the right lengths, None otherwise."""
    if len(sig) != 64 or len(key) != 32:
        return None
    s = int.from_bytes(sig[32:], "little")
    h = int.from_bytes(hashlib.sha512(sig[:32] + key + msg).digest(), "little") % ED_L
    return s, h, ed_decode(key) is not None


# ---------------------------------------------------------------------------
# keys and signing


def ecdsa_public(scheme: str, d: int) -> bytes:
    c = CURVES[scheme]
    return sec1_encode(*_affine(c, wei_base_mul(c, d)))


def rfc6979_nonce(n: int, d: int, digest: bytes) -> int:
    """RFC 6979 §3.2 with HMAC-SHA-256 for a 256-bit group order n."""
    x = d.to_bytes(32, "big")
    h1 = (int.from_bytes(digest, "big") % n).to_bytes(32, "big")

    def mac(key: bytes, data: bytes) -> bytes:
        return hmac.new(key, data, hashlib.sha256).digest()

    v, k = b"\x01" * 32, b"\x00" * 32
    k = mac(k, v + b"\x00" + x + h1)
    v = mac(k, v)
    k = mac(k, v + b"\x01" + x + h1)
    v = mac(k, v)
    while True:
        v = mac(k, v)
        t = int.from_bytes(v, "big")
        if 1 <= t < n:
            return t
        k = mac(k, v + b"\x00")
        v = mac(k, v)


def ecdsa_sign(scheme: str, d: int, msg: bytes) -> bytes:
    c = CURVES[scheme]
    digest = hashlib.sha256(msg).digest()
    z = int.from_bytes(digest, "big")
    k = rfc6979_nonce(c.n, d, digest)
    r = _affine(c, wei_base_mul(c, k))[0] % c.n
    s = pow(k, -1, c.n) * (z + r * d) % c.n
    if r == 0 or s == 0:
        raise ValueError("degenerate nonce")      # probability about 2^-256
    return der_encode(r, s)


def _ed_expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def ed25519_public(seed: bytes) -> bytes:
    return ed_encode(ed_base_mul(_ed_expand(seed)[0]))


def ed25519_sign(seed: bytes, public: bytes, msg: bytes) -> bytes:
    a, prefix = _ed_expand(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % ED_L
    big_r = ed_encode(ed_base_mul(r))
    k = int.from_bytes(hashlib.sha512(big_r + public + msg).digest(), "little") % ED_L
    return big_r + ((r + k * a) % ED_L).to_bytes(32, "little")
