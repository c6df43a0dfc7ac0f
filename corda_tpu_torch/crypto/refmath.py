"""Pure-Python reference EC arithmetic — the bit-exactness anchor.

Copy of corda_tpu/crypto/refmath.py. Textbook affine modular
arithmetic with python ints, against which the port's limb code and
CUDA kernels are checked. It also backs host-side signing, the G-table
constants of the ladders and the CPU BatchSignatureVerifier.

Semantics follow the reference's JCA stack (core/.../crypto/Crypto.kt:
439-503): ECDSA per SEC1 with DER signatures, EdDSA per the cofactorless
ed25519 check used by the i2p EdDSAEngine the reference bundles.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .curves import ED25519, EdwardsCurve, WeierstrassCurve

Point = Optional[tuple[int, int]]  # None = point at infinity (Weierstrass)


# ---------------------------------------------------------------------------
# short Weierstrass


def wei_on_curve(c: WeierstrassCurve, P: Point) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0


def wei_add(c: WeierstrassCurve, P: Point, Q: Point) -> Point:
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    p = c.p
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def wei_mul(c: WeierstrassCurve, k: int, P: Point) -> Point:
    acc: Point = None
    add = P
    while k:
        if k & 1:
            acc = wei_add(c, acc, add)
        add = wei_add(c, add, add)
        k >>= 1
    return acc


def ecdsa_verify(c: WeierstrassCurve, pub: Point, z: int, r: int, s: int) -> bool:
    """SEC1 ECDSA verification with hash value z (already truncated)."""
    if pub is None or not wei_on_curve(c, pub):
        return False
    if not (1 <= r < c.n and 1 <= s < c.n):
        return False
    w = pow(s, -1, c.n)
    u1 = (z * w) % c.n
    u2 = (r * w) % c.n
    R = wei_add(c, wei_mul(c, u1, (c.gx, c.gy)), wei_mul(c, u2, pub))
    if R is None:
        return False
    return R[0] % c.n == r


# ---------------------------------------------------------------------------
# twisted Edwards / ed25519


def ed_add(c: EdwardsCurve, P: tuple[int, int], Q: tuple[int, int]) -> tuple[int, int]:
    x1, y1 = P
    x2, y2 = Q
    p = c.p
    dxxyy = c.d * x1 * x2 * y1 * y2 % p
    x3 = (x1 * y2 + x2 * y1) * pow(1 + dxxyy, -1, p) % p
    y3 = (y1 * y2 + x1 * x2) * pow(1 - dxxyy, -1, p) % p
    return (x3, y3)


def ed_mul(c: EdwardsCurve, k: int, P: tuple[int, int]) -> tuple[int, int]:
    acc = (0, 1)
    add = P
    while k:
        if k & 1:
            acc = ed_add(c, acc, add)
        add = ed_add(c, add, add)
        k >>= 1
    return acc


def ed_on_curve(c: EdwardsCurve, P: tuple[int, int]) -> bool:
    x, y = P
    return (-x * x + y * y - 1 - c.d * x * x * y * y) % c.p == 0


def ed_decompress(c: EdwardsCurve, enc: bytes) -> Optional[tuple[int, int]]:
    """RFC8032 point decoding; None if not a valid encoding."""
    if len(enc) != 32:
        return None
    y = int.from_bytes(enc, "little")
    sign = (y >> 255) & 1
    y &= (1 << 255) - 1
    p = c.p
    if y >= p:
        return None
    u = (y * y - 1) % p
    v = (c.d * y * y + 1) % p
    # x = sqrt(u/v); p = 5 mod 8 trick
    cand = (u * pow(v, 3, p)) % p * pow((u * pow(v, 7, p)) % p, (p - 5) // 8, p) % p
    if (v * cand * cand) % p == u:
        x = cand
    elif (v * cand * cand) % p == (-u) % p:
        x = (cand * pow(2, (p - 1) // 4, p)) % p
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = p - x
    return (x, y)


def ed_compress(c: EdwardsCurve, P: tuple[int, int]) -> bytes:
    x, y = P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def ed25519_verify(pub_enc: bytes, msg: bytes, sig: bytes) -> bool:
    """Cofactorless ed25519 verification, byte-comparing encodings.

    Matches the i2p EdDSAEngine the reference uses as its default scheme
    (Crypto.kt:171, EDDSA_ED25519_SHA512): R' = s*B - k*A, accept iff
    encode(R') == sig[0:32]. No s < L strictness check (s is reduced
    implicitly by the group order when multiplying).
    """
    c = ED25519
    if len(sig) != 64 or len(pub_enc) != 32:
        return False
    A = ed_decompress(c, pub_enc)
    if A is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= 1 << 256:  # cannot happen from 32 bytes; defensive
        return False
    k = int.from_bytes(
        hashlib.sha512(sig[:32] + pub_enc + msg).digest(), "little"
    ) % c.L
    neg_A = ((c.p - A[0]) % c.p, A[1])
    Rp = ed_add(c, ed_mul(c, s, (c.gx, c.gy)), ed_mul(c, k, neg_A))
    return ed_compress(c, Rp) == sig[:32]
