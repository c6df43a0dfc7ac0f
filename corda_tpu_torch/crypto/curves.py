"""Curve parameters for the three EC signature schemes of the reference.

Copy of corda_tpu/crypto/curves.py (the port imports nothing of the
JAX package). Slice 1 runs the two Weierstrass curves; the ed25519
constants come along as data for the next slice.

Scheme set mirrors core/.../crypto/Crypto.kt:101-184 of the reference:
ECDSA over secp256k1 and secp256r1 (NIST P-256), and EdDSA over ed25519.
(RSA and SPHINCS-256 from the reference registry are host-side only — see
schemes.py — they have no EC batch kernel.)

All per-curve device constants are precomputed here on the host with
python ints and exposed as Montgomery-domain limb tuples.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from .limbs import R_BITS, int_to_limbs
from .modmath import MontCtx


def _mont_limbs(x: int, p: int) -> tuple[int, ...]:
    """Host: Montgomery form of x mod p as a canonical limb tuple."""
    return tuple(int(v) for v in int_to_limbs((x << R_BITS) % p))


@dataclass(frozen=True)
class WeierstrassCurve:
    """Short Weierstrass curve y^2 = x^3 + ax + b over F_p, prime order n."""

    name: str
    p: int
    a: int
    b: int
    n: int           # group order (prime)
    gx: int
    gy: int

    @property
    @lru_cache(maxsize=None)
    def fp(self) -> MontCtx:
        return MontCtx.make(self.p)

    @property
    @lru_cache(maxsize=None)
    def fn(self) -> MontCtx:
        return MontCtx.make(self.n)

    @property
    @lru_cache(maxsize=None)
    def a_mont(self) -> tuple[int, ...]:
        return _mont_limbs(self.a % self.p, self.p)

    @property
    @lru_cache(maxsize=None)
    def b3_mont(self) -> tuple[int, ...]:
        return _mont_limbs((3 * self.b) % self.p, self.p)


@dataclass(frozen=True)
class EdwardsCurve:
    """Twisted Edwards curve -x^2 + y^2 = 1 + d x^2 y^2 over F_p (ed25519)."""

    name: str
    p: int
    d: int
    L: int           # prime subgroup order
    gx: int
    gy: int

    @property
    @lru_cache(maxsize=None)
    def fp(self) -> MontCtx:
        return MontCtx.make(self.p)

    @property
    @lru_cache(maxsize=None)
    def fl(self) -> MontCtx:
        return MontCtx.make(self.L)

    @property
    @lru_cache(maxsize=None)
    def d2_mont(self) -> tuple[int, ...]:
        return _mont_limbs((2 * self.d) % self.p, self.p)


SECP256K1 = WeierstrassCurve(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SECP256R1 = WeierstrassCurve(
    name="secp256r1",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

ED25519_P = (1 << 255) - 19
ED25519 = EdwardsCurve(
    name="ed25519",
    p=ED25519_P,
    d=0x52036CEE2B6FFE738CC740797779E89800700A4D4141D8AB75EB4DCA135978A3,
    L=(1 << 252) + 27742317777372353535851937790883648493,
    gx=0x216936D3CD6E53FEC0A4E231FDD6DC5C692CC7609525A7B2C9562D608F25D51A,
    gy=0x6666666666666666666666666666666666666666666666666666666666666658,
)
