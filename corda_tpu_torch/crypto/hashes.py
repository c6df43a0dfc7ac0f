"""SecureHash value type.

Port of corda_tpu/crypto/hashes.py (reference: core/.../crypto/
SecureHash.kt:14, a SHA-256 value type). Hashing runs on the host with
hashlib; the native batched SHA-256 of the reference waits for the
staging codec (Queue 1 #7).
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from ..core import serialization as ser


@dataclass(frozen=True, order=True)
class SecureHash:
    """A SHA-256 output as an immutable, orderable value type."""

    bytes_: bytes

    def __post_init__(self):
        if len(self.bytes_) != 32:
            raise ValueError("SecureHash must be 32 bytes")

    @staticmethod
    def sha256(data: bytes) -> "SecureHash":
        return SecureHash(hashlib.sha256(data).digest())

    @staticmethod
    def sha256_twice(data: bytes) -> "SecureHash":
        return SecureHash.sha256(hashlib.sha256(data).digest())

    @staticmethod
    def parse(hex_str: str) -> "SecureHash":
        return SecureHash(bytes.fromhex(hex_str))

    @staticmethod
    def random() -> "SecureHash":
        return SecureHash(secrets.token_bytes(32))

    @staticmethod
    def zero() -> "SecureHash":
        return SecureHash(b"\x00" * 32)

    @staticmethod
    def all_ones() -> "SecureHash":
        return SecureHash(b"\xff" * 32)

    def hash_concat(self, other: "SecureHash") -> "SecureHash":
        return SecureHash.sha256(self.bytes_ + other.bytes_)

    def prefix_chars(self, n: int = 6) -> str:
        return self.bytes_.hex()[:n].upper()

    def __str__(self) -> str:
        return self.bytes_.hex().upper()

    def __repr__(self) -> str:
        return f"SecureHash({self.prefix_chars(12)}…)"


ser.register_custom(
    SecureHash, "Hash", lambda h: h.bytes_, lambda b: SecureHash(b)
)


def secure_hash_of(obj) -> SecureHash:
    """SHA-256 of the canonical encoding of any serializable value."""
    return SecureHash.sha256(ser.encode(obj))
