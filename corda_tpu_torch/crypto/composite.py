"""CompositeKey: threshold multi-signature key trees.

Port of corda_tpu/crypto/composite.py (the key tree as data and its
fulfilment test). A composite key's own signature rows have no kernel
in the port: CudaBatchVerifier raises UnsupportedScheme for them.

Reference semantics: core/.../crypto/composite/CompositeKey.kt:35 — a
tree whose leaves are public keys and whose nodes carry per-child
weights and a threshold; a set of signing keys fulfils the node if the
summed weight of fulfilled children reaches the threshold. Validation
rejects duplicate leaves, non-positive weights/thresholds and
unreachable thresholds.

`leaf_keys` gathers the candidate leaf signatures the batch verifier
checks; `is_fulfilled_by` then runs on the boolean results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Union

from ..core import serialization as ser
from . import schemes

AnyKey = Union[schemes.PublicKey, "CompositeKey"]


@ser.serializable
@dataclass(frozen=True)
class CompositeNode:
    key: AnyKey
    weight: int


@ser.serializable
@dataclass(frozen=True)
class CompositeKey:
    threshold: int
    children: tuple[CompositeNode, ...]

    @staticmethod
    def build(
        keys: Iterable[AnyKey],
        weights: Iterable[int] | None = None,
        threshold: int | None = None,
    ) -> "CompositeKey":
        keys = list(keys)
        ws = list(weights) if weights is not None else [1] * len(keys)
        th = threshold if threshold is not None else sum(ws)
        ck = CompositeKey(
            th, tuple(CompositeNode(k, w) for k, w in zip(keys, ws))
        )
        ck.validate()
        return ck

    def validate(self) -> None:
        if self.threshold <= 0:
            raise ValueError("threshold must be positive")
        if not self.children:
            raise ValueError("composite key must have children")
        total = 0
        for c in self.children:
            if c.weight <= 0:
                raise ValueError("child weight must be positive")
            total += c.weight
            if isinstance(c.key, CompositeKey):
                c.key.validate()
        if total < self.threshold:
            raise ValueError("threshold unreachable")
        leaves = list(self.leaf_keys())
        if len(leaves) != len(set(leaves)):
            raise ValueError("duplicate leaf keys in composite tree")

    def leaf_keys(self) -> Iterable[schemes.PublicKey]:
        for c in self.children:
            if isinstance(c.key, CompositeKey):
                yield from c.key.leaf_keys()
            else:
                yield c.key

    def is_fulfilled_by(self, keys: Iterable[schemes.PublicKey]) -> bool:
        keyset = set(keys)
        total = 0
        for c in self.children:
            if isinstance(c.key, CompositeKey):
                ok = c.key.is_fulfilled_by(keyset)
            else:
                ok = c.key in keyset
            if ok:
                total += c.weight
        return total >= self.threshold

    def fingerprint(self) -> bytes:
        from .hashes import secure_hash_of

        return secure_hash_of(self).bytes_


def leaves_of(key: AnyKey) -> list[schemes.PublicKey]:
    """All candidate leaf keys of a plain or composite key."""
    if isinstance(key, CompositeKey):
        return list(key.leaf_keys())
    return [key]


def is_fulfilled_by(key: AnyKey, signers: Iterable[schemes.PublicKey]) -> bool:
    if isinstance(key, CompositeKey):
        return key.is_fulfilled_by(signers)
    return key in set(signers)
