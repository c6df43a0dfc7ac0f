"""Identities: parties and anonymous parties.

Port of corda_tpu/core/identity.py. Reference: core/.../identity/ (Party, AbstractParty,
PartyAndCertificate — SURVEY.md §2.1). Certificate-path identity (X.509
hierarchies) is a host-side concern layered on later; the ledger data
model only needs the owning key and an optional well-known name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from ..core import serialization as ser
from ..crypto import composite as comp
from ..crypto import schemes

AnyPublicKey = Union[schemes.PublicKey, "comp.CompositeKey"]


@ser.serializable
@dataclass(frozen=True)
class AnonymousParty:
    """A party known only by key (confidential identity)."""

    owning_key: schemes.PublicKey

    def __str__(self) -> str:
        return f"Anonymous({self.owning_key.fingerprint().hex()[:12]})"


@ser.serializable
@dataclass(frozen=True)
class Party:
    """A well-known party: display name + owning key.

    The reference carries an X.500 name from the node certificate
    (identity/Party.kt); names here are plain strings validated by the
    network map service at registration time.
    """

    name: str
    owning_key: schemes.PublicKey

    def anonymise(self) -> AnonymousParty:
        return AnonymousParty(self.owning_key)

    def ref(self, ref_bytes: bytes) -> "PartyAndReference":
        return PartyAndReference(self, ref_bytes)

    def __str__(self) -> str:
        return self.name


@ser.serializable
@dataclass(frozen=True)
class PartyAndReference:
    """A party plus an opaque reference (e.g. issuer account ref)."""

    party: Party
    reference: bytes

    def __str__(self) -> str:
        return f"{self.party}{self.reference.hex()}"


ser.register_custom(
    schemes.PublicKey,
    "PubKey",
    lambda k: [k.scheme_id, k.data],
    lambda v: schemes.PublicKey(v[0], bytes(v[1])),
)
