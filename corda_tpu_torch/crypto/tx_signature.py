"""Transaction signatures: metadata-bound signatures over tx ids.

Port of corda_tpu/crypto/tx_signature.py. Reference semantics:
crypto/TransactionSignature.kt:14, SignableData.kt:13,
SignatureMetadata.kt:15 — the signed payload is NOT the raw tx id but
the canonical encoding of SignableData(txId, metadata), binding the
platform version and scheme id into every signature.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from ..core import serialization as ser
from .hashes import SecureHash
from .merkle import PartialMerkleTree, SingleLeafProof, single_leaf_proofs
from .schemes import PrivateKey, PublicKey, verify_one

PLATFORM_VERSION = 1


@ser.serializable
@dataclass(frozen=True)
class SignatureMetadata:
    platform_version: int
    scheme_id: int


@ser.serializable
@dataclass(frozen=True)
class SignableData:
    """The canonical signed payload: (tx id, signature metadata)."""

    tx_id: SecureHash
    metadata: SignatureMetadata

    def to_bytes(self) -> bytes:
        return signable_bytes(self.tx_id, self.metadata)


# Template-spliced payload encoding: the canonical encoding of
# SignableData(tx_id, meta) is the same for every tx but the 32 hash
# bytes, and the notary flush builds one per signature. Encode a probe
# once per metadata value, locate the probe hash, splice thereafter.
_PROBE = SecureHash(
    bytes.fromhex(
        "f1d2c3b4a5968778695a4b3c2d1e0ff0e1d2c3b4a5968778695a4b3c2d1e0f01"
    )
)
_TEMPLATES: dict = {}


def signable_bytes(tx_id: SecureHash, meta: SignatureMetadata) -> bytes:
    tpl = _TEMPLATES.get(meta)
    if tpl is None:
        enc = ser.encode(SignableData(_PROBE, meta))
        i = enc.index(_PROBE.bytes_)   # once: metadata holds two small ints
        tpl = _TEMPLATES[meta] = (enc[:i], enc[i + 32:])
    return tpl[0] + tx_id.bytes_ + tpl[1]


@ser.serializable
@dataclass(frozen=True)
class TransactionSignature:
    """Signature bytes + signer key + metadata.

    `partial_merkle` marks a BATCH signature: the signature bytes cover
    the root of a Merkle tree over many transaction ids signed in one
    pass, and the proof ties THIS transaction's id to that root
    (core/crypto/TransactionSignature.kt `partialMerkleTree`); a plain
    per-tx signature is the None case."""

    signature: bytes
    by: PublicKey
    metadata: SignatureMetadata
    partial_merkle: Optional[Union[PartialMerkleTree, SingleLeafProof]] = None

    def signable_payload(self, tx_id: SecureHash) -> bytes:
        if self.partial_merkle is not None:
            # a malformed proof must fail verification, not crash
            # staging: an empty payload no honest signer ever signed
            try:
                root = self.partial_merkle._root_for([tx_id])
            except (ValueError, IndexError):
                return b""
            return signable_bytes(root, self.metadata)
        return signable_bytes(tx_id, self.metadata)

    def is_valid(self, tx_id: SecureHash) -> bool:
        """Host-path single verification (CPU reference semantics)."""
        return verify_one(self.by, self.signature, self.signable_payload(tx_id))

    def verify(self, tx_id: SecureHash) -> None:
        if not self.is_valid(tx_id):
            raise InvalidSignature(
                f"signature by {self.by} over {tx_id} is invalid"
            )


class InvalidSignature(Exception):
    pass


def sign_tx_id(private: PrivateKey, tx_id: SecureHash) -> TransactionSignature:
    meta = SignatureMetadata(PLATFORM_VERSION, private.scheme_id)
    return TransactionSignature(
        private.sign(signable_bytes(tx_id, meta)), private.public, meta
    )


def sign_tx_ids(
    private: PrivateKey, tx_ids: list[SecureHash]
) -> list[TransactionSignature]:
    """ONE signature over the Merkle root of `tx_ids`, fanned out as a
    per-transaction TransactionSignature carrying its inclusion proof:
    the batching notary's signing path (one host signature per flush)."""
    if not tx_ids:
        return []
    meta = SignatureMetadata(PLATFORM_VERSION, private.scheme_id)
    root, proofs = single_leaf_proofs(tx_ids)
    sig = private.sign(signable_bytes(root, meta))
    pub = private.public
    return [TransactionSignature(sig, pub, meta, pmt) for pmt in proofs]
