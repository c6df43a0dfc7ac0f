"""Merkle trees and partial (inclusion-proof) Merkle trees.

Port of corda_tpu/crypto/merkle.py, its Python paths (the reference's
native calls — merkle_root, merkle_paths, pmt_verify_many — compute the
same values in C and wait for Queue 1 #7). Reference semantics:
core/.../crypto/MerkleTree.kt:14-60 (SHA-256 binary tree, leaf list
zero-padded to the next power of two) and PartialMerkleTree.kt:45
(tear-off inclusion proofs).

The tree hash is consensus-critical: a transaction's id is the root
over its component hashes (core/transactions.py), and the batching
notary signs the root over a flush's transaction ids (tx_signature.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..core import serialization as ser
from .hashes import SecureHash


def _pad_leaves(leaves: list[SecureHash]) -> list[SecureHash]:
    if not leaves:
        raise ValueError("cannot build a Merkle tree with no leaves")
    n = 1
    while n < len(leaves):
        n *= 2
    return leaves + [SecureHash.zero()] * (n - len(leaves))


def merkle_levels(leaves: list[SecureHash]) -> list[list[SecureHash]]:
    """All levels bottom-up (levels[0] = padded leaves, levels[-1] = [root])."""
    level = _pad_leaves(leaves)
    levels = [level]
    while len(level) > 1:
        level = [
            level[i].hash_concat(level[i + 1]) for i in range(0, len(level), 2)
        ]
        levels.append(level)
    return levels


def merkle_root(leaves: list[SecureHash]) -> SecureHash:
    """Root of the zero-padded binary SHA-256 tree."""
    return merkle_levels(leaves)[-1][0]


def verify_proofs(
    items: list[tuple["PartialMerkleTree", SecureHash, list[SecureHash]]],
) -> list[bool]:
    """Bulk partial-proof verification: [(pmt, root, leaves)] -> [bool]."""
    return [pmt.verify(root, leaves) for pmt, root, leaves in items]


@ser.serializable
@dataclass(frozen=True)
class SingleLeafProof:
    """One leaf's inclusion proof in its compact form: the sibling path
    as ONE bytes blob (32 bytes per level, bottom-up). The batch-signing
    shape (tx_signature.sign_tx_ids): a 16k notary flush builds 16k
    proofs, one object each; the hash walk happens only when a verifier
    recomputes the root. Verification semantics match
    PartialMerkleTree(size, (index,), path) exactly."""

    tree_size: int
    index: int
    path: bytes             # len = 32 * log2(tree_size)

    def _root_for(self, leaves: list[SecureHash]) -> SecureHash:
        if len(leaves) != 1:
            raise ValueError("single-leaf proof takes exactly one leaf")
        size = self.tree_size
        if size <= 0 or size & (size - 1):
            raise ValueError("tree size not a power of two")
        depth = size.bit_length() - 1
        if len(self.path) != 32 * depth:
            raise ValueError("sibling path length mismatch")
        if not 0 <= self.index < size:
            raise ValueError("leaf index out of range")
        i = self.index
        h = leaves[0].bytes_
        for d in range(depth):
            sib = self.path[d * 32 : (d + 1) * 32]
            pair = h + sib if i % 2 == 0 else sib + h
            h = hashlib.sha256(pair).digest()
            i //= 2
        return SecureHash(h)

    def verify(self, root: SecureHash, leaves: list[SecureHash]) -> bool:
        try:
            return self._root_for(leaves) == root
        except (ValueError, IndexError):
            return False

    def as_partial_merkle_tree(self) -> "PartialMerkleTree":
        """The expanded equivalent (tooling/debug)."""
        return PartialMerkleTree(
            self.tree_size,
            (self.index,),
            tuple(
                SecureHash(self.path[j : j + 32])
                for j in range(0, len(self.path), 32)
            ),
        )


def single_leaf_proofs(
    leaves: list[SecureHash],
) -> tuple[SecureHash, list["SingleLeafProof"]]:
    """(root, one single-leaf inclusion proof per input leaf). The tree
    levels are built ONCE — O(n) hashing — then each leaf's proof is its
    sibling path, O(log n) lookups with no further hashing."""
    levels = merkle_levels(leaves)
    size = len(levels[0])
    root = levels[-1][0]
    proofs = []
    for i0 in range(len(leaves)):
        path = []
        i = i0
        for level in levels[:-1]:
            path.append(level[i ^ 1].bytes_)
            i //= 2
        proofs.append(SingleLeafProof(size, i0, b"".join(path)))
    return root, proofs


@ser.serializable
@dataclass(frozen=True)
class PartialMerkleTree:
    """Inclusion proof for a subset of leaves.

    Encoding: the set of proven leaf indices (in the padded tree), the
    padded tree size, and the sibling hashes needed to recompute the
    root, in deterministic bottom-up, left-to-right order.
    """

    tree_size: int
    included_indices: tuple[int, ...]
    hashes: tuple[SecureHash, ...]

    @staticmethod
    def build(
        all_leaves: list[SecureHash], included: list[SecureHash]
    ) -> "PartialMerkleTree":
        levels = merkle_levels(all_leaves)
        padded = levels[0]
        want = set()
        incl_set = {h.bytes_ for h in included}
        for i, leaf in enumerate(padded):
            if leaf.bytes_ in incl_set:
                want.add(i)
        if len(incl_set - {padded[i].bytes_ for i in want}):
            raise ValueError("included leaf not present in tree")
        # walk up: record sibling hashes not derivable from included leaves
        proof: list[SecureHash] = []
        needed = want
        for level in levels[:-1]:
            next_needed = set()
            for i in sorted(needed):
                sib = i ^ 1
                if sib not in needed:
                    proof.append(level[sib])
                next_needed.add(i // 2)
            needed = next_needed
        return PartialMerkleTree(len(padded), tuple(sorted(want)), tuple(proof))

    def verify(self, root: SecureHash, leaves: list[SecureHash]) -> bool:
        """Check `leaves` (in index order) hash up to `root`."""
        try:
            return self._root_for(leaves) == root
        except (ValueError, IndexError):
            return False

    def _root_for(self, leaves: list[SecureHash]) -> SecureHash:
        if len(leaves) != len(self.included_indices):
            raise ValueError("leaf count mismatch")
        if not self.included_indices:
            raise ValueError("proof proves no leaves")
        if self.tree_size & (self.tree_size - 1) or self.tree_size <= 0:
            raise ValueError("tree size not a power of two")
        known: dict[int, SecureHash] = dict(zip(self.included_indices, leaves))
        if any(i >= self.tree_size or i < 0 for i in known):
            raise ValueError("leaf index out of range")
        proof = list(self.hashes)
        size = self.tree_size
        while size > 1:
            nxt: dict[int, SecureHash] = {}
            for i in sorted(known):
                sib = i ^ 1
                if sib in known:
                    if i < sib:
                        nxt[i // 2] = known[i].hash_concat(known[sib])
                else:
                    if not proof:
                        raise ValueError("proof exhausted")
                    sh = proof.pop(0)
                    pair = (known[i], sh) if i % 2 == 0 else (sh, known[i])
                    nxt[i // 2] = pair[0].hash_concat(pair[1])
            known = nxt
            size //= 2
        if proof:
            raise ValueError("unused proof hashes")
        return known[0]
