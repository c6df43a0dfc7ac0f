"""Transactions: wire, signed, resolved (ledger) and filtered forms.

Port of corda_tpu/core/transactions.py. Signature checks default to the
port's `default_verifier()`, a CudaBatchVerifier on the card: callers
on the CPU pass a verifier (or set_default_verifier). A contract that no
process registered is loaded from the transaction's own attachments and
run in the sandbox (core/sandbox.py), as the reference does.

Reference structure (SURVEY.md §2.1, core/.../transactions/):
  WireTransaction      — unsigned; id = Merkle root over component
                         hashes (WireTransaction.kt:39,104)
  SignedTransaction    — wire bytes + signatures; signature checking
                         entry point (SignedTransaction.kt:135-149)
  LedgerTransaction    — inputs resolved to states; runs contract
                         verification (LedgerTransaction.kt:64-79)
  FilteredTransaction  — Merkle tear-off for notaries/oracles
                         (MerkleTransaction.kt)
  TransactionBuilder   — mutable builder (TransactionBuilder.kt)

Batch-first: `SignedTransaction.signature_requests` stages (key, sig,
payload) triples so callers (the batching notary) drain many
transactions through one BatchSignatureVerifier dispatch. The single-tx
path wraps the same SPI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence

from ..core import serialization as ser
from ..crypto import composite as comp
from ..crypto.batch_verifier import (
    BatchSignatureVerifier,
    VerificationRequest,
    default_verifier,
)
from ..crypto.hashes import SecureHash
from ..crypto.merkle import PartialMerkleTree, merkle_root
from ..crypto.schemes import PrivateKey, PublicKey
from ..crypto.tx_signature import (
    InvalidSignature,
    TransactionSignature,
    sign_tx_id,
)
from .contracts import (
    Command,
    CommandWithParties,
    ContractViolation,
    StateAndRef,
    StateRef,
    TimeWindow,
    TransactionState,
    contract_by_name,
)
from .identity import Party

# component group ordinals (stable — part of the id preimage)
G_INPUTS, G_OUTPUTS, G_COMMANDS, G_ATTACHMENTS, G_NOTARY, G_TIMEWINDOW = range(6)
# meta group: a single always-revealed leaf carrying the per-group
# component counts, so a FilteredTransaction can prove COMPLETENESS of
# a revealed group (a partial Merkle proof alone proves inclusion, not
# that nothing was hidden — without this a tear-off could conceal an
# input from a non-validating notary and double-spend it)
G_META = 6
N_GROUPS = 6


class TransactionVerificationError(Exception):
    pass


class SignaturesMissingError(InvalidSignature):
    def __init__(self, missing: set, tx_id: SecureHash):
        self.missing = missing
        self.tx_id = tx_id
        super().__init__(f"missing signatures on {tx_id}: {missing}")


@ser.serializable
@dataclass(frozen=True)
class WireTransaction:
    """Immutable unsigned transaction.

    The id is the root of the component Merkle tree; every component
    leaf is H(group_ordinal, index, canonical_encoding(component)), so
    FilteredTransaction can reveal any subset with inclusion proofs.
    """

    inputs: tuple[StateRef, ...]
    outputs: tuple[TransactionState, ...]
    commands: tuple[Command, ...]
    attachments: tuple[SecureHash, ...]
    notary: Optional[Party]
    time_window: Optional[TimeWindow]

    # -- identity ----------------------------------------------------------

    def group_counts(self) -> list[int]:
        return [
            len(self.inputs),
            len(self.outputs),
            len(self.commands),
            len(self.attachments),
            1 if self.notary else 0,
            1 if self.time_window else 0,
        ]

    def component_leaves(self) -> list[tuple[int, int, Any]]:
        """(group, index, component) triples in canonical order; the
        trailing G_META leaf commits to every group's size."""
        out: list[tuple[int, int, Any]] = []
        for g, items in (
            (G_INPUTS, self.inputs),
            (G_OUTPUTS, self.outputs),
            (G_COMMANDS, self.commands),
            (G_ATTACHMENTS, self.attachments),
            (G_NOTARY, (self.notary,) if self.notary else ()),
            (G_TIMEWINDOW, (self.time_window,) if self.time_window else ()),
        ):
            for i, item in enumerate(items):
                out.append((g, i, item))
        out.append((G_META, 0, self.group_counts()))
        return out

    def leaf_hashes(self) -> list[SecureHash]:
        return [component_hash(g, i, c) for g, i, c in self.component_leaves()]

    def leaf_preimages(self) -> list[bytes]:
        """Every component leaf's id-preimage (the canonical encoding
        `component_hash` digests), in leaf order. The pipelined ingest
        path (node/ingest.py) collects these across a whole decode
        batch and hashes them in ONE batched SHA-256 pass — and uses
        the bytes as the key of its leaf-digest cache, so re-seen
        component structures skip hashing entirely."""
        return [
            component_preimage(g, i, c) for g, i, c in self.component_leaves()
        ]

    @property
    def id(self) -> SecureHash:
        """Merkle root over component hashes — THE transaction identity.
        Cached per instance: the encode-and-hash walk is a host hot
        path (every signature check, vault notify, broadcast and
        notary round asks for the id), and the instance is frozen so
        the root can never change."""
        cached = getattr(self, "_id_cache", None)
        if cached is None:
            cached = merkle_root(self.leaf_hashes())
            object.__setattr__(self, "_id_cache", cached)
        return cached

    # -- state access ------------------------------------------------------

    def out_ref(self, index: int) -> StateRef:
        if not (0 <= index < len(self.outputs)):
            raise IndexError(f"no output {index}")
        return StateRef(self.id, index)

    def outputs_of_type(self, cls) -> list[TransactionState]:
        return [o for o in self.outputs if isinstance(o.data, cls)]

    @property
    def required_signing_keys(self) -> set:
        # memoised like `id`: recomputed on every signature-sufficiency
        # check otherwise, and the instance is frozen
        cached = getattr(self, "_rsk_cache", None)
        if cached is None:
            keys: set = set()
            for c in self.commands:
                keys.update(c.signers)
            if self.notary is not None and self.inputs:
                keys.add(self.notary.owning_key)
            cached = frozenset(keys)
            object.__setattr__(self, "_rsk_cache", cached)
        return cached

    # -- filtering (tear-offs) --------------------------------------------

    def build_filtered_transaction(
        self, predicate: Callable[[Any], bool]
    ) -> "FilteredTransaction":
        leaves = self.component_leaves()
        hashes = self.leaf_hashes()
        included = [
            (g, i, c)
            for (g, i, c), h in zip(leaves, hashes)
            if g == G_META or predicate(c)   # meta is always revealed
        ]
        included_hashes = [
            component_hash(g, i, c) for g, i, c in included
        ]
        proof = PartialMerkleTree.build(hashes, included_hashes)
        return FilteredTransaction(
            id=self.id,
            components=tuple(included),
            proof=proof,
        )


def component_preimage(group: int, index: int, component: Any) -> bytes:
    """The id-preimage bytes of one component leaf — ONE encoding
    shared by component_hash and the batched ingest id stage, so the
    two can never drift."""
    return ser.encode([group, index, component])


def component_hash(group: int, index: int, component: Any) -> SecureHash:
    return SecureHash.sha256(component_preimage(group, index, component))


@ser.serializable
@dataclass(frozen=True)
class FilteredTransaction:
    """Merkle tear-off: a subset of components + inclusion proof.

    A non-validating notary receives only StateRefs, the notary and the
    TimeWindow (reference: NotaryFlow.kt:68-77, MerkleTransaction.kt).
    """

    id: SecureHash
    components: tuple[tuple[int, int, Any], ...]
    proof: PartialMerkleTree

    def verify(self) -> None:
        hashes = [component_hash(g, i, c) for g, i, c in self.components]
        # proof indices are in padded-tree order; leaves must be supplied
        # sorted by their padded index, which build() preserved
        if not self.proof.verify(self.id, hashes):
            raise TransactionVerificationError(
                f"filtered transaction proof failed for {self.id}"
            )
        metas = self.components_in_group(G_META)
        if len(metas) != 1 or len(metas[0]) != N_GROUPS:
            raise TransactionVerificationError(
                "filtered transaction lacks the group-counts meta leaf"
            )
        counts = metas[0]
        for g in range(N_GROUPS):
            revealed = len(self.components_in_group(g))
            if revealed > counts[g]:
                raise TransactionVerificationError(
                    f"group {g} reveals more components than committed"
                )

    def group_count(self, group: int) -> int:
        """Committed total size of a group (from the meta leaf)."""
        return self.components_in_group(G_META)[0][group]

    def all_revealed(self, group: int) -> bool:
        """True iff every component of `group` is present — the
        completeness check a non-validating notary needs on inputs."""
        return len(self.components_in_group(group)) == self.group_count(group)

    def components_in_group(self, group: int) -> list[Any]:
        return [c for g, _, c in self.components if g == group]

    @property
    def inputs(self) -> list[StateRef]:
        return self.components_in_group(G_INPUTS)

    @property
    def notary(self) -> Optional[Party]:
        ns = self.components_in_group(G_NOTARY)
        return ns[0] if ns else None

    @property
    def time_window(self) -> Optional[TimeWindow]:
        ts = self.components_in_group(G_TIMEWINDOW)
        return ts[0] if ts else None


@ser.serializable
@dataclass(frozen=True)
class SignedTransaction:
    """Wire transaction + signatures over SignableData(id, metadata)."""

    wtx: WireTransaction
    sigs: tuple[TransactionSignature, ...]

    @property
    def id(self) -> SecureHash:
        return self.wtx.id

    def __post_init__(self):
        if not isinstance(self.wtx, WireTransaction):
            raise TypeError("wtx must be a WireTransaction")

    # -- signature machinery ----------------------------------------------

    def with_additional_signature(self, sig: TransactionSignature) -> "SignedTransaction":
        return SignedTransaction(self.wtx, self.sigs + (sig,))

    def with_additional_signatures(
        self, sigs: Iterable[TransactionSignature]
    ) -> "SignedTransaction":
        return SignedTransaction(self.wtx, self.sigs + tuple(sigs))

    def signature_requests(self) -> list[VerificationRequest]:
        """Stage every attached signature for batch verification.

        Memoised like `wtx.id` (the instance is frozen): the ingest
        pipeline stages at decode time, and downstream drains — the
        notary flush, the verifier worker — then reuse the staged list
        instead of re-staging per consumer."""
        cached = self.__dict__.get("_sigreq_cache")
        if cached is None:
            cached = [
                VerificationRequest(
                    s.by, s.signature, s.signable_payload(self.id)
                )
                for s in self.sigs
            ]
            object.__setattr__(self, "_sigreq_cache", cached)
        return cached

    def check_signatures_are_valid(
        self, verifier: Optional[BatchSignatureVerifier] = None
    ) -> None:
        """All attached signatures must be cryptographically valid
        (reference: TransactionWithSignatures.checkSignaturesAreValid:58)."""
        v = verifier or default_verifier()
        self.raise_on_invalid(v.verify_batch(self.signature_requests()))

    def raise_on_invalid(self, results: Sequence[bool]) -> None:
        """Map per-signature batch results back to signers; raise
        InvalidSignature naming the bad ones. Shared by the in-process
        check above and the out-of-process verifier worker, which stages
        many transactions' signatures into one batch dispatch."""
        if all(results):
            return
        bad = [s for s, ok in zip(self.sigs, results) if not ok]
        if bad:
            raise InvalidSignature(
                f"invalid signature(s) on {self.id} by "
                f"{[str(s.by) for s in bad]}"
            )

    def _signer_keys(self) -> set[PublicKey]:
        return {s.by for s in self.sigs}

    def missing_signing_keys(self, except_keys: set = frozenset()) -> set:
        """Required keys (composite-aware) not fulfilled by attached sigs."""
        signed = self._signer_keys()
        missing = set()
        for key in self.wtx.required_signing_keys:
            if key in except_keys:
                continue
            if not comp.is_fulfilled_by(key, signed):
                missing.add(key)
        return missing

    def verify_required_signatures(
        self, except_keys: set = frozenset()
    ) -> None:
        """Reference: TransactionWithSignatures.verifySignaturesExcept:41."""
        missing = self.missing_signing_keys(except_keys)
        if missing:
            raise SignaturesMissingError(missing, self.id)

    # -- full verification -------------------------------------------------

    def to_ledger_transaction(self, services) -> "LedgerTransaction":
        return services.resolve_transaction(self.wtx)

    def verify(
        self,
        services,
        check_sufficient_signatures: bool = True,
        verifier: Optional[BatchSignatureVerifier] = None,
    ) -> None:
        """Full verification: signatures, required signers, contracts.

        Mirrors SignedTransaction.verify -> verifyRegularTransaction
        (SignedTransaction.kt:135-149), with the signature batch drained
        through the BatchSignatureVerifier SPI and contract execution
        delegated to services.transaction_verifier.
        """
        self.check_signatures_are_valid(verifier)
        if check_sufficient_signatures:
            self.verify_required_signatures()
        else:
            notary_key = self.wtx.notary.owning_key if self.wtx.notary else None
            self.verify_required_signatures(
                {notary_key} if notary_key else set()
            )
        ltx = self.to_ledger_transaction(services)
        services.transaction_verifier.verify(ltx).result()


@ser.serializable
@dataclass(frozen=True)
class LedgerTransaction:
    """Fully resolved transaction: ready for contract execution.

    Serializable because the out-of-process verifier pool ships resolved
    transactions to workers (reference: VerifierApi.kt VerificationRequest
    carries the LedgerTransaction bytes)."""

    inputs: tuple[StateAndRef, ...]
    outputs: tuple[TransactionState, ...]
    commands: tuple[CommandWithParties, ...]
    attachments: tuple[Any, ...]
    notary: Optional[Party]
    time_window: Optional[TimeWindow]
    id: SecureHash

    def verify(self) -> None:
        """Run every referenced contract's verify (LedgerTransaction.kt:
        64-79): each distinct contract sees the whole transaction.
        Replacement transactions (notary change / contract upgrade)
        dispatch to their special rules instead — the reference models
        those as separate LedgerTransaction classes
        (NotaryChangeTransactions.kt). The lazy import keeps the rules
        in core (every verifying process gets them, including
        out-of-process workers) without an import cycle."""
        from . import replacement as _repl

        special = _repl.replacement_verifier(self)
        if special is not None:
            special()
            return
        for name in self.contract_names():
            try:
                contract = contract_by_name(name)
            except ContractViolation:
                # not installed locally: load sandboxed code from the
                # transaction's own attachments (AttachmentsClassLoader
                # .kt:23 analogue — the tx references the attachment
                # hash, so the code identity is signed over)
                from .sandbox import contract_from_attachments

                contract = contract_from_attachments(name, self.attachments)
            contract.verify(self)

    def contract_names(self) -> list[str]:
        """Every contract this transaction touches, in the (sorted)
        order `verify` runs them. ONE implementation shared with the
        batch path (core/batch_verify.py) — two copies that drift would
        let the batch path run fewer contracts than per-tx verify.
        Memoised: the notary flush classifies each transaction twice
        (attachment-code deferral, then batch grouping)."""
        names = self.__dict__.get("_contract_names")
        if names is None:
            s = {ts.contract for ts in self.outputs}
            s.update(sar.state.contract for sar in self.inputs)
            names = sorted(s)
            object.__setattr__(self, "_contract_names", names)
        return names

    # -- state grouping (LedgerTransaction.groupStates:142) ----------------

    def group_states(self, cls, key_fn) -> list["InOutGroup"]:
        groups: dict[Any, InOutGroup] = {}

        def group_for(k):
            if k not in groups:
                groups[k] = InOutGroup(k, [], [])
            return groups[k]

        for sar in self.inputs:
            if isinstance(sar.state.data, cls):
                group_for(key_fn(sar.state.data)).inputs.append(sar.state.data)
        for ts in self.outputs:
            if isinstance(ts.data, cls):
                group_for(key_fn(ts.data)).outputs.append(ts.data)
        return list(groups.values())

    def commands_of_type(self, cls) -> list[CommandWithParties]:
        return [c for c in self.commands if isinstance(c.value, cls)]

    def inputs_of_type(self, cls) -> list:
        return [s.state.data for s in self.inputs if isinstance(s.state.data, cls)]

    def outputs_of_type(self, cls) -> list:
        return [t.data for t in self.outputs if isinstance(t.data, cls)]


@dataclass
class InOutGroup:
    key: Any
    inputs: list
    outputs: list


class TransactionBuilder:
    """Mutable builder for WireTransactions (TransactionBuilder.kt)."""

    def __init__(self, notary: Optional[Party] = None):
        self.notary = notary
        self._inputs: list[StateRef] = []
        self._outputs: list[TransactionState] = []
        self._commands: list[Command] = []
        self._attachments: list[SecureHash] = []
        self._time_window: Optional[TimeWindow] = None

    def add_input_state(self, sar: StateAndRef) -> "TransactionBuilder":
        if self.notary is None:
            self.notary = sar.state.notary
        elif sar.state.notary != self.notary:
            raise TransactionVerificationError(
                "all inputs must share one notary"
            )
        self._inputs.append(sar.ref)
        return self

    def add_output_state(
        self,
        data: Any,
        contract: str,
        notary: Optional[Party] = None,
        encumbrance: Optional[int] = None,
    ) -> "TransactionBuilder":
        n = notary or self.notary
        if n is None:
            raise TransactionVerificationError("output needs a notary")
        self._outputs.append(TransactionState(data, contract, n, encumbrance))
        return self

    def add_command(self, value: Any, *signers) -> "TransactionBuilder":
        self._commands.append(Command(value, tuple(signers)))
        return self

    def add_attachment(self, att_id: SecureHash) -> "TransactionBuilder":
        self._attachments.append(att_id)
        return self

    def set_time_window(self, tw: TimeWindow) -> "TransactionBuilder":
        self._time_window = tw
        return self

    def to_wire_transaction(self) -> WireTransaction:
        return WireTransaction(
            inputs=tuple(self._inputs),
            outputs=tuple(self._outputs),
            commands=tuple(self._commands),
            attachments=tuple(self._attachments),
            notary=self.notary,
            time_window=self._time_window,
        )

    def sign_initial_transaction(self, *privs: PrivateKey) -> SignedTransaction:
        wtx = self.to_wire_transaction()
        tx_id = wtx.id
        return SignedTransaction(
            wtx, tuple(sign_tx_id(p, tx_id) for p in privs)
        )
