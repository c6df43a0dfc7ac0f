"""Contract/state data model: states, commands, attachments, amounts.

Port of corda_tpu/core/contracts.py. Reference: core/.../contracts/Structures.kt:40-465 and Amount.kt
(SURVEY.md §2.1). Contracts here are pure-python callables with a
`verify(ltx)` entry point raising on failure — deterministic by
discipline (the reference's deterministic-JVM sandbox is likewise only
a prototype: experimental/sandbox/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Protocol, runtime_checkable

from ..core import serialization as ser
from ..crypto.composite import AnyKey, leaves_of
from ..crypto.hashes import SecureHash
from ..crypto.schemes import PublicKey
from .identity import Party, PartyAndReference


# ---------------------------------------------------------------------------
# money & fungibles


@ser.serializable
@dataclass(frozen=True, order=True)
class Issued:
    """An asset type qualified by its issuer: (issuer ref, product)."""

    issuer: PartyAndReference
    product: str

    def __hash__(self) -> int:
        # the token is the state-grouping key of every fungible-asset
        # clause (group_states on the notary's flush path hashes it
        # several times per transaction); the nested dataclass hash
        # chain (Issued -> PartyAndReference -> Party -> PublicKey) is
        # worth memoising
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.issuer, self.product))
            object.__setattr__(self, "_hash", h)
        return h


@ser.serializable
@dataclass(frozen=True, order=True)
class Amount:
    """Integer quantity of a token in indivisible units (no floats —
    float arithmetic is not deterministic across hosts; reference:
    contracts/Amount.kt)."""

    quantity: int
    token: Any

    def __post_init__(self):
        if self.quantity < 0:
            raise ValueError("amount cannot be negative")

    def __add__(self, other: "Amount") -> "Amount":
        self._check(other)
        return Amount(self.quantity + other.quantity, self.token)

    def __sub__(self, other: "Amount") -> "Amount":
        self._check(other)
        if other.quantity > self.quantity:
            raise ValueError("amount underflow")
        return Amount(self.quantity - other.quantity, self.token)

    def _check(self, other: "Amount") -> None:
        if other.token != self.token:
            raise ValueError(f"token mismatch: {self.token} vs {other.token}")

    def __mul__(self, k: int) -> "Amount":
        return Amount(self.quantity * k, self.token)

    @staticmethod
    def zero(token) -> "Amount":
        return Amount(0, token)

    @staticmethod
    def sum_or_zero(amounts: Iterable["Amount"], token) -> "Amount":
        total = Amount(0, token)
        for a in amounts:
            total = total + a
        return total


# ---------------------------------------------------------------------------
# states


@ser.serializable
@dataclass(frozen=True, order=True)
class UniqueIdentifier:
    """Identity of a LinearState thread across its evolution
    (reference: contracts/Structures.kt UniqueIdentifier — external id
    plus UUID; here the internal id is 16 opaque bytes minted via the
    flow-journaled randomness so replays are stable)."""

    id_bytes: bytes
    external_id: Optional[str] = None

    @staticmethod
    def fresh(rng=None) -> "UniqueIdentifier":
        import secrets

        data = (
            rng.getrandbits(128).to_bytes(16, "big")
            if rng is not None
            else secrets.token_bytes(16)
        )
        return UniqueIdentifier(data)

    def __str__(self) -> str:
        prefix = f"{self.external_id}_" if self.external_id else ""
        return prefix + self.id_bytes.hex()


@runtime_checkable
class LinearState(Protocol):
    """A state thread evolving through time, tracked by linear_id
    (reference: Structures.kt LinearState). Contracts must verify that
    a linear id never appears in more than one output."""

    @property
    def linear_id(self) -> UniqueIdentifier: ...


@dataclass(frozen=True)
class ScheduledActivity:
    """A flow to run at a time (reference: Structures.kt
    ScheduledActivity): flow logic tag + constructor args + micros."""

    flow_tag: str
    flow_args: tuple
    scheduled_at: int


@runtime_checkable
class SchedulableState(Protocol):
    """A state that requests future activity; the scheduler service
    watches vault outputs for these (Structures.kt SchedulableState,
    node/.../events/NodeSchedulerService.kt)."""

    def next_scheduled_activity(
        self, this_state_ref: "StateRef"
    ) -> Optional[ScheduledActivity]: ...


@runtime_checkable
class ContractState(Protocol):
    """Anything stored on ledger. Implementations are frozen dataclasses
    with a `contract` property and `participants` (keys that must sign
    state changes)."""

    @property
    def participants(self) -> tuple[AnyKey, ...]: ...


@ser.serializable
@dataclass(frozen=True)
class StateRef:
    """Pointer to an output of a previous transaction: (txhash, index)."""

    txhash: SecureHash
    index: int

    def __str__(self) -> str:
        return f"{self.txhash.prefix_chars()}({self.index})"


@ser.serializable
@dataclass(frozen=True)
class TransactionState:
    """A ContractState plus ledger metadata: which notary controls it
    and which contract governs it (reference: Structures.kt:101)."""

    data: Any                      # the ContractState
    contract: str                  # contract identifier (registry key)
    notary: Party
    encumbrance: Optional[int] = None

    def with_notary(self, notary: Party) -> "TransactionState":
        return TransactionState(self.data, self.contract, notary, self.encumbrance)


@ser.serializable
@dataclass(frozen=True)
class StateAndRef:
    state: TransactionState
    ref: StateRef


# ---------------------------------------------------------------------------
# commands


@ser.serializable
@dataclass(frozen=True)
class Command:
    """Instruction to a contract plus the keys required to sign it."""

    value: Any
    signers: tuple[Any, ...]       # PublicKey or CompositeKey

    @property
    def signing_leaf_keys(self) -> list[PublicKey]:
        out = []
        for k in self.signers:
            out.extend(leaves_of(k))
        return out


@ser.serializable
@dataclass(frozen=True)
class CommandWithParties:
    """Command resolved against known identities (LedgerTransaction view)."""

    signers: tuple[Any, ...]
    signing_parties: tuple[Party, ...]
    value: Any


@ser.serializable
@dataclass(frozen=True)
class TimeWindow:
    """Validity window for a transaction, enforced by the notary
    (reference: contracts/Structures.kt TimeWindow + TimeWindowChecker).
    Times are integer microseconds since epoch (determinism)."""

    from_time: Optional[int] = None
    until_time: Optional[int] = None

    def __post_init__(self):
        if self.from_time is None and self.until_time is None:
            raise ValueError("empty time window")
        if (
            self.from_time is not None
            and self.until_time is not None
            and self.until_time < self.from_time
        ):
            raise ValueError("until < from")

    @staticmethod
    def between(from_time: int, until_time: int) -> "TimeWindow":
        return TimeWindow(from_time, until_time)

    @staticmethod
    def from_only(t: int) -> "TimeWindow":
        return TimeWindow(t, None)

    @staticmethod
    def until_only(t: int) -> "TimeWindow":
        return TimeWindow(None, t)

    def contains(self, instant: int) -> bool:
        if self.from_time is not None and instant < self.from_time:
            return False
        if self.until_time is not None and instant >= self.until_time:
            return False
        return True


# ---------------------------------------------------------------------------
# attachments


@ser.serializable
@dataclass(frozen=True)
class Attachment:
    """Content-addressed blob (contract code / data) referenced by hash.

    Reference: Structures.kt Attachment + NodeAttachmentService.kt —
    JAR blobs; here: opaque zip/bytes addressed by sha256.
    """

    id: SecureHash
    data: bytes

    @staticmethod
    def of(data: bytes) -> "Attachment":
        return Attachment(SecureHash.sha256(data), data)


# ---------------------------------------------------------------------------
# contract protocol & registry


class ContractViolation(Exception):
    """Raised by Contract.verify on any rule violation."""


@runtime_checkable
class Contract(Protocol):
    def verify(self, ltx: "LedgerTransaction") -> None: ...  # noqa: F821


_CONTRACT_REGISTRY: dict[str, Any] = {}


def register_contract(name: str, contract) -> None:
    _CONTRACT_REGISTRY[name] = contract


def contract_by_name(name: str):
    c = _CONTRACT_REGISTRY.get(name)
    if c is None:
        raise ContractViolation(f"unknown contract {name!r}")
    return c


def require_that(description: str, condition: bool) -> None:
    """Contract assertion helper (the reference's `requireThat` DSL)."""
    if not condition:
        raise ContractViolation(f"Failed requirement: {description}")
