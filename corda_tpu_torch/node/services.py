"""ServiceHub and the in-memory node services.

Port of corda_tpu/node/services.py: the clock, the storages, key
management, identity, the network-map cache, the vault with its query
DSL (`query_by` / `track_by` over node/vault_query.py), the in-memory
transaction verifier service and the hub, with its CorDapp services
(node/cordapp.py) and its batched resolve + verify
(`resolve_verify_batch`, the notary flush's host hot path). The
hub's batch verifier defaults to the port's `default_verifier()`, a
CudaBatchVerifier on the card. A hub given a `db` (node/persistence.py's
PersistentServiceHub) records each batch of transactions in one
database transaction.

Reference: the `ServiceHub` facade (core/.../node/ServiceHub.kt:45-60 —
vault, keyManagement, identity, attachments, validatedTransactions,
transactionVerifierService, clock, networkMapCache) and its node-side
implementations (SURVEY §2.8). These in-memory implementations are the
Ring-2/Ring-3 substrate (reference: testing/node/MockServices.kt) and
double as the storage interface the sqlite-backed Phase-3 services
implement.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from ..core import serialization as ser
from ..core.contracts import (
    Attachment,
    CommandWithParties,
    StateAndRef,
    StateRef,
    TransactionState,
)
from ..core.identity import AnonymousParty, Party
from ..core.transactions import (
    LedgerTransaction,
    SignedTransaction,
    TransactionVerificationError,
    WireTransaction,
)
from ..crypto import composite as comp
from ..crypto import schemes
from ..crypto.batch_verifier import (
    BatchSignatureVerifier,
    default_verifier,
)
from ..crypto.hashes import SecureHash
from ..crypto.tx_signature import (
    TransactionSignature,
    sign_tx_id,
    sign_tx_ids,
)
from ..utils import locks


# ---------------------------------------------------------------------------
# clock


class Clock:
    """Integer-microsecond clock (determinism: no floats on consensus
    paths; reference TimeWindow uses Instants)."""

    def now_micros(self) -> int:
        import time

        return time.time_ns() // 1_000


class TestClock(Clock):
    """Settable clock for Ring-2/3 tests (reference: TestClock.kt)."""

    def __init__(self, start_micros: int = 1_700_000_000_000_000):
        self._now = start_micros

    def now_micros(self) -> int:
        return self._now

    def advance(self, micros: int) -> None:
        self._now += micros

    def set(self, micros: int) -> None:
        self._now = micros


def _safe_notify(cb, item) -> None:
    """Observer failures must not abort ledger recording: a subscriber
    bug aborting record_transactions would roll back the DB rows while
    the in-memory caches keep them — permanent memory/disk divergence.
    Matches the reference's Rx semantics (onNext errors don't undo the
    vault write)."""
    import logging

    try:
        cb(item)
    except Exception:
        logging.getLogger("corda_tpu_torch.vault").exception(
            "ledger observer raised; continuing"
        )


# ---------------------------------------------------------------------------
# storage services


class TransactionStorage:
    """Validated-transaction store (reference: DBTransactionStorage).
    Observers fire on first record — the SMM's waitForLedgerCommit and
    the vault hang off this."""

    def __init__(self):
        self._txs: dict[SecureHash, SignedTransaction] = {}
        self.observers: list[Callable[[SignedTransaction], None]] = []

    def get(self, tx_id: SecureHash) -> Optional[SignedTransaction]:
        return self._txs.get(tx_id)

    def add(self, stx: SignedTransaction) -> bool:
        """Returns True if newly added (idempotent on re-record)."""
        if not self.add_quiet(stx):
            return False
        self.fire_observers(stx)
        return True

    def add_quiet(self, stx: SignedTransaction) -> bool:
        """Store without firing observers — record_transactions defers
        observer side effects until the vault has fully persisted, so a
        disk failure can unwind with no observer having seen the tx."""
        if stx.id in self._txs:
            return False
        self._txs[stx.id] = stx
        return True

    def fire_observers(self, stx: SignedTransaction) -> None:
        for cb in list(self.observers):
            _safe_notify(cb, stx)

    def _forget(self, tx_id: SecureHash) -> None:
        """Undo of add_quiet when a later step of the record fails."""
        self._txs.pop(tx_id, None)

    def __contains__(self, tx_id: SecureHash) -> bool:
        return tx_id in self._txs

    def all(self) -> list[SignedTransaction]:
        return list(self._txs.values())

    def count(self) -> int:
        """O(1) — dashboards must not copy the whole store to count it."""
        return len(self._txs)


class AttachmentStorage:
    """Content-addressed blob store (reference: NodeAttachmentService)."""

    def __init__(self):
        self._blobs: dict[SecureHash, bytes] = {}

    def import_attachment(self, data: bytes) -> SecureHash:
        att = Attachment.of(data)
        self._blobs.setdefault(att.id, data)
        return att.id

    def open_attachment(self, att_id: SecureHash) -> Optional[Attachment]:
        data = self._blobs.get(att_id)
        return None if data is None else Attachment(att_id, data)

    def __contains__(self, att_id: SecureHash) -> bool:
        return att_id in self._blobs


class CheckpointStorage:
    """Flow checkpoint store (reference: DBCheckpointStorage.kt:18)."""

    def __init__(self):
        self._checkpoints: dict[bytes, bytes] = {}

    def add(self, flow_id: bytes, record: bytes) -> None:
        self._checkpoints[flow_id] = record

    def remove(self, flow_id: bytes) -> None:
        self._checkpoints.pop(flow_id, None)

    def all(self) -> list[tuple[bytes, bytes]]:
        return sorted(self._checkpoints.items())


# ---------------------------------------------------------------------------
# key management & identity


class KeyManagementService:
    """Holds this node's signing keys; mints fresh (anonymous) keys
    (reference: node/.../services/keys/PersistentKeyManagementService)."""

    def __init__(self, *initial_keys: schemes.KeyPair, rng=None):
        import random as _random

        self._keys: dict[schemes.PublicKey, schemes.PrivateKey] = {
            kp.public: kp.private for kp in initial_keys
        }
        self._rng = rng or _random.Random()

    @property
    def keys(self) -> set[schemes.PublicKey]:
        return set(self._keys)

    def fresh_key(
        self, scheme_id: int = schemes.DEFAULT_SCHEME
    ) -> schemes.PublicKey:
        kp = schemes.generate_keypair(
            scheme_id, seed=self._rng.getrandbits(256)
        )
        self._keys[kp.public] = kp.private
        return kp.public

    def register_keypair(self, kp: schemes.KeyPair) -> None:
        """Install an externally-provisioned key (a notary cluster's
        shared service key, distributed out of band)."""
        self._keys[kp.public] = kp.private

    def sign(self, tx_id: SecureHash, key: schemes.PublicKey) -> TransactionSignature:
        priv = self._keys.get(key)
        if priv is None:
            raise KeyError(f"no private key for {key}")
        return sign_tx_id(priv, tx_id)

    def sign_batch(
        self, tx_ids: list[SecureHash], key: schemes.PublicKey
    ) -> list[TransactionSignature]:
        """One Merkle-batch signature fanned out per tx id (the
        batching notary's reply-signing path — see
        tx_signature.sign_tx_ids)."""
        priv = self._keys.get(key)
        if priv is None:
            raise KeyError(f"no private key for {key}")
        return sign_tx_ids(priv, tx_ids)

    def sign_bytes(self, data: bytes, key: schemes.PublicKey) -> bytes:
        """Raw scheme signature over arbitrary bytes (identity binds,
        registrations — NOT transactions, which go through sign())."""
        priv = self._keys.get(key)
        if priv is None:
            raise KeyError(f"no private key for {key}")
        return priv.sign(data)

    def our_first_key_for(self, candidates: Iterable) -> Optional[schemes.PublicKey]:
        """First leaf of any candidate key that we control."""
        for k in candidates:
            for leaf in comp.leaves_of(k):
                if leaf in self._keys:
                    return leaf
        return None


class IdentityService:
    """party <-> key registry (reference: InMemoryIdentityService)."""

    def __init__(self, *parties: Party):
        self._by_key: dict[bytes, Party] = {}
        self._by_name: dict[str, Party] = {}
        for p in parties:
            self.register(p)

    def register(self, party: Party) -> None:
        self._by_key[_key_fp(party.owning_key)] = party
        self._by_name[party.name] = party

    def register_anonymous(self, anonymous, well_known: Party) -> None:
        """Record that an anonymous key belongs to a well-known party
        (confidential identities — the mapping TransactionKeyFlow
        exchanges; reference: IdentityService.registerAnonymousIdentity).
        Refuses to REBIND a key already mapped to a different party —
        silently overwriting would let a counterparty hijack someone
        else's identity resolution on this node."""
        fp = _key_fp(anonymous.owning_key)
        existing = self._by_key.get(fp)
        if existing is not None and existing != well_known:
            raise ValueError(
                f"key already registered to {existing}; refusing rebind "
                f"to {well_known}"
            )
        self._by_key[fp] = well_known

    def party_from_key(self, key) -> Optional[Party]:
        return self._by_key.get(_key_fp(key))

    def party_from_name(self, name: str) -> Optional[Party]:
        return self._by_name.get(name)

    def well_known_party(self, party) -> Optional[Party]:
        """Resolve an AnonymousParty/Party to its well-known identity."""
        if isinstance(party, Party):
            return party
        if isinstance(party, AnonymousParty):
            return self.party_from_key(party.owning_key)
        return None

    def all_parties(self) -> list[Party]:
        return list(self._by_name.values())


def _key_fp(key) -> bytes:
    return key.fingerprint()


# ---------------------------------------------------------------------------
# network map cache


@ser.serializable
@dataclass(frozen=True)
class NodeInfo:
    """A node's advertised identity + address (reference:
    core/.../node/NodeInfo.kt). `address` is the peer's fabric address
    (its unique peer name — message targets everywhere). On the DCN
    fabric, `host`/`port`/`tls_fingerprint` tell bridges where to dial
    and which self-signed TLS cert to pin; the network map is how they
    are learned (the reference distributes cert chains the same way)."""

    address: str
    legal_identity: Party
    advertised_services: tuple[str, ...] = ()
    host: Optional[str] = None
    port: int = 0
    tls_fingerprint: Optional[bytes] = None
    # distributed notaries: the shared service identity this member
    # serves (reference: ServiceInfo with a cluster-wide notary
    # identity; notary-demo Raft/BFT clusters). Transactions name the
    # cluster party as their notary; any member answers for it.
    cluster_identity: Optional[Party] = None
    # the node's web-gateway port (None = no gateway): how peers reach
    # GET /health for the cluster-wide rollup (utils/health.py
    # ClusterHealth) — advertised through the network map like the
    # fabric port, never consensus input
    web_port: Optional[int] = None

    @property
    def notary_identity(self) -> Party:
        return self.legal_identity


SERVICE_NOTARY = "corda.notary.simple"
SERVICE_NOTARY_VALIDATING = "corda.notary.validating"
SERVICE_NETWORK_MAP = "corda.network_map"


@dataclass(frozen=True)
class MapChange:
    """One network-map delta (reference: NetworkMapCache.MapChange —
    Added/Removed/Modified)."""

    kind: str                 # "added" | "removed"
    info: NodeInfo


ser.serializable(MapChange)


class NetworkMapCache:
    """Peer directory (reference: InMemoryNetworkMapCache). The Phase-3
    network-map *service* feeds this over the fabric; Ring-3 tests fill
    it directly. Observers receive MapChange deltas — removals too, or
    feed consumers would route to dead addresses forever."""

    def __init__(self):
        self._nodes: dict[str, NodeInfo] = {}
        # cluster party name -> member infos (in arrival order)
        self._clusters: dict[str, list[NodeInfo]] = {}
        self._cluster_parties: dict[str, Party] = {}
        self._rr: dict[str, int] = {}   # round-robin cursor per cluster
        self.observers: list[Callable[[MapChange], None]] = []
        # liveness for the explorer's network view: name -> micros of
        # the last map sighting (registration/push). Stamped only when
        # a clock is wired (ServiceHub does) — the cache itself stays
        # clock-free for bare test fills
        self.last_seen: dict[str, int] = {}
        self.clock_fn: Optional[Callable[[], int]] = None

    def add_node(self, info: NodeInfo) -> None:
        self._nodes[info.legal_identity.name] = info
        if self.clock_fn is not None:
            self.last_seen[info.legal_identity.name] = self.clock_fn()
        if info.cluster_identity is not None:
            cname = info.cluster_identity.name
            members = self._clusters.setdefault(cname, [])
            members[:] = [
                m
                for m in members
                if m.legal_identity.name != info.legal_identity.name
            ] + [info]
            self._cluster_parties[cname] = info.cluster_identity
        for cb in list(self.observers):
            _safe_notify(cb, MapChange("added", info))

    def remove_node(self, info: NodeInfo) -> None:
        removed = self._nodes.pop(info.legal_identity.name, None)
        self.last_seen.pop(info.legal_identity.name, None)
        if removed is not None:
            for cname, members in list(self._clusters.items()):
                members[:] = [
                    m
                    for m in members
                    if m.legal_identity.name != info.legal_identity.name
                ]
                if not members:
                    del self._clusters[cname]
                    self._cluster_parties.pop(cname, None)
            for cb in list(self.observers):
                _safe_notify(cb, MapChange("removed", removed))

    def address_of(self, party: Party) -> Optional[str]:
        """Message-level address resolution. For a cluster party this is
        deliberately STICKY (first member): sessions are multi-message,
        and rotating here would scatter one session's messages across
        members. Load balancing lives in cluster_members(), which
        rotates its starting member per call — flows that understand
        clusters (NotaryFlow) address members directly."""
        info = self._nodes.get(party.name)
        if info is not None:
            return info.address
        members = self._clusters.get(party.name)
        if members:
            return members[0].address
        return None

    def node_of(self, party: Party) -> Optional[NodeInfo]:
        return self._nodes.get(party.name)

    def node_by_name(self, name: str) -> Optional[NodeInfo]:
        return self._nodes.get(name)

    def notary_identities(self) -> list[Party]:
        singles = [
            n.legal_identity
            for n in self._nodes.values()
            if n.cluster_identity is None
            and any(s.startswith("corda.notary") for s in n.advertised_services)
        ]
        clusters = [
            self._cluster_parties[cname]
            for cname, members in self._clusters.items()
            if any(
                s.startswith("corda.notary")
                for m in members
                for s in m.advertised_services
            )
        ]
        return singles + clusters

    def is_validating_notary(self, party: Party) -> bool:
        info = self._nodes.get(party.name)
        if info is not None:
            return SERVICE_NOTARY_VALIDATING in info.advertised_services
        members = self._clusters.get(party.name, [])
        return any(
            SERVICE_NOTARY_VALIDATING in m.advertised_services
            for m in members
        )

    def cluster_members(self, party: Party) -> list[NodeInfo]:
        """Members of a cluster service, rotated per call so successive
        callers start at different members (the load-balancing role of
        the reference's shared notary queues)."""
        members = list(self._clusters.get(party.name, ()))
        if not members:
            return members
        i = self._rr.get(party.name, 0) % len(members)
        self._rr[party.name] = i + 1
        return members[i:] + members[:i]

    def all_nodes(self) -> list[NodeInfo]:
        return list(self._nodes.values())


# ---------------------------------------------------------------------------
# vault


@dataclass
class VaultUpdate:
    """One ledger delta seen by this node (reference: Vault.Update)."""

    consumed: list[StateAndRef]
    produced: list[StateAndRef]


# Vault updates stream over RPC feeds (CordaRPCOps.vaultTrackBy), so
# they need a wire form; mutable lists round-trip as lists.
ser.register_custom(
    VaultUpdate,
    "VaultUpdate",
    lambda u: [list(u.consumed), list(u.produced)],
    lambda v: VaultUpdate(list(v[0]), list(v[1])),
)


class Observable:
    """Minimal push stream (the Rx Observable role in DataFeed —
    reference returns rx.Observable from trackBy/CordaRPCOps feeds)."""

    def __init__(self):
        self._subscribers: list[Callable[[Any], None]] = []

    def subscribe(self, cb: Callable[[Any], None]) -> Callable[[], None]:
        self._subscribers.append(cb)

        def unsubscribe():
            if cb in self._subscribers:
                self._subscribers.remove(cb)

        return unsubscribe

    def emit(self, item: Any) -> None:
        for cb in list(self._subscribers):
            _safe_notify(cb, item)   # one bad subscriber can't starve the rest


@dataclass
class DataFeed:
    """Snapshot + updates stream (core/.../messaging/DataFeed).
    `dispose()` detaches the feed from its source (the reference leans
    on Rx unsubscribe + GC reaping, RPCClientProxyHandler.kt:37-68)."""

    snapshot: Any
    updates: Observable
    dispose: Optional[Callable[[], None]] = None

    def close(self) -> None:
        if self.dispose is not None:
            self.dispose()


class VaultService:
    """Tracks our unconsumed states; streams updates; soft-locks states
    for in-flight spends (reference: NodeVaultService.kt +
    VaultSoftLockManager)."""

    def __init__(self, services: "ServiceHub"):
        self._services = services
        self._unconsumed: dict[StateRef, TransactionState] = {}
        self._consumed: dict[StateRef, TransactionState] = {}
        self._soft_locks: dict[StateRef, bytes] = {}   # ref -> lock id
        self._recorded_at: dict[StateRef, int] = {}
        self.updates: list[Callable[[VaultUpdate], None]] = []

    # -- ingestion ----------------------------------------------------------

    def notify(self, wtx: WireTransaction) -> None:
        """Apply a recorded transaction: consume our inputs, add our
        relevant outputs (NodeVaultService.notifyAll)."""
        consumed = []
        for ref in wtx.inputs:
            ts = self._unconsumed.pop(ref, None)
            if ts is not None:
                self._consumed[ref] = ts
                self._soft_locks.pop(ref, None)
                consumed.append(StateAndRef(ts, ref))
        produced = []
        my_keys = self._services.key_management.keys
        now = self._services.clock.now_micros()
        for i, ts in enumerate(wtx.outputs):
            if self._is_relevant(ts, my_keys):
                ref = StateRef(wtx.id, i)
                self._unconsumed[ref] = ts
                self._recorded_at[ref] = now
                produced.append(StateAndRef(ts, ref))
        if consumed or produced:
            update = VaultUpdate(consumed, produced)
            # persistence hook first and NOT error-shielded: a failed
            # disk write must abort the record — and unwind the map
            # mutations above so memory never runs ahead of disk and a
            # retry of record_transactions isn't silently a no-op
            try:
                self._on_delta(update)
            except BaseException:
                for sar in consumed:
                    self._unconsumed[sar.ref] = sar.state
                    self._consumed.pop(sar.ref, None)
                for sar in produced:
                    self._unconsumed.pop(sar.ref, None)
                    self._recorded_at.pop(sar.ref, None)
                raise
            for cb in list(self.updates):
                _safe_notify(cb, update)

    def _on_delta(self, update: VaultUpdate) -> None:
        """Subclass hook: persist one vault delta (no-op in memory)."""

    @staticmethod
    def _is_relevant(ts: TransactionState, my_keys: set) -> bool:
        for participant in ts.data.participants:
            for leaf in comp.leaves_of(_owning_key_of(participant)):
                if leaf in my_keys:
                    return True
        return False

    # -- queries ------------------------------------------------------------

    def unconsumed_states(self, cls=None) -> list[StateAndRef]:
        out = []
        for ref, ts in self._unconsumed.items():
            if cls is None or isinstance(ts.data, cls):
                out.append(StateAndRef(ts, ref))
        return out

    def state_and_ref(self, ref: StateRef) -> Optional[StateAndRef]:
        """Look up one unconsumed state by ref (None if spent/unknown)."""
        ts = self._unconsumed.get(ref)
        return StateAndRef(ts, ref) if ts is not None else None

    def consumed_states(self, cls=None) -> list[StateAndRef]:
        return [
            StateAndRef(ts, ref)
            for ref, ts in self._consumed.items()
            if cls is None or isinstance(ts.data, cls)
        ]

    # -- query DSL ----------------------------------------------------------

    def _query_rows(self):
        from .vault_query import CONSUMED, UNCONSUMED, row_of

        rows = []
        for ref, ts in self._unconsumed.items():
            rows.append(
                row_of(
                    StateAndRef(ts, ref),
                    UNCONSUMED,
                    self._recorded_at.get(ref, 0),
                )
            )
        for ref, ts in self._consumed.items():
            rows.append(
                row_of(
                    StateAndRef(ts, ref),
                    CONSUMED,
                    self._recorded_at.get(ref, 0),
                )
            )
        return rows

    def query_by(self, criteria, paging=None, sorting=None):
        """VaultService.queryBy (VaultService.kt:157): criteria AST →
        Page. The in-memory vault evaluates criteria as predicates; the
        persistent vault compiles the same AST to SQL."""
        from .vault_query import PageSpecification, Sort, run_in_memory

        return run_in_memory(
            self._query_rows(),
            criteria,
            paging or PageSpecification(),
            sorting or Sort(),
        )

    def track_by(self, criteria, paging=None, sorting=None) -> "DataFeed":
        """VaultService.trackBy: consistent snapshot + stream of future
        updates whose states match the criteria."""
        snapshot = self.query_by(criteria, paging, sorting)
        feed = Observable()

        def on_update(update: VaultUpdate) -> None:
            from .vault_query import UNCONSUMED, row_of

            now = self._services.clock.now_micros()
            # Consumed states are matched as if still live: the feed
            # reports consumption of states that were IN the tracked
            # set (reference trackBy semantics) — projecting them as
            # CONSUMED would always fail status=UNCONSUMED criteria.
            consumed = [
                s
                for s in update.consumed
                if criteria.matches(row_of(s, UNCONSUMED, now))
            ]
            produced = [
                s
                for s in update.produced
                if criteria.matches(row_of(s, UNCONSUMED, now))
            ]
            if consumed or produced:
                feed.emit(VaultUpdate(consumed, produced))

        self.updates.append(on_update)
        return DataFeed(
            snapshot,
            feed,
            dispose=lambda: (
                self.updates.remove(on_update)
                if on_update in self.updates
                else None
            ),
        )

    # -- coin selection -----------------------------------------------------

    def unconsumed_states_for_spending(
        self,
        amount_quantity: int,
        lock_id: bytes,
        cls=None,
        predicate: Callable[[TransactionState], bool] = lambda ts: True,
        quantity_of: Callable[[TransactionState], int] = None,
    ) -> list[StateAndRef]:
        """Greedy coin selection with soft-locking (reference:
        NodeVaultService.unconsumedStatesForSpending)."""
        if quantity_of is None:
            quantity_of = lambda ts: ts.data.amount.quantity  # noqa: E731
        picked, total = [], 0
        for ref, ts in sorted(
            self._unconsumed.items(), key=lambda kv: str(kv[0])
        ):
            if cls is not None and not isinstance(ts.data, cls):
                continue
            # ANY live lock excludes the coin — including this flow's
            # own: a second spend in the same flow must not re-select
            # coins its first spend already committed to (replay never
            # re-selects, it reuses the journaled picks, so self-lock
            # re-selection is never needed)
            if self._soft_locks.get(ref) is not None:
                continue
            if not predicate(ts):
                continue
            picked.append(StateAndRef(ts, ref))
            total += quantity_of(ts)
            if total >= amount_quantity:
                break
        if total < amount_quantity:
            # nothing to release: the picked coins were never locked,
            # and dropping the whole lock_id here would free an EARLIER
            # spend's in-flight locks in the same flow
            raise InsufficientBalanceError(amount_quantity - total)
        for sar in picked:
            self._soft_locks[sar.ref] = lock_id
        return picked

    def release_soft_locks(self, lock_id: bytes) -> None:
        self._soft_locks = {
            r: l for r, l in self._soft_locks.items() if l != lock_id
        }

    def soft_lock(self, refs: Iterable[StateRef], lock_id: bytes) -> None:
        """Re-assert locks over a journaled coin selection after a
        checkpoint replay (locks are process-local; the selection itself
        is journaled so replay never re-runs it — see finance/cash.py)."""
        for ref in refs:
            if ref in self._unconsumed:
                self._soft_locks[ref] = lock_id


class InsufficientBalanceError(Exception):
    def __init__(self, shortfall: int):
        self.shortfall = shortfall
        super().__init__(f"short {shortfall} units")


# Registered with the canonical codec so a journaled selection failure
# replays after restart with its attributes intact (statemachine.py
# record() error journaling).
ser.register_custom(
    InsufficientBalanceError,
    "InsufficientBalanceError",
    lambda e: e.shortfall,
    lambda v: InsufficientBalanceError(v),
)


def _owning_key_of(participant):
    """Participants may be keys or parties."""
    return getattr(participant, "owning_key", participant)


# ---------------------------------------------------------------------------
# transaction verifier service (the offload seam)


class _Future:
    """Tiny synchronous future (the SPI is future-shaped so the out-of-
    process pool in Phase 4 can slot in: OutOfProcessTransaction-
    VerifierService.kt:19-73). Completion is condition-signalled so a
    pump-less waiter parks on `wait(timeout)` and wakes the instant the
    pump thread resolves it — no polling sleep in the await loop."""

    def __init__(self):
        self._cond = locks.make_condition("_Future._cond")
        self._done = False
        self._exc: Optional[BaseException] = None

    def set_result(self) -> None:
        with self._cond:
            self._done = True
            self._cond.notify_all()

    def set_exception(self, exc: BaseException) -> None:
        with self._cond:
            self._exc = exc
            self._done = True
            self._cond.notify_all()

    @property
    def done(self) -> bool:
        return self._done

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until resolved (or `timeout` seconds); True when the
        future completed. The completing thread notifies, so there is
        no busy-wait — pump-owning callers keep pumping instead (the
        pump itself delivers the completion)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._done, timeout)

    def result(self) -> None:
        if not self._done:
            raise RuntimeError("verification still pending")
        if self._exc is not None:
            raise self._exc


class TransactionVerifierService:
    """SPI: verify(ltx) -> future (reference: core/.../node/services/
    TransactionVerifierService.kt:9-15)."""

    # True when verify()'s future is already resolved on return (the
    # in-memory service). Async implementations (the out-of-process
    # pool) resolve via the message pump — a caller ON the pump thread
    # (the batching notary's flush) must not block on them.
    synchronous = False

    def verify(self, ltx: LedgerTransaction) -> _Future:
        raise NotImplementedError

    def verify_many(self, ltxs: list[LedgerTransaction]) -> list[_Future]:
        """Batch entry point (no reference analogue — its verification
        is per-tx on thread pools). Implementations that can check a
        whole batch in one pass override this; the default preserves
        per-tx dispatch semantics."""
        return [self.verify(ltx) for ltx in ltxs]


class InMemoryTransactionVerifierService(TransactionVerifierService):
    """Runs contract verification inline (reference: InMemoryTransaction-
    VerifierService.kt:10-14 — thread pool there; synchronous here, the
    fabric pump provides concurrency)."""

    synchronous = True
    # the notary's object-less fast sweep may bypass this service:
    # verify_many below IS the same grouped contract sweep, so the
    # decisions are identical and no custom SPI is being skipped
    fast_sweep_ok = True

    def verify(self, ltx: LedgerTransaction) -> _Future:
        f = _Future()
        try:
            ltx.verify()
            f.set_result()
        except Exception as e:
            f.set_exception(e)
        return f

    def verify_many(self, ltxs: list[LedgerTransaction]) -> list[_Future]:
        """One grouped-by-contract pass over the whole batch
        (core/batch_verify.py) — the notary flush's contract phase."""
        from ..core.batch_verify import verify_ledger_batch

        futs = []
        for err in verify_ledger_batch(ltxs):
            f = _Future()
            if err is None:
                f.set_result()
            else:
                f.set_exception(err)
            futs.append(f)
        return futs


# ---------------------------------------------------------------------------
# the hub


class ServiceHub:
    """Facade over every node service (ServiceHub.kt:45-60)."""

    def __init__(
        self,
        my_info: NodeInfo,
        key_management: KeyManagementService,
        identity: IdentityService,
        network_map_cache: Optional[NetworkMapCache] = None,
        clock: Optional[Clock] = None,
        batch_verifier: Optional[BatchSignatureVerifier] = None,
        db=None,
        validated_transactions: Optional[TransactionStorage] = None,
        attachments: Optional[AttachmentStorage] = None,
        checkpoint_storage: Optional[CheckpointStorage] = None,
        vault_factory: Optional[Callable[["ServiceHub"], VaultService]] = None,
    ):
        self.my_info = my_info
        self.key_management = key_management
        self.identity = identity
        self.network_map_cache = network_map_cache or NetworkMapCache()
        self.clock = clock or Clock()
        if self.network_map_cache.clock_fn is None:
            self.network_map_cache.clock_fn = self.clock.now_micros
        self.db = db   # NodeDatabase for persistent hubs, else None
        self.validated_transactions = (
            validated_transactions or TransactionStorage()
        )
        self.attachments = attachments or AttachmentStorage()
        self.checkpoint_storage = checkpoint_storage or CheckpointStorage()
        self.vault = (vault_factory or VaultService)(self)
        self.transaction_verifier = InMemoryTransactionVerifierService()
        self._batch_verifier = batch_verifier
        # @corda_service instances, filled by cordapp.install_cordapp_services
        self.cordapp_services: dict = {}

    @property
    def batch_verifier(self) -> BatchSignatureVerifier:
        """The signature-verification SPI for this node (the port's
        default_verifier(), on the card, unless one was passed)."""
        return self._batch_verifier or default_verifier()

    def cordapp_service(self, cls):
        """This node's instance of a @corda_service class (reference:
        ServiceHub.cordaService(Class), AbstractNode.kt:226-279)."""
        svc = self.cordapp_services.get(cls)
        if svc is None:
            raise KeyError(
                f"no @corda_service {cls.__name__} installed on this node"
            )
        return svc

    # -- recording ----------------------------------------------------------

    def record_transactions(self, stxs: Iterable[SignedTransaction]) -> None:
        """Store validated transactions + notify the vault (reference:
        ServiceHub.recordTransactions -> NodeVaultService.notifyAll).
        On a persistent hub the whole record — tx rows, vault rows, and
        any checkpoints written by observers resuming waiting flows —
        lands in ONE database transaction, so a crash can never leave a
        stored tx whose vault effects are missing."""
        import contextlib

        ctx = self.db.transaction() if self.db else contextlib.nullcontext()
        with ctx:
            for stx in stxs:
                if self.validated_transactions.add_quiet(stx):
                    try:
                        self.vault.notify(stx.wtx)
                    except BaseException:
                        # disk failure: unwind memory too, so a retry
                        # re-runs the whole record instead of no-opping
                        self.validated_transactions._forget(stx.id)
                        raise
                    self.validated_transactions.fire_observers(stx)

    # -- resolution ---------------------------------------------------------

    def resolve_transaction(self, wtx: WireTransaction) -> LedgerTransaction:
        """WireTransaction -> LedgerTransaction: resolve input refs from
        storage, signers to parties, attachment ids to blobs
        (WireTransaction.toLedgerTransaction, WireTransaction.kt:60)."""
        return self._ledger_tx_from_resolved(
            wtx, self._resolve_input_states(wtx)
        )

    def _resolve_input_states(self, wtx: WireTransaction) -> list:
        """Input StateRefs -> their TransactionStates, from storage."""
        txs_get = self.validated_transactions.get
        resolved = []
        for ref in wtx.inputs:
            stx = txs_get(ref.txhash)
            if stx is None:
                raise TransactionResolutionError(ref.txhash)
            outs = stx.wtx.outputs
            if ref.index >= len(outs):
                raise TransactionResolutionError(ref.txhash)
            resolved.append(outs[ref.index])
        return resolved

    def _ledger_tx_from_resolved(
        self, wtx: WireTransaction, resolved_states: list
    ) -> LedgerTransaction:
        inputs = [
            StateAndRef(ts, ref)
            for ts, ref in zip(resolved_states, wtx.inputs)
        ]
        party_from_key = self.identity.party_from_key
        commands = []
        for cmd in wtx.commands:
            signers = cmd.signers
            parties = [
                p for p in map(party_from_key, signers) if p is not None
            ]
            commands.append(
                CommandWithParties(signers, tuple(parties), cmd.value)
            )
        attachments = []
        for att_id in wtx.attachments:
            att = self.attachments.open_attachment(att_id)
            if att is None:
                raise AttachmentResolutionError(att_id)
            attachments.append(att)
        return LedgerTransaction(
            inputs=tuple(inputs),
            outputs=wtx.outputs,
            commands=tuple(commands),
            attachments=tuple(attachments),
            notary=wtx.notary,
            time_window=wtx.time_window,
            id=wtx.id,
        )

    def resolve_verify_batch(self, stxs: list, spi=None) -> tuple:
        """Batched resolution + contract verification — the notary
        flush's host hot path (round-4 verdict #1). Returns
        (errs, deferred): one entry per transaction — None on
        acceptance or the exception the resolve-then-verify path would
        raise — plus {index: LedgerTransaction} for transactions whose
        (peer-supplied, sandboxed) attachment code must not run until
        their signatures are known-good.

        The OBJECT-LESS fast path: a transaction with no attachments,
        no replacement command, and every touched contract registered
        with a `verify_fields` hook is resolved and checked straight
        from its wire pieces — no StateAndRef / CommandWithParties /
        LedgerTransaction is ever built. That construction was ~11 of
        the ~35 us/tx serving cost at depth 16384, for objects the
        asset sweep immediately re-flattened into field lists.
        Decision AND message identity with the LedgerTransaction path
        is fuzz-checked in tests/test_batch_verify.py.

        `spi`: a SYNCHRONOUS TransactionVerifierService to honour for
        the non-fast transactions (the notary's SPI seam). The fast
        path bypasses it only when the service opts in
        (`fast_sweep_ok`, set by the in-memory service whose
        verify_many is the same grouped sweep)."""
        from ..core.batch_verify import (
            uses_attachment_code,
            verify_ledger_batch,
        )
        from ..core.contracts import ContractViolation, contract_by_name
        from ..core.replacement import has_replacement_command

        errs: list = [None] * len(stxs)
        deferred: dict[int, LedgerTransaction] = {}
        ltxs: list[LedgerTransaction] = []
        ltx_idx: list[int] = []
        allow_fast = spi is None or getattr(spi, "fast_sweep_ok", False)
        handlers: dict[str, Any] = {}   # contract name -> hook | None
        resolve_inputs = self._resolve_input_states
        for i, stx in enumerate(stxs):
            wtx = stx.wtx
            try:
                resolved = resolve_inputs(wtx)
            except Exception as e:   # noqa: BLE001 - per-tx outcome
                errs[i] = e
                continue
            outputs = wtx.outputs
            commands = wtx.commands
            names = None
            fast = (
                allow_fast
                and not wtx.attachments
                and not has_replacement_command(commands)
            )
            if fast:
                nameset = {ts.contract for ts in outputs}
                nameset.update(ts.contract for ts in resolved)
                names = sorted(nameset)
                for name in names:
                    hook = handlers.get(name, False)
                    if hook is False:
                        try:
                            hook = getattr(
                                contract_by_name(name), "verify_fields",
                                None,
                            )
                        except ContractViolation:
                            hook = None   # attachment-carried contract
                        handlers[name] = hook
                    if hook is None:
                        fast = False
                        break
            if fast:
                in_datas = [ts.data for ts in resolved]
                out_datas = [ts.data for ts in outputs]
                try:
                    # sorted-name order, first failure wins — exactly
                    # LedgerTransaction.verify's contract order
                    for name in names:
                        handlers[name](commands, in_datas, out_datas)
                except Exception as e:   # noqa: BLE001 - per-tx outcome
                    errs[i] = e
                continue
            try:
                ltx = self._ledger_tx_from_resolved(wtx, resolved)
            except Exception as e:   # noqa: BLE001 - per-tx outcome
                errs[i] = e
                continue
            if uses_attachment_code(ltx):
                deferred[i] = ltx
            else:
                ltxs.append(ltx)
                ltx_idx.append(i)
        if ltxs:
            if spi is not None:
                for i, fut in zip(ltx_idx, spi.verify_many(ltxs)):
                    try:
                        fut.result()
                    except Exception as e:   # noqa: BLE001 - per-tx
                        errs[i] = e
            else:
                for i, e in zip(ltx_idx, verify_ledger_batch(ltxs)):
                    errs[i] = e
        return errs, deferred

    # -- signing ------------------------------------------------------------

    def sign_initial_transaction(self, builder, *keys) -> SignedTransaction:
        """Build + sign with our keys (default: legal identity key)."""
        wtx = builder.to_wire_transaction()
        use = list(keys) or [self.my_info.legal_identity.owning_key]
        sigs = tuple(self.key_management.sign(wtx.id, k) for k in use)
        return SignedTransaction(wtx, sigs)

    def add_signature(self, stx: SignedTransaction, key=None) -> SignedTransaction:
        k = key or self.my_info.legal_identity.owning_key
        return stx.with_additional_signature(
            self.key_management.sign(stx.id, k)
        )


class TransactionResolutionError(TransactionVerificationError):
    def __init__(self, tx_id):
        self.tx_id = tx_id
        super().__init__(f"cannot resolve {tx_id}")


class AttachmentResolutionError(TransactionVerificationError):
    def __init__(self, att_id):
        self.att_id = att_id
        super().__init__(f"missing attachment {att_id}")
