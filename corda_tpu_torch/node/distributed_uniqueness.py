"""Distributed sharded uniqueness across notary cluster members.

Port of corda_tpu/node/distributed_uniqueness.py: the wire messages,
`ShardMap`, `XShardPolicy` with its seeded jittered backoff, and
`DistributedUniquenessProvider` — coordinator, participant, `tick`,
`recover`, the raft replication seam (`partition_apply`, with
raft.partition_raft_groups), the health rules (`attach_health`), the
QoS cross-shard lane (`qos.record_xshard`) and the lifecycle ledger
(`txstory`). Frames, journal rows and decision logs are the
reference's: given the same seed, clock and fabric schedule, every
`TOPIC_XSHARD` frame is byte-equal. Signature verification never runs
here: a member's batching notary verifies on its hub's batch verifier
(on the card, CudaBatchVerifier) before it commits through this
provider.

The in-process sharded plane (notary.py ShardedUniquenessProvider:
per-partition conditions, deterministic ascending-order two-phase
reserve→commit) partitions the commit plane INSIDE one node. This
module partitions the state-ref space ACROSS cluster members — a
static ownership map (`ShardMap`, computable by every member from
configuration alone) routes every ref to exactly one owning member —
and generalises the in-process reserve→commit to fabric messages on
`messaging.TOPIC_XSHARD`:

    ShardReserve  -> ShardReserveAck (ok | busy | conflict)
    ShardCommit   -> ShardCommitAck
    ShardAbort
    ShardStatusQuery -> ShardStatusReply   (presumed-abort recovery)

Robustness is the headline, not the message shapes:

  * The coordinator journals every cross-MEMBER intent in a durable
    presumed-abort WAL (persistence.XShardCoordinatorJournal) BEFORE
    the first reserve leaves the process, marks the commit decision
    durably BEFORE any ShardCommit is sent (the 2PC commit point), and
    drives a resumable state machine with per-phase timeouts and
    capped exponential backoff with seeded jitter.
  * Reserves acquire partitions in ascending partition order, one
    partition at a time, and a participant answers each reserve
    all-or-nothing (every ref of the message reserved, or none) — the
    hierarchical-ordering argument that makes the in-process provider
    deadlock-free carries over to the fabric: a transaction only ever
    waits (busy-retries) on a partition strictly above everything it
    holds.
  * A participant holding an orphaned reservation (its TTL expired —
    the coordinator went quiet) queries the coordinator, or whatever
    restarted over the coordinator's WAL, and resolves: "commit"
    applies the rows, "abort" (including the presumed abort a missing
    WAL row implies) releases them. Participant reservations are
    themselves journaled (persistence.XShardReservationJournal) so a
    kill -9 mid-reserve reloads the holds instead of opening a silent
    double-spend window.
  * A partitioned/dead owner yields a typed answer — the coordinator
    gives up after the reserve-phase timeout and the request resolves
    with notary.ShardUnavailableError (a `shard-unavailable`
    NotaryError at the serving seam), never a hang: nothing the
    request reserved outlives it, and the `shard.unreachable` /
    `reservation.orphaned` health rules tell the operator why.

Accept/reject decisions stay bit-exact against a serial replay of the
decision log: a request is only ever rejected against a COMMITTED
conflict (busy reservations are waited out via retry, exactly like the
in-process provider's condition waits), and the accept is recorded at
the durable commit decision — before any partition's rows become
visible to a later loser.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..core import serialization as ser
from ..core.contracts import StateRef
from ..core.identity import Party
from ..crypto.hashes import SecureHash
from ..flows.api import FlowFuture
from ..utils import locks
from ..utils.metrics import MetricRegistry
from .messaging import Message, MessagingService, TOPIC_XSHARD
from .notary import (
    ShardUnavailableError,
    ShardedUniquenessProvider,
    UniquenessConflict,
    UniquenessProvider,
    shard_of_ref,
)

# -- wire messages -----------------------------------------------------------


@ser.serializable
@dataclass(frozen=True)
class ShardReserve:
    """Phase one, one partition's slice: reserve `refs` (all owned by
    `partition`) for `tx_id`. All-or-nothing at the participant."""

    xid: int                 # coordinator-local transaction id
    tx_id: SecureHash
    partition: int
    refs: tuple              # StateRef, ...
    requester: Party
    coordinator: str         # peer name answers go back to
    attempt: int = 0
    # probe mode: the transaction is already doomed by a conflict on an
    # earlier partition — the remaining partitions are visited ONLY to
    # complete the conflict REPORT (the in-process provider's full-set
    # contract): a probe never reserves and never answers busy
    probe: bool = False


RESERVE_OK = "ok"
RESERVE_BUSY = "busy"
RESERVE_CONFLICT = "conflict"


@ser.serializable
@dataclass(frozen=True)
class ShardReserveAck:
    xid: int
    tx_id: SecureHash
    partition: int
    owner: str
    status: str              # RESERVE_OK | RESERVE_BUSY | RESERVE_CONFLICT
    conflict: tuple = ()     # ((StateRef, consuming SecureHash), ...)


@ser.serializable
@dataclass(frozen=True)
class ShardCommit:
    """Phase two: flip `refs` (this owner's slice, any of its
    partitions) to committed rows. Idempotent — re-driven freely by a
    recovering coordinator."""

    xid: int
    tx_id: SecureHash
    refs: tuple
    requester: Party
    coordinator: str


@ser.serializable
@dataclass(frozen=True)
class ShardCommitAck:
    xid: int
    tx_id: SecureHash
    owner: str


@ser.serializable
@dataclass(frozen=True)
class ShardAbort:
    """Release `refs` reserved for `tx_id` (idempotent; loss is
    tolerated — the reservation TTL + status query path cleans up)."""

    xid: int
    tx_id: SecureHash
    refs: tuple
    coordinator: str


@ser.serializable
@dataclass(frozen=True)
class ShardStatusQuery:
    """Participant -> coordinator: what happened to `tx_id`? Sent for
    reservations whose TTL expired (the orphan path)."""

    tx_id: SecureHash
    owner: str               # where the reply goes


DECISION_COMMIT = "commit"
DECISION_ABORT = "abort"
DECISION_PENDING = "pending"


@ser.serializable
@dataclass(frozen=True)
class ShardStatusReply:
    tx_id: SecureHash
    decision: str            # DECISION_COMMIT | DECISION_ABORT | DECISION_PENDING


# -- ownership map -----------------------------------------------------------


class ShardMap:
    """Static partition -> owner assignment over the cluster members.

    Partitioning reuses `shard_of_ref` (state-ref prefix mod
    n_partitions — pure, restart-stable, the same function the
    in-process plane routes by); partition k is owned by member
    `members[k % len(members)]`, so every member can compute the whole
    map from configuration alone and the network map never has to
    carry per-ref routing state. `snapshot()` is the ownership half of
    `DistributedUniquenessProvider.shards_snapshot`."""

    def __init__(self, members, n_partitions: int):
        if not members:
            raise ValueError("ShardMap needs at least one member")
        self.members = tuple(members)
        self.n_partitions = max(1, int(n_partitions))

    def partition_of(self, ref: StateRef) -> int:
        return shard_of_ref(ref, self.n_partitions)

    def owner_of_partition(self, partition: int) -> str:
        return self.members[partition % len(self.members)]

    def owner_of(self, ref: StateRef) -> str:
        return self.owner_of_partition(self.partition_of(ref))

    def partitions_of(self, member: str) -> tuple:
        return tuple(
            k for k in range(self.n_partitions)
            if self.owner_of_partition(k) == member
        )

    def snapshot(self) -> dict:
        return {
            "members": list(self.members),
            "n_partitions": self.n_partitions,
            "partitions": [
                {"partition": k, "owner": self.owner_of_partition(k)}
                for k in range(self.n_partitions)
            ],
        }


# -- policy ------------------------------------------------------------------


@dataclass(frozen=True)
class XShardPolicy:
    """Timeout/backoff knobs for the cross-member protocol (config:
    notary_xshard_timeout_micros / notary_xshard_backoff)."""

    # reserve-phase silence bound: no ack (ok/busy/conflict) from the
    # partition owner within this window -> the owner is unreachable
    # and the request answers `shard-unavailable`. Any ack re-arms it.
    timeout_micros: int = 2_000_000
    # capped exponential resend/retry backoff, with seeded jitter
    backoff_base_micros: int = 50_000
    backoff_cap_micros: int = 1_000_000
    # participant reservation TTL: a hold older than this with no
    # resolution is an ORPHAN and starts querying its coordinator
    reservation_ttl_micros: int = 4_000_000

    def backoff(self, attempt: int, rng: random.Random) -> int:
        """Capped exponential with jitter in [base/2, base] — seeded,
        so chaos runs replay deterministically."""
        base = min(
            self.backoff_cap_micros,
            self.backoff_base_micros * (1 << min(attempt, 16)),
        )
        half = max(1, base // 2)
        return half + rng.randrange(half + 1)


# -- internal state ----------------------------------------------------------

_RESERVING = "reserving"
_COMMITTING = "committing"


class _XTxn:
    """One coordinated cross-shard transaction's resumable state."""

    __slots__ = (
        "xid", "tx_id", "refs", "requester", "future", "waiters", "trace",
        "span", "journaled", "parts", "idx", "attempt", "waiting_remote",
        "phase_started", "next_send", "state", "pending_owners",
        "owner_refs", "owner_attempt", "owner_next_send", "started",
        "decided_at", "conflict", "doomed_at",
    )

    def __init__(self, xid, tx_id, refs, requester, future, trace, parts,
                 now):
        self.xid = xid
        self.tx_id = tx_id
        self.refs = refs
        self.requester = requester
        self.future = future
        self.waiters: list = []       # same-tx re-commits piggyback
        self.trace = trace
        self.span = None
        self.journaled = False
        # [(partition, owner, [refs])] ascending partition order — THE
        # acquisition order (deadlock freedom rides on it)
        self.parts = parts
        self.idx = 0
        self.attempt = 0
        self.waiting_remote = False
        self.phase_started = now
        self.next_send = now
        self.state = _RESERVING
        self.pending_owners: set = set()
        self.owner_refs: dict = {}
        self.owner_attempt: dict = {}
        self.owner_next_send: dict = {}
        self.started = now
        self.decided_at: Optional[int] = None
        # full-conflict-report accumulation: first conflict dooms the
        # transaction at partition index `doomed_at` (everything below
        # it is reserved and must release); later partitions are
        # probed, not reserved, to complete the report
        self.conflict: dict = {}
        self.doomed_at: Optional[int] = None


class _Reservation:
    """One participant-side hold: every ref this member reserved for
    one transaction, plus the orphan-recovery bookkeeping."""

    __slots__ = (
        "tx_id", "xid", "coordinator", "refs", "requester", "expiry",
        "next_query", "query_attempt",
    )

    def __init__(self, tx_id, xid, coordinator, requester, expiry):
        self.tx_id = tx_id
        self.xid = xid
        self.coordinator = coordinator
        self.refs: set = set()
        self.requester = requester
        self.expiry = expiry
        self.next_query = expiry
        self.query_attempt = 0


# -- the provider ------------------------------------------------------------


class DistributedUniquenessProvider(UniquenessProvider):
    """Cluster-partitioned uniqueness: every member runs BOTH roles —
    coordinator for the requests its notary serves, participant for
    the partitions it owns. Single-threaded by contract: handlers,
    tick() and commit_async() all run on the node pump (snapshot
    readers go through the small state lock).

    `store` holds the local committed registry (a
    ShardedUniquenessProvider — the sqlite-backed subclass on real
    nodes, so commits are durable); only this member's owned
    partitions ever gain rows, unless per-partition raft groups
    replicate them (see `raft_groups`/`partition_apply`).

    `decision_log`: an optional shared append-only list; accepts and
    conflicts append (tx_id, conflict-or-None) at their true decision
    points, in execution order — the serial-replay assertion surface
    that exactly-one-winner is reconciled against.
    """

    batch_synchronous = False

    def __init__(
        self,
        name: str,
        members,
        messaging: MessagingService,
        clock,
        n_partitions: Optional[int] = None,
        store: Optional[ShardedUniquenessProvider] = None,
        journal=None,
        reservations=None,
        metrics: Optional[MetricRegistry] = None,
        tracer=None,
        qos=None,
        policy: Optional[XShardPolicy] = None,
        seed: int = 0,
        decision_log: Optional[list] = None,
        raft_groups: Optional[dict] = None,
    ):
        """`journal`: a persistence.XShardCoordinatorJournal (None =
        volatile coordinator — test rigs only; a real node always
        journals, or a crash mid-protocol strands participants until
        their presumed-abort query hits an empty-journal coordinator).
        `reservations`: a persistence.XShardReservationJournal making
        participant holds survive kill -9. `raft_groups`: optional
        {partition: RaftNode} — committed rows for an owned partition
        are additionally submitted to its group so followers hold a
        replica (raft.partition_raft_groups wires one group per
        partition; apply fns come from `partition_apply`)."""
        n = n_partitions if n_partitions is not None else len(tuple(members))
        self.name = name
        self.shard_map = ShardMap(members, n)
        self.messaging = messaging
        self.clock = clock
        self.store = store if store is not None else ShardedUniquenessProvider(
            self.shard_map.n_partitions
        )
        self.journal = journal
        self.reservations = reservations
        self.tracer = tracer
        self.qos = qos
        # transaction lifecycle ledger (utils/txstory.py): wired by
        # node.py / rigs — coordinator-side reserve/commit/abort and
        # participant-side orphan detection stamp per-tx events
        self.txstory = None
        self.policy = policy or XShardPolicy()
        self.rng = random.Random(seed)
        self.decisions = decision_log
        self.raft_groups = raft_groups or {}
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._lock = locks.make_lock(
            "DistributedUniquenessProvider._lock"
        )   # snapshot-vs-pump memory guard
        self._txns: dict[SecureHash, _XTxn] = {}        # coordinator
        self._res: dict[SecureHash, _Reservation] = {}  # participant
        self._ref_hold: dict[StateRef, SecureHash] = {}
        self._unreachable: dict[str, int] = {}          # owner -> since
        self._next_xid = 0
        self.stopped = False

        m = self.metrics
        self._c_reserves = m.counter("Notary.CrossShard.Reserves")
        self._c_commits = m.counter("Notary.CrossShard.Commits")
        self._c_aborts = m.counter("Notary.CrossShard.Aborts")
        self._c_conflicts = m.counter("Notary.CrossShard.Conflicts")
        self._c_retries = m.counter("Notary.CrossShard.Retries")
        self._c_unavailable = m.counter("Notary.CrossShard.Unavailable")
        self._c_recovered = m.counter("Notary.CrossShard.Recovered")
        self._c_orphan_queries = m.counter("Notary.CrossShard.OrphanQueries")
        self._c_orphans_resolved = m.counter(
            "Notary.CrossShard.OrphansResolved"
        )
        m.gauge("Notary.CrossShard.InFlight", lambda: len(self._txns))
        m.gauge("Notary.CrossShard.Reservations", lambda: len(self._ref_hold))
        m.gauge("Notary.CrossShard.Orphans", self.orphan_count)
        m.gauge(
            "Notary.CrossShard.UnreachableOwners",
            lambda: len(self._unreachable),
        )

        messaging.add_handler(TOPIC_XSHARD, self._on_message)

    # -- views ---------------------------------------------------------------

    @property
    def committed(self) -> dict:
        """This member's committed registry (its owned partitions, plus
        anything raft replication delivered)."""
        return self.store.committed

    def orphan_count(self) -> int:
        now = self.clock.now_micros()
        with self._lock:
            return sum(1 for r in self._res.values() if now >= r.expiry)

    def reservation_count(self) -> int:
        with self._lock:
            return len(self._ref_hold)

    def in_flight_count(self) -> int:
        return len(self._txns)

    def unreachable_owners(self) -> dict:
        with self._lock:
            return dict(self._unreachable)

    def shards_snapshot(self) -> dict:
        """The ownership map + this member's live reservation/orphan/
        commit depths (the reference serves it at GET /shards)."""
        now = self.clock.now_micros()
        with self._lock:
            holds = list(self._ref_hold)
            orphans = sum(1 for r in self._res.values() if now >= r.expiry)
            unreachable = sorted(self._unreachable)
        by_part: dict[int, int] = {}
        for ref in holds:
            k = self.shard_map.partition_of(ref)
            by_part[k] = by_part.get(k, 0) + 1
        out = self.shard_map.snapshot()
        local = set(self.shard_map.partitions_of(self.name))
        for row in out["partitions"]:
            k = row["partition"]
            row["local"] = k in local
            row["reservation_depth"] = by_part.get(k, 0)
            if k in local:
                row["committed_depth"] = self.store.partition_depth(k)
        out.update(
            member=self.name,
            reservation_depth=len(holds),
            orphan_count=orphans,
            in_flight=len(self._txns),
            unreachable_owners=unreachable,
            journal_unresolved=(
                self.journal.unresolved_count
                if self.journal is not None else 0
            ),
        )
        return out

    # -- raft replication seam ----------------------------------------------

    def partition_apply(self, partition: int) -> Callable:
        """The replicated state machine for one partition's raft group:
        every member's group instance applies committed rows into ITS
        store copy (idempotent writes, so the owner's direct write and
        its own apply coexist)."""

        def apply_fn(cmd):
            tag, tx_id, refs, requester = cmd
            if tag == "xcommit":
                self.store.write_partition(
                    partition, list(refs), tx_id, requester
                )
            return None

        return apply_fn

    def _replicate(self, partition: int, refs, tx_id, requester) -> None:
        group = self.raft_groups.get(partition)
        if group is not None:
            group.submit(("xcommit", tx_id, tuple(refs), requester))

    # -- health --------------------------------------------------------------

    def attach_health(self, monitor) -> None:
        """Register the `shard.unreachable` + `reservation.orphaned`
        rules (utils/health.watch_distributed_uniqueness)."""
        monitor.watch_distributed_uniqueness(self)

    # -- UniquenessProvider SPI ---------------------------------------------

    def commit(self, states, tx_id, requester) -> None:
        """Synchronous commit — valid only when every involved
        partition is locally owned (the all-local fast path resolves
        inline). Cross-member commits need the pump: use
        commit_async."""
        fut = self.commit_async(states, tx_id, requester)
        if not fut.done:
            raise RuntimeError(
                "cross-member commit cannot resolve synchronously — "
                "await commit_async on the pump"
            )
        fut.result()

    def commit_async(self, states, tx_id, requester, trace=None):
        fut = FlowFuture()
        now = self.clock.now_micros()
        existing = self._txns.get(tx_id)
        if existing is not None:
            # same-tx re-commit while the first drive is in flight
            # (intent-WAL replay racing the original): piggyback — one
            # protocol drive, every caller answered identically. A txn
            # already PAST its decision (committing/re-driving, where
            # _resolve has run and _finish never re-runs it) answers
            # the new caller NOW: the commit point is durable, which
            # IS the success contract — parking on waiters there would
            # strand the future forever.
            if existing.state == _COMMITTING:
                fut.set_result(None)
            else:
                existing.waiters.append(fut)
            return fut
        by_part: dict[int, list] = {}
        for ref in states:
            by_part.setdefault(self.shard_map.partition_of(ref), []).append(
                ref
            )
        parts = [
            (k, self.shard_map.owner_of_partition(k), by_part[k])
            for k in sorted(by_part)
        ]
        with self._lock:
            self._next_xid += 1
            xid = self._next_xid
        txn = _XTxn(xid, tx_id, list(states), requester, fut, trace, parts,
                    now)
        if self.tracer is not None and self.tracer.enabled and trace:
            txn.span = self.tracer.start_span(
                "xshard.reserve", trace,
                tx_id=str(tx_id), member=self.name,
                partitions=len(parts),
            )
        if self.txstory is not None:
            self.txstory.record(
                str(tx_id), "xshard.reserve",
                partitions=len(parts), coordinator=self.name,
            )
        remote = [p for p in parts if p[1] != self.name]
        if remote and self.journal is not None:
            # the WAL row lands BEFORE the first reserve leaves this
            # process: from here a coordinator crash replays the
            # transaction (commit-marked rows re-drive, unmarked rows
            # presumed-abort) instead of stranding participants
            txn.xid = self.journal.begin(tx_id, txn.refs, requester)
            txn.journaled = True
        self._txns[tx_id] = txn
        self._advance(txn)
        return fut

    # -- coordinator ---------------------------------------------------------

    def _advance(self, txn: _XTxn) -> None:
        """Drive the reserve phase: acquire partitions in ascending
        order — local ones inline, the first remote one by message
        (then wait for its ack). A conflict dooms the transaction but
        the remaining partitions are still PROBED (no reservation, no
        busy-wait) so the requester gets the FULL conflict set, the
        in-process provider's contract. Reaching the end decides
        commit — or aborts with the accumulated conflicts."""
        now = self.clock.now_micros()
        while txn.idx < len(txn.parts):
            partition, owner, refs = txn.parts[txn.idx]
            doomed = txn.doomed_at is not None
            if owner == self.name:
                if doomed:
                    for ref in refs:
                        prior = self.store.prior_consumer(partition, ref)
                        if prior is not None and prior != txn.tx_id:
                            txn.conflict[ref] = prior
                    txn.idx += 1
                    continue
                status, conflict = self._reserve_local(
                    partition, refs, txn.tx_id, txn.xid, self.name,
                    txn.requester,
                )
                if status == RESERVE_OK:
                    txn.idx += 1
                    txn.attempt = 0
                    continue
                if status == RESERVE_CONFLICT:
                    txn.conflict.update(conflict)
                    txn.doomed_at = txn.idx
                    txn.idx += 1
                    txn.attempt = 0
                    continue
                # busy on a local hold: retry after backoff (the holder
                # resolves within bounded time — commit, abort or the
                # orphan path)
                txn.next_send = now + self.policy.backoff(
                    txn.attempt, self.rng
                )
                txn.attempt += 1
                txn.waiting_remote = False
                self._c_retries.inc()
                return
            self._send_reserve(txn, partition, owner, refs, now, fresh=True)
            return
        if txn.doomed_at is not None:
            self._abort(txn, txn.conflict)
            return
        self._decide_commit(txn)

    def _send_reserve(self, txn, partition, owner, refs, now,
                      fresh: bool = False) -> None:
        txn.waiting_remote = True
        if fresh:
            # the silence window opens at the FIRST send of this step;
            # resends must not re-arm it (only a real ack does), or a
            # dead owner would never time out
            txn.phase_started = now
        txn.next_send = now + self.policy.backoff(txn.attempt, self.rng)
        self._c_reserves.inc()
        self._send(
            owner,
            ShardReserve(
                txn.xid, txn.tx_id, partition, tuple(refs),
                txn.requester, self.name, txn.attempt,
                probe=txn.doomed_at is not None,
            ),
            trace=txn.trace,
        )

    def _on_reserve_ack(self, m: ShardReserveAck) -> None:
        self._mark_reachable(m.owner)
        txn = self._txns.get(m.tx_id)
        if txn is None or txn.state != _RESERVING or not txn.waiting_remote:
            return
        partition, _owner, _refs = txn.parts[txn.idx]
        if m.partition != partition:
            return   # stale ack from an earlier (resent) step
        now = self.clock.now_micros()
        txn.phase_started = now   # the owner is alive: re-arm the timeout
        if m.status == RESERVE_OK:
            txn.idx += 1
            txn.attempt = 0
            txn.waiting_remote = False
            self._advance(txn)
        elif m.status == RESERVE_BUSY:
            # contended, not conflicted: the holder resolves soon —
            # capped exponential retry with seeded jitter
            txn.attempt += 1
            txn.next_send = now + self.policy.backoff(txn.attempt, self.rng)
            self._c_retries.inc()
        else:
            # doomed — but keep walking the remaining partitions (as
            # probes) so the abort reports the FULL conflict set
            txn.conflict.update(
                {ref: consumer for ref, consumer in m.conflict}
            )
            if txn.doomed_at is None:
                txn.doomed_at = txn.idx
            txn.idx += 1
            txn.attempt = 0
            txn.waiting_remote = False
            self._advance(txn)

    def _decide_commit(self, txn: _XTxn) -> None:
        """All partitions reserved: THE commit point. The decision is
        made durable (journal) and recorded (decision log) BEFORE any
        partition's rows flip — a later loser can only observe (and
        record its conflict against) this transaction after this
        append, so the log stays in true serialisation order."""
        now = self.clock.now_micros()
        if txn.journaled:
            self.journal.decide_commit(txn.xid)
        self._record(txn.tx_id, None)
        self._c_commits.inc()
        txn.state = _COMMITTING
        txn.decided_at = now
        by_owner: dict[str, list] = {}
        for partition, owner, refs in txn.parts:
            by_owner.setdefault(owner, []).extend(refs)
        for owner, refs in by_owner.items():
            if owner == self.name:
                self._apply_commit(txn.tx_id, refs, txn.requester)
            else:
                txn.pending_owners.add(owner)
                txn.owner_refs[owner] = list(refs)
                txn.owner_attempt[owner] = 0
                txn.owner_next_send[owner] = now + self.policy.backoff(
                    0, self.rng
                )
                self._send(
                    owner,
                    ShardCommit(
                        txn.xid, txn.tx_id, tuple(refs), txn.requester,
                        self.name,
                    ),
                    trace=txn.trace,
                )
        if txn.span is not None:
            txn.span.add_event("decided", decision=DECISION_COMMIT)
            txn.span.end()
            txn.span = self.tracer.start_span(
                "xshard.commit", txn.trace,
                tx_id=str(txn.tx_id), member=self.name,
                owners=len(txn.pending_owners),
            )
        if self.txstory is not None:
            # the 2PC commit point (the WAL mark is durable): every
            # acquired partition will apply this commit
            self.txstory.record(
                str(txn.tx_id), "xshard.commit",
                owners=len(txn.pending_owners), coordinator=self.name,
            )
        self._resolve(txn, None)
        if not txn.pending_owners:
            self._finish(txn)

    def _on_commit_ack(self, m: ShardCommitAck) -> None:
        self._mark_reachable(m.owner)
        txn = self._txns.get(m.tx_id)
        if txn is None or txn.state != _COMMITTING:
            return
        txn.pending_owners.discard(m.owner)
        if not txn.pending_owners:
            self._finish(txn)

    def _finish(self, txn: _XTxn) -> None:
        if txn.journaled:
            self.journal.finish(txn.xid)
        if txn.span is not None:
            txn.span.end()
            txn.span = None
        self._txns.pop(txn.tx_id, None)
        # belt and braces: a waiter that slipped in after the decision
        # resolved must not outlive the txn unanswered
        for fut in txn.waiters:
            if fut is not None and not getattr(fut, "done", False):
                fut.set_result(None)
        txn.waiters = []

    def _abort(self, txn: _XTxn, conflict: dict) -> None:
        """Reserve-phase conflict: release everything acquired so far
        (partitions strictly below the conflicted one), record the
        loss, answer the requester. Presumed abort: the WAL row is
        simply deleted — recovery of a row without the commit mark
        re-sends the aborts anyway."""
        self._release_acquired(txn)
        self._record(txn.tx_id, conflict)
        self._c_aborts.inc()
        self._c_conflicts.inc()
        if self.txstory is not None:
            self.txstory.record(
                str(txn.tx_id), "xshard.abort",
                conflicts=len(conflict), coordinator=self.name,
            )
        if txn.journaled:
            self.journal.finish(txn.xid)
        if txn.span is not None:
            txn.span.add_event("decided", decision=DECISION_ABORT)
            txn.span.end()
            txn.span = None
        if self.tracer is not None and self.tracer.enabled and txn.trace:
            s = self.tracer.start_span(
                "xshard.abort", txn.trace,
                tx_id=str(txn.tx_id), member=self.name,
            )
            s.end()
        self._txns.pop(txn.tx_id, None)
        self._resolve(txn, UniquenessConflict(dict(conflict)))

    def _unavailable(self, txn: _XTxn, owner: str, partition: int) -> None:
        """Reserve-phase timeout: the owner never answered. Give up —
        release what was acquired, answer a typed degraded error. The
        request holds nothing afterwards (any reserve the dead owner
        DID apply resolves through its orphan query against our now
        row-less journal: presumed abort)."""
        now = self.clock.now_micros()
        with self._lock:
            self._unreachable.setdefault(owner, now)
        self._release_acquired(txn)
        self._c_unavailable.inc()
        if self.txstory is not None:
            self.txstory.record(
                str(txn.tx_id), "xshard.unavailable",
                owner=owner, partition=partition,
            )
        if txn.journaled:
            self.journal.finish(txn.xid)
        if txn.span is not None:
            txn.span.add_event("unavailable", owner=owner)
            txn.span.end()
            txn.span = None
        self._txns.pop(txn.tx_id, None)
        self._resolve(
            txn,
            ShardUnavailableError(
                owner, (partition,), now - txn.started
            ),
        )

    def _release_acquired(self, txn: _XTxn) -> None:
        # only partitions ACQUIRED before the doom point hold anything
        # (probed partitions reserved nothing)
        upto = txn.doomed_at if txn.doomed_at is not None else txn.idx
        by_owner: dict[str, list] = {}
        for partition, owner, refs in txn.parts[:upto]:
            by_owner.setdefault(owner, []).extend(refs)
        for owner, refs in by_owner.items():
            if owner == self.name:
                self._release_local(txn.tx_id, refs)
            else:
                self._send(
                    owner,
                    ShardAbort(txn.xid, txn.tx_id, tuple(refs), self.name),
                    trace=txn.trace,
                )

    def _resolve(self, txn: _XTxn, outcome) -> None:
        now = self.clock.now_micros()
        if self.qos is not None and hasattr(self.qos, "record_xshard"):
            self.qos.record_xshard(now - txn.started)
        futures = [txn.future] + txn.waiters
        txn.waiters = []
        for fut in futures:
            if fut is None or getattr(fut, "done", False):
                continue
            if outcome is None:
                fut.set_result(None)
            elif isinstance(outcome, Exception):
                fut.set_exception(outcome)
        txn.future = None

    def _record(self, tx_id, conflict) -> None:
        if self.decisions is not None:
            self.decisions.append((tx_id, conflict))

    # -- participant ---------------------------------------------------------

    def _reserve_local(self, partition, refs, tx_id, xid, coordinator,
                       requester):
        """All-or-nothing reserve of one partition's refs. Returns
        (status, conflict-dict). Used directly for locally-owned
        partitions and by the ShardReserve handler."""
        conflict = {}
        for ref in refs:
            prior = self.store.prior_consumer(partition, ref)
            if prior is not None and prior != tx_id:
                conflict[ref] = prior
        if conflict:
            return RESERVE_CONFLICT, conflict
        with self._lock:
            for ref in refs:
                holder = self._ref_hold.get(ref)
                if holder is not None and holder != tx_id:
                    return RESERVE_BUSY, {}
            res = self._res.get(tx_id)
            if res is None:
                res = _Reservation(
                    tx_id, xid, coordinator, requester,
                    self.clock.now_micros()
                    + self.policy.reservation_ttl_micros,
                )
                self._res[tx_id] = res
            res.refs.update(refs)
            res.expiry = (
                self.clock.now_micros() + self.policy.reservation_ttl_micros
            )
            for ref in refs:
                self._ref_hold[ref] = tx_id
            held = tuple(res.refs)
        if self.reservations is not None:
            # durable AFTER the memory state (and outside the lock —
            # sqlite never runs under the pump-hot lock): a crash
            # between the two loses only memory, which the row reload
            # reconstructs; a crash before either loses both, which is
            # a never-acked reserve the coordinator simply retries
            self.reservations.reserve(
                tx_id, xid, coordinator, held, requester
            )
        return RESERVE_OK, {}

    def _apply_commit(self, tx_id, refs, requester) -> None:
        by_part: dict[int, list] = {}
        for ref in refs:
            by_part.setdefault(self.shard_map.partition_of(ref), []).append(
                ref
            )
        for partition, prefs in by_part.items():
            self.store.write_partition(partition, prefs, tx_id, requester)
            self._replicate(partition, prefs, tx_id, requester)
        self._release_local(tx_id, refs)

    def _release_local(self, tx_id, refs=None) -> None:
        with self._lock:
            res = self._res.pop(tx_id, None)
            held = res.refs if res is not None else (refs or ())
            for ref in held:
                if self._ref_hold.get(ref) == tx_id:
                    del self._ref_hold[ref]
        if self.reservations is not None:
            self.reservations.release(tx_id)

    def _on_reserve(self, m: ShardReserve) -> None:
        if m.probe:
            # conflict-report completion for a doomed transaction:
            # check committed rows only — reserve nothing, never busy
            conflict = {}
            for ref in m.refs:
                prior = self.store.prior_consumer(m.partition, ref)
                if prior is not None and prior != m.tx_id:
                    conflict[ref] = prior
            status = RESERVE_CONFLICT if conflict else RESERVE_OK
        else:
            status, conflict = self._reserve_local(
                m.partition, m.refs, m.tx_id, m.xid, m.coordinator,
                m.requester,
            )
        self._send(
            m.coordinator,
            ShardReserveAck(
                m.xid, m.tx_id, m.partition, self.name, status,
                tuple((ref, consumer) for ref, consumer in conflict.items()),
            ),
        )

    def _on_commit(self, m: ShardCommit) -> None:
        self._apply_commit(m.tx_id, m.refs, m.requester)
        self._send(
            m.coordinator, ShardCommitAck(m.xid, m.tx_id, self.name)
        )

    def _on_abort(self, m: ShardAbort) -> None:
        self._release_local(m.tx_id, m.refs)

    def _on_status_query(self, m: ShardStatusQuery) -> None:
        txn = self._txns.get(m.tx_id)
        if txn is not None:
            decision = (
                DECISION_COMMIT if txn.state == _COMMITTING
                else DECISION_PENDING
            )
        elif self.journal is not None and self.journal.is_committed(m.tx_id):
            decision = DECISION_COMMIT
        else:
            # presumed abort: no live transaction, no commit-marked WAL
            # row — the reservation may be released
            decision = DECISION_ABORT
        self._send(m.owner, ShardStatusReply(m.tx_id, decision))

    def _on_status_reply(self, m: ShardStatusReply) -> None:
        with self._lock:
            res = self._res.get(m.tx_id)
            held = tuple(res.refs) if res is not None else ()
            requester = res.requester if res is not None else None
        if res is None:
            return
        if m.decision == DECISION_COMMIT:
            self._apply_commit(m.tx_id, held, requester)
            self._c_orphans_resolved.inc()
        elif m.decision == DECISION_ABORT:
            self._release_local(m.tx_id)
            self._c_orphans_resolved.inc()
        else:
            with self._lock:
                if m.tx_id in self._res:
                    self._res[m.tx_id].expiry = (
                        self.clock.now_micros()
                        + self.policy.reservation_ttl_micros
                    )

    # -- dispatch ------------------------------------------------------------

    _HANDLERS = {
        "ShardReserve": "_on_reserve",
        "ShardReserveAck": "_on_reserve_ack",
        "ShardCommit": "_on_commit",
        "ShardCommitAck": "_on_commit_ack",
        "ShardAbort": "_on_abort",
        "ShardStatusQuery": "_on_status_query",
        "ShardStatusReply": "_on_status_reply",
    }

    def _on_message(self, msg: Message) -> None:
        if self.stopped:
            return
        # ANY frame from a member proves it lives: the unreachable
        # mark (and with it the shard.unreachable alert) clears the
        # moment a healed owner speaks — whether it answers us or
        # coordinates its own traffic at us
        self._mark_reachable(msg.sender)
        m = ser.decode(msg.payload)
        handler = self._HANDLERS.get(type(m).__name__)
        if handler is None:
            return
        if msg.trace is not None and self.tracer is not None and (
            self.tracer.enabled
        ):
            # a traced protocol frame stamps a completed hop span into
            # the requester's trace on THIS member's recorder — the
            # cross-node assembly picks it up from here
            t = time.perf_counter()
            self.tracer.span_at(
                "xshard.hop", msg.trace, t, t,
                kind=type(m).__name__, member=self.name,
            )
        getattr(self, handler)(m)

    def _send(self, target: str, m, trace=None) -> None:
        if target == self.name:
            # local loopback, synchronous: the member is both ends
            handler = self._HANDLERS.get(type(m).__name__)
            if handler is not None:
                getattr(self, handler)(m)
            return
        self.messaging.send(
            TOPIC_XSHARD, ser.encode(m), target, trace=trace
        )

    def _mark_reachable(self, owner: str) -> None:
        with self._lock:
            self._unreachable.pop(owner, None)

    # -- pump ----------------------------------------------------------------

    def tick(self) -> int:
        """Pump hook: resend schedules, reserve-phase timeouts, commit
        re-drives, orphan queries. Returns actions taken (MockNetwork
        quiescence contract)."""
        if self.stopped:
            return 0
        now = self.clock.now_micros()
        actions = 0
        for txn in list(self._txns.values()):
            if txn.state == _RESERVING:
                if txn.waiting_remote:
                    partition, owner, refs = txn.parts[txn.idx]
                    if now - txn.phase_started >= self.policy.timeout_micros:
                        if txn.doomed_at is not None:
                            # already conflicted — a silent PROBE owner
                            # must not upgrade the answer to
                            # unavailable: report the conflicts found
                            # (possibly incomplete) and release
                            with self._lock:
                                self._unreachable.setdefault(owner, now)
                            self._abort(txn, txn.conflict)
                        else:
                            self._unavailable(txn, owner, partition)
                        actions += 1
                    elif now >= txn.next_send:
                        txn.attempt += 1
                        self._c_retries.inc()
                        self._send_reserve(txn, partition, owner, refs, now)
                        actions += 1
                elif now >= txn.next_send:
                    self._advance(txn)
                    actions += 1
            elif txn.state == _COMMITTING:
                for owner in list(txn.pending_owners):
                    if now >= txn.owner_next_send.get(owner, 0):
                        txn.owner_attempt[owner] = (
                            txn.owner_attempt.get(owner, 0) + 1
                        )
                        txn.owner_next_send[owner] = (
                            now + self.policy.backoff(
                                txn.owner_attempt[owner], self.rng
                            )
                        )
                        if (
                            now - (txn.decided_at or now)
                            >= self.policy.timeout_micros
                        ):
                            # the decision stands (it is durable); the
                            # owner is just unreachable — keep
                            # re-driving, tell the health plane
                            with self._lock:
                                self._unreachable.setdefault(owner, now)
                        self._send(
                            owner,
                            ShardCommit(
                                txn.xid, txn.tx_id,
                                tuple(txn.owner_refs[owner]),
                                txn.requester, self.name,
                            ),
                            trace=txn.trace,
                        )
                        actions += 1
        # participant orphan scan: holds past their TTL query the
        # coordinator (or its restarted WAL) with capped backoff
        with self._lock:
            due = [
                r for r in self._res.values()
                if now >= r.expiry and now >= r.next_query
            ]
            for r in due:
                r.query_attempt += 1
                r.next_query = now + self.policy.backoff(
                    r.query_attempt, self.rng
                )
        for r in due:
            self._c_orphan_queries.inc()
            if self.txstory is not None and r.query_attempt == 1:
                # first orphan detection only: a hold outlived its TTL
                # and the recovery machinery is querying its
                # coordinator (retries walk on backoff, not the story)
                self.txstory.record(
                    str(r.tx_id), "xshard.orphan",
                    coordinator=r.coordinator, member=self.name,
                )
            if r.coordinator == self.name and r.tx_id not in self._txns:
                # our own dead coordination (pre-restart leftovers):
                # answer from the journal directly
                if self.journal is not None and self.journal.is_committed(
                    r.tx_id
                ):
                    self._on_status_reply(
                        ShardStatusReply(r.tx_id, DECISION_COMMIT)
                    )
                else:
                    self._on_status_reply(
                        ShardStatusReply(r.tx_id, DECISION_ABORT)
                    )
            else:
                self._send(
                    r.coordinator, ShardStatusQuery(r.tx_id, self.name)
                )
            actions += 1
        return actions

    # -- recovery ------------------------------------------------------------

    def recover(self) -> int:
        """Boot-time replay of the coordinator WAL + participant
        reservation journal. Commit-marked intents re-drive to
        completion; unmarked intents presumed-abort (release sent to
        every involved owner); journaled reservations reload as
        immediate orphans so their status queries fire on the first
        tick. Returns the number of recovered coordinator intents."""
        recovered = 0
        span = None
        if self.tracer is not None and self.tracer.enabled:
            span = self.tracer.start_trace(
                "xshard.recover", member=self.name
            )
        now = self.clock.now_micros()
        if self.journal is not None:
            for xid, tx_id, refs, requester, committed in (
                self.journal.unresolved()
            ):
                by_part: dict[int, list] = {}
                for ref in refs:
                    by_part.setdefault(
                        self.shard_map.partition_of(ref), []
                    ).append(ref)
                parts = [
                    (k, self.shard_map.owner_of_partition(k), by_part[k])
                    for k in sorted(by_part)
                ]
                by_owner: dict[str, list] = {}
                for k, owner, prefs in parts:
                    by_owner.setdefault(owner, []).extend(prefs)
                if committed:
                    # re-drive: the decision is durable, participants
                    # apply idempotently. No client future exists any
                    # more — the intent-WAL replay upstream re-asks.
                    # The durable mark IS the accept decision: a crash
                    # between the mark and the in-memory decision-log
                    # append would otherwise leave the log missing an
                    # accept that a later loser's conflict entry cites
                    # (found by the crash-schedule explorer's
                    # serial-replay invariant) — re-record it, before
                    # any re-driven ShardCommit makes the rows visible
                    # again, unless the original append did land
                    if self.decisions is not None and (
                        (tx_id, None) not in self.decisions
                    ):
                        self.decisions.append((tx_id, None))
                    txn = _XTxn(
                        xid, tx_id, list(refs), requester, None, None,
                        parts, now,
                    )
                    txn.journaled = True
                    txn.state = _COMMITTING
                    txn.decided_at = now
                    for owner, orefs in by_owner.items():
                        if owner == self.name:
                            self._apply_commit(tx_id, orefs, requester)
                        else:
                            txn.pending_owners.add(owner)
                            txn.owner_refs[owner] = list(orefs)
                            txn.owner_attempt[owner] = 0
                            txn.owner_next_send[owner] = now
                            self._send(
                                owner,
                                ShardCommit(
                                    xid, tx_id, tuple(orefs), requester,
                                    self.name,
                                ),
                            )
                    if txn.pending_owners:
                        self._txns[tx_id] = txn
                    else:
                        self.journal.finish(xid)
                    self._c_recovered.inc()
                    recovered += 1
                else:
                    # presumed abort: release whatever the dead drive
                    # may have reserved, drop the row
                    for owner, orefs in by_owner.items():
                        if owner == self.name:
                            self._release_local(tx_id, orefs)
                        else:
                            self._send(
                                owner,
                                ShardAbort(
                                    xid, tx_id, tuple(orefs), self.name
                                ),
                            )
                    self.journal.finish(xid)
        if self.reservations is not None:
            for tx_id, xid, coordinator, refs, requester in (
                self.reservations.held()
            ):
                with self._lock:
                    if tx_id in self._res:
                        continue
                    res = _Reservation(tx_id, xid, coordinator, requester,
                                       now)
                    res.refs.update(refs)
                    res.next_query = now   # orphan immediately: query
                    self._res[tx_id] = res
                    for ref in refs:
                        self._ref_hold.setdefault(ref, tx_id)
        if span is not None:
            span.set_attribute("recovered", recovered)
            span.end()
        return recovered

    def stop(self) -> None:
        """Detach from the fabric (kill/rebuild seams)."""
        self.stopped = True
        remove = getattr(self.messaging, "remove_handler", None)
        if remove is not None:
            remove(TOPIC_XSHARD, self._on_message)
