"""Raft consensus over the message fabric + the replicated uniqueness map.

Port of corda_tpu/node/raft.py: the wire messages, `RaftConfig`, the
sqlite log, meta and snapshot tables, `RaftNode` (election,
replication, snapshots and chunked InstallSnapshot) and
`RaftUniquenessProvider`. Frames, log rows and snapshot blobs are the
reference's bytes. Its Raft.Phase.* timers and `raft.<phase>` spans go
through the port's utils/metrics.py and utils/tracing.py. Traced
frames feed the tracer's `ClockSync`, the clock-offset evidence of
cross-node trace assembly. `txstory=` stamps each applied uniqueness
commit on its transaction's lifecycle story (utils/txstory.py).
`partition_raft_groups` wires one group per partition of the distributed
uniqueness plane (node/distributed_uniqueness.py), on
`raft.<cluster>.p<k>`.

Reference: `RaftUniquenessProvider` (node/.../transactions/
RaftUniquenessProvider.kt:41) — a Copycat-replicated
`DistributedImmutableMap` (DistributedImmutableMap.kt) of
stateRef→consumingTx, with the Raft transport running over its own
Netty mesh (`:72-110`). The port runs Raft over the same message
fabric the rest of the node uses (one transport, SURVEY §2.5), and the
notary awaits commits through the FlowFuture seam so the service flow
suspends while the cluster replicates.

The algorithm is standard Raft (election §5.2, replication §5.3, the
current-term commit rule §5.4.2 — Ongaro & Ousterhout, "In Search of an
Understandable Consensus Algorithm", public spec): persistent
(term, votedFor, log) in the node database, randomized election
timeouts driven by explicit `tick()` calls from the node's pump loop —
deterministic under the Ring-3 manual pump, wall-clock on a real node.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..core import serialization as ser
from ..crypto.hashes import SecureHash
from ..utils import tracing
from ..flows.api import FlowFuture
from .messaging import Message, MessagingService

TOPIC_RAFT = "raft"

# consensus-phase vocabulary: per-member spans (`raft.<phase>`, each
# carrying member= and at= attributes) and always-on Raft.Phase.*
# timers. propose = submission handling on the origin member; append =
# AppendEntries processing on any member; quorum = leader-side wait
# from local append to commit-index advance; commit = commit-known to
# entry-resolved on each member (apply nested inside it); apply =
# apply_fn alone; view_change / catch_up are root spans over the
# protocol's repair arcs.
RAFT_PHASES = (
    "propose", "append", "quorum", "commit", "apply",
    "view_change", "catch_up",
)
# bound on the per-entry trace/timing tables: a trace context whose
# entry never commits (deposed leader, lost quorum) must not leak
_TRACE_TABLE_CAP = 4096


def _story_consensus_commit(story, command, index, member, term) -> None:
    """Stamp `consensus.commit` on a just-applied uniqueness command's
    lifecycle story (utils/txstory.py). Only the notary's `["commit",
    tx_id_bytes, refs]` command shape carries a tx id; anything else
    (noops, foreign state machines) is silently skipped — the ledger
    is an observer, never a failure source."""
    try:
        if not isinstance(command, (list, tuple)) or len(command) < 2:
            return
        if command[0] == "commit":
            # notary cluster shape: tx id rides as raw hash bytes
            story.consensus_commit(
                str(SecureHash(bytes(command[1]))),
                index=index, member=member, term=term,
            )
        elif command[0] == "xcommit":
            # partition-group replication shape (distributed
            # uniqueness): tx id rides as the SecureHash itself
            story.consensus_commit(
                str(command[1]), index=index, member=member, term=term,
            )
    except Exception:   # noqa: BLE001 - observer plane, never fatal
        pass


class RaftUnavailable(Exception):
    """No leader reachable within the command deadline (the caller —
    e.g. a notary client — retries, NotaryFlow.kt:159-162)."""


ser.register_custom(
    RaftUnavailable,
    "RaftUnavailable",
    lambda e: str(e),
    lambda v: RaftUnavailable(v),
)


# -- wire messages (all peer-to-peer on the cluster topic) -------------------


@dataclass(frozen=True)
class RequestVote:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass(frozen=True)
class VoteReply:
    term: int
    granted: bool
    voter: str


@dataclass(frozen=True)
class AppendEntries:
    term: int
    leader: str
    prev_log_index: int
    prev_log_term: int
    # (term, command) pairs; a TRACED entry ships as a
    # (term, command, wire_trace_header) triple so a 64-entry batch
    # attributes each entry to ITS OWN client trace (one message-level
    # header could not say which entry it belongs to). The header is
    # observability metadata: receivers strip it before the log append,
    # so replication state is identical traced or not.
    entries: tuple
    leader_commit: int


@dataclass(frozen=True)
class AppendReply:
    term: int
    follower: str
    success: bool
    match_index: int


@dataclass(frozen=True)
class InstallSnapshot:
    """Leader→lagging-follower state transfer (Raft §7): the follower's
    next entry was compacted away, so ship the state machine snapshot
    instead of replaying from genesis. Copycat streams snapshots the
    same way for the reference's RaftUniquenessProvider
    (RaftUniquenessProvider.kt:41 delegates storage/compaction to
    Copycat).

    Chunked per §7 (offset/done): `data` is a slice of the CTS-encoded
    snapshot at `offset`; a real uniqueness map (millions of
    StateRefs) encodes far past the fabric's frame limit, so one
    message cannot carry it. The transfer is follower-paced: each
    chunk is acked with a SnapshotAck naming the next offset wanted,
    and the leader answers statelessly from its cached blob — a lost
    chunk heals when the heartbeat re-sends chunk 0 and the follower
    re-acks its true position."""

    term: int
    leader: str
    last_included_index: int
    last_included_term: int
    offset: int             # byte position of `data` in the blob
    data: bytes             # one chunk of ser.encode(snapshot state)
    done: bool              # True on the final chunk
    total: int              # full blob size (progress/validation)


@dataclass(frozen=True)
class SnapshotAck:
    """Follower→leader: got chunks up to `next_offset`; send more."""

    term: int
    follower: str
    last_included_index: int
    next_offset: int


@dataclass(frozen=True)
class ClientCommand:
    """A command forwarded to the (believed) leader by any member."""

    cmd_id: int
    origin: str
    command: Any


@dataclass(frozen=True)
class ClientResult:
    cmd_id: int
    ok: bool
    value: Any


for _cls in (
    RequestVote, VoteReply, AppendEntries, AppendReply,
    InstallSnapshot, SnapshotAck, ClientCommand, ClientResult,
):
    ser.serializable(_cls)


# -- configuration -----------------------------------------------------------


@dataclass(frozen=True)
class RaftConfig:
    heartbeat_micros: int = 50_000
    election_min_micros: int = 150_000
    election_max_micros: int = 300_000
    command_deadline_micros: int = 10_000_000
    # take a state-machine snapshot and truncate the log every N
    # applied entries (0 disables; requires snapshot_fn/restore_fn)
    snapshot_interval: int = 1024
    # InstallSnapshot chunk size, bytes — comfortably under the
    # fabric's 64 MiB frame limit with CTS overhead to spare
    snapshot_chunk_bytes: int = 1 << 20


_RAFT_SCHEMA = """
CREATE TABLE IF NOT EXISTS raft_log (
    cluster TEXT NOT NULL,
    idx     INTEGER NOT NULL,
    term    INTEGER NOT NULL,
    command BLOB NOT NULL,
    PRIMARY KEY (cluster, idx)
);
CREATE TABLE IF NOT EXISTS raft_meta (
    cluster  TEXT PRIMARY KEY,
    term     INTEGER NOT NULL,
    voted_for TEXT
);
CREATE TABLE IF NOT EXISTS raft_snapshot (
    cluster TEXT PRIMARY KEY,
    idx     INTEGER NOT NULL,
    term    INTEGER NOT NULL,
    state   BLOB NOT NULL
);
"""

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftNode:
    """One cluster member. The log is 1-indexed; `apply_fn(command)` is
    the replicated state machine, invoked exactly once per committed
    entry in log order on every member (DistributedImmutableMap's
    role). `submit()` returns a FlowFuture resolved with apply_fn's
    return value once the entry commits."""

    def __init__(
        self,
        name: str,
        peers: list[str],                  # all members, self included
        messaging: MessagingService,
        apply_fn: Callable[[Any], Any],
        clock,
        cluster: str = "notary",
        db=None,
        rng=None,
        config: RaftConfig = RaftConfig(),
        snapshot_fn: Optional[Callable[[], Any]] = None,
        restore_fn: Optional[Callable[[Any], None]] = None,
        metrics=None,
        tracer=None,
        txstory=None,
    ):
        """`metrics`: an optional MetricRegistry — Raft.Phase.* timers
        over every consensus phase plus quorum-lag gauges land on it
        (always-on, the Notary.FlushPhase.* discipline). `tracer`: an
        optional utils/tracing.Tracer — commands submitted with a
        trace context get per-member `raft.<phase>` spans stamped into
        it, and traced protocol frames feed the tracer's ClockSync so
        cross-node assembly can order spans honestly. `txstory`: an
        optional utils/txstory.TxStory — every applied uniqueness
        commit command stamps a `consensus.commit` lifecycle event
        (log index + member) on its transaction's story, on EVERY
        member that applies it. All default to None: the bare protocol
        stays dependency- and overhead-free."""
        import random as _random

        assert name in peers, "peers must include this member"
        self.name = name
        self.peers = list(peers)
        self.others = [p for p in peers if p != name]
        self.messaging = messaging
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.clock = clock
        self.cluster = cluster
        self.config = config
        self.rng = rng or _random.Random()
        self._db = db
        if db is not None:
            db.execute_script(_RAFT_SCHEMA)

        # persistent state (reloaded from db). The log is logically
        # 1-indexed but physically holds only entries ABOVE the last
        # snapshot: self.log[k] is entry snap_index+1+k. A snapshot
        # (state-machine dump at snap_index) replaces the compacted
        # prefix — restart restores it and replays only the tail,
        # bounding both disk and restart time (Copycat's storage
        # semantics for the reference, RaftUniquenessProvider.kt:41).
        self.term = 0
        self.voted_for: Optional[str] = None
        self.snap_index = 0
        self.snap_term = 0
        self._snap_state: Any = None   # last snapshot payload (for IS)
        # leader: cached ser.encode(_snap_state), keyed by snap_index,
        # answering SnapshotAck chunk requests without re-encoding
        self._snap_blob: Optional[bytes] = None
        self._snap_blob_index = -1
        # leader: peer -> (snap_index, last_chunk_sent_micros) — gates
        # heartbeat re-initiation so one transfer runs per follower
        self._snap_inflight: dict[str, tuple] = {}
        # follower: in-progress chunked transfer —
        # (leader, last_included_index, last_included_term, buffer)
        self._snap_incoming: Optional[tuple] = None
        self.log: list[tuple[int, Any]] = []   # [(term, command)]
        self._load()

        # volatile
        self.role = FOLLOWER
        self.leader: Optional[str] = None
        self.commit_index = self.snap_index
        self.last_applied = self.snap_index
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.votes: set[str] = set()
        # leader: log index -> (term, future, deadline);
        # everywhere: cmd_id -> (future, deadline)
        self._index_futures: dict[int, tuple[int, FlowFuture, int]] = {}
        self._client_futures: dict[int, tuple[FlowFuture, int]] = {}
        # leader: log index -> (origin, cmd_id, term) for forwarded cmds
        self._forwarded: dict[int, tuple[str, int, int]] = {}
        # unresolved client commands awaiting a (possibly future) leader;
        # re-flushed whenever leadership changes — commands MUST be
        # idempotent (the uniqueness map is), because a leader change
        # can replicate a command twice
        self._pending_client: dict[int, Any] = {}
        self._flushed_to: Optional[str] = None
        self._next_cmd = 0
        self._last_heartbeat_sent = 0
        self._election_deadline = self._fresh_election_deadline()
        self.applied_count = 0

        # -- observability: phase timers, lag gauges, spans -----------
        self.metrics = metrics
        self.tracer = tracer
        self.txstory = txstory
        self._phase_timers: dict[str, Any] = {}
        if metrics is not None:
            for phase in RAFT_PHASES:
                self._phase_timers[phase] = metrics.timer(
                    "Raft.Phase." + phase.title().replace("_", "")
                )
            metrics.gauge(
                "Raft.QuorumLagEntries",
                lambda: self.last_log_index - self.commit_index,
            )
            metrics.gauge(
                "Raft.ApplyLagEntries",
                lambda: self.commit_index - self.last_applied,
            )
            for peer in self.others:
                metrics.gauge(
                    f"Raft.PeerLag.{peer}",
                    lambda p=peer: (
                        self.last_log_index - self.match_index.get(p, 0)
                        if self.role == LEADER else 0
                    ),
                )
        # log idx -> propagated wire trace header (the client's trace);
        # log idx -> perf_counter seconds at local append (phase t0)
        self._entry_trace: dict[int, tuple] = {}
        self._entry_t0: dict[int, float] = {}
        # cmd_id -> wire trace header for commands parked/forwarded
        self._cmd_trace: dict[int, tuple] = {}
        # open repair-arc spans (root traces, not client-joined)
        self._vc_span = None
        self._vc_t0 = 0.0
        self._catchup_span = None
        self._catchup_t0 = 0.0

        self.topic = f"{TOPIC_RAFT}.{cluster}"
        messaging.add_handler(self.topic, self._on_message)
        self.stopped = False

        # Restart semantics: the snapshot (restored in _load) covers
        # everything up to snap_index; commit_index above that is
        # volatile and rediscovered from the leader, so the tail is
        # re-applied lazily as commit_index advances past last_applied.
        # apply_fn must be deterministic AND rebuildable (the
        # uniqueness provider's map is; reference: Copycat
        # snapshot+replay).

    # -- persistence ---------------------------------------------------------

    def _load(self) -> None:
        if self._db is None:
            return
        rows = self._db.query(
            "SELECT term, voted_for FROM raft_meta WHERE cluster=?",
            (self.cluster,),
        )
        if rows:
            self.term, self.voted_for = rows[0][0], rows[0][1]
        snap = self._db.query(
            "SELECT idx, term, state FROM raft_snapshot WHERE cluster=?",
            (self.cluster,),
        )
        if snap:
            self.snap_index, self.snap_term = snap[0][0], snap[0][1]
            self._snap_state = ser.decode(bytes(snap[0][2]))
            if self.restore_fn is None:
                raise RuntimeError(
                    "raft snapshot on disk but no restore_fn configured"
                )
            self.restore_fn(self._snap_state)
        for idx, term, blob in self._db.query(
            "SELECT idx, term, command FROM raft_log WHERE cluster=?"
            " AND idx>? ORDER BY idx",
            (self.cluster, self.snap_index),
        ):
            assert idx == self.snap_index + len(self.log) + 1, (
                "raft log has holes"
            )
            self.log.append((term, ser.decode(bytes(blob))))

    def _persist_meta(self) -> None:
        if self._db is None:
            return
        self._db.execute(
            "INSERT OR REPLACE INTO raft_meta (cluster, term, voted_for)"
            " VALUES (?,?,?)",
            (self.cluster, self.term, self.voted_for),
        )

    def _persist_append(self, start_idx: int) -> None:
        """Persist log[start_idx-1:] (1-indexed start)."""
        if self._db is None:
            return
        with self._db.transaction():
            self._db.execute(
                "DELETE FROM raft_log WHERE cluster=? AND idx>=?",
                (self.cluster, start_idx),
            )
            for i in range(start_idx, self.last_log_index + 1):
                term, command = self._entry(i)
                self._db.execute(
                    "INSERT INTO raft_log (cluster, idx, term, command)"
                    " VALUES (?,?,?,?)",
                    (self.cluster, i, term, ser.encode(command)),
                )

    def _persist_snapshot(self) -> None:
        if self._db is None:
            return
        with self._db.transaction():
            self._db.execute(
                "INSERT OR REPLACE INTO raft_snapshot"
                " (cluster, idx, term, state) VALUES (?,?,?,?)",
                (
                    self.cluster, self.snap_index, self.snap_term,
                    ser.encode(self._snap_state),
                ),
            )
            self._db.execute(
                "DELETE FROM raft_log WHERE cluster=? AND idx<=?",
                (self.cluster, self.snap_index),
            )

    # -- log helpers ---------------------------------------------------------

    @property
    def last_log_index(self) -> int:
        return self.snap_index + len(self.log)

    @property
    def last_log_term(self) -> int:
        return self.log[-1][0] if self.log else self.snap_term

    def _entry(self, idx: int) -> tuple[int, Any]:
        """Entry at 1-indexed log position `idx` (> snap_index)."""
        return self.log[idx - self.snap_index - 1]

    def _term_at(self, idx: int) -> int:
        if idx == self.snap_index:
            return self.snap_term
        if self.snap_index < idx <= self.last_log_index:
            return self._entry(idx)[0]
        return 0

    # -- consensus-phase observability ---------------------------------------

    def _tracing(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _observing(self) -> bool:
        """True when per-entry phase timing is worth collecting at all
        (a timer or a tracer will consume it)."""
        return self.metrics is not None or self._tracing()

    def _stamp(self, phase: str, hdr, t0: float, t1: Optional[float] = None,
               **attrs) -> None:
        """One consensus phase interval: always into the Raft.Phase.*
        timer (when metrics are wired), and — when the entry carries a
        trace context and tracing is on — as a completed
        `raft.<phase>` span joined to the client's trace, carrying
        member= (which replica) and at= (node-clock micros at phase
        end, the simulated-time-honest ordering key `phase_summary`
        ranks members by)."""
        t1 = time.perf_counter() if t1 is None else t1
        timer = self._phase_timers.get(phase)
        if timer is not None:
            timer.update(t1 - t0)
        if hdr is not None and self._tracing():
            self.tracer.span_at(
                "raft." + phase, hdr, t0, t1,
                member=self.name, at=self.clock.now_micros(), **attrs,
            )

    def _bind_trace(self, idx: int, hdr) -> None:
        if hdr is None:
            return
        if len(self._entry_trace) >= _TRACE_TABLE_CAP:
            self._entry_trace.pop(next(iter(self._entry_trace)))
        self._entry_trace[idx] = tuple(hdr)

    def _bind_t0(self, idx: int) -> None:
        if not self._observing():
            return
        if len(self._entry_t0) >= _TRACE_TABLE_CAP:
            self._entry_t0.pop(next(iter(self._entry_t0)))
        self._entry_t0[idx] = time.perf_counter()

    def _open_repair_span(self, name: str):
        if not self._tracing():
            return None
        return self.tracer.start_trace(
            name, member=self.name, at=self.clock.now_micros()
        )

    def _close_vc_span(self, outcome: str) -> None:
        if self._vc_span is not None:
            self._vc_span.set_attribute("outcome", outcome)
            self._vc_span.end()
            self._vc_span = None
        if self._vc_t0:
            timer = self._phase_timers.get("view_change")
            if timer is not None:
                timer.update(time.perf_counter() - self._vc_t0)
            self._vc_t0 = 0.0

    def _close_catchup_span(self, outcome: str) -> None:
        if self._catchup_span is not None:
            self._catchup_span.set_attribute("outcome", outcome)
            self._catchup_span.end()
            self._catchup_span = None
        if self._catchup_t0:
            timer = self._phase_timers.get("catch_up")
            if timer is not None:
                timer.update(time.perf_counter() - self._catchup_t0)
            self._catchup_t0 = 0.0

    # -- timers --------------------------------------------------------------

    def _fresh_election_deadline(self) -> int:
        span = (
            self.config.election_max_micros - self.config.election_min_micros
        )
        return (
            self.clock.now_micros()
            + self.config.election_min_micros
            + self.rng.randrange(span + 1)
        )

    def tick(self) -> int:
        """Drive timers; returns number of messages sent (so pump loops
        can detect quiescence)."""
        if self.stopped:
            return 0
        now = self.clock.now_micros()
        sent = 0
        if self.role == LEADER:
            if now - self._last_heartbeat_sent >= self.config.heartbeat_micros:
                sent += self._broadcast_append()
        elif now >= self._election_deadline:
            sent += self._start_election()
        sent += self._expire_client_futures(now)
        return sent

    def _expire_client_futures(self, now: int) -> int:
        for cmd_id, (fut, deadline) in list(self._client_futures.items()):
            if now >= deadline:
                del self._client_futures[cmd_id]
                self._pending_client.pop(cmd_id, None)
                fut.set_exception(
                    RaftUnavailable(
                        f"no commit within deadline (leader={self.leader})"
                    )
                )
        for idx, (term, fut, deadline) in list(self._index_futures.items()):
            if now >= deadline:
                del self._index_futures[idx]
                fut.set_exception(
                    RaftUnavailable("deposed before entry committed")
                )
        return 0

    # -- elections -----------------------------------------------------------

    def _start_election(self) -> int:
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.name
        self.leader = None
        self.votes = {self.name}
        if self._vc_span is None:
            # a repair arc, not client work: its own root trace, so
            # the flight recorder answers "was there an election while
            # that commit was slow" — ends on leadership or yield
            self._vc_span = self._open_repair_span("raft.view_change")
            self._vc_t0 = time.perf_counter() if self._observing() else 0.0
        self._persist_meta()
        self._election_deadline = self._fresh_election_deadline()
        msg = RequestVote(
            self.term, self.name, self.last_log_index, self.last_log_term
        )
        for peer in self.others:
            self._send(peer, msg)
        if self._quorum(len(self.votes)):   # single-member cluster
            self._become_leader()
        return len(self.others)

    def _quorum(self, n: int) -> bool:
        return n * 2 > len(self.peers)

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader = self.name
        self._close_vc_span("leader")
        self.next_index = {p: self.last_log_index + 1 for p in self.others}
        self.match_index = {p: 0 for p in self.others}
        # commit a no-op entry so prior-term entries can commit under
        # the §5.4.2 current-term rule without waiting for client load
        self.log.append((self.term, ["noop"]))
        self._persist_append(self.last_log_index)
        # commands awaiting a leader: we ARE the leader now
        for cmd_id, command in list(self._pending_client.items()):
            self.log.append((self.term, command))
            idx = self.last_log_index
            self._bind_t0(idx)
            self._bind_trace(idx, self._cmd_trace.get(cmd_id))
            self._persist_append(idx)
            self._forwarded[idx] = (self.name, cmd_id, self.term)
        self._flushed_to = self.name
        self._broadcast_append()
        self._maybe_advance_commit()   # single-member cluster

    def _maybe_step_down(self, term: int) -> None:
        if term > self.term:
            if self.role == CANDIDATE:
                self._close_vc_span("superseded")
            self.term = term
            self.voted_for = None
            self.role = FOLLOWER
            self.leader = None   # stale pointers drop commands silently
            self.votes = set()
            self._persist_meta()

    # -- replication ---------------------------------------------------------

    def _broadcast_append(self) -> int:
        self._last_heartbeat_sent = self.clock.now_micros()
        for peer in self.others:
            self._send_append(peer)
        return len(self.others)

    def _send_append(self, peer: str) -> None:
        nxt = self.next_index.get(peer, self.last_log_index + 1)
        prev = nxt - 1
        if prev < self.snap_index:
            # the follower needs entries the log no longer holds:
            # transfer the snapshot instead (Raft §7). Initiate with
            # chunk 0 and let the follower's SnapshotAcks pull the
            # rest — but do NOT re-initiate on every heartbeat while
            # the ack-driven chain is making progress: each redundant
            # chunk 0 would spawn a parallel chunk/ack chain (the
            # follower re-acks its true position on duplicates) and
            # the transfer would amplify linearly with its own
            # duration. Only a stalled transfer (no chunk sent for a
            # few heartbeats — a lost chunk or ack) is re-kicked.
            now = self.clock.now_micros()
            st = self._snap_inflight.get(peer)
            if (
                st is not None
                and st[0] == self.snap_index
                and now - st[1] < 4 * self.config.heartbeat_micros
            ):
                return
            self._send_snapshot_chunk(peer, 0)
            return
        off = prev - self.snap_index
        window = self.log[off : off + 64]
        msg_hdr = None
        if self._entry_trace:
            entries = []
            for k, (t, c) in enumerate(window):
                hdr = self._entry_trace.get(prev + 1 + k)
                if hdr is not None:
                    hdr = tracing.wire_trace(hdr)
                    if msg_hdr is None:
                        # message-level header: the first traced
                        # entry's context — what feeds the receiver's
                        # clock-offset evidence
                        msg_hdr = hdr
                    entries.append((t, c, hdr))
                else:
                    entries.append((t, c))
            entries = tuple(entries)
        else:
            entries = tuple((t, c) for t, c in window)
        self._send(
            peer,
            AppendEntries(
                self.term, self.name, prev, self._term_at(prev),
                entries, self.commit_index,
            ),
            trace=msg_hdr,
        )

    def submit(self, command: Any, trace=None) -> FlowFuture:
        """Replicate one command; future resolves with apply_fn's return
        once committed (leader) or via ClientResult (member/forwarded).
        Submissions while leaderless wait in the client table and are
        flushed to the leader when one emerges (deadline-bounded).

        `trace`: optional trace context (Span / SpanContext / wire
        header) — the command's protocol messages carry it across the
        fabric and every member stamps its `raft.<phase>` spans into
        the SAME trace, so a distributed commit reads as one
        cross-node tree."""
        hdr = tracing.wire_trace(trace)
        t0 = time.perf_counter() if self._observing() else 0.0
        fut = FlowFuture()
        deadline = (
            self.clock.now_micros() + self.config.command_deadline_micros
        )
        if self.role == LEADER:
            # register BEFORE appending: on a single-member cluster the
            # append commits (and applies) inline
            idx = self.last_log_index + 1
            self._index_futures[idx] = (self.term, fut, deadline)
            self._bind_trace(idx, hdr)
            self._leader_append(command)
            self._stamp("propose", hdr, t0)
            return fut
        self._next_cmd += 1
        cmd_id = self._next_cmd
        self._client_futures[cmd_id] = (fut, deadline)
        self._pending_client[cmd_id] = command
        if hdr is not None:
            if len(self._cmd_trace) >= _TRACE_TABLE_CAP:
                self._cmd_trace.pop(next(iter(self._cmd_trace)))
            self._cmd_trace[cmd_id] = hdr
        if self.leader is not None:
            self._send(
                self.leader, ClientCommand(cmd_id, self.name, command),
                trace=tracing.wire_trace(hdr),
            )
        self._stamp("propose", hdr, t0)
        return fut

    def _leader_append(self, command: Any) -> int:
        self.log.append((self.term, command))
        idx = self.last_log_index
        self._bind_t0(idx)
        self._persist_append(idx)
        self._broadcast_append()
        self._maybe_advance_commit()   # single-member clusters commit now
        return idx

    # -- message handling ----------------------------------------------------

    def _on_message(self, msg: Message) -> None:
        if self.stopped:
            return
        try:
            m = ser.decode(msg.payload)
        except ser.SerializationError:
            return
        if msg.trace is not None and self._tracing():
            # traced frames carry the sender's monotonic send stamp:
            # the receive pairing is the clock-offset evidence cross-
            # node assembly orders spans by (tracing.ClockSync)
            self.tracer.clock_sync.observe_header(msg.sender, msg.trace)
        if isinstance(m, RequestVote):
            self._on_request_vote(m, msg.sender)
        elif isinstance(m, VoteReply):
            self._on_vote_reply(m)
        elif isinstance(m, AppendEntries):
            self._on_append(m, msg.sender, msg.trace)
        elif isinstance(m, InstallSnapshot):
            self._on_install_snapshot(m, msg.sender)
        elif isinstance(m, SnapshotAck):
            if msg.sender == m.follower:
                self._on_snapshot_ack(m)
        elif isinstance(m, AppendReply):
            self._on_append_reply(m)
        elif isinstance(m, ClientCommand):
            self._on_client_command(m, msg.trace)
        elif isinstance(m, ClientResult):
            self._on_client_result(m)

    def _on_request_vote(self, m: RequestVote, sender: str) -> None:
        if sender != m.candidate or m.candidate not in self.peers:
            return   # a non-member (or spoofing member) gets no vote
        self._maybe_step_down(m.term)
        up_to_date = (m.last_log_term, m.last_log_index) >= (
            self.last_log_term, self.last_log_index,
        )
        grant = (
            m.term == self.term
            and self.voted_for in (None, m.candidate)
            and up_to_date
        )
        if grant:
            self.voted_for = m.candidate
            self._persist_meta()
            self._election_deadline = self._fresh_election_deadline()
        self._send(m.candidate, VoteReply(self.term, grant, self.name))

    def _on_vote_reply(self, m: VoteReply) -> None:
        self._maybe_step_down(m.term)
        if self.role != CANDIDATE or m.term != self.term or not m.granted:
            return
        if m.voter not in self.peers:
            return
        self.votes.add(m.voter)
        if self._quorum(len(self.votes)):
            self._become_leader()

    def _on_append(self, m: AppendEntries, sender: str, hdr=None) -> None:
        if sender != m.leader or m.leader not in self.peers:
            return
        t0 = time.perf_counter() if self._observing() else 0.0
        self._maybe_step_down(m.term)
        if m.term < self.term:
            self._send(
                m.leader, AppendReply(self.term, self.name, False, 0)
            )
            return
        # valid leader for this term
        if self.role == CANDIDATE:
            self._close_vc_span("yielded")
        self.role = FOLLOWER
        self.leader = m.leader
        self.votes = set()
        self._election_deadline = self._fresh_election_deadline()
        self._flush_parked()
        # log consistency check (prev below our snapshot is committed
        # state — consistent by definition, term no longer checkable)
        if m.prev_log_index > self.last_log_index or (
            m.prev_log_index >= max(1, self.snap_index)
            and self._term_at(m.prev_log_index) != m.prev_log_term
        ):
            self._send(
                m.leader,
                AppendReply(self.term, self.name, False, 0),
            )
            return
        # append, truncating any conflicting suffix
        insert_at = m.prev_log_index
        changed_from = None
        for i, entry in enumerate(m.entries):
            term, command = entry[0], entry[1]
            idx = insert_at + i + 1
            if idx <= self.snap_index:
                continue   # compacted == committed: matches by definition
            # per-entry header, named apart from the MESSAGE-level
            # `hdr` parameter (the first traced entry's context, which
            # the batch append span below is stamped into)
            e_hdr = tuple(entry[2]) if len(entry) > 2 and entry[2] else None
            if idx <= self.last_log_index:
                if self._term_at(idx) == term:
                    # term-matched redelivery: bind the header if the
                    # first copy predated the trace
                    if e_hdr is not None and idx not in self._entry_trace:
                        self._bind_trace(idx, e_hdr)
                    continue
                del self.log[idx - self.snap_index - 1 :]
                # the truncated entries' trace/timing bindings die with
                # them: a REPLACEMENT entry at the same index must not
                # stamp its commit/apply spans into the overwritten
                # entry's trace
                for table in (self._entry_trace, self._entry_t0):
                    for k in [k for k in table if k >= idx]:
                        del table[k]
            self.log.append((term, list(command) if isinstance(command, tuple) else command))
            if e_hdr is not None:
                self._bind_trace(idx, e_hdr)
            self._bind_t0(idx)
            if changed_from is None:
                changed_from = idx
        if changed_from is not None:
            self._persist_append(changed_from)
            self._stamp("append", hdr, t0, batch=len(m.entries))
        if m.leader_commit > self.commit_index:
            self.commit_index = min(m.leader_commit, self.last_log_index)
            self._apply_committed()
        self._send(
            m.leader,
            AppendReply(self.term, self.name, True, insert_at + len(m.entries)),
        )

    def _flush_parked(self) -> None:
        """(Re)send unresolved client commands when leadership changes —
        a command sent to a since-crashed leader would otherwise hang
        until its deadline despite a healthy new leader."""
        if self.leader is None or self._flushed_to == self.leader:
            return
        self._flushed_to = self.leader
        for cmd_id, command in list(self._pending_client.items()):
            self._send(
                self.leader, ClientCommand(cmd_id, self.name, command),
                trace=tracing.wire_trace(self._cmd_trace.get(cmd_id)),
            )

    def _on_append_reply(self, m: AppendReply) -> None:
        self._maybe_step_down(m.term)
        if self.role != LEADER or m.term != self.term:
            return
        if m.follower not in self.peers:
            return
        if m.success:
            self.match_index[m.follower] = max(
                self.match_index.get(m.follower, 0), m.match_index
            )
            self.next_index[m.follower] = self.match_index[m.follower] + 1
            self._maybe_advance_commit()
            if self.next_index[m.follower] <= self.last_log_index:
                self._send_append(m.follower)   # more to stream
        else:
            self.next_index[m.follower] = max(
                1, self.next_index.get(m.follower, 1) - 1
            )
            if self.next_index[m.follower] - 1 < self.snap_index:
                # next step is an InstallSnapshot; a follower that
                # rejects it (e.g. no restore_fn) would otherwise
                # ping-pong the full snapshot in a tight reply loop —
                # let the heartbeat timer pace the retry instead
                return
            self._send_append(m.follower)

    def _snapshot_blob(self) -> bytes:
        if self._snap_blob_index != self.snap_index or self._snap_blob is None:
            self._snap_blob = ser.encode(self._snap_state)
            self._snap_blob_index = self.snap_index
        return self._snap_blob

    def _send_snapshot_chunk(self, peer: str, offset: int) -> None:
        blob = self._snapshot_blob()
        chunk = max(1, self.config.snapshot_chunk_bytes)
        offset = min(max(offset, 0), len(blob))
        data = blob[offset : offset + chunk]
        self._snap_inflight[peer] = (
            self.snap_index, self.clock.now_micros(),
        )
        self._send(
            peer,
            InstallSnapshot(
                self.term, self.name, self.snap_index, self.snap_term,
                offset, data, offset + len(data) >= len(blob), len(blob),
            ),
        )

    def _on_snapshot_ack(self, m: SnapshotAck) -> None:
        """Stateless chunk server: answer each ack with the chunk the
        follower asks for next. An ack for a superseded snapshot (we
        compacted again mid-transfer) restarts it at chunk 0 of the
        current one."""
        self._maybe_step_down(m.term)
        if self.role != LEADER or m.term != self.term:
            return
        if m.follower not in self.peers:
            return
        if m.last_included_index != self.snap_index:
            self._send_snapshot_chunk(m.follower, 0)
            return
        if m.next_offset < len(self._snapshot_blob()):
            self._send_snapshot_chunk(m.follower, m.next_offset)
        # else: the follower holds every byte and is installing; its
        # final AppendReply advances next_index past the snapshot

    def _maybe_advance_commit(self) -> None:
        for idx in range(self.last_log_index, self.commit_index, -1):
            if self._term_at(idx) != self.term:
                break   # §5.4.2: only current-term entries count directly
            replicated = 1 + sum(
                1 for p in self.others if self.match_index.get(p, 0) >= idx
            )
            if self._quorum(replicated):
                self.commit_index = idx
                self._apply_committed()
                break

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            idx = self.last_applied
            if self.role == LEADER:
                # the leader RETAINS the binding past apply: a follower
                # that missed the original frames (drop/partition — the
                # lagging replica this plane exists to identify) gets
                # the header on the re-send; the snapshot prune and the
                # table cap bound the retention
                hdr = self._entry_trace.get(idx)
            else:
                hdr = self._entry_trace.pop(idx, None)
            append_t0 = self._entry_t0.pop(idx, None)
            observing = self._observing()
            t_commit = time.perf_counter() if observing else 0.0
            if self.role == LEADER and append_t0 is not None:
                # quorum: leader-side wait from local append to the
                # commit-index advance that covered this entry
                self._stamp("quorum", hdr, append_t0, t_commit)
            term, command = self._entry(self.last_applied)
            t_apply = time.perf_counter() if observing else 0.0
            result = (
                None if command == ["noop"] else self.apply_fn(command)
            )
            if observing:
                self._stamp("apply", hdr, t_apply)
            if self.txstory is not None:
                _story_consensus_commit(
                    self.txstory, command, idx, self.name, term
                )
            self.applied_count += 1
            entry = self._index_futures.pop(self.last_applied, None)
            if entry is not None:
                fterm, fut, _deadline = entry
                if fterm == term:
                    fut.set_result(result)
                else:
                    fut.set_exception(
                        RaftUnavailable("entry overwritten by new leader")
                    )
            fwd = self._forwarded.pop(self.last_applied, None)
            if fwd is not None:
                origin, cmd_id, fwd_term = fwd
                if fwd_term != term:
                    # a new leader overwrote this index with a DIFFERENT
                    # entry: reporting success would hand the origin a
                    # result for someone else's command (a double-spend
                    # window at the notary)
                    if origin != self.name:
                        self._send(
                            origin,
                            ClientResult(
                                cmd_id, False, "entry overwritten"
                            ),
                        )
                elif origin == self.name:
                    # a command parked here pre-election: resolve locally
                    entry = self._client_futures.pop(cmd_id, None)
                    if entry is not None:
                        self._pending_client.pop(cmd_id, None)
                        entry[0].set_result(result)
                else:
                    self._send(
                        origin, ClientResult(cmd_id, True, result),
                        trace=tracing.wire_trace(hdr),
                    )
            if observing:
                # commit: commit-known to entry-resolved on THIS member
                # (apply_fn nested inside as raft.apply)
                self._stamp("commit", hdr, t_commit)
        # a deposed leader's outstanding futures must not hang forever:
        # indexes at/below commit that resolved above are gone; the rest
        # expire via the client-deadline path or on overwrite
        self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        """Compact: dump the state machine at last_applied, drop the
        log prefix it covers. Disk stays bounded and restart replays
        only the post-snapshot tail."""
        interval = self.config.snapshot_interval
        if (
            self.snapshot_fn is None
            or interval <= 0
            or self.last_applied - self.snap_index < interval
        ):
            return
        new_term = self._term_at(self.last_applied)
        self._snap_state = self.snapshot_fn()
        del self.log[: self.last_applied - self.snap_index]
        self.snap_index = self.last_applied
        self.snap_term = new_term
        # compacted entries can never be re-sent (InstallSnapshot
        # covers them): drop their retained trace bindings
        for table in (self._entry_trace, self._entry_t0):
            for k in [k for k in table if k <= self.snap_index]:
                del table[k]
        self._persist_snapshot()

    def _on_install_snapshot(self, m: InstallSnapshot, sender: str) -> None:
        if sender != m.leader or m.leader not in self.peers:
            return
        self._maybe_step_down(m.term)
        if m.term < self.term:
            self._send(
                m.leader, AppendReply(self.term, self.name, False, 0)
            )
            return
        self.role = FOLLOWER
        self.leader = m.leader
        self.votes = set()
        self._election_deadline = self._fresh_election_deadline()
        self._flush_parked()
        # -- chunk assembly (Raft §7 offset/done) -------------------------
        if not (m.done and m.offset == 0):
            key = (m.leader, m.last_included_index, m.last_included_term)
            buf = (
                self._snap_incoming[3]
                if self._snap_incoming is not None
                and self._snap_incoming[:3] == key
                else None
            )
            if m.offset == 0:
                if buf and not m.done:
                    # duplicate heartbeat-paced chunk 0 mid-transfer:
                    # re-ack our true position instead of restarting,
                    # which also heals a lost chunk/ack
                    self._send(
                        m.leader,
                        SnapshotAck(
                            self.term, self.name,
                            m.last_included_index, len(buf),
                        ),
                    )
                    return
                buf = bytearray()
                self._snap_incoming = (*key, buf)
                if self._catchup_span is None:
                    # the state-transfer arc: one root span from first
                    # chunk to installed (or abandoned)
                    self._catchup_span = self._open_repair_span(
                        "raft.catch_up"
                    )
                    self._catchup_t0 = (
                        time.perf_counter() if self._observing() else 0.0
                    )
            elif buf is None or m.offset != len(buf):
                # out-of-order / superseded chunk: report where we
                # really are (0 if we hold nothing for this snapshot)
                self._send(
                    m.leader,
                    SnapshotAck(
                        self.term, self.name, m.last_included_index,
                        len(buf) if buf is not None else 0,
                    ),
                )
                return
            buf += bytes(m.data)
            if not m.done:
                self._send(
                    m.leader,
                    SnapshotAck(
                        self.term, self.name,
                        m.last_included_index, len(buf),
                    ),
                )
                return
            self._snap_incoming = None
            try:
                state = ser.decode(bytes(buf))
            except ser.SerializationError:
                # corrupt assembled blob: abandon the transfer WITHOUT
                # acking — an ack(0) would restart the whole stream at
                # network speed (an unthrottled loop when the failure
                # is deterministic); silence lets the leader's stall
                # re-kick retry at heartbeat pace instead
                self._close_catchup_span("corrupt")
                return
        else:
            try:
                state = ser.decode(bytes(m.data))
            except ser.SerializationError:
                return   # malformed single-chunk snapshot: drop
        if m.last_included_index > self.last_applied:
            if self.restore_fn is None:
                # cannot install: answer failure rather than hang the
                # leader's retry loop silently
                self._send(
                    m.leader, AppendReply(self.term, self.name, False, 0)
                )
                return
            self.restore_fn(state)
            keep_suffix = (
                m.last_included_index <= self.last_log_index
                and self._term_at(m.last_included_index)
                == m.last_included_term
            )
            if keep_suffix:
                del self.log[: m.last_included_index - self.snap_index]
            else:
                self.log = []
            self.snap_index = m.last_included_index
            self.snap_term = m.last_included_term
            self._snap_state = state
            self.last_applied = self.snap_index
            self.commit_index = max(self.commit_index, self.snap_index)
            if self._db is not None:
                if not keep_suffix:
                    self._db.execute(
                        "DELETE FROM raft_log WHERE cluster=?",
                        (self.cluster,),
                    )
                self._persist_snapshot()
        # entries up to the snapshot point are committed on the leader,
        # so they "match" regardless of whether we installed or were
        # already past it
        self._close_catchup_span("installed")
        self._send(
            m.leader,
            AppendReply(
                self.term, self.name, True, m.last_included_index
            ),
        )

    def _on_client_command(self, m: ClientCommand, hdr=None) -> None:
        if m.origin not in self.peers:
            return
        if self.role != LEADER:
            return   # origin re-flushes on leader discovery
        idx = self.last_log_index + 1
        self._forwarded[idx] = (m.origin, m.cmd_id, self.term)
        self._bind_trace(idx, hdr)
        self._leader_append(m.command)

    def _on_client_result(self, m: ClientResult) -> None:
        entry = self._client_futures.pop(m.cmd_id, None)
        if entry is None:
            return
        self._pending_client.pop(m.cmd_id, None)
        self._cmd_trace.pop(m.cmd_id, None)
        fut, _deadline = entry
        if m.ok:
            fut.set_result(m.value)
        else:
            fut.set_exception(RaftUnavailable(str(m.value)))

    # -- plumbing ------------------------------------------------------------

    def _send(self, peer: str, message, trace=None) -> None:
        if trace is None:
            # the common untraced path keeps the bare send signature
            # (narrow test doubles stub send(topic, payload, target))
            self.messaging.send(self.topic, ser.encode(message), peer)
        else:
            self.messaging.send(
                self.topic, ser.encode(message), peer, trace=trace
            )

    def stop(self) -> None:
        self.stopped = True
        remove = getattr(self.messaging, "remove_handler", None)
        if remove is not None:
            remove(self.topic, self._on_message)

    def __repr__(self) -> str:
        return (
            f"<RaftNode {self.name} {self.role} term={self.term}"
            f" log={self.last_log_index} commit={self.commit_index}>"
        )


# ---------------------------------------------------------------------------
# the replicated uniqueness map


class RaftUniquenessProvider:
    """stateRef→consumingTx map replicated by Raft (reference:
    RaftUniquenessProvider.kt:41 + DistributedImmutableMap.kt — put-all
    is atomic: any conflict rejects the whole batch).

    Every member applies the same deterministic conflict check, so the
    map is identical cluster-wide; the submitting member's future
    resolves with the conflict set (or None) once the entry commits.
    """

    def __init__(self, raft_factory: Callable[..., RaftNode]):
        """raft_factory(apply_fn, snapshot_fn=..., restore_fn=...) ->
        RaftNode — the provider owns the state machine, the caller owns
        transport/cluster wiring."""
        self.committed: dict = {}   # StateRef -> SecureHash
        # factories MUST forward the snapshot hooks (accept **kwargs):
        # silently dropping them would disable compaction — unbounded
        # log growth — so a non-conforming factory fails loudly here
        self.raft = raft_factory(
            self._apply,
            snapshot_fn=self._snapshot,
            restore_fn=self._restore,
        )

    # snapshot hooks: the whole uniqueness map, deterministic order ----------

    def _snapshot(self) -> list:
        from .notary import snapshot_uniqueness_map

        return snapshot_uniqueness_map(self.committed)

    def _restore(self, state) -> None:
        from .notary import restore_uniqueness_map

        self.committed = restore_uniqueness_map(state)

    # the replicated state machine ------------------------------------------

    def _apply(self, command) -> Any:
        from ..crypto.hashes import SecureHash

        kind, tx_id_b, refs_b = command
        assert kind == "commit", f"unknown raft command {kind!r}"
        tx_id = SecureHash(bytes(tx_id_b))
        refs = [ser.decode(bytes(r)) for r in refs_b]
        conflict = {
            str(ref): str(self.committed[ref])
            for ref in refs
            if ref in self.committed and self.committed[ref] != tx_id
        }
        if conflict:
            return ["conflict", conflict]
        for ref in refs:
            self.committed[ref] = tx_id
        return ["ok"]

    # the UniquenessProvider surface ----------------------------------------

    def commit_async(self, states, tx_id, requester, trace=None) -> FlowFuture:
        from .notary import UniquenessConflict

        raft_fut = self.raft.submit(
            ["commit", tx_id.bytes_, [ser.encode(r) for r in states]],
            trace=trace,
        )
        out = FlowFuture()

        def adapt(fut: FlowFuture) -> None:
            try:
                result = fut.result()
            except BaseException as e:
                out.set_exception(e)
                return
            if result and result[0] == "conflict":
                out.set_exception(UniquenessConflict(dict(result[1])))
            else:
                out.set_result(None)

        raft_fut.add_done_callback(adapt)
        return out

    def commit(self, states, tx_id, requester) -> None:
        raise NotImplementedError(
            "Raft commits are asynchronous; use commit_async"
        )


def partition_raft_groups(
    name: str,
    peers: list,
    messaging: MessagingService,
    clock,
    apply_for: Callable[[int], Callable],
    partitions,
    cluster: str = "xshard",
    db=None,
    rng=None,
    config: Optional[RaftConfig] = None,
    metrics=None,
    tracer=None,
    txstory=None,
) -> dict:
    """One Raft group PER uniqueness partition (the distributed
    sharded uniqueness plane): group k rides the
    `raft.<cluster>.p<k>` topic namespace — the groups' protocol
    frames stay disjoint on ONE fabric endpoint per member, and the
    persistence tables are already cluster-keyed, so every group can
    share the node database.

    `apply_for(k)` supplies partition k's replicated state machine
    (DistributedUniquenessProvider.partition_apply: idempotent
    committed-row writes into the member's local store copy, so a
    partition owner's rows gain a replica on every member and a
    failover owner boots warm). Returns {partition: RaftNode} — the
    caller ticks each group alongside the provider."""
    groups: dict[int, RaftNode] = {}
    for k in partitions:
        groups[k] = RaftNode(
            name,
            list(peers),
            messaging,
            apply_for(k),
            clock,
            cluster=f"{cluster}.p{k}",
            db=db,
            rng=rng,
            config=config or RaftConfig(),
            metrics=metrics,
            tracer=tracer,
            txstory=txstory,
        )
    return groups
