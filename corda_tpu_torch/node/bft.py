"""BFT notary: PBFT-style totally-ordered commits, f+1 reply aggregation.

Port of corda_tpu/node/bft.py: the PBFT messages, `BftConfig`,
`BftReplica` (pre-prepare, prepare, commit, view change with signed
prepared certificates, checkpoints, catch-up) and `BFTNotaryService`,
with the reference's frames and checkpoint digests. Its Bft.Phase.*
timers and `bft.<phase>` spans go through the port's utils/metrics.py
and utils/tracing.py; traced frames feed the tracer's `ClockSync`, the
clock-offset evidence of cross-node trace assembly. `txstory=` stamps
each executed notarisation on its transaction's lifecycle story, and
`BFTNotaryService` admits and closes the coordinator's story
(utils/txstory.py).

Reference: `BFTSMaRt` client/replica (node/.../transactions/
BFTSMaRt.kt:52-173) + `BFTNonValidatingNotaryService`
(BFTNonValidatingNotaryService.kt:29): a `CommitRequest` is totally
ordered across 3f+1 replicas by the BFT-SMaRt library; every replica
independently verifies the Merkle tear-off, commits the inputs to its
own map, and SIGNS the transaction; the client aggregates replica
signatures into a `ClusterResponse`, accepting once f+1 agree. The
notary's service identity is a **composite key with threshold f+1**
over the replica keys, so the ordinary signature-check path proves
byzantine agreement.

Here the library's role is played by an in-tree PBFT normal case
(pre-prepare → 2f prepares → 2f+1 commits → in-order execution), a
view change completed by a NEW-VIEW message (the new primary merges
the prepared sets from its 2f+1 view-change certificate and
re-proposes them, so requests caught mid-prepare by a primary failure
still commit in view+1), periodic checkpoints (2f+1 matching
state digests make a checkpoint stable and garbage-collect protocol
state below it), and catch-up state transfer (a lagging or restarted
replica installs a checkpoint attested by f+1 peers and replays the
agreed tail — the BFTSMaRt getSnapshot/installSnapshot surface,
BFTSMaRt.kt:193,219).

View-change votes are proof-carrying (PBFT's prepared certificates,
played by BFT-SMaRt internally for the reference): each prepared entry
in a ViewChange carries the 2f+1 distinct PREPARE attestations
(including the view primary's — its prepare plays classic PBFT's
signed pre-prepare) that made it prepared, and both the new primary
and every validator discard entries whose certificate does not check
out — so a single authenticated-but-lying replica cannot smuggle a
never-prepared command into the new view, and two conflicting
certificates for one (view, seq) are impossible by quorum
intersection. Seqs no vote certifies are re-proposed as no-ops
(PBFT's null requests) so in-sequence execution never stalls on a
hole. With the notary's signature hooks installed
(`sign_prepare_fn`/`verify_prepare_fn`, wired by `BFTNotaryService`),
certificates are per-replica signatures over (view, seq, digest) and
the guarantee is cryptographic: safety holds with ≤f byzantine
replicas in ANY role (primary, view-change voter, or backup). Without
the hooks (bare protocol tests), validation falls back to requiring
every attestation in a certificate to match a PREPARE the validator
itself received over the fabric's authenticated channels — same
safety on a lossless fabric, with liveness deferred (not lost) when a
validator missed the original PREPAREs. Liveness needs n-f live
replicas; replies only count with f+1 agreement.
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

TOPIC_BFT = "bft"

# consensus-phase vocabulary (per-member `bft.<phase>` spans + always-
# on Bft.Phase.* timers): pre_prepare = ordering/accept processing;
# prepare = accept -> prepared (the 2f+1 PREPARE quorum wait); commit =
# prepared -> committed (the COMMIT quorum wait); reply = in-sequence
# execution + answer; view_change / catch_up are repair-arc root spans.
BFT_PHASES = (
    "pre_prepare", "prepare", "commit", "reply", "view_change", "catch_up",
)
_TRACE_TABLE_CAP = 4096


def _story_bft_commit(story, outcome, seq: int, member: str) -> None:
    """Stamp `consensus.commit` on an executed notarisation's
    lifecycle story (utils/txstory.py): the replica state machine's
    success outcome `["ok", tx_id_bytes]` carries the id. Anything
    else (errors, foreign state machines) is skipped — the ledger is
    an observer, never a failure source."""
    try:
        if (
            isinstance(outcome, (list, tuple))
            and len(outcome) >= 2
            and outcome[0] == "ok"
        ):
            story.consensus_commit(
                str(SecureHash(bytes(outcome[1]))),
                index=seq, member=member,
            )
    except Exception:   # noqa: BLE001 - observer plane, never fatal
        pass


class BftUnavailable(Exception):
    pass


ser.register_custom(
    BftUnavailable, "BftUnavailable", lambda e: str(e), lambda v: BftUnavailable(v)
)


# -- wire --------------------------------------------------------------------


@dataclass(frozen=True)
class BftRequest:
    cmd_id: int
    origin: str
    command: Any


@dataclass(frozen=True)
class PrePrepare:
    view: int
    seq: int
    cmd_id: int
    origin: str
    command: Any
    # the primary's clock at ordering time: execution validates time
    # windows against THIS (identical on every replica), not each
    # replica's own clock — replicas sanity-check it for skew before
    # preparing, so a lying primary can't shift time beyond tolerance
    timestamp: int = 0


@dataclass(frozen=True)
class BftPrepare:
    view: int
    seq: int
    digest: bytes
    replica: str
    # the replica's signature over (cluster, view, seq, digest) when
    # the service installed sign_prepare_fn — collected into the
    # prepared certificate that makes view-change votes proof-carrying
    signature: Optional[Any] = None


@dataclass(frozen=True)
class BftCommitMsg:
    view: int
    seq: int
    digest: bytes
    replica: str


@dataclass(frozen=True)
class BftReply:
    cmd_id: int
    seq: int
    outcome: Any               # canonical value; replies match on it
    replica: str
    signature: Optional[Any]   # replica's TransactionSignature (ok case)


@dataclass(frozen=True)
class ViewChange:
    new_view: int
    replica: str
    # prepared set: tuple of (seq, view, cmd_id, origin, command, ts,
    # cert) where cert = ((replica, prepare_signature), ...) — the
    # 2f+1 distinct PREPARE attestations that made the entry prepared.
    # Entries without a checkable quorum certificate are discarded by
    # every consumer (_merge_prepared), so a lying voter cannot inject
    # a never-prepared command.
    prepared: tuple


@dataclass(frozen=True)
class NewView:
    """The new primary's completion of a view change (PBFT NEW-VIEW):
    carries the 2f+1 view-change certificate it collected and the
    pre-prepares (re-proposals of the merged prepared set) it issues in
    the new view, so every replica adopts the view and the in-flight
    requests atomically — a replica that reached the vote quorum late
    would otherwise drop the new primary's pre-prepares as
    wrong-view."""

    view: int
    primary: str
    votes: tuple       # ((replica, prepared), ...) — the certificate
    preprepares: tuple  # ((seq, cmd_id, origin, command, timestamp), ...)


@dataclass(frozen=True)
class BftCheckpoint:
    """Periodic state attestation (PBFT checkpoint): 2f+1 matching
    digests at `seq` make the checkpoint stable — protocol state below
    it is garbage-collected and the snapshot becomes the catch-up
    transfer unit (reference surface: BFTSMaRt.kt:193,219
    getStateManager/getSnapshot/installSnapshot)."""

    seq: int
    digest: bytes
    replica: str


@dataclass(frozen=True)
class NewViewRequest:
    """A replica stuck awaiting a NEW-VIEW (its vote quorum advanced
    the view but the primary's one broadcast never arrived — dropped
    over a reconnect, say) asks the primary to retransmit. Without
    this the _awaiting_new_view gate would refuse ordinary
    pre-prepares in that view forever, silently costing the cluster
    one replica of fault margin."""

    view: int
    replica: str


@dataclass(frozen=True)
class CatchUpRequest:
    """A lagging/restarted replica asking peers for state transfer."""

    have_seq: int       # highest executed seq the requester holds
    replica: str


@dataclass(frozen=True)
class CatchUpReply:
    checkpoint_seq: int
    checkpoint_state: Any   # snapshot_fn() output at checkpoint_seq
    # executed tail above the checkpoint:
    # ((seq, cmd_id, origin, command, timestamp), ...)
    entries: tuple
    replica: str


for _cls in (
    BftRequest, PrePrepare, BftPrepare, BftCommitMsg, BftReply,
    ViewChange, NewView, NewViewRequest, BftCheckpoint, CatchUpRequest,
    CatchUpReply,
):
    ser.serializable(_cls)


@dataclass(frozen=True)
class BftConfig:
    request_timeout_micros: int = 2_000_000    # before suspecting primary
    client_deadline_micros: int = 10_000_000
    timestamp_skew_micros: int = 60_000_000    # primary clock sanity bound
    checkpoint_interval: int = 16              # executions per checkpoint
    catchup_cooldown_micros: int = 1_000_000   # between catch-up asks


def quorum_2f1(n: int) -> int:
    f = (n - 1) // 3
    return 2 * f + 1


def weak_quorum(n: int) -> int:
    f = (n - 1) // 3
    return f + 1


def _digest(command: Any) -> bytes:
    import hashlib

    return hashlib.sha256(ser.encode(command)).digest()


def _canon(command: Any) -> Any:
    """Canonicalise a command for digesting/re-proposal: CTS decode
    yields lists where local construction may hold tuples. ONE helper —
    digest agreement is consensus-critical, so every site must
    normalise identically."""
    return list(command) if isinstance(command, tuple) else command


# NEW-VIEW gap filler (PBFT's null request): a seq the old primary
# assigned but that never certifiably prepared is re-proposed as a
# no-op, so execution (strictly in-sequence) can advance past it
# instead of stalling forever on a hole below next_seq.
NOOP = "__bft_noop__"


class BftReplica:
    """One PBFT replica + embedded client gateway.

    `execute_fn(command) -> (outcome, signature)` is the deterministic
    state machine (the notary's verify+commit+sign); `outcome` must be
    canonical and equal across honest replicas, `signature` is this
    replica's own signature share (excluded from reply matching).
    """

    def __init__(
        self,
        name: str,
        peers: list[str],
        messaging: MessagingService,
        execute_fn: Callable[[Any], tuple],
        clock,
        cluster: str = "bft-notary",
        rng=None,
        config: BftConfig = BftConfig(),
        metrics=None,
        tracer=None,
        txstory=None,
    ):
        """`metrics` / `tracer`: the consensus observability seam (see
        raft.RaftNode — same contract): Bft.Phase.* timers + lag/view
        gauges on the registry, per-member `bft.<phase>` spans joined
        to a submitted command's trace context, ClockSync feeding from
        traced frames. `txstory`: an optional utils/txstory.TxStory —
        every successfully-executed notarisation stamps a
        `consensus.commit` lifecycle event (sequence + member) on its
        transaction's story, on EVERY replica that executes it. All
        None by default — the bare protocol pays nothing."""
        import random as _random

        assert name in peers
        self.name = name
        self.peers = list(peers)
        self.n = len(peers)
        self.f = (self.n - 1) // 3
        self.messaging = messaging
        self.execute_fn = execute_fn
        self.clock = clock
        self.cluster = cluster
        self.config = config
        self.rng = rng or _random.Random()

        self.view = 0
        self.next_seq = 1                 # primary: next sequence to assign
        self.exec_seq = 1                 # next sequence to execute
        # seq -> (view, cmd_id, origin, command)
        self.accepted: dict[int, tuple] = {}
        # (view,seq,digest) -> {replica: prepare_signature}
        self.prepares: dict[tuple, dict[str, Any]] = {}
        self.commits: dict[tuple, set[str]] = {}
        self.prepared: dict[int, tuple] = {}          # seq -> accepted entry
        # seq -> (view, digest, ((replica, sig), ...)) — the PREPARE
        # evidence snapshot taken when the entry became prepared;
        # shipped inside ViewChange votes as the prepared certificate
        self.prepared_cert: dict[int, tuple] = {}
        # prepared-certificate hooks (installed by BFTNotaryService):
        # sign_prepare_fn(view, seq, digest) -> signature for our own
        # PREPAREs; verify_prepare_fn(replica, view, seq, digest, sig)
        # -> bool gates both incoming PREPAREs and certificate entries.
        # Without them, certificates are validated against the
        # PREPAREs this replica itself received (fabric-auth fallback).
        self.sign_prepare_fn: Optional[Callable[[int, int, bytes], Any]] = None
        self.verify_prepare_fn: Optional[
            Callable[[str, int, int, bytes, Any], bool]
        ] = None
        self.committed: set[int] = set()
        self.executed: dict[int, Any] = {}            # seq -> outcome
        self.seen_requests: dict[tuple, int] = {}     # (origin, cmd_id) -> seq
        # every replica remembers broadcast requests so a new primary
        # can (re-)order ones the failed primary never pre-prepared
        self.pending_requests: dict[tuple, Any] = {}  # (origin, cmd_id) -> cmd
        # replies only count if this passes (the notary installs a
        # signature-share check; a byzantine 'ok' with a missing or
        # bogus signature must not reach the f+1 bucket)
        self.validate_reply: Callable[[Any, str, Any], bool] = (
            lambda outcome, replica, signature: True
        )
        # client side: cmd_id -> (future, deadline, {outcome_key: [(replica, sig)]})
        self._client: dict[int, list] = {}
        self._next_cmd = 0
        # request watchdog: (origin, cmd_id) -> first-seen micros
        self._watch: dict[tuple, int] = {}
        self._view_votes: dict[int, dict[str, tuple]] = {}
        # NEW-VIEW messages parked until our own vote quorum arrives
        self._pending_new_view: dict[int, NewView] = {}
        # view-change gating (round-4 advisor, high): between our own
        # vote quorum advancing the view and a VALIDATED NEW-VIEW for
        # it, ordinary pre-prepares are refused outright — and after
        # adoption they are refused at or below the NEW-VIEW's
        # re-proposal top. Without this a byzantine new primary could
        # OMIT a certified seq from its NEW-VIEW and then reorder that
        # seq with a fresh pre-prepare carrying a different command
        # (the coverage check in _on_new_view rejects the omission;
        # this floor closes the reorder half of the same attack).
        self._awaiting_new_view = False
        self._awaiting_since = 0
        self._new_view_floor = 0
        # primary side: the NewView we broadcast per view, kept so a
        # replica that missed the one broadcast can ask for a resend
        self._sent_new_view: dict[int, NewView] = {}
        # state-transfer hooks (installed by the notary service):
        # snapshot_fn() -> canonical state, restore_fn(state, seq)
        self.snapshot_fn: Optional[Callable[[], Any]] = None
        self.restore_fn: Optional[Callable[[Any, int], None]] = None
        # checkpoints: seq -> digest -> {replica}; stable = 2f+1 match
        self._ckpt_votes: dict[int, dict[bytes, set[str]]] = {}
        self._ckpt_snapshots: dict[int, Any] = {}   # our own, by seq
        self.stable_checkpoint = 0
        self.stable_state: Any = None
        # catch-up: per-replica highest claimed seq — a seq only counts
        # as evidence of lag when f+1 DISTINCT replicas claim it (one
        # byzantine peer advertising seq=10**9 must not trigger
        # perpetual full-state transfers) + buckets of peer replies
        # awaiting f+1 agreement
        self._seq_claims: dict[str, int] = {}
        self._stuck_since: Optional[int] = None
        self._last_catchup_ask = -(10**12)
        self._catchup_replies: dict[str, CatchUpReply] = {}
        self._catchup_served: dict[str, int] = {}   # per-requester limit
        self.stopped = False

        # -- observability: phase timers, gauges, spans ----------------
        self.metrics = metrics
        self.tracer = tracer
        self.txstory = txstory
        self._phase_timers: dict[str, Any] = {}
        if metrics is not None:
            for phase in BFT_PHASES:
                self._phase_timers[phase] = metrics.timer(
                    "Bft.Phase."
                    + "".join(p.title() for p in phase.split("_"))
                )
            metrics.gauge("Bft.View", lambda: self.view)
            metrics.gauge(
                "Bft.ExecLagEntries",
                lambda: max(0, self.credible_seq - (self.exec_seq - 1)),
            )
        # (origin, cmd_id) -> wire trace header; seq -> header once
        # ordered; seq -> perf_counter marks at accept/prepared time
        self._req_trace: dict[tuple, tuple] = {}
        self._seq_trace: dict[int, tuple] = {}
        self._seq_accept_t: dict[int, float] = {}
        self._seq_prepared_t: dict[int, float] = {}
        self._vc_span = None
        self._vc_t0 = 0.0
        self._vc_view = 0
        self._catchup_span = None
        self._catchup_t0 = 0.0

        self.topic = f"{TOPIC_BFT}.{cluster}"
        messaging.add_handler(self.topic, self._on_message)

    # -- roles ---------------------------------------------------------------

    @property
    def primary(self) -> str:
        return self.peers[self.view % self.n]

    @property
    def is_primary(self) -> bool:
        return self.primary == self.name

    # -- consensus-phase observability ---------------------------------------

    def _tracing(self) -> bool:
        return self.tracer is not None and self.tracer.enabled

    def _observing(self) -> bool:
        return self.metrics is not None or self._tracing()

    def _stamp(self, phase: str, hdr, t0: float,
               t1: Optional[float] = None, **attrs) -> None:
        """One phase interval: into the Bft.Phase.* timer always (when
        metrics are wired) and — for a traced command — as a completed
        `bft.<phase>` span joined to the client's trace with member=
        and at= (node-clock micros) attributes."""
        t1 = time.perf_counter() if t1 is None else t1
        timer = self._phase_timers.get(phase)
        if timer is not None:
            timer.update(t1 - t0)
        if hdr is not None and self._tracing():
            self.tracer.span_at(
                "bft." + phase, hdr, t0, t1,
                member=self.name, at=self.clock.now_micros(), **attrs,
            )

    def _bind(self, table: dict, key, value) -> None:
        if value is None:
            return
        if len(table) >= _TRACE_TABLE_CAP:
            table.pop(next(iter(table)))
        table[key] = value

    def _seq_hdr(self, seq: int) -> Optional[tuple]:
        hdr = self._seq_trace.get(seq)
        return tracing.wire_trace(hdr) if hdr is not None else None

    def _open_repair_span(self, name: str):
        if not self._tracing():
            return None
        return self.tracer.start_trace(
            name, member=self.name, at=self.clock.now_micros()
        )

    def _close_repair_span(self, kind: str, outcome: str) -> None:
        span_attr, t0_attr = f"_{kind}_span", f"_{kind}_t0"
        span = getattr(self, span_attr)
        if span is not None:
            span.set_attribute("outcome", outcome)
            span.end()
            setattr(self, span_attr, None)
        t0 = getattr(self, t0_attr)
        if t0:
            timer = self._phase_timers.get(
                "view_change" if kind == "vc" else "catch_up"
            )
            if timer is not None:
                timer.update(time.perf_counter() - t0)
            setattr(self, t0_attr, 0.0)

    # -- client gateway ------------------------------------------------------

    def submit(self, command: Any, trace=None) -> FlowFuture:
        """Broadcast a request; future resolves once f+1 replicas reply
        with the same outcome — value is (outcome, [signatures]).

        `trace`: optional trace context — protocol messages for this
        command carry it across the fabric and every replica stamps
        its `bft.<phase>` spans into the SAME trace (see
        raft.RaftNode.submit)."""
        hdr = tracing.wire_trace(trace)
        self._next_cmd += 1
        cmd_id = self._next_cmd
        fut = FlowFuture()
        deadline = self.clock.now_micros() + self.config.client_deadline_micros
        self._client[cmd_id] = [fut, deadline, {}]
        req = BftRequest(cmd_id, self.name, command)
        payload = ser.encode(req)
        for peer in self.peers:
            if peer == self.name:
                self._on_request(req, hdr)
            else:
                self._send(peer, payload, trace=tracing.wire_trace(hdr))
        return fut

    def _on_reply(self, m: BftReply) -> None:
        entry = self._client.get(m.cmd_id)
        if entry is None or m.replica not in self.peers:
            return
        if not self.validate_reply(m.outcome, m.replica, m.signature):
            return
        fut, deadline, buckets = entry
        key = ser.encode(m.outcome)
        votes = buckets.setdefault(key, [])
        if any(r == m.replica for r, _ in votes):
            return   # one vote per replica
        votes.append((m.replica, m.signature))
        if len(votes) >= weak_quorum(self.n):
            del self._client[m.cmd_id]
            sigs = [s for _, s in votes if s is not None]
            fut.set_result([ser.decode(key), sigs])

    # -- replica: request handling -------------------------------------------

    def _on_request(self, m: BftRequest, hdr=None) -> None:
        key = (m.origin, m.cmd_id)
        self._bind(self._req_trace, key, hdr)
        seq = self.seen_requests.get(key)
        if seq is not None:
            # duplicate (client retry): re-reply if already executed
            if seq in self.executed:
                self._reply(seq)
            return
        self._watch.setdefault(key, self.clock.now_micros())
        self.pending_requests[key] = m.command
        if self.is_primary:
            self._order(m.cmd_id, m.origin, m.command)

    def _order(self, cmd_id: int, origin: str, command: Any) -> None:
        seq = self.next_seq
        self.next_seq += 1
        pp = PrePrepare(
            self.view, seq, cmd_id, origin, command,
            self.clock.now_micros(),
        )
        self._accept_preprepare(pp)
        self._broadcast(pp, trace=self._seq_hdr(seq))

    def _accept_preprepare(
        self, pp: PrePrepare, skew_exempt: bool = False, hdr=None
    ) -> None:
        if pp.seq in self.accepted and self.accepted[pp.seq][0] >= pp.view:
            return   # first pre-prepare per (seq, view) wins; stale views drop
        t0 = time.perf_counter() if self._observing() else 0.0
        if hdr is None:
            hdr = self._req_trace.get((pp.origin, pp.cmd_id))
        skew = abs(pp.timestamp - self.clock.now_micros())
        if skew > self.config.timestamp_skew_micros and not skew_exempt:
            # primary's clock is lying/broken: refuse to prepare.
            # NEW-VIEW re-proposals are exempt: they replay the ORIGINAL
            # ordering timestamp (execution must be deterministic across
            # views), and a view change delayed past the skew bound —
            # partition, long outage — must not leave a certified entry
            # un-re-preparable forever, stalling in-sequence execution
            # at its hole. The certificate already proves 2f+1 replicas
            # accepted that timestamp when it was fresh.
            return
        self.accepted[pp.seq] = (
            pp.view, pp.cmd_id, pp.origin, pp.command, pp.timestamp,
        )
        self.seen_requests[(pp.origin, pp.cmd_id)] = pp.seq
        self._bind(self._seq_trace, pp.seq, hdr)
        if self._observing():
            self._bind(self._seq_accept_t, pp.seq, t0)
        d = _digest(_canon(pp.command))
        sig = (
            self.sign_prepare_fn(pp.view, pp.seq, d)
            if self.sign_prepare_fn is not None
            else None
        )
        prep = BftPrepare(pp.view, pp.seq, d, self.name, sig)
        self._record_prepare(prep)
        self._stamp("pre_prepare", hdr, t0, seq=pp.seq)
        self._broadcast(prep, trace=self._seq_hdr(pp.seq))

    def _on_preprepare(self, pp: PrePrepare, sender: str, hdr=None) -> None:
        if sender != self.primary or pp.view != self.view:
            return   # only the current primary may order
        if self._awaiting_new_view:
            return   # no ordinary ordering until the NEW-VIEW validates
        if pp.seq < self._new_view_floor or pp.seq < self.exec_seq:
            # at/below the adopted NEW-VIEW top or our own executed
            # history: an honest primary never orders there (its
            # next_seq starts above its top), so this is either a
            # stale redelivery or a byzantine reorder attempt
            return
        self._accept_preprepare(pp, hdr=hdr)

    def _record_prepare(self, p: BftPrepare) -> None:
        if (
            p.replica != self.name
            and self.verify_prepare_fn is not None
            and not self.verify_prepare_fn(
                p.replica, p.view, p.seq, bytes(p.digest), p.signature
            )
        ):
            return   # unsigned/mis-signed PREPARE: inadmissible evidence
        key = (p.view, p.seq, bytes(p.digest))
        group = self.prepares.setdefault(key, {})
        group[p.replica] = p.signature
        # prepared = pre-prepare accepted + 2f+1 distinct prepares
        # INCLUDING the view primary's (every replica here broadcasts a
        # PREPARE on accept, so the primary's prepare plays the role of
        # classic PBFT's signed pre-prepare in the certificate). The
        # 2f+1-at-transition invariant is what guarantees every
        # prepared replica can immediately produce a certificate that
        # passes _valid_prepared_entry — an entry that COMMITS anywhere
        # therefore always survives a view change, because any 2f+1
        # view-change vote quorum contains a replica holding its cert.
        # A seq prepared in an OLD view prepares again in the new one
        # (the NEW-VIEW re-proposal path): commit quorums are per-view,
        # so the view-0 prepared state must not gag the view-1 commit.
        if (
            p.seq in self.accepted
            and self.accepted[p.seq][0] == p.view
            and len(group) >= quorum_2f1(self.n)
            and self.peers[p.view % self.n] in group
            and (
                p.seq not in self.prepared
                or self.prepared[p.seq][0] < p.view
            )
        ):
            self.prepared[p.seq] = self.accepted[p.seq]
            # snapshot the evidence: this tuple is the prepared
            # certificate a future view-change vote will carry — the
            # transition condition just guaranteed it holds 2f+1
            # distinct attesters, exactly what _valid_prepared_entry
            # demands (a larger snapshot would only give fallback-mode
            # validators more inbox entries to have to confirm)
            self.prepared_cert[p.seq] = (
                p.view,
                bytes(p.digest),
                tuple(sorted(group.items(), key=lambda kv: kv[0])),
            )
            if self._observing():
                # prepare phase: accept -> 2f+1 PREPARE quorum
                t_prep = time.perf_counter()
                t_accept = self._seq_accept_t.get(p.seq)
                if t_accept is not None:
                    self._stamp(
                        "prepare", self._seq_trace.get(p.seq),
                        t_accept, t_prep, seq=p.seq,
                    )
                self._bind(self._seq_prepared_t, p.seq, t_prep)
            c = BftCommitMsg(p.view, p.seq, bytes(p.digest), self.name)
            self._record_commit(c)
            self._broadcast(c, trace=self._seq_hdr(p.seq))

    def _record_commit(self, c: BftCommitMsg) -> None:
        key = (c.view, c.seq, bytes(c.digest))
        group = self.commits.setdefault(key, set())
        group.add(c.replica)
        if (
            len(group) >= quorum_2f1(self.n)
            and c.seq in self.prepared
            and c.seq not in self.committed
        ):
            self.committed.add(c.seq)
            if self._observing():
                # commit phase: prepared -> 2f+1 COMMIT quorum
                t_prep = self._seq_prepared_t.pop(c.seq, None)
                if t_prep is not None:
                    self._stamp(
                        "commit", self._seq_trace.get(c.seq),
                        t_prep, seq=c.seq,
                    )
            self._execute_ready()

    def _execute_ready(self) -> None:
        """Execute committed entries strictly in sequence order. The
        ordered timestamp rides along so time-dependent checks are
        deterministic across replicas."""
        while self.exec_seq in self.committed:
            seq = self.exec_seq
            self.exec_seq += 1
            _view, cmd_id, origin, command, timestamp = self.accepted[seq]
            if _canon(command) == NOOP:
                # gap filler: no state transition, nobody to reply to
                self.executed[seq] = (cmd_id, origin, None, None)
                self._maybe_checkpoint(seq)
                continue
            observing = self._observing()
            t0 = time.perf_counter() if observing else 0.0
            outcome, signature = self.execute_fn(
                _canon(command), timestamp,
            )
            if self.txstory is not None:
                _story_bft_commit(self.txstory, outcome, seq, self.name)
            self.executed[seq] = (cmd_id, origin, outcome, signature)
            self._watch.pop((origin, cmd_id), None)
            self.pending_requests.pop((origin, cmd_id), None)
            self._req_trace.pop((origin, cmd_id), None)
            self._reply(seq)
            if observing:
                # reply phase: in-sequence execution + the answer send
                self._stamp(
                    "reply", self._seq_trace.get(seq), t0, seq=seq,
                )
            self._seq_accept_t.pop(seq, None)
            self._maybe_checkpoint(seq)

    # -- checkpoints ---------------------------------------------------------

    def _maybe_checkpoint(self, seq: int) -> None:
        if (
            self.snapshot_fn is None
            or seq % self.config.checkpoint_interval != 0
        ):
            return
        state = self.snapshot_fn()
        self._ckpt_snapshots[seq] = state
        ck = BftCheckpoint(seq, _digest(state), self.name)
        self._record_checkpoint(ck)
        self._broadcast(ck)

    def _record_checkpoint(self, ck: BftCheckpoint) -> None:
        if ck.seq <= self.stable_checkpoint:
            return
        by_digest = self._ckpt_votes.setdefault(ck.seq, {})
        group = by_digest.setdefault(bytes(ck.digest), set())
        group.add(ck.replica)
        own = self._ckpt_snapshots.get(ck.seq)
        if (
            len(group) >= quorum_2f1(self.n)
            and own is not None
            and _digest(own) == bytes(ck.digest)
        ):
            self._stabilise(ck.seq, own)

    def _stabilise(self, seq: int, state: Any) -> None:
        """2f+1 replicas attested the same state at `seq`: protocol
        bookkeeping below it can never be needed again."""
        self.stable_checkpoint = seq
        self.stable_state = state
        for d in (
            self.accepted, self.prepared, self.prepared_cert, self.executed,
            self._seq_trace, self._seq_accept_t, self._seq_prepared_t,
        ):
            for s in [s for s in d if s <= seq]:
                del d[s]
        for d in (self.prepares, self.commits):
            for k in [k for k in d if k[1] <= seq]:
                del d[k]
        self.committed = {s for s in self.committed if s > seq}
        for s in [s for s in self._ckpt_votes if s <= seq]:
            del self._ckpt_votes[s]
        for s in [s for s in self._ckpt_snapshots if s <= seq]:
            del self._ckpt_snapshots[s]

    # -- catch-up (state transfer) -------------------------------------------

    def _note_seq(self, seq: int, replica: str) -> None:
        if seq > self._seq_claims.get(replica, 0):
            self._seq_claims[replica] = seq

    @property
    def credible_seq(self) -> int:
        """Highest seq at least f+1 distinct replicas have claimed —
        guaranteed to include one honest claim."""
        claims = sorted(self._seq_claims.values(), reverse=True)
        f = self.f
        return claims[f] if len(claims) > f else 0

    def _maybe_request_catchup(self, now: int) -> int:
        """A replica that sees credible protocol traffic above what it
        can execute — and holds no pre-prepare for its next slot —
        missed messages while down/partitioned. Normal retransmission
        cannot help (PBFT has none for executed history); ask for
        transfer. The condition must PERSIST for a full cooldown before
        asking: during normal operation the in-flight slot's own
        prepare traffic briefly looks like lag when messages arrive
        out of order."""
        if self.snapshot_fn is None:
            return 0
        behind = self.credible_seq > self.exec_seq - 1
        stuck = self.exec_seq not in self.accepted
        if not (behind and stuck):
            self._stuck_since = None
            return 0
        if self._stuck_since is None:
            self._stuck_since = now
            return 0
        if now - self._stuck_since < self.config.catchup_cooldown_micros:
            return 0
        if now - self._last_catchup_ask < self.config.catchup_cooldown_micros:
            return 0
        self._last_catchup_ask = now
        self._catchup_replies.clear()
        if self._catchup_span is None:
            # the state-transfer arc: ask -> f+1-agreed install
            self._catchup_span = self._open_repair_span("bft.catch_up")
            self._catchup_t0 = (
                time.perf_counter() if self._observing() else 0.0
            )
        self._broadcast(CatchUpRequest(self.exec_seq - 1, self.name))
        return self.n - 1

    def _on_catchup_request(self, m: CatchUpRequest) -> None:
        if m.replica == self.name:
            return
        # server-side rate limit: a byzantine peer spamming requests
        # must not make every honest replica re-serialize the full
        # state map per message (asymmetric CPU/bandwidth DoS)
        now = self.clock.now_micros()
        last = self._catchup_served.get(m.replica, -(10**12))
        if now - last < self.config.catchup_cooldown_micros:
            return
        self._catchup_served[m.replica] = now
        # the executed tail above our stable checkpoint that the
        # requester does not already hold, oldest first
        entries = tuple(
            (
                seq,
                self.accepted[seq][1],
                self.accepted[seq][2],
                _canon(self.accepted[seq][3]),
                self.accepted[seq][4],
            )
            for seq in sorted(self.executed)
            if seq in self.accepted and seq > m.have_seq
        )
        if m.have_seq >= self.stable_checkpoint:
            # requester already holds our checkpoint: ship only the tail
            reply = CatchUpReply(0, None, entries, self.name)
        else:
            reply = CatchUpReply(
                self.stable_checkpoint, self.stable_state, entries,
                self.name,
            )
        self.messaging.send(self.topic, ser.encode(reply), m.replica)

    def _on_catchup_reply(self, m: CatchUpReply) -> None:
        """Install once f+1 peers agree (digest match) on a checkpoint
        ahead of us — at most f replicas are byzantine, so f+1 matching
        attestations contain at least one honest one. Tail entries
        above the installed checkpoint are replayed only with f+1
        per-entry agreement; anything newer arrives via the normal
        protocol once we are back inside the window."""
        if m.replica not in self.peers or self.restore_fn is None:
            return
        self._catchup_replies[m.replica] = m
        progressed = False
        # phase 1 — install the highest checkpoint ahead of us that
        # f+1 peers attest with matching digests
        groups: dict[tuple, list[CatchUpReply]] = {}
        for r in self._catchup_replies.values():
            if r.checkpoint_state is None:
                continue   # tail-only reply (we already held their ckpt)
            key = (r.checkpoint_seq, _digest(r.checkpoint_state))
            groups.setdefault(key, []).append(r)
        for (ck_seq, _d), replies in sorted(groups.items(), reverse=True):
            if (
                len(replies) >= weak_quorum(self.n)
                and ck_seq > self.exec_seq - 1
            ):
                self.restore_fn(replies[0].checkpoint_state, ck_seq)
                self.stable_checkpoint = ck_seq
                self.stable_state = replies[0].checkpoint_state
                self.exec_seq = ck_seq + 1
                self.next_seq = max(self.next_seq, self.exec_seq)
                progressed = True
                break
        # phase 2 — replay the tail with f+1 per-entry agreement
        # across ALL replies (peers may disagree on checkpoint ages
        # while still agreeing on the executed entries)
        by_seq: dict[int, dict[bytes, list[tuple]]] = {}
        for r in self._catchup_replies.values():
            for e in r.entries:
                by_seq.setdefault(e[0], {}).setdefault(
                    _digest(list(e)), []
                ).append(tuple(e))
        for seq in sorted(by_seq):
            if seq != self.exec_seq:
                continue
            agreed = [
                es for es in by_seq[seq].values()
                if len(es) >= weak_quorum(self.n)
            ]
            if not agreed:
                break
            _seq, cmd_id, origin, command, ts = agreed[0][0]
            if _canon(command) == NOOP:
                outcome, signature = None, None
            else:
                outcome, signature = self.execute_fn(_canon(command), ts)
            self.exec_seq = seq + 1
            self.next_seq = max(self.next_seq, self.exec_seq)
            self.executed[seq] = (cmd_id, origin, outcome, signature)
            self.seen_requests[(origin, cmd_id)] = seq
            self._maybe_checkpoint(seq)
            progressed = True
        if progressed:
            self._catchup_replies.clear()
            self._close_repair_span("catchup", "installed")

    def _reply(self, seq: int) -> None:
        cmd_id, origin, outcome, signature = self.executed[seq]
        reply = BftReply(cmd_id, seq, outcome, self.name, signature)
        if origin == self.name:
            self._on_reply(reply)
        else:
            self._send(origin, ser.encode(reply), trace=self._seq_hdr(seq))

    # -- view change (simplified) --------------------------------------------

    def tick(self) -> int:
        if self.stopped:
            return 0
        now = self.clock.now_micros()
        sent = 0
        # requests nobody will ever answer for stop driving view changes
        # once past the client deadline
        for k, t0 in list(self._watch.items()):
            if now - t0 >= self.config.client_deadline_micros:
                del self._watch[k]
                self.pending_requests.pop(k, None)
        overdue = [
            k
            for k, t0 in self._watch.items()
            if now - t0 >= self.config.request_timeout_micros
        ]
        if overdue:
            for k in overdue:
                self._watch[k] = now   # re-arm
            sent += self._vote_view_change(self.view + 1)
        # expire client futures
        for cmd_id, (fut, deadline, _b) in list(self._client.items()):
            if now >= deadline:
                del self._client[cmd_id]
                fut.set_exception(
                    BftUnavailable("no f+1 agreement within deadline")
                )
        # stuck awaiting a NEW-VIEW (the one broadcast was lost, or we
        # rejected it for vote-set skew): ask the primary to resend.
        # Recovers the replica's participation; a primary that cannot
        # produce an acceptable NEW-VIEW just leaves us re-asking until
        # the next view change supersedes the wait.
        if (
            self._awaiting_new_view
            and now - self._awaiting_since >= self.config.request_timeout_micros
            and self.primary != self.name
        ):
            self._awaiting_since = now   # re-arm
            self.messaging.send(
                self.topic,
                ser.encode(NewViewRequest(self.view, self.name)),
                self.primary,
            )
            sent += 1
        sent += self._maybe_request_catchup(now)
        return sent

    def _open_vc_span(self, new_view: int) -> None:
        if new_view <= self._vc_view:
            return   # re-vote for a view already being tracked
        self._vc_view = new_view
        if self._vc_span is None:
            self._vc_span = self._open_repair_span("bft.view_change")
            self._vc_t0 = time.perf_counter() if self._observing() else 0.0
        if self._vc_span is not None:
            self._vc_span.set_attribute("new_view", new_view)

    def _vote_view_change(self, new_view: int) -> int:
        self._open_vc_span(new_view)
        # EVERY certified entry above the stable checkpoint rides in
        # the vote — including executed ones. Excluding executed seqs
        # would break the NEW-VIEW no-op filler's invariant ("no vote
        # certifies it => it cannot have committed anywhere"): a seq
        # executed at 2f+1-minus-one replicas but missing from the
        # merge would be no-op-filled at a lagging new primary and
        # diverge it from the executed majority. Checkpoint GC
        # (_stabilise) bounds the vote size.
        prepared = tuple(
            (
                seq, v, cmd_id, origin, _canon(cmd), ts,
                self.prepared_cert[seq][2],
            )
            for seq, (v, cmd_id, origin, cmd, ts) in sorted(
                self.prepared.items()
            )
            if seq in self.prepared_cert
        )
        vc = ViewChange(new_view, self.name, prepared)
        self._record_view_change(vc)
        self._broadcast(vc)
        return self.n - 1

    def _record_view_change(self, vc: ViewChange) -> None:
        if vc.new_view <= self.view:
            return
        votes = self._view_votes.setdefault(vc.new_view, {})
        votes[vc.replica] = vc.prepared
        if len(votes) >= quorum_2f1(self.n):
            new_view = vc.new_view
            self.view = new_view
            # keep the CURRENT view's vote set: NEW-VIEW validation
            # replays it (votes are broadcast to everyone, so each
            # replica holds its own copy of the certificate evidence)
            self._view_votes = {
                v: m for v, m in self._view_votes.items() if v >= self.view
            }
            self._pending_new_view = {
                v: nv
                for v, nv in self._pending_new_view.items()
                if v >= self.view
            }
            if self.is_primary:
                # a stale wait from an earlier, never-completed view
                # must not outlive our own primaryship
                self._awaiting_new_view = False
                self._send_new_view(new_view, votes)
            else:
                self._awaiting_new_view = True
                self._awaiting_since = self.clock.now_micros()
                pending = self._pending_new_view.pop(new_view, None)
                if pending is not None:
                    self._on_new_view(pending, pending.primary)

    def _valid_prepared_entry(self, entry, support=None) -> bool:
        """Check one view-change prepared entry's certificate: 2f+1
        DISTINCT peer attestations over (view, seq, digest(command)).
        With verify_prepare_fn installed each attestation is a
        signature check (fabric-independent); otherwise each must
        match a PREPARE this replica itself received — a lying voter
        can fabricate names but not the validator's own inbox.

        2f+1 (not the local prepared predicate's 2f) is what makes two
        conflicting certificates for one (view, seq) impossible: any
        two 2f+1 attester sets intersect in >= f+1 replicas, so at
        least one HONEST replica would have had to attest both digests
        — and honest replicas send exactly one PREPARE per (view, seq)
        (the Castro-Liskov prepared-uniqueness argument). At 2f, an
        equivocating primary plus f double-signing accomplices could
        certify a second digest behind a committed one and the
        view-change merge would tie-break by arrival order."""
        try:
            seq, v, _cmd_id, _origin, command, _ts, cert = entry
            names = [r for r, _sig in cert]
        except (TypeError, ValueError):
            return False   # malformed entry (old wire shape / garbage)
        if len(set(names)) != len(names) or not set(names) <= set(self.peers):
            return False
        if len(names) < quorum_2f1(self.n):
            return False
        d = _digest(_canon(command))
        if self.verify_prepare_fn is not None:
            return all(
                self.verify_prepare_fn(r, v, seq, d, sig)
                for r, sig in cert
            )
        # Fallback (no signature hooks): an attestation checks out if
        # we received that replica's PREPARE ourselves. A validator
        # that was down/partitioned for the original traffic instead
        # accepts an entry carried IDENTICALLY (same seq, view,
        # digest) by f+1 distinct view-change votes: at most f voters
        # are byzantine, so one honest voter — who only carries
        # entries it genuinely prepared with a full certificate —
        # backs it.
        own = self.prepares.get((v, seq, d), {})
        if all(r in own for r in names):
            return True
        return (
            support is not None
            and support.get((seq, v, d), 0) >= weak_quorum(self.n)
        )

    def _merge_prepared(self, prepared_sets) -> dict[int, tuple]:
        """Merge view-change prepared sets: highest view wins per seq,
        over certificate-backed entries ONLY. Deterministic — replicas
        recompute it from the NEW-VIEW certificate to validate the
        primary's re-proposals."""
        sets = [list(p) for p in prepared_sets]
        # per-entry vote support (distinct votes carrying the same
        # (seq, view, digest)) for the fallback admission rule above
        support: dict[tuple, int] = {}
        for prepared in sets:
            seen = set()
            for entry in prepared:
                try:
                    seq, v, _c, _o, command, _t, _cert = entry
                except (TypeError, ValueError):
                    continue
                k = (seq, v, _digest(_canon(command)))
                if k not in seen:
                    seen.add(k)
                    support[k] = support.get(k, 0) + 1
        best: dict[int, tuple] = {}
        for prepared in sets:
            for entry in prepared:
                if not self._valid_prepared_entry(entry, support):
                    continue
                seq, v, cmd_id, origin, command, ts, _cert = entry
                if seq not in best or best[seq][0] < v:
                    best[seq] = (v, cmd_id, origin, command, ts)
        return best

    def _send_new_view(self, view: int, votes: dict[str, tuple]) -> None:
        """New primary: merge the prepared sets from the view-change
        certificate (highest view wins per seq), broadcast ONE NewView
        carrying certificate + re-proposals, apply locally, then order
        any broadcast-but-never-ordered requests."""
        best = self._merge_prepared(votes.values())
        # re-propose EVERY certified entry, even ones this primary has
        # executed: a validator that missed the original round receives
        # the command in-band (re-commitment is a no-op at replicas
        # already past it — execution is exec_seq-gated)
        pps = tuple(
            (seq, cmd_id, origin, _canon(command), ts)
            for seq, (_v, cmd_id, origin, command, ts) in sorted(best.items())
        )
        # fresh ordering must start ABOVE every seq this cluster has
        # ever used: our own executed/accepted history AND the
        # certificate's prepared seqs — reusing an executed seq would
        # overwrite history and stall the new request forever (its
        # commit can never re-execute)
        top = self.exec_seq - 1
        if self.accepted:
            top = max(top, max(self.accepted))
        if best:
            top = max(top, max(best))
        self.next_seq = max(self.next_seq, top + 1)
        self._new_view_floor = max(self._new_view_floor, top + 1)
        # fill the holes: a seq the dead primary assigned that no vote
        # certifies (it cannot have committed anywhere — commit implies
        # a 2f+1 certificate in every vote quorum) re-proposes as a
        # no-op, or in-sequence execution would stall below it forever
        covered = {pp[0] for pp in pps}
        now = self.clock.now_micros()
        noops = tuple(
            (seq, -seq, self.name, NOOP, now)
            for seq in range(self.exec_seq, top + 1)
            if seq not in covered
        )
        pps = tuple(sorted(pps + noops))
        cert = tuple((r, p) for r, p in sorted(votes.items()))
        nv = NewView(view, self.name, cert, pps)
        # kept for retransmission (NewViewRequest); older views pruned
        self._sent_new_view = {view: nv}
        self._broadcast(nv)
        for seq, cmd_id, origin, command, ts in pps:
            self._accept_preprepare(
                PrePrepare(view, seq, cmd_id, origin, command, ts),
                skew_exempt=True,
            )
        for (origin, cmd_id), command in list(self.pending_requests.items()):
            if (origin, cmd_id) in self.seen_requests:
                continue   # already ordered (possibly re-proposed above)
            self._order(cmd_id, origin, command)
        self._close_repair_span("vc", "primary")

    def _on_new_view(self, m: NewView, sender: str) -> None:
        """Adopt the new view on the primary's NEW-VIEW: late replicas
        (that had not yet reached the vote quorum themselves) jump
        views WITH the re-proposals instead of dropping them as
        wrong-view pre-prepares.

        The embedded certificate is NOT trusted: the channel
        authenticates only the relaying primary, so a byzantine
        primary could author a fake 2f+1 certificate. ViewChange votes
        are broadcast to every replica, so each replica validates the
        NEW-VIEW against the votes IT received (buffering the message
        until its own quorum arrives). A re-proposal a replica cannot
        back with its own votes is rejected — worst case the request
        re-times-out into the next view (liveness deferred), never an
        unbacked command executing (safety kept). The same stance
        covers vote-set skew around no-ops: if the primary's quorum
        missed the one vote certifying an entry and no-op-filled its
        seq, a validator holding that vote rejects the whole NEW-VIEW
        rather than risk a possibly-committed entry — transient
        liveness loss (the next timeout retries with more votes
        circulated), and impossible for committed entries under an
        honest primary (a committed entry's certificate is in EVERY
        2f+1 vote quorum, so an honest primary never no-ops it)."""
        if sender != m.primary or m.primary not in self.peers:
            return
        if m.view < self.view:
            return
        if self.peers[m.view % self.n] != m.primary:
            return   # not the rightful primary for that view
        own_votes = self._view_votes.get(m.view, {})
        if len(own_votes) < quorum_2f1(self.n):
            # our own evidence hasn't arrived yet: park, re-checked on
            # every vote (votes are broadcast, so they do arrive)
            self._pending_new_view[m.view] = m
            return
        # recompute the merge from OUR OWN received votes: a
        # byzantine-but-rightful primary must not smuggle a DIFFERENT
        # command under a prepared seq (that would overwrite an entry
        # another replica already executed)
        merged = self._merge_prepared(own_votes.values())
        # COVERAGE (round-4 advisor, high): every seq OUR evidence
        # certifies must be re-proposed. A byzantine primary that
        # simply omits a certified (possibly committed) seq — rather
        # than tampering with it — would otherwise slip past the
        # per-entry checks below, free to reorder that seq later with
        # a fresh pre-prepare for a conflicting command. Same stance
        # as vote-set skew around no-ops: reject the whole NEW-VIEW,
        # worst case liveness defers to the next view.
        listed = {pp[0] for pp in m.preprepares}
        if not set(merged) <= listed:
            return   # certified seq omitted from the NEW-VIEW
        for seq, cmd_id, origin, command, ts in m.preprepares:
            ref = merged.get(seq)
            if ref is None:
                if (
                    _canon(command) == NOOP
                    and origin == m.primary
                    and cmd_id == -seq
                ):
                    continue   # gap filler over an uncertified hole
                return   # re-proposal not backed by our evidence
            _v, r_cmd_id, r_origin, r_command, r_ts = ref
            if (r_cmd_id, r_origin, r_ts) != (cmd_id, origin, ts) or (
                _digest(_canon(command)) != _digest(_canon(r_command))
            ):
                return   # tampered re-proposal: reject the whole NEW-VIEW
        if m.view > self.view:
            self.view = m.view
            self._view_votes = {
                v: vm for v, vm in self._view_votes.items() if v >= self.view
            }
        self._awaiting_new_view = False
        self._close_repair_span("vc", "adopted")
        if listed:
            # ordinary ordering in this view must start above the
            # adopted re-proposal top — see _on_preprepare
            self._new_view_floor = max(self._new_view_floor, max(listed) + 1)
        for seq, cmd_id, origin, command, ts in m.preprepares:
            self._note_seq(seq, m.primary)
            self._accept_preprepare(
                PrePrepare(m.view, seq, cmd_id, origin, command, ts),
                skew_exempt=True,
            )

    # -- dispatch ------------------------------------------------------------

    def _on_message(self, msg: Message) -> None:
        if self.stopped:
            return
        try:
            m = ser.decode(msg.payload)
        except ser.SerializationError:
            return
        sender = msg.sender
        if msg.trace is not None and self._tracing():
            # clock-offset evidence for cross-node span ordering
            self.tracer.clock_sync.observe_header(sender, msg.trace)
        if isinstance(m, BftRequest):
            if sender == m.origin or sender == self.name:
                self._on_request(m, msg.trace)
        elif isinstance(m, PrePrepare):
            self._note_seq(m.seq, sender)
            self._on_preprepare(m, sender, msg.trace)
        elif isinstance(m, BftPrepare):
            if sender == m.replica and sender in self.peers:
                self._note_seq(m.seq, sender)
                self._record_prepare(m)
        elif isinstance(m, BftCommitMsg):
            if sender == m.replica and sender in self.peers:
                self._note_seq(m.seq, sender)
                self._record_commit(m)
        elif isinstance(m, BftReply):
            if sender == m.replica:
                self._on_reply(m)
        elif isinstance(m, ViewChange):
            if sender == m.replica and sender in self.peers:
                self._record_view_change(m)
        elif isinstance(m, NewView):
            self._on_new_view(m, sender)
        elif isinstance(m, NewViewRequest):
            if sender == m.replica and sender in self.peers:
                nv = self._sent_new_view.get(m.view)
                if nv is not None:
                    self.messaging.send(
                        self.topic, ser.encode(nv), m.replica
                    )
        elif isinstance(m, BftCheckpoint):
            if sender == m.replica and sender in self.peers:
                self._note_seq(m.seq, sender)
                self._record_checkpoint(m)
        elif isinstance(m, CatchUpRequest):
            if sender == m.replica and sender in self.peers:
                self._on_catchup_request(m)
        elif isinstance(m, CatchUpReply):
            if sender == m.replica and sender in self.peers:
                self._on_catchup_reply(m)

    def _send(self, peer: str, payload: bytes, trace=None) -> None:
        if trace is None:
            # the common untraced path keeps the bare send signature
            # (narrow test doubles stub send(topic, payload, target))
            self.messaging.send(self.topic, payload, peer)
        else:
            self.messaging.send(self.topic, payload, peer, trace=trace)

    def _broadcast(self, message, trace=None) -> None:
        payload = ser.encode(message)
        for peer in self.peers:
            if peer != self.name:
                self._send(
                    peer, payload,
                    trace=tracing.wire_trace(trace) if trace else None,
                )

    def stop(self) -> None:
        self.stopped = True
        remove = getattr(self.messaging, "remove_handler", None)
        if remove is not None:
            remove(self.topic, self._on_message)

    def __repr__(self) -> str:
        return (
            f"<BftReplica {self.name} view={self.view}"
            f" exec={self.exec_seq - 1}>"
        )


# ---------------------------------------------------------------------------
# the BFT notary service


class BFTNotaryService:
    """Non-validating BFT notary (BFTNonValidatingNotaryService.kt:29).

    The gateway member's service flow submits the tear-off to the
    cluster; EVERY replica independently verifies it, commits inputs to
    its own uniqueness map, and signs; the client side aggregates f+1
    matching outcomes. The service identity's owning key is a
    CompositeKey(threshold=f+1) over replica keys, so the standard
    signature check proves agreement."""

    validating = False

    def __init__(
        self,
        services,
        replica: BftReplica,
        service_identity,
        tolerance_micros: int = 30_000_000,
        member_key=None,
        member_keys: Optional[dict] = None,
    ):
        """`member_key`: the composite-leaf key this replica signs with
        (must be in key management); defaults to the node identity key —
        correct when the composite is built over member identities.
        `member_keys`: replica name -> expected signing key, used to
        validate reply signature shares before they count toward f+1
        (a byzantine 'ok' without a valid share must not poison the
        agreement bucket)."""
        from .notary import TimeWindowChecker

        self.services = services
        self.replica = replica
        self.service_identity = service_identity
        self.tolerance_micros = tolerance_micros
        self.time_window_checker = TimeWindowChecker(
            services.clock, tolerance_micros
        )
        self.committed: dict = {}   # this replica's stateRef -> tx id
        self._member_key = member_key
        self._member_keys = member_keys or {}
        replica.execute_fn = self._execute
        replica.validate_reply = self._validate_reply
        replica.snapshot_fn = self._snapshot
        replica.restore_fn = self._restore
        # proof-carrying view changes: replicas sign their PREPAREs so
        # prepared certificates verify independently of the fabric.
        # The hook-less fallback in _valid_prepared_entry (inbox/f+1
        # support) is a weaker, test-rig-only mode — every service
        # construction (and therefore every node-config path) MUST
        # leave the cluster in signed-certificate mode.
        replica.sign_prepare_fn = self._sign_prepare
        replica.verify_prepare_fn = self._verify_prepare

    # -- prepared-certificate signatures (PBFT view-change evidence) ---------

    def _prepare_hash(self, view: int, seq: int, digest: bytes):
        """Domain-separated signing payload for a PREPARE attestation:
        bound to the cluster name and (view, seq, digest) so a
        certificate entry cannot be replayed across clusters, views or
        sequence slots."""
        from ..crypto.hashes import SecureHash

        return SecureHash.sha256(
            b"bft-prepare\x00"
            + self.replica.cluster.encode()
            + b"\x00"
            + view.to_bytes(8, "big")
            + seq.to_bytes(8, "big")
            + digest
        )

    def _sign_prepare(self, view: int, seq: int, digest: bytes):
        return self.services.key_management.sign(
            self._prepare_hash(view, seq, digest),
            self._member_key
            or self.services.my_info.legal_identity.owning_key,
        )

    def _verify_prepare(
        self, replica_name: str, view: int, seq: int, digest: bytes, sig
    ) -> bool:
        from ..crypto.tx_signature import TransactionSignature

        if not isinstance(sig, TransactionSignature):
            return False
        # fail CLOSED on an unknown replica name: verifying against the
        # attestation's own embedded key would leave the claimed
        # identity unbound — a byzantine replica could sign with its
        # own key and label the entry with any honest peer's name,
        # fabricating a 2f+1 certificate. (Reply validation tolerates a
        # missing key because replies need f+1 AGREEING replicas;
        # certificate entries are each load-bearing.)
        expected = self._member_keys.get(replica_name)
        if expected is None or sig.by != expected:
            return False
        try:
            sig.verify(self._prepare_hash(view, seq, digest))
        except Exception:
            return False
        return True

    # -- state transfer (BFTSMaRt.kt:219 getSnapshot/installSnapshot) --------

    def _snapshot(self) -> list:
        """Canonical dump of the uniqueness map — the digest of this
        value is what checkpoints attest (shared with the Raft
        provider: notary.snapshot_uniqueness_map)."""
        from .notary import snapshot_uniqueness_map

        return snapshot_uniqueness_map(self.committed)

    def _restore(self, state, seq: int) -> None:
        from .notary import restore_uniqueness_map

        self.committed = restore_uniqueness_map(state)

    def _validate_reply(self, outcome, replica_name: str, signature) -> bool:
        outcome = list(outcome)
        if outcome and outcome[0] == "ok":
            if signature is None:
                return False
            from ..crypto.hashes import SecureHash
            from ..crypto.tx_signature import TransactionSignature

            if not isinstance(signature, TransactionSignature):
                return False
            expected = self._member_keys.get(replica_name)
            if expected is not None and signature.by != expected:
                return False
            try:
                signature.verify(SecureHash(bytes(outcome[1])))
            except Exception:
                return False
        return True

    @property
    def identity(self):
        return self.service_identity

    # -- the deterministic replica state machine -----------------------------

    def _execute(self, command, timestamp: int):
        """(outcome, signature): verify tear-off, commit, sign — what
        the reference replica does in BFTSMaRt.Replica (BFTSMaRt.kt:
        executeCommand: verify + commitInputStates + sign). `timestamp`
        is the primary's ordering time: time-window validation uses it
        so every replica computes the SAME outcome."""
        from ..core.transactions import (
            FilteredTransaction,
            G_INPUTS,
            G_NOTARY,
            G_TIMEWINDOW,
            TransactionVerificationError,
        )
        from ..crypto.hashes import SecureHash

        kind, ftx_b = command
        assert kind == "notarise", f"unknown bft command {kind!r}"
        try:
            ftx = ser.decode(bytes(ftx_b))
        except ser.SerializationError:
            return ["err", "invalid-proof", "undecodable tear-off"], None
        if not isinstance(ftx, FilteredTransaction):
            return ["err", "invalid-proof", "not a tear-off"], None
        try:
            ftx.verify()
        except TransactionVerificationError as e:
            return ["err", "invalid-proof", str(e)], None
        for g, what in (
            (G_INPUTS, "inputs"),
            (G_NOTARY, "notary"),
            (G_TIMEWINDOW, "time window"),
        ):
            if not ftx.all_revealed(g):
                return ["err", "incomplete-tearoff", f"tear-off hides {what}"], None
        if ftx.notary != self.identity:
            return ["err", "wrong-notary", f"tx names {ftx.notary}"], None
        if not self.time_window_checker.is_valid(
            ftx.time_window, now=timestamp
        ):
            return ["err", "time-window-invalid", str(ftx.time_window)], None
        conflict = {
            str(ref): str(self.committed[ref])
            for ref in ftx.inputs
            if ref in self.committed and self.committed[ref] != ftx.id
        }
        if conflict:
            return ["err", "conflict", conflict], None
        for ref in ftx.inputs:
            self.committed[ref] = ftx.id
        sig = self.services.key_management.sign(
            ftx.id,
            self._member_key
            or self.services.my_info.legal_identity.owning_key,
        )
        return ["ok", ftx.id.bytes_], sig

    # -- the NotaryService surface (generator, like the others) --------------

    def process(self, ftx, requester, deadline=None, trace=None):
        del deadline   # accepted for flow-call parity; BFT replicas
        #                order every admitted request (notary.py
        #                SimpleNotaryService.process note)
        from ..core.transactions import FilteredTransaction
        from ..flows.api import wait_future
        from .notary import NotaryError

        if not isinstance(ftx, FilteredTransaction):
            return NotaryError("invalid-proof", "BFT notary takes a tear-off")
        # lifecycle ledger: the BFT flavour's coordinator-side admit +
        # terminal (replicas stamp their own consensus.commit events)
        story = getattr(self.services, "txstory", None)
        if story is not None:
            story.admit(
                str(ftx.id), requester=getattr(requester, "name", None)
            )
        fut = self.replica.submit(["notarise", ser.encode(ftx)], trace=trace)
        try:
            outcome, sigs = yield from wait_future(fut)
        except BftUnavailable as e:
            err = NotaryError("unavailable", str(e))
            if story is not None:
                story.terminal_from(str(ftx.id), err)
            return err
        outcome = list(outcome)
        if outcome[0] == "err":
            kind, detail = outcome[1], outcome[2]
            conflict = dict(detail) if kind == "conflict" else None
            err = NotaryError(
                kind,
                str(detail) if conflict is None else "input states consumed",
                conflict=conflict,
            )
            if story is not None:
                story.terminal_from(str(ftx.id), err)
            return err
        if story is not None:
            story.close(str(ftx.id), "committed")
        return list(sigs)
