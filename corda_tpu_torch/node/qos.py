"""SLO-aware admission control + adaptive batching for the serving path.

Port of corda_tpu/node/qos.py, whole: deadline propagation and the one
expiry predicate (`DeadlineExpired`, `expired`), the per-client
`TokenBucket`, the two priority lanes (`LaneRouter`, weighted-fair
drain, `_classify_by_topic`), the AIMD `AdaptiveBatchController`, the
brownout state machine and the `NotaryQos` facade with its shed
vocabulary (`SHED_*`) and `snapshot()` — the reference's arithmetic and
dict layout unchanged, so one drive on a TestClock leaves equal
snapshots in both packages. Everything here is host-side control plane:
it decides which requests reach the notary's verify dispatch (on the
card, CudaBatchVerifier) and how deep each flush is; with `qos=None`
the notary's hot path pays a single attribute check.

Four cooperating pieces behind one `NotaryQos` facade:

  deadline propagation — an optional absolute-microsecond deadline
      rides the fabric as a message header (messaging.Message.deadline)
      and through the ingest pipeline. An expired request is shed at
      the CHEAPEST point it is noticed — pre-decode at ingress,
      pre-stage at the flush — into a typed `shed` NotaryError instead
      of being verified for nobody.

  priority lanes — two bounded ingest rings (`interactive` for fresh
      notarisation requests, `bulk` for resolution floods and other
      elastic traffic) with weighted-fair draining, so a bulk flood can
      delay bulk, never starve interactive. A per-client token bucket
      caps any single sender's admission rate.

  adaptive batching — a feedback controller that retunes the notary's
      effective `max_wait_micros` / `max_batch` each flush from the
      observed queue depth and the admitted-request latency p99 against
      a configured target: latency above target collapses the batching
      window multiplicatively; latency comfortably under target with
      full batches stretches it additively — AIMD.

  brownout — when the backlog keeps growing for K consecutive flushes
      despite the controller, degrade deliberately: level 1 sheds the
      bulk lane at admission, level 2 additionally sheds deadline-less
      interactive traffic. Every shed increments a `Qos.Shed.<reason>`
      counter and the controller state is exported as gauges.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..utils import locks
from ..utils.metrics import Histogram, MetricRegistry

# shed reasons — ONE vocabulary for counters, NotaryError.kind payloads
# and the /qos endpoint, so dashboards and clients never fork
SHED_KIND = "shed"                    # NotaryError.kind for every shed

SHED_EXPIRED_INGRESS = "ExpiredIngress"   # dead on arrival, pre-decode
SHED_EXPIRED_FLUSH = "ExpiredFlush"       # died queued, pre-stage
SHED_ADMISSION = "Admission"              # per-client token bucket
SHED_BROWNOUT_BULK = "BrownoutBulk"       # level >= 1: bulk lane dropped
SHED_BROWNOUT_NO_DEADLINE = "BrownoutNoDeadline"  # level >= 2

LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"


class DeadlineExpired(Exception):
    """Pre-decode shed marker: the frame's deadline passed before any
    work was spent on it. Carried in IngestedTx.error so the wire path
    reports sheds per-slot exactly like malformed frames."""

    def __init__(self, deadline_micros: int, now_micros: int):
        self.deadline_micros = deadline_micros
        self.now_micros = now_micros
        super().__init__(
            f"deadline {deadline_micros} expired "
            f"{now_micros - deadline_micros} us before processing"
        )


def expired(deadline_micros: Optional[int], now_micros: int) -> bool:
    """The ONE expiry predicate (ingest, lanes, notary flush all call
    this): None never expires; expiry is inclusive so a deadline equal
    to `now` sheds — serving it would complete strictly after it."""
    return deadline_micros is not None and now_micros >= deadline_micros


@dataclass(frozen=True)
class QosPolicy:
    """Operator knobs (config.py maps node TOML onto this).

    `target_p99_micros` is THE SLO: the controller holds the admitted-
    request p99 completion latency at or under it. The wait/batch
    bounds fence the controller — it tunes freely inside them, so a
    misbehaving feedback signal can degrade batching efficiency but
    never violate the operator's latency floor/ceiling outright."""

    target_p99_micros: int = 50_000
    min_wait_micros: int = 0
    max_wait_micros: int = 20_000
    min_batch: int = 16
    max_batch: int = 512
    # weighted-fair drain: per round, up to `interactive_weight` frames
    # leave the interactive ring for every `bulk_weight` bulk frames
    interactive_weight: int = 4
    bulk_weight: int = 1
    lane_depth: int = 4096            # per-lane ring bound (frames)
    # per-client token bucket at the fabric seam; rate 0 disables
    admission_rate_per_sec: float = 0.0
    admission_burst: int = 256
    # brownout: raise the level after this many consecutive flushes of
    # growing backlog, drop it after the same count of shrinking ones
    brownout_after_flushes: int = 4
    # additive increase step for the batching window (micros per flush)
    wait_step_micros: int = 1_000


class TokenBucket:
    """Per-client admission gate at the fabric seam.

    Classic token bucket in integer microseconds: `rate` tokens/sec
    refill, `burst` capacity. One bucket per client name, created on
    first sight; clients the map never admitted cannot reach this layer
    (the fabric authenticated the sender), so the table is bounded by
    the peer set."""

    def __init__(self, rate_per_sec: float, burst: int):
        self.rate = float(rate_per_sec)
        self.burst = max(1, int(burst))
        self._lock = locks.make_lock("TokenBucket._lock")
        self._state: dict[str, tuple[float, int]] = {}  # name -> (tokens, t)

    def admit(self, client: str, now_micros: int, cost: int = 1) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            tokens, t_prev = self._state.get(client, (float(self.burst), now_micros))
            tokens = min(
                float(self.burst),
                tokens + (now_micros - t_prev) * self.rate / 1e6,
            )
            if tokens < cost:
                self._state[client] = (tokens, now_micros)
                return False
            self._state[client] = (tokens - cost, now_micros)
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate_per_sec": self.rate,
                "burst": self.burst,
                "clients": len(self._state),
            }


class LaneRouter:
    """Two bounded rings in front of the ingest pipeline with weighted-
    fair draining — the fabric-seam half of the QoS plane.

    `offer(msg)` is ring-shaped so `MessagingService.add_ring` can
    route a topic straight into a lane: it admission-gates the sender,
    sheds expired / browned-out frames PRE-DECODE (a count and a falsy
    return of work, not a park — a shed frame must not be redelivered),
    and enqueues survivors on the lane the classifier picks. `drain`
    interleaves the lanes by weight so a resolution flood on `bulk` can
    never starve `interactive` notarisations; within a lane order stays
    FIFO. Returns True from offer for every consumed-or-shed frame —
    False ONLY when the target lane is full, which is the park-for-
    retry_parked backpressure signal the fabric already speaks."""

    def __init__(
        self,
        qos: "NotaryQos",
        classify: Optional[Callable[[Any], str]] = None,
    ):
        from .ingest import IngestRing

        self._qos = qos
        policy = qos.policy
        self.lanes = {
            LANE_INTERACTIVE: IngestRing(depth=policy.lane_depth),
            LANE_BULK: IngestRing(depth=policy.lane_depth),
        }
        self._classify = classify or _classify_by_topic
        self._weights = (
            max(1, policy.interactive_weight),
            max(1, policy.bulk_weight),
        )

    def offer(self, msg) -> bool:
        qos = self._qos
        now = qos.now_micros()
        deadline = getattr(msg, "deadline", None)
        if expired(deadline, now):
            qos.count_shed(SHED_EXPIRED_INGRESS)
            return True   # consumed: dead on arrival, zero decode spent
        sender = getattr(msg, "sender", "")
        if sender and not qos.admission.admit(sender, now):
            qos.count_shed(SHED_ADMISSION)
            return True
        lane = self._classify(msg)
        if lane not in self.lanes:
            lane = LANE_BULK
        level = qos.brownout_level
        if level >= 1 and lane == LANE_BULK:
            qos.count_shed(SHED_BROWNOUT_BULK)
            return True
        if level >= 2 and lane == LANE_INTERACTIVE and deadline is None:
            # deadline-less traffic cannot be meaningfully prioritised
            # under brownout: the client gave us no SLO to serve it by
            qos.count_shed(SHED_BROWNOUT_NO_DEADLINE)
            return True
        return self.lanes[lane].offer(msg)

    def drain(self, budget: Optional[int] = None) -> list:
        """Weighted-fair interleave across the lanes, up to `budget`
        frames (None = everything waiting). Expired frames are shed
        here too — they may have died *queued* — still pre-decode."""
        qos = self._qos
        w_i, w_b = self._weights
        inter, bulk = self.lanes[LANE_INTERACTIVE], self.lanes[LANE_BULK]
        out: list = []
        now = qos.now_micros()

        def take(ring, n: int) -> int:
            moved = 0
            while moved < n:
                item = ring.take(timeout=0)
                if item is None:
                    break
                if expired(getattr(item, "deadline", None), now):
                    qos.count_shed(SHED_EXPIRED_INGRESS)
                    continue   # shed, but the slot was drained: count it
                out.append(item)
                moved += 1
            return moved

        while budget is None or len(out) < budget:
            room = None if budget is None else budget - len(out)
            got = take(inter, w_i if room is None else min(w_i, room))
            room = None if budget is None else budget - len(out)
            got += take(bulk, w_b if room is None else min(w_b, room))
            if not got:
                break
        return out

    def depth(self) -> int:
        return sum(len(r) for r in self.lanes.values())

    def close(self) -> None:
        for r in self.lanes.values():
            r.close()


def _classify_by_topic(msg) -> str:
    """Default lane classifier: resolution/backchain topics are bulk,
    everything else (notarisation requests, session traffic) is
    interactive. Topic names are the only signal every fabric carries."""
    topic = getattr(msg, "topic", "") or ""
    if "resolve" in topic or "resolution" in topic or "bulk" in topic:
        return LANE_BULK
    return LANE_INTERACTIVE


class AdaptiveBatchController:
    """The feedback loop: (max_wait_micros, max_batch) retuned each
    flush to hold the admitted-request p99 at the target while keeping
    batch occupancy — the throughput lever (the serving rate rides
    flush depth) — as high as the SLO allows.

    AIMD on the batching window: p99 above target halves the window
    (and sheds depth pressure immediately — latency breaches are paid
    by EVERY queued request, so the reaction is multiplicative); p99
    under half the target with full flushes stretches the window one
    additive step. `max_batch` follows the window: a collapsed window
    also caps depth so one flush can't blow the budget, a stretched one
    re-opens toward the policy ceiling."""

    def __init__(self, policy: QosPolicy, latency: Histogram):
        self.policy = policy
        self.latency = latency            # admitted micros, shared w/ /qos
        self.wait_micros = min(
            max(policy.min_wait_micros, policy.max_wait_micros // 4),
            policy.max_wait_micros,
        )
        self.batch = policy.max_batch
        self.flushes = 0
        self._last_p99 = 0.0

    def observe_flush(self, batch_size: int, backlog: int) -> None:
        """Called after every flush with the depth it served and the
        backlog it left behind (lanes + re-queued arrivals)."""
        pol = self.policy
        self.flushes += 1
        p99 = self.latency.quantile(0.99)
        self._last_p99 = p99
        if p99 > pol.target_p99_micros:
            self.wait_micros = max(pol.min_wait_micros, self.wait_micros // 2)
            self.batch = max(pol.min_batch, self.batch // 2)
        elif p99 < pol.target_p99_micros * 0.5:
            if batch_size >= self.batch or backlog == 0:
                self.wait_micros = min(
                    pol.max_wait_micros,
                    self.wait_micros + pol.wait_step_micros,
                )
            self.batch = min(pol.max_batch, max(self.batch * 2, pol.min_batch))

    def snapshot(self) -> dict:
        return {
            "wait_micros": self.wait_micros,
            "batch": self.batch,
            "target_p99_micros": self.policy.target_p99_micros,
            "admitted_p99_micros": round(self._last_p99, 1),
            "flushes_observed": self.flushes,
        }


class NotaryQos:
    """The facade the notary, node wiring, webserver and tests hold.

    Owns the admission gate, the lanes, the adaptive controller, the
    brownout state machine and every Qos.* metric — registered on the
    node's MetricRegistry so /metrics carries them, mirrored as JSON by
    `snapshot()` for GET /qos. `now_micros` is injected (the node
    clock) so simulated-time rigs drive the whole control plane
    deterministically."""

    def __init__(
        self,
        policy: Optional[QosPolicy] = None,
        clock=None,
        metrics: Optional[MetricRegistry] = None,
        classify: Optional[Callable[[Any], str]] = None,
    ):
        self.policy = policy or QosPolicy()
        self._clock = clock
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.admission = TokenBucket(
            self.policy.admission_rate_per_sec, self.policy.admission_burst
        )
        # admitted-request completion latency (micros, node clock):
        # the controller's feedback signal AND the /qos p99 readout
        self.admitted_latency = self.metrics.histogram(
            "Qos.AdmittedLatencyMicros"
        )
        self.controller = AdaptiveBatchController(
            self.policy, self.admitted_latency
        )
        self.lanes = LaneRouter(self, classify=classify)
        self._shed: dict[str, Any] = {}
        self.admitted = self.metrics.counter("Qos.Admitted")
        self.answered = self.metrics.counter("Qos.Answered")
        self._brownout_level = 0
        self._backlog_trend = 0       # +k growing / -k shrinking streak
        self._last_backlog = 0
        # every brownout level change, as (node-clock micros, new
        # level): the assertion surface chaos rigs reconcile against —
        # "brownout engaged during the spike and ONLY during the
        # spike" needs the transition times, not just the live level.
        # Bounded (an oscillation bug must not grow memory forever).
        self.brownout_transitions: list[tuple[int, int]] = []
        self._lock = locks.make_lock("NotaryQos._lock")
        # sharded commit plane: one AIMD controller + admitted
        # latency histogram PER SHARD, created by ensure_shards — a hot
        # shard (one partition's refs contended or deep) then collapses
        # ITS batching window without browning out its siblings. The
        # global controller stays as the unsharded/back-compat lane.
        self.shard_controllers: list[AdaptiveBatchController] = []
        self._shard_latency: list[Histogram] = []
        # distributed cross-shard commit latency lane:
        # created lazily on the first record_xshard so nodes without
        # the distributed plane register no extra series
        self._xshard_latency: Optional[Histogram] = None
        self.metrics.gauge(
            "Qos.Controller.WaitMicros", lambda: self.controller.wait_micros
        )
        self.metrics.gauge(
            "Qos.Controller.Batch", lambda: self.controller.batch
        )
        self.metrics.gauge("Qos.BrownoutLevel", lambda: self._brownout_level)
        self.metrics.gauge("Qos.LaneDepth", self.lanes.depth)
        # transaction lifecycle ledger (utils/txstory.py): wired by
        # node.py when the provenance plane is on — admit/shed events
        # with the tx id land in the per-tx story next to the counters
        self.txstory = None

    # -- lifecycle-ledger hooks -----------------------------------------------

    def admit_tx(self, tx_id) -> None:
        """Count one admitted request AND stamp `qos.admit` on its
        lifecycle story (when both the ledger and a tx id are known —
        pre-decode lane traffic has no id yet and only counts).
        `tx_id` may be the raw SecureHash: the str conversion is paid
        only when a ledger is attached."""
        self.admitted.inc()
        if self.txstory is not None and tx_id is not None:
            self.txstory.record(str(tx_id), "qos.admit")

    def shed_tx(
        self,
        reason: str,
        tx_id=None,
        terminal: bool = False,
    ) -> None:
        """Count one shed AND stamp `qos.shed` (with the reason) on
        the transaction's story. `terminal=True` additionally CLOSES
        the story as shed — the pre-queue shed sites, where no answer
        future exists to carry the terminal; flush-time sheds resolve
        their future and terminal through it instead."""
        self.count_shed(reason)
        if self.txstory is not None and tx_id is not None:
            from ..utils.txstory import shed_reason as _canonical

            tid = str(tx_id)
            self.txstory.record(tid, "qos.shed", reason=reason)
            if terminal:
                self.txstory.close(tid, "shed", reason=_canonical(reason))

    # -- clock ----------------------------------------------------------------

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    # -- shed accounting ------------------------------------------------------

    def count_shed(self, reason: str) -> None:
        counter = self._shed.get(reason)
        if counter is None:
            with self._lock:
                counter = self._shed.get(reason)
                if counter is None:
                    counter = self.metrics.counter("Qos.Shed." + reason)
                    self._shed[reason] = counter
        counter.inc()

    @property
    def shed_total(self) -> int:
        with self._lock:
            counters = list(self._shed.values())
        return sum(c.count for c in counters)

    # -- per-shard lanes ------------------------------------------------------

    def ensure_shards(self, n: int) -> None:
        """Create the per-shard controller lanes (idempotent; called by
        the sharded BatchingNotaryService with its shard count). Each
        lane = its own AIMD controller over its own
        Qos.Shard<k>.AdmittedLatencyMicros histogram, fenced by the SAME
        policy — so per-shard tuning can never escape the operator's
        latency floor/ceiling either."""
        while len(self.shard_controllers) < n:
            k = len(self.shard_controllers)
            hist = self.metrics.histogram(
                f"Qos.Shard{k}.AdmittedLatencyMicros"
            )
            self._shard_latency.append(hist)
            self.shard_controllers.append(
                AdaptiveBatchController(self.policy, hist)
            )
            self.metrics.gauge(
                f"Qos.Shard{k}.Batch",
                (lambda c=self.shard_controllers[k]: c.batch),
            )
            self.metrics.gauge(
                f"Qos.Shard{k}.WaitMicros",
                (lambda c=self.shard_controllers[k]: c.wait_micros),
            )

    def controller_for(self, shard: Optional[int]):
        """The AIMD lane steering one shard's flush (the global
        controller when unsharded or for an unknown shard id)."""
        if shard is None or shard >= len(self.shard_controllers):
            return self.controller
        return self.shard_controllers[shard]

    def observe_shard_flush(
        self, shard: int, batch_size: int, backlog: int
    ) -> None:
        """Per-shard flush feedback: retunes THAT shard's lane only.
        Brownout deliberately does not walk here — one hot shard must
        not brown out the whole node; the notary tick feeds the
        aggregate backlog to observe_backlog once per pump round."""
        self.controller_for(shard).observe_flush(batch_size, backlog)

    # -- flush feedback -------------------------------------------------------

    def record_admitted(
        self, latency_micros: int, shard: Optional[int] = None
    ) -> None:
        self.answered.inc()
        self.admitted_latency.update(max(0, latency_micros))
        if shard is not None and shard < len(self._shard_latency):
            self._shard_latency[shard].update(max(0, latency_micros))

    # -- cross-shard lane -----------------------------------------------------

    def record_xshard(self, latency_micros: int) -> None:
        """Resolution latency of one DISTRIBUTED cross-shard commit
        (reserve sent -> decided/aborted, node-clock micros). Its own
        lane, not mixed into the admitted histogram: a cross-member
        round trip is structurally slower than a local flush commit,
        and folding it in would stretch the adaptive controller's p99
        signal — the operator reads the two latencies side by side at
        GET /qos instead."""
        hist = self._xshard_latency
        if hist is None:
            with self._lock:
                hist = self._xshard_latency
                if hist is None:
                    hist = self.metrics.histogram("Qos.XShardLatencyMicros")
                    self._xshard_latency = hist
        hist.update(max(0, latency_micros))

    def xshard_snapshot(self) -> dict:
        hist = self._xshard_latency
        if hist is None:
            return {"count": 0}
        return {
            "count": hist.count,
            "p50_micros": hist.quantile(0.5),
            "p99_micros": hist.quantile(0.99),
        }

    def observe_flush(self, batch_size: int, backlog: int) -> None:
        """One call per notary flush: feeds the controller and walks
        the brownout state machine on the backlog trend."""
        self.controller.observe_flush(batch_size, backlog)
        self.observe_backlog(backlog)

    def observe_backlog(self, backlog: int) -> None:
        """Walk the brownout state machine on the (aggregate) backlog
        trend — split from observe_flush so the sharded notary can feed
        per-shard controller observations separately from the ONE
        node-level backlog observation per pump round."""
        pol = self.policy
        with self._lock:
            # "growing" means NOT draining: a backlog holding level or
            # rising despite the flush. A shrinking backlog — however
            # large — is recovery and must step the level DOWN, not up
            # (a single deep burst draining over several flushes is
            # not sustained overload).
            if backlog > 0 and backlog >= self._last_backlog:
                self._backlog_trend = max(1, self._backlog_trend + 1)
            else:
                self._backlog_trend = min(-1, self._backlog_trend - 1)
            self._last_backlog = backlog
            if self._backlog_trend >= pol.brownout_after_flushes:
                if self._brownout_level < 2:
                    self._brownout_level += 1
                    self._note_transition()
                self._backlog_trend = 0
            elif self._backlog_trend <= -pol.brownout_after_flushes:
                if self._brownout_level > 0:
                    self._brownout_level -= 1
                    self._note_transition()
                self._backlog_trend = 0

    def _note_transition(self) -> None:
        """Record one brownout level change (caller holds the lock)."""
        self.brownout_transitions.append(
            (self.now_micros(), self._brownout_level)
        )
        if len(self.brownout_transitions) > 256:
            del self.brownout_transitions[:128]

    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """The GET /qos payload: JSON-safe, one read of live state."""
        lanes = {
            name: {"depth": len(ring), "high_water": ring.high_water}
            for name, ring in self.lanes.lanes.items()
        }
        with self._lock:
            # copy under the lock count_shed inserts under: the
            # webserver thread must not iterate a dict the pump thread
            # is growing mid-overload (the exact moment /qos matters)
            shed = dict(self._shed)
        shard_lanes = [
            c.snapshot() for c in list(self.shard_controllers)
        ]
        return {
            "enabled": True,
            "controller": self.controller.snapshot(),
            # per-shard AIMD lanes: one entry per commit-plane
            # shard, in shard order — empty when unsharded
            "shards": shard_lanes,
            "brownout": {
                "level": self._brownout_level,
                "trend": self._backlog_trend,
                "after_flushes": self.policy.brownout_after_flushes,
                # (at_micros, level) history — the chaos-rig assertion
                # surface (tail only; the live level is above)
                "transitions": [
                    list(t) for t in self.brownout_transitions[-16:]
                ],
            },
            "shed": {
                reason: counter.count
                for reason, counter in sorted(shed.items())
            },
            "shed_total": self.shed_total,
            # distributed cross-shard commit latency: its
            # own lane next to the admitted p99 — count 0 when the
            # node runs no distributed plane
            "xshard": self.xshard_snapshot(),
            "admitted": self.admitted.count,
            "answered": self.answered.count,
            "admission": self.admission.snapshot(),
            "lanes": lanes,
            "policy": {
                "target_p99_micros": self.policy.target_p99_micros,
                "max_wait_micros": self.policy.max_wait_micros,
                "max_batch": self.policy.max_batch,
                "interactive_weight": self.policy.interactive_weight,
                "bulk_weight": self.policy.bulk_weight,
            },
        }
