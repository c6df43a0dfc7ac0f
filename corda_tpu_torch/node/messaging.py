"""Messaging fabric: topic/peer addressed, durable-queue semantics.

Port of corda_tpu/node/messaging.py: `Message`, `MessagingService`,
`FabricFaults` and the in-memory fabric (`InMemoryMessagingNetwork`,
`InMemoryMessaging`) with its manual pump and (sender, unique_id)
dedupe, and the ingest-ring seam (`add_ring`, `parked_count`,
`retry_parked`, `register_ring_gauges`) that the verifier worker's and
the notary's pipelined ingest drain, and the wire-telemetry seam: an
endpoint's `telemetry` (a utils/wire_telemetry.WireAccounting) records
its sends, deliveries and dedupe hits, and `wire_depths()` feeds the
wire plane's tick. The TCP fabric is node/fabric.py.

Reference: the `MessagingService` API (node/.../services/messaging/
Messaging.kt — send, addMessageHandler(topic), createMessage) backed in
production by an embedded Artemis broker with per-peer store-and-forward
queues and TLS bridges (ArtemisMessagingServer.kt:90,300-401), and in
Ring-3 tests by `InMemoryMessagingNetwork` with manually-pumped
deterministic delivery (test-utils/.../InMemoryMessagingNetwork.kt:47).

This module provides the API plus the in-memory fabric. Delivery
guarantees match Artemis semantics: per-(sender, target) FIFO, at-least-
once upstream with exactly-once to handlers via (sender, unique_id)
dedupe. Payloads are canonical-serialized bytes — even in-memory
delivery round-trips through the wire encoding so serialization gaps
surface in Ring-3 tests, not in production.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import locks

TOPIC_SESSION = "platform.session"
TOPIC_VERIFIER_REQ = "verifier.requests"
TOPIC_VERIFIER_RES = "verifier.responses"
# distributed sharded uniqueness (node/distributed_uniqueness.py): the
# cross-member two-phase reserve→commit protocol — ShardReserve /
# ShardReserveAck / ShardCommit / ShardCommitAck / ShardAbort plus the
# presumed-abort status queries — all ride this one topic
TOPIC_XSHARD = "notary.xshard"

# dedupe-table bound (the reference's TCP fabric shares it): the newest
# DEDUPE_KEEP dispatched (sender, uid) keys are retained; older ones
# prune away so a long soak's dedupe state stays bounded. Safe because
# senders stop re-offering a frame once it acks — only an explicit
# `unique_id=` replay could carry a key older than the watermark.
DEDUPE_KEEP = 8192


@dataclass(frozen=True)
class Message:
    topic: str
    payload: bytes          # canonical-serialized body
    sender: str             # peer name of origin
    unique_id: int          # per-sender unique id (dedupe key)
    # OPTIONAL tracing header (utils/tracing.py): the sender's
    # (trace_id, span_id) SpanContext pair, so a receiver's spans join
    # the SAME trace — one connected tree per notarisation across the
    # fabric hop. None (the default) everywhere tracing is off; the
    # field is observability metadata, never consensus input.
    trace: Optional[tuple] = None
    # OPTIONAL deadline header (node/qos.py): absolute node-clock
    # microseconds after which the SENDER no longer wants an answer.
    # Consumers shed expired work at the cheapest point they notice it
    # (pre-decode at ingress, pre-stage at the notary flush) into a
    # typed `shed` response. QoS metadata, never consensus input — but
    # unlike `trace` it IS journaled across the TCP fabric: a frame
    # redelivered after a crash should still be shed if it expired.
    deadline: Optional[int] = None


Handler = Callable[[Message], None]


class MessagingService:
    """Send/handle interface every node component talks through."""

    def send(
        self,
        topic: str,
        payload: bytes,
        target: str,
        unique_id: Optional[int] = None,
        trace: Optional[tuple] = None,
        deadline: Optional[int] = None,
    ) -> None:
        """`trace`: optional tracing SpanContext header (see
        Message.trace); trace propagation is best-effort, delivery
        semantics are not. `deadline`: optional absolute-microsecond
        QoS header (Message.deadline) — both ride the fabric as
        headers, never as payload."""
        raise NotImplementedError

    def add_handler(self, topic: str, handler: Handler) -> None:
        raise NotImplementedError

    def add_ring(self, topic: str, ring, metrics=None) -> None:
        """OPTIONAL bulk-ingest seam (node/ingest.py): deliver `topic`
        messages into a bounded ring (`ring.offer(msg) -> bool`)
        instead of per-message handler dispatch, so a consumer can
        decode whole delivery rounds through the sharded ingest
        pipeline. A full ring parks the frame for redelivery
        (`retry_parked`) — backpressure without blocking the pump.
        Fabrics that don't implement it raise, and callers fall back
        to the per-message handler path.

        `metrics`: an optional MetricRegistry; implementations register
        ring-depth / high-water / parked-frame gauges for the topic
        (see register_ring_gauges)."""
        raise NotImplementedError(f"{type(self).__name__} has no ring seam")

    @property
    def my_address(self) -> str:
        raise NotImplementedError


def register_ring_gauges(metrics, topic: str, ring, parked_count=None) -> None:
    """Gauges over one topic's ingest ring: current depth, lifetime
    high-water mark, and (when the fabric exposes a counter) frames
    parked waiting for retry_parked. ONE naming scheme for every
    fabric, so dashboards don't fork per transport."""
    metrics.gauge(f"Ingest.{topic}.RingDepth", lambda: len(ring))
    metrics.gauge(f"Ingest.{topic}.RingHighWater", lambda: ring.high_water)
    if parked_count is not None:
        metrics.gauge(f"Ingest.{topic}.Parked", parked_count)


class FabricFaults:
    """First-class fault-injection seam shared by BOTH fabrics.

    The chaos plane (testing/fleet.py) needs to break the network the
    way production breaks — partitions, dead nodes, slow links, frame
    drop/duplication — WITHOUT monkeypatching fabric internals. This
    object is the injection point: the in-memory fabric consults it at
    delivery time (simulated-time delays on the shared TestClock), the
    TCP fabric (node/fabric.py) consults it at bridge-connect, accept
    and per-frame ingest time (real-time delays). Both fabrics keep
    their delivery guarantees UNDER the faults — a blocked or delayed
    frame stays queued/journaled and redelivers on heal, a duplicated
    frame is absorbed by (sender, uid) dedupe — so chaos tests exercise
    the same code paths a real outage would.

    Every control-plane call appends to `log` with a fault-clock
    timestamp: the "injected reality" an invariant checker compares the
    health/cluster story against. Thread-safe: the TCP fabric reads
    from its loop thread while a test thread injects.
    """

    def __init__(self, clock=None, seed: int = 0):
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = locks.make_lock("FabricFaults._lock")
        self._groups: tuple[frozenset, ...] = ()   # partition groups
        self._down: set[str] = set()               # killed nodes
        self._delay: dict[tuple[str, str], int] = {}    # directional us
        self._drop: dict[tuple[str, str], float] = {}   # drop probability
        self._dup: dict[tuple[str, str], float] = {}    # dup probability
        self.log: list[dict] = []

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        import time

        return time.time_ns() // 1_000

    def _record(self, action: str, **detail) -> None:
        self.log.append(
            {"at_micros": self.now_micros(), "action": action, **detail}
        )

    # -- control plane (the chaos side) --------------------------------------

    def partition(self, *groups) -> None:
        """Split the network: links BETWEEN groups are blocked (both
        directions), links within a group stay up. Nodes in no group
        are unreachable from every group — `partition({"A","B"})`
        isolates everyone else from A and B. Replaces any previous
        partition; `heal()` removes it."""
        with self._lock:
            self._groups = tuple(frozenset(g) for g in groups)
        self._record("partition", groups=[sorted(g) for g in groups])

    def heal(self) -> None:
        with self._lock:
            self._groups = ()
        self._record("heal")

    def kill(self, name: str) -> None:
        """Mark a node down: nothing reaches it, nothing leaves it.
        Frames addressed to it stay queued (in-memory) / journaled
        (TCP) and deliver after `revive` — the store-and-forward
        semantics a real crash exercises."""
        with self._lock:
            self._down.add(name)
        self._record("kill", node=name)

    def revive(self, name: str) -> None:
        with self._lock:
            self._down.discard(name)
        self._record("revive", node=name)

    def slow_link(
        self, a: str, b: str, delay_micros: int, symmetric: bool = True
    ) -> None:
        """Add per-frame latency on a link (0 clears it). The in-memory
        fabric holds frames until the TestClock passes send+delay; the
        TCP fabric sleeps the same interval before acking."""
        with self._lock:
            for pair in ((a, b), (b, a)) if symmetric else ((a, b),):
                if delay_micros > 0:
                    self._delay[pair] = int(delay_micros)
                else:
                    self._delay.pop(pair, None)
        self._record(
            "slow_link", a=a, b=b,
            delay_micros=int(delay_micros), symmetric=symmetric,
        )

    def slow_peer(self, name: str, delay_micros: int, peers=()) -> None:
        """Slow EVERY link touching `name` (both directions). With a
        known peer set, pass it; the wildcard key slows links to/from
        unknown peers too."""
        with self._lock:
            for key in (("*", name), (name, "*")):
                if delay_micros > 0:
                    self._delay[key] = int(delay_micros)
                else:
                    self._delay.pop(key, None)
        for p in peers:
            self.slow_link(name, p, delay_micros)
        if not peers:
            self._record(
                "slow_peer", node=name, delay_micros=int(delay_micros)
            )

    def drop_link(
        self, a: str, b: str, rate: float, symmetric: bool = True
    ) -> None:
        """Drop frames on a link with probability `rate` (0 clears).
        Safe only for traffic with an upstream retry (consensus
        heartbeats, the TCP fabric's journaled bridges) — the seeded
        RNG keeps runs deterministic."""
        with self._lock:
            for pair in ((a, b), (b, a)) if symmetric else ((a, b),):
                if rate > 0:
                    self._drop[pair] = float(rate)
                else:
                    self._drop.pop(pair, None)
        self._record("drop_link", a=a, b=b, rate=rate, symmetric=symmetric)

    def duplicate_link(
        self, a: str, b: str, rate: float, symmetric: bool = True
    ) -> None:
        """Deliver frames twice with probability `rate` (0 clears) —
        the receiver's (sender, uid) dedupe must absorb the copy."""
        with self._lock:
            for pair in ((a, b), (b, a)) if symmetric else ((a, b),):
                if rate > 0:
                    self._dup[pair] = float(rate)
                else:
                    self._dup.pop(pair, None)
        self._record(
            "duplicate_link", a=a, b=b, rate=rate, symmetric=symmetric
        )

    # -- query plane (the fabric side) ---------------------------------------

    def down(self, name: str) -> bool:
        with self._lock:
            return name in self._down

    def blocked(self, sender: str, target: str) -> bool:
        """True when no frame may move sender -> target right now:
        either end is down, or a partition separates them."""
        with self._lock:
            if sender in self._down or target in self._down:
                return True
            if not self._groups:
                return False
            ga = gb = None
            for g in self._groups:
                if sender in g:
                    ga = g
                if target in g:
                    gb = g
            return ga is not gb or ga is None

    def delay_micros(self, sender: str, target: str) -> int:
        with self._lock:
            return max(
                self._delay.get((sender, target), 0),
                self._delay.get(("*", target), 0),
                self._delay.get((sender, "*"), 0),
            )

    def should_drop(self, sender: str, target: str) -> bool:
        with self._lock:
            rate = self._drop.get((sender, target), 0.0)
            return rate > 0 and self._rng.random() < rate

    def should_duplicate(self, sender: str, target: str) -> bool:
        with self._lock:
            rate = self._dup.get((sender, target), 0.0)
            return rate > 0 and self._rng.random() < rate

    def snapshot(self) -> dict:
        """JSON-safe view of the ACTIVE faults (the log has history)."""
        with self._lock:
            return {
                "partition": [sorted(g) for g in self._groups],
                "down": sorted(self._down),
                "slow_links": {
                    f"{a}->{b}": d for (a, b), d in sorted(self._delay.items())
                },
                "drop_links": {
                    f"{a}->{b}": r for (a, b), r in sorted(self._drop.items())
                },
                "duplicate_links": {
                    f"{a}->{b}": r for (a, b), r in sorted(self._dup.items())
                },
            }


class InMemoryMessagingNetwork:
    """Shared fabric for Ring-3 tests: deterministic, manually pumped.

    One FIFO queue per (sender, target) pair — the in-memory analogue of
    Artemis per-peer bridges. `pump(1)` delivers exactly one message in
    global send order; `run(seed)` delivers until quiescent, with a seed
    interleaving *between* pair-queues (never reordering within one) to
    surface cross-peer races deterministically — the reference's
    pumpSend/pumpReceive + runNetwork loop.

    With a `FabricFaults` plane (and the clock it shares), delivery
    becomes fault-aware: frames across a partition or to a down node
    stay QUEUED (they deliver after heal/revive — store-and-forward,
    not loss), slow links hold frames until the TestClock passes
    send-time + delay, and drop/duplicate rates apply at delivery with
    the plane's seeded RNG. Per-pair FIFO order holds under every
    fault: only the HEAD of a pair queue is ever eligible.
    """

    def __init__(self, clock=None, faults: Optional[FabricFaults] = None):
        # queue entries are (msg, ready_at_micros)
        self._queues: dict[tuple[str, str], deque] = {}
        self._order: deque[tuple[str, str]] = deque()
        self._endpoints: dict[str, "InMemoryMessaging"] = {}
        self._dropped: list[Message] = []
        self.sent_count = 0
        self._clock = clock
        self.faults = faults

    def _now(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        if self.faults is not None:
            # no network clock: judge slow-link delays on the fault
            # plane's clock (its wall-clock fallback keeps delayed
            # frames DELIVERABLE eventually — a ready_at computed
            # against a clock pinned at 0 would strand them forever)
            return self.faults.now_micros()
        return 0

    def endpoint(self, name: str) -> "InMemoryMessaging":
        if name not in self._endpoints:
            self._endpoints[name] = InMemoryMessaging(self, name)
        return self._endpoints[name]

    def _enqueue(self, msg: Message, target: str) -> None:
        self.sent_count += 1
        pair = (msg.sender, target)
        ready_at = 0
        if self.faults is not None:
            delay = self.faults.delay_micros(msg.sender, target)
            if delay:
                ready_at = self._now() + delay
        self._queues.setdefault(pair, deque()).append((msg, ready_at))
        self._order.append(pair)

    def _deliverable_pairs(self) -> list[tuple[str, str]]:
        """Pairs whose HEAD frame may deliver now, in earliest-send
        order (faults mode only)."""
        now = self._now()
        faults = self.faults
        seen = set()
        out = []
        for pair in self._order:
            if pair in seen:
                continue
            seen.add(pair)
            q = self._queues.get(pair)
            if not q:
                continue
            _, ready_at = q[0]
            if ready_at > now:
                continue
            if faults.blocked(pair[0], pair[1]):
                continue
            ep = self._endpoints.get(pair[1])
            if ep is None or not ep.running:
                # a dead endpoint under chaos is a DOWN node: keep the
                # frame queued for redelivery after restart (the
                # durable fabric's store-and-forward analogue)
                continue
            out.append(pair)
        return out

    def pump(self, n: int = 1, rng: Optional[random.Random] = None) -> int:
        """Deliver up to n messages; returns how many were delivered.
        In faults mode only deliverable frames move — blocked/unready
        ones stay queued and pump returns short."""
        if self.faults is not None:
            return self._pump_faulty(n, rng)
        delivered = 0
        while self._order and delivered < n:
            if rng is None:
                pair = self._order.popleft()
            else:
                live = [p for p, q in self._queues.items() if q]
                pair = live[rng.randrange(len(live))]
                self._order.remove(pair)   # earliest occurrence
            msg, _ = self._queues[pair].popleft()
            ep = self._endpoints.get(pair[1])
            if ep is None or not ep.running:
                self._dropped.append(msg)
            else:
                ep._deliver(msg)
            delivered += 1
        return delivered

    def _pump_faulty(self, n: int, rng: Optional[random.Random]) -> int:
        faults = self.faults
        delivered = 0
        while delivered < n:
            live = self._deliverable_pairs()
            if not live:
                break
            pair = live[0] if rng is None else live[rng.randrange(len(live))]
            self._order.remove(pair)   # earliest occurrence
            msg, _ = self._queues[pair].popleft()
            if faults.should_drop(pair[0], pair[1]):
                self._dropped.append(msg)
            else:
                ep = self._endpoints[pair[1]]
                ep._deliver(msg)
                if faults.should_duplicate(pair[0], pair[1]):
                    ep._deliver(msg)   # (sender, uid) dedupe absorbs
            delivered += 1
        return delivered

    def run(self, seed: Optional[int] = None) -> int:
        """Pump until quiescent (nothing DELIVERABLE left — blocked or
        delayed frames stay queued). Returns total delivered."""
        rng = random.Random(seed) if seed is not None else None
        total = 0
        while True:
            got = self.pump(1, rng)
            if not got:
                return total
            total += got

    @property
    def pending(self) -> int:
        return len(self._order)

    @property
    def deliverable(self) -> int:
        """Pairs with a deliverable HEAD frame right now (a quiescence
        signal: nonzero iff pump(1) would move something) — `pending`
        without a fault plane; under faults, blocked/delayed frames
        don't count (quiescence must not wait on them). One scan of
        the order deque, no per-queue walk."""
        if self.faults is None:
            return len(self._order)
        return len(self._deliverable_pairs())


class InMemoryMessaging(MessagingService):
    """One node's endpoint on the in-memory fabric."""

    def __init__(self, network: InMemoryMessagingNetwork, name: str):
        self._network = network
        self._name = name
        self._handlers: dict[str, list[Handler]] = {}
        # topic -> bounded ingest ring (node/ingest.py IngestRing)
        self._rings: dict[str, object] = {}
        self._next_id = 0
        # insertion-ordered so the DEDUPE_KEEP bound evicts oldest-
        # first (the in-memory analogue of the TCP fabric's arrival-
        # watermark prune)
        self._seen: dict[tuple[str, int], None] = {}
        self._undelivered: deque[Message] = deque()
        self.running = True
        self.dedupe_keep = DEDUPE_KEEP
        # wire-telemetry seam (utils.wire_telemetry.WireAccounting):
        # mutable like FabricEndpoint.telemetry — None costs one
        # attribute check per frame
        self.telemetry = None

    @property
    def my_address(self) -> str:
        return self._name

    def send(
        self,
        topic: str,
        payload: bytes,
        target: str,
        unique_id: Optional[int] = None,
        trace: Optional[tuple] = None,
        deadline: Optional[int] = None,
    ) -> None:
        """Explicit unique_id lets flows use deterministic ids so that
        replayed sends after checkpoint restore dedupe at the receiver
        (statemachine.py); counter ids stay below 2**63, hashed flow ids
        set the top bit, so the namespaces never collide."""
        if unique_id is None:
            unique_id = self._next_id
            self._next_id += 1
        msg = Message(topic, payload, self._name, unique_id, trace, deadline)
        tel = self.telemetry
        if tel is not None:
            tel.record_frame("out", target, topic, len(payload))
        self._network._enqueue(msg, target)

    def add_handler(self, topic: str, handler: Handler) -> None:
        self._handlers.setdefault(topic, []).append(handler)
        parked = [m for m in self._undelivered if m.topic == topic]
        for m in parked:
            self._undelivered.remove(m)
            self._deliver(m)

    def remove_handler(self, topic: str, handler: Handler) -> None:
        handlers = self._handlers.get(topic, [])
        if handler in handlers:
            handlers.remove(handler)

    def add_ring(self, topic: str, ring, metrics=None) -> None:
        """Route `topic` into a bounded ingest ring (wire-ingest fast
        path — see MessagingService.add_ring). Messages already parked
        for the topic flow into the ring immediately. With a
        MetricRegistry, the ring's depth/high-water and this endpoint's
        parked-frame count become gauges."""
        self._rings[topic] = ring
        if metrics is not None:
            register_ring_gauges(
                metrics, topic, ring,
                parked_count=lambda t=topic: self.parked_count(t),
            )
        self.retry_parked(topic)

    def parked_count(self, topic: str) -> int:
        """Frames parked for `topic` because its ring was full (they
        re-enter via retry_parked)."""
        return sum(1 for m in self._undelivered if m.topic == topic)

    def retry_parked(self, topic: str) -> int:
        """Re-offer frames parked while the topic's ring was full
        (the consumer calls this after draining). Returns how many
        moved into the ring."""
        ring = self._rings.get(topic)
        if ring is None:
            return 0
        moved = 0
        parked = [m for m in self._undelivered if m.topic == topic]
        for m in parked:
            key = (m.sender, m.unique_id)
            if key in self._seen:
                # an at-least-once redelivery of this frame already
                # reached the ring while this copy sat parked — drop
                # the duplicate, exactly-once holds on the ring path
                # just like the handler path
                self._undelivered.remove(m)
                continue
            if not ring.offer(m):
                break   # still full: keep FIFO order, stop early
            self._undelivered.remove(m)
            self._remember(key, m)
            moved += 1
        return moved

    def _remember(self, key: tuple[str, int], msg: Message) -> None:
        """Mark a frame delivered (dedupe) and record the inbound link,
        evicting the oldest key past the DEDUPE_KEEP bound: one seam for
        the three delivery paths."""
        tel = self.telemetry
        if tel is not None:
            tel.record_frame("in", msg.sender, msg.topic, len(msg.payload))
        self._seen[key] = None
        if len(self._seen) > self.dedupe_keep:
            self._seen.pop(next(iter(self._seen)))

    def wire_depths(self) -> dict:
        """The WirePlane's per-tick depth pull (the TCP fabric's
        `wire_depths` shape): undelivered frames queued toward each
        peer stand in for the unacked journal backlog."""
        backlog = {
            target: len(q)
            for (sender, target), q in self._network._queues.items()
            if sender == self._name and q
        }
        return {
            "journal_depth": sum(backlog.values()),
            "dedupe_depth": len(self._seen),
            "backlog": backlog,
        }

    def _deliver(self, msg: Message) -> None:
        key = (msg.sender, msg.unique_id)
        if key in self._seen:
            # at-least-once upstream, exactly-once to handlers
            tel = self.telemetry
            if tel is not None:
                tel.record_dedupe_hit(msg.sender)
            return
        ring = self._rings.get(msg.topic)
        if ring is not None:
            # ring seam: enqueue the raw frame for the bulk decoder; a
            # full ring parks it (backpressure) for retry_parked
            if ring.offer(msg):
                self._remember(key, msg)
            else:
                self._undelivered.append(msg)
            return
        handlers = self._handlers.get(msg.topic)
        if not handlers:
            self._undelivered.append(msg)
            return
        self._remember(key, msg)
        for h in list(handlers):
            h(msg)
