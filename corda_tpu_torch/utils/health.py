"""Self-monitoring health plane: watchdogs, SLO alerts, canary probes.

Port of corda_tpu/utils/health.py: heartbeats, the watchdog, the
event log, alert rules with hysteresis (burn rate, shed ratio, ring),
the canary probe and `HealthMonitor`, `ClusterHealth`,
`IncidentRecorder` and the notary canary, which notarises through the
real flush path (on the card, one CudaBatchVerifier dispatch).
`watch_qos`, `watch_txstory`, `watch_perf`, `watch_device` and
`watch_wire` install the QoS, tx-story, perf, device and wire planes'
rules; `watch_distributed_uniqueness` installs the cross-member
uniqueness plane's `shard.unreachable` and `reservation.orphaned`
(node/distributed_uniqueness.py).

Every node has rich telemetry (/metrics, /traces, /qos), but
nothing in-process WATCHES it without this plane: a wedged flush loop, a stalled
decode pool or a dead verifier drain thread is invisible until clients
time out. Hardware-accelerator verification engines treat sustained-
throughput monitoring as part of the design (the FPGA ECDSA engine of
arXiv:2112.02229 ships rate counters next to the datapath); a
notary on an accelerator needs the same, plus liveness detection for
the host-side threads that feed the card. Four pieces behind one
`HealthMonitor` facade:

  Heartbeat / Watchdog — every long-lived loop (messaging pump, ingest
      decode pool, notary flush tick, verifier drain, raft/bft
      drivers) registers a named heartbeat and beats it each
      iteration, carrying a progress counter (frames drained). The
      watchdog, driven by the NODE clock (simulated-time rigs stay
      deterministic), flags a SILENT STALL (no beat within the
      deadline) and a LIVELOCK (still beating, queue depth > 0, zero
      progress across the livelock window) — the two failure shapes a
      thread dump can't tell apart.

  Alert rules with hysteresis — a small rule engine walks each alert
      through pending -> firing -> resolved with for-duration holds in
      BOTH directions, so a metric oscillating across its threshold
      never flaps. Built-in rules: multi-window SLO burn rate on the
      admitted-latency p99 vs the configured target, shed ratio, ring
      saturation / parked-frame growth, watchdog events, canary
      deadman. A FIRING alert captures evidence — the flight
      recorder's slowest matching trace ids plus a metrics snapshot —
      and every firing/resolved transition appends one JSON line to a
      structured event log.

  Canary probe — a periodic synthetic notarisation driven through the
      REAL hot path (staged, dispatched, committed and signed by a
      real flush). The canary transaction has NO inputs, so its
      uniqueness commit is vacuous — it never touches the uniqueness
      store's real namespace — and its completion latency feeds
      `Health.CanaryLatencyMicros`. Probes that stop completing trip
      the deadman alert: the one failure mode every other signal
      shares (a dead pump also stops scraping /metrics).

  healthz / snapshot — `healthz()` is the orchestrator's cheap
      liveness answer (the webserver maps it to GET /healthz
      200/503 from watchdog state); `snapshot()` is the full
      GET /health JSON: heartbeats, alerts, canary, event-log tail.
      `ClusterHealth` pulls per-node summaries over the network-map
      peer list so ANY node can serve GET /cluster with fleet-wide
      worst-state and staleness marking for unreachable peers.

Everything is driven by `tick()` from the node pump and an injected
clock, so the whole plane is testable in simulated time
(tests/test_health.py runs the stall/recovery soak on a TestClock).
"""

from __future__ import annotations

import json
import threading
from . import locks
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .metrics import MetricRegistry

# heartbeat states — the watchdog's vocabulary (and /healthz's)
HB_OK = "ok"
HB_STALLED = "stalled"          # no beat within the deadline
HB_LIVELOCK = "livelock"        # beating, queue > 0, zero progress

# alert lifecycle — ONE state walk for every rule
ALERT_INACTIVE = "inactive"
ALERT_PENDING = "pending"
ALERT_FIRING = "firing"
ALERT_RESOLVED = "resolved"

SEV_WARNING = "warning"
SEV_CRITICAL = "critical"


@dataclass(frozen=True)
class HealthPolicy:
    """Operator knobs, all in node-clock microseconds so simulated-time
    rigs drive the plane deterministically.

    `heartbeat_deadline_micros` is the watchdog deadline: a loop that
    misses it is STALLED. `livelock_deadline_micros` is the zero-
    progress window for loops that expose a queue depth. The alert
    holds are the hysteresis: a condition must hold `alert_for_micros`
    before pending becomes firing, and stay clear
    `alert_clear_for_micros` before firing resolves."""

    heartbeat_deadline_micros: int = 5_000_000
    livelock_deadline_micros: int = 10_000_000
    alert_for_micros: int = 2_000_000
    alert_clear_for_micros: int = 2_000_000
    # burn rate: breach fraction of the SLO budget over two windows —
    # the fast window catches a cliff, the slow one filters blips; both
    # must burn past the threshold to fire (multiwindow burn-rate
    # alerting, the SRE-workbook shape)
    burn_short_window_micros: int = 60_000_000
    burn_long_window_micros: int = 300_000_000
    slo_budget_fraction: float = 0.05
    burn_threshold: float = 1.0
    shed_ratio_threshold: float = 0.5
    shed_window_micros: int = 60_000_000
    ring_saturation_threshold: float = 0.9
    canary_interval_micros: int = 2_000_000
    canary_deadman_micros: int = 10_000_000
    event_log_capacity: int = 512
    evidence_traces: int = 5
    # windowed rules record at most one sample per this gap: tick()
    # runs on EVERY pump iteration, and without the gap a loaded
    # node's sample deques would grow with the tick rate (a 300s
    # window at 1k ticks/s is 300k entries rescanned per tick, on the
    # pump hot path). Conditions are still computed fresh every tick —
    # only the APPEND is throttled, bounding the deques to
    # window/gap entries.
    rule_sample_gap_micros: int = 1_000_000


class Heartbeat:
    """One long-lived loop's liveness signal.

    `beat(progress=n)` each iteration; `progress` is the loop's own
    unit of useful work (frames drained, requests answered) and powers
    livelock detection when a `queue_depth` callable is registered —
    a loop that beats forever while its queue sits full and progress
    stays flat is wedged in the way a stall detector can't see."""

    def __init__(
        self,
        name: str,
        clock_fn: Callable[[], int],
        deadline_micros: int,
        livelock_micros: int,
        queue_depth: Optional[Callable[[], int]] = None,
    ):
        self.name = name
        self._clock_fn = clock_fn
        self.deadline_micros = deadline_micros
        self.livelock_micros = livelock_micros
        self.queue_depth = queue_depth
        self._lock = locks.make_lock("Heartbeat._lock")
        # registration counts as the first beat: a loop that never runs
        # at all must show as stalled one deadline after it registered,
        # not crash the watchdog on a None timestamp
        self.last_beat_micros = clock_fn()
        self.beats = 0
        self.progress = 0

    def beat(self, progress: int = 0) -> None:
        with self._lock:
            self.last_beat_micros = self._clock_fn()
            self.beats += 1
            if progress > 0:
                self.progress += progress

    def read(self) -> tuple[int, int, int]:
        with self._lock:
            return self.last_beat_micros, self.beats, self.progress


class Watchdog:
    """Stall + livelock detection over the registered heartbeats,
    judged on the injected clock. `check(now)` is cheap (a few dict
    probes per heartbeat) and safe from any thread — /healthz calls it
    live so the answer reflects NOW, not the last pump tick."""

    def __init__(self):
        self._lock = locks.make_lock("Watchdog._lock")
        self._beats: dict[str, Heartbeat] = {}
        # livelock memory: name -> [progress value, micros it last moved]
        self._mem: dict[str, list] = {}

    def register(self, hb: Heartbeat) -> Heartbeat:
        with self._lock:
            self._beats[hb.name] = hb
            self._mem[hb.name] = [hb.progress, hb.last_beat_micros]
        return hb

    def heartbeats(self) -> list[Heartbeat]:
        with self._lock:
            return list(self._beats.values())

    def check(self, now: int) -> dict[str, dict]:
        """Per-heartbeat state: {"state", "age_micros", "beats",
        "progress", "queue_depth"}."""
        out: dict[str, dict] = {}
        for hb in self.heartbeats():
            last, beats, progress = hb.read()
            age = now - last
            depth = None
            if hb.queue_depth is not None:
                try:
                    depth = int(hb.queue_depth())
                except Exception:   # a gauge must not break the watchdog
                    depth = None
            state = HB_OK
            if age > hb.deadline_micros:
                state = HB_STALLED
            elif depth is not None:
                with self._lock:
                    mem = self._mem.setdefault(hb.name, [progress, now])
                    if progress != mem[0]:
                        mem[0], mem[1] = progress, now
                    stuck_for = now - mem[1]
                if depth > 0 and stuck_for >= hb.livelock_micros:
                    state = HB_LIVELOCK
            out[hb.name] = {
                "state": state,
                "age_micros": max(0, age),
                "beats": beats,
                "progress": progress,
                "queue_depth": depth,
            }
        return out


class HealthEventLog:
    """Structured event log: bounded in-memory tail (what GET /health
    serves) plus optional append-only JSON-lines file — the durable
    record an operator greps after the incident.

    The on-disk file is BOUNDED too: once it grows past `max_bytes`
    it rotates to `<path>.1` (replacing the previous rotation), so a
    long-lived node holds at most ~2x max_bytes of event history —
    the in-memory tail was always bounded, but the file used to grow
    forever."""

    def __init__(
        self,
        capacity: int = 512,
        path: Optional[str] = None,
        max_bytes: int = 4 << 20,
    ):
        self._lock = locks.make_lock("HealthEventLog._lock")
        self._tail: deque = deque(maxlen=max(8, capacity))
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        self.appended = 0
        self.rotations = 0
        self._file_bytes = 0
        if path:
            try:
                import os as _os

                self._file_bytes = _os.path.getsize(path)
            except OSError:
                self._file_bytes = 0

    def append(self, record: dict) -> None:
        line = json.dumps(record, default=str, sort_keys=True)
        with self._lock:
            self._tail.append(json.loads(line))   # tail stays JSON-safe
            self.appended += 1
        if self.path:
            try:
                with self._lock:
                    if self._file_bytes >= self.max_bytes:
                        import os as _os

                        _os.replace(self.path, self.path + ".1")
                        self._file_bytes = 0
                        self.rotations += 1
                    self._file_bytes += len(line) + 1
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            except OSError:
                pass   # a full disk must not take the health plane down

    def tail(self, n: int = 64) -> list[dict]:
        with self._lock:
            items = list(self._tail)
        return items[-n:]


class AlertRule:
    """One named condition the engine evaluates each tick.

    `check(now) -> (condition, detail)`: `condition` drives the
    pending/firing/resolved walk, `detail` is the JSON-safe evidence
    context (current value, threshold, burn rates). `for_micros` /
    `clear_for_micros` default to the policy holds; pass 0 for rules
    whose condition already encodes its own duration (watchdog
    deadlines, the canary deadman)."""

    def __init__(
        self,
        name: str,
        check: Callable[[int], tuple[bool, dict]],
        severity: str = SEV_WARNING,
        for_micros: Optional[int] = None,
        clear_for_micros: Optional[int] = None,
        trace_filter: Optional[str] = None,
    ):
        self.name = name
        self.check = check
        self.severity = severity
        self.for_micros = for_micros
        self.clear_for_micros = clear_for_micros
        # evidence: only flight-recorder traces matching this token
        # (span-name substring, or a `shard<k>` span attribute — see
        # tracing.Trace.matches) are attached; None = the slowest
        # overall. A CALLABLE resolves at capture time, so a rule whose
        # subject moves (the perf plane's skew rule: the hot shard of
        # the moment) cites the traces that touched the CURRENT one.
        self.trace_filter = trace_filter


class _Alert:
    """Mutable per-rule state the engine walks."""

    __slots__ = (
        "rule", "state", "since_micros", "fired_at_micros",
        "resolved_at_micros", "clear_since_micros", "detail", "evidence",
        "fire_count",
    )

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = ALERT_INACTIVE
        self.since_micros: Optional[int] = None
        self.fired_at_micros: Optional[int] = None
        self.resolved_at_micros: Optional[int] = None
        self.clear_since_micros: Optional[int] = None
        self.detail: dict = {}
        self.evidence: Optional[dict] = None
        self.fire_count = 0

    def snapshot(self) -> dict:
        out = {
            "state": self.state,
            "severity": self.rule.severity,
            "since_micros": self.since_micros,
            "fired_at_micros": self.fired_at_micros,
            "resolved_at_micros": self.resolved_at_micros,
            "fire_count": self.fire_count,
            "detail": self.detail,
        }
        if self.state == ALERT_FIRING and self.evidence is not None:
            out["evidence"] = self.evidence
        return out


class BurnRateRule(AlertRule):
    """Multi-window SLO burn rate on a latency p99 vs its target.

    Each tick samples `p99_fn()` and records whether it breached the
    target. Burn rate over a window = (breach fraction) / (the SLO's
    error budget fraction): burning at 1.0 spends the budget exactly,
    above it the SLO will be violated. Fires only when BOTH the short
    and the long window burn past the threshold — the short window
    reacts fast, the long one stops a single bad flush from paging."""

    def __init__(
        self,
        p99_fn: Callable[[], float],
        target_micros: float,
        policy: HealthPolicy,
        name: str = "slo.burn_rate",
    ):
        self._p99_fn = p99_fn
        self.target_micros = float(target_micros)
        self._policy = policy
        self._samples: deque = deque()   # (micros, breached)
        self._last_sample: Optional[int] = None
        super().__init__(
            name, self._check, severity=SEV_CRITICAL,
            trace_filter="notar",
        )

    def _check(self, now: int) -> tuple[bool, dict]:
        pol = self._policy
        p99 = float(self._p99_fn())
        if (
            self._last_sample is None
            or now - self._last_sample >= pol.rule_sample_gap_micros
        ):
            self._last_sample = now
            self._samples.append(
                (now, p99 > self.target_micros and p99 > 0)
            )
        horizon = now - pol.burn_long_window_micros
        while self._samples and self._samples[0][0] < horizon:
            self._samples.popleft()

        def burn(window: int) -> float:
            lo = now - window
            hits = total = 0
            for t, breached in self._samples:
                if t >= lo:
                    total += 1
                    hits += breached
            frac = hits / total if total else 0.0
            return frac / max(pol.slo_budget_fraction, 1e-9)

        short, long_ = burn(pol.burn_short_window_micros), burn(
            pol.burn_long_window_micros
        )
        cond = short >= pol.burn_threshold and long_ >= pol.burn_threshold
        return cond, {
            "p99_micros": round(p99, 1),
            "target_p99_micros": self.target_micros,
            "burn_short": round(short, 3),
            "burn_long": round(long_, 3),
        }


class ShedRatioRule(AlertRule):
    """Shed fraction of the answered+shed flow over a sliding window —
    overload that admission control is absorbing, surfaced before
    clients notice their error rate."""

    def __init__(
        self,
        shed_fn: Callable[[], int],
        answered_fn: Callable[[], int],
        policy: HealthPolicy,
        name: str = "qos.shed_ratio",
    ):
        self._shed_fn = shed_fn
        self._answered_fn = answered_fn
        self._policy = policy
        self._samples: deque = deque()   # (micros, shed, answered)
        self._last_sample: Optional[int] = None
        super().__init__(name, self._check, severity=SEV_WARNING)

    def _check(self, now: int) -> tuple[bool, dict]:
        pol = self._policy
        shed, answered = int(self._shed_fn()), int(self._answered_fn())
        if (
            self._last_sample is None
            or now - self._last_sample >= pol.rule_sample_gap_micros
        ):
            self._last_sample = now
            self._samples.append((now, shed, answered))
        horizon = now - pol.shed_window_micros
        while len(self._samples) > 1 and self._samples[0][0] < horizon:
            self._samples.popleft()
        t0, shed0, ans0 = self._samples[0]
        d_shed, d_ans = shed - shed0, answered - ans0
        total = d_shed + d_ans
        ratio = d_shed / total if total > 0 else 0.0
        return ratio >= pol.shed_ratio_threshold and d_shed > 0, {
            "shed_ratio": round(ratio, 3),
            "shed_in_window": d_shed,
            "answered_in_window": d_ans,
            "threshold": pol.shed_ratio_threshold,
        }


class RingRule(AlertRule):
    """Ingest-ring saturation / parked-frame growth: the backpressure
    seam filling toward its bound, or frames parking faster than
    retry_parked re-admits them — both precede a stalled pump."""

    def __init__(
        self,
        name: str,
        depth_fn: Callable[[], int],
        capacity: int,
        policy: HealthPolicy,
        parked_fn: Optional[Callable[[], int]] = None,
    ):
        self._depth_fn = depth_fn
        self._capacity = max(1, int(capacity))
        self._parked_fn = parked_fn
        self._policy = policy
        self._parked: deque = deque()    # (micros, parked count)
        self._last_sample: Optional[int] = None
        super().__init__(name, self._check, severity=SEV_WARNING)

    def _check(self, now: int) -> tuple[bool, dict]:
        pol = self._policy
        depth = int(self._depth_fn())
        saturation = depth / self._capacity
        parked = growth = 0
        if self._parked_fn is not None:
            parked = int(self._parked_fn())
            if (
                self._last_sample is None
                or now - self._last_sample >= pol.rule_sample_gap_micros
            ):
                self._last_sample = now
                self._parked.append((now, parked))
            horizon = now - pol.shed_window_micros
            while len(self._parked) > 1 and self._parked[0][0] < horizon:
                self._parked.popleft()
            growth = parked - self._parked[0][1]
        cond = saturation >= pol.ring_saturation_threshold or (
            parked > 0 and growth > 0
        )
        return cond, {
            "depth": depth,
            "capacity": self._capacity,
            "saturation": round(saturation, 3),
            "parked": parked,
            "parked_growth": growth,
        }


class CanaryProbe:
    """Periodic synthetic round trip through the real hot path.

    `fn(complete)` launches one probe; the wiring calls
    `complete(ok=True)` when the probe's future resolves (the flush
    answered it), which stamps `Health.CanaryLatencyMicros` on the
    node clock. The deadman predicate is the alert condition: no
    completed probe within `deadman_micros` — covering wedges no
    component-level signal sees (the whole path is dead)."""

    def __init__(
        self,
        fn: Callable[[Callable], None],
        clock_fn: Callable[[], int],
        interval_micros: int,
        deadman_micros: int,
        latency_hist,
    ):
        self._fn = fn
        self._clock_fn = clock_fn
        self.interval_micros = interval_micros
        self.deadman_micros = deadman_micros
        self._hist = latency_hist
        self._lock = locks.make_lock("CanaryProbe._lock")
        self._last_launch: Optional[int] = None
        # grace from construction: the deadman arms `deadman_micros`
        # after the plane boots, not instantly on an idle node
        self.last_complete_micros = clock_fn()
        self.last_latency_micros: Optional[int] = None
        self.launched = 0
        self.completed = 0
        self.failed = 0
        self.last_error: Optional[str] = None

    def maybe_launch(self, now: int) -> bool:
        with self._lock:
            if (
                self._last_launch is not None
                and now - self._last_launch < self.interval_micros
            ):
                return False
            self._last_launch = now
            self.launched += 1
        t0 = now

        def complete(ok: bool = True) -> None:
            with self._lock:
                if not ok:
                    self.failed += 1
                    return
                done = self._clock_fn()
                self.completed += 1
                self.last_complete_micros = done
                self.last_latency_micros = done - t0
            self._hist.update(max(0, done - t0))

        try:
            self._fn(complete)
        except Exception as e:   # a broken probe is a signal, not a crash
            with self._lock:
                self.failed += 1
                self.last_error = repr(e)
        return True

    def overdue(self, now: int) -> bool:
        with self._lock:
            return now - self.last_complete_micros > self.deadman_micros

    def snapshot(self, now: int) -> dict:
        with self._lock:
            return {
                "launched": self.launched,
                "completed": self.completed,
                "failed": self.failed,
                "last_latency_micros": self.last_latency_micros,
                "since_last_complete_micros": (
                    now - self.last_complete_micros
                ),
                "deadman_micros": self.deadman_micros,
                "overdue": now - self.last_complete_micros
                > self.deadman_micros,
                "last_error": self.last_error,
            }


class HealthMonitor:
    """The facade the node, webserver and tests hold.

    Owns the watchdog, the rule engine, the canary and the event log;
    `tick()` (called from the node pump) advances all of them on the
    injected clock. `healthz()` answers live — it re-checks the
    watchdog at call time, so GET /healthz reflects a stall the moment
    the deadline passes even if the pump (which would have ticked the
    monitor) is the thing that stalled."""

    def __init__(
        self,
        clock=None,
        metrics: Optional[MetricRegistry] = None,
        tracer=None,
        policy: Optional[HealthPolicy] = None,
        event_log_path: Optional[str] = None,
    ):
        self.policy = policy or HealthPolicy()
        self._clock = clock
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.tracer = tracer
        self.watchdog = Watchdog()
        self.events = HealthEventLog(
            self.policy.event_log_capacity, event_log_path
        )
        self._rules_lock = locks.make_lock("HealthMonitor._rules_lock")
        self._alerts: dict[str, _Alert] = {}
        self.canary: Optional[CanaryProbe] = None
        # incident forensics (attach_incidents): every firing
        # transition snapshots a durable evidence bundle
        self.incidents: Optional["IncidentRecorder"] = None
        self._incident_node: Optional[str] = None
        self._incident_background = False
        # last liveness verdict seen by tick(): healthz FLIPS land in
        # the event log as first-class records, so post-hoc forensics
        # (and chaos-rig invariant checkers) can reconcile "when did
        # /healthz go 503 and when did it recover" against injected
        # reality without having polled the endpoint at the right time
        self._last_healthz_ok: Optional[bool] = None
        self.canary_latency = self.metrics.histogram(
            "Health.CanaryLatencyMicros"
        )
        self.metrics.gauge(
            "Health.Healthy", lambda: 1.0 if self.healthz()[0] else 0.0
        )
        self.metrics.gauge("Health.AlertsFiring", self.alerts_firing)

    # -- clock ---------------------------------------------------------------

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        import time

        return time.time_ns() // 1_000

    # -- registration --------------------------------------------------------

    def heartbeat(
        self,
        name: str,
        queue_depth: Optional[Callable[[], int]] = None,
        deadline_micros: Optional[int] = None,
        livelock_micros: Optional[int] = None,
    ) -> Heartbeat:
        """Register (or replace) one loop's heartbeat."""
        pol = self.policy
        return self.watchdog.register(
            Heartbeat(
                name,
                self.now_micros,
                deadline_micros or pol.heartbeat_deadline_micros,
                livelock_micros or pol.livelock_deadline_micros,
                queue_depth=queue_depth,
            )
        )

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._rules_lock:
            self._alerts[rule.name] = _Alert(rule)
        return rule

    def watch_qos(self, qos) -> None:
        """Install the SLO rules over a node/qos.NotaryQos: multi-window
        burn rate on Qos.AdmittedLatencyMicros p99 vs the configured
        target, and the shed-ratio rule over its Qos.Shed.* counters."""
        self.add_rule(
            BurnRateRule(
                lambda: qos.admitted_latency.quantile(0.99),
                qos.policy.target_p99_micros,
                self.policy,
            )
        )
        self.add_rule(
            ShedRatioRule(
                lambda: qos.shed_total,
                lambda: qos.answered.count,
                self.policy,
            )
        )

    def watch_distributed_uniqueness(self, provider) -> None:
        """Install the distributed-uniqueness rules over a node/
        distributed_uniqueness.DistributedUniquenessProvider:

        `shard.unreachable` — a partition owner stopped answering the
        cross-shard protocol (reserve-phase timeout fired, or a
        decided commit is being re-driven into silence). Critical with
        zero hold on both edges: the provider's own timeout already
        encodes the duration, and the mark clears the moment any frame
        from the owner arrives — so the alert auto-resolves on heal.

        `reservation.orphaned` — this member holds reservations whose
        TTL expired (their coordinator went quiet); the orphan query
        machinery is driving them to resolution. Uses the policy holds
        so a hold that resolves within one walk never pages."""
        self.add_rule(
            AlertRule(
                "shard.unreachable",
                lambda now: (
                    bool(provider.unreachable_owners()),
                    {"owners": sorted(provider.unreachable_owners())},
                ),
                severity=SEV_CRITICAL,
                for_micros=0,
                clear_for_micros=0,
                trace_filter="xshard",
            )
        )
        self.add_rule(
            AlertRule(
                "reservation.orphaned",
                lambda now: (
                    provider.orphan_count() > 0,
                    {
                        "orphans": provider.orphan_count(),
                        "reservations": provider.reservation_count(),
                    },
                ),
                trace_filter="xshard",
            )
        )

    def watch_perf(self, perf) -> None:
        """Install the performance-attribution rules over a
        utils/perf.PerfPlane: cold-shape-after-warmup and per-shard
        skew (utils/perf.py `_perf_rules` — the plane owns the
        telemetry, this monitor owns the alert walks + evidence)."""
        perf.install_rules(self)

    def watch_device(self, plane) -> None:
        """Install the device-telemetry rules over a
        utils/device_telemetry.DevicePlane: `device.hbm_pressure`
        (sustained device memory occupancy over threshold),
        `device.fallback_active` (the notary's degraded-mode gauge bridged
        with device evidence) and `device.utilization_collapse` (busy
        fraction dropping while the backlog grows — the pump starved
        the chip). The plane owns the telemetry, this monitor the
        alert walks + evidence (the watch_perf pattern)."""
        plane.install_rules(self)

    def watch_wire(self, plane) -> None:
        """Install the wire-telemetry rules over a
        utils/wire_telemetry.WirePlane: `wire.journal_growth` (the
        store-and-forward journal deep AND still growing across the
        sample window — drains aren't keeping up), `wire.backlog`
        (some peer's unacked backlog over threshold, detail naming
        the peer and its high-water) and `gateway.saturated` (the
        web gateway stealing more than the allowed fraction of pump
        wall — handlers starving message delivery). Same ownership
        split as watch_device: the plane owns the telemetry, this
        monitor the alert walks + evidence."""
        plane.install_rules(self)

    def watch_txstory(
        self, story, targets: dict, window_micros=None
    ) -> None:
        """Install the `txstory.stage_slo` rule over a
        utils/txstory.TxStory: fires while any serving stage's recent
        p99 breaches its target ({stage: micros}), the detail citing
        the offending stage AND the worst tx ids — per-transaction
        attribution for what a bare p99 regression hides."""
        story.install_rules(self, targets, window_micros=window_micros)

    def watch_ring(
        self,
        name: str,
        depth_fn: Callable[[], int],
        capacity: int,
        parked_fn: Optional[Callable[[], int]] = None,
    ) -> None:
        self.add_rule(
            RingRule(f"ring.{name}", depth_fn, capacity, self.policy,
                     parked_fn=parked_fn)
        )

    def attach_incidents(
        self,
        recorder: "IncidentRecorder",
        node: Optional[str] = None,
        background: bool = False,
    ) -> "IncidentRecorder":
        """Wire incident forensics: every alert FIRING transition from
        now on snapshots a durable bundle (see IncidentRecorder) whose
        id lands in the alert's evidence and event-log line.
        `background=True` (production nodes) moves the capture — the
        cross-node pulls and the disk write — off the pump tick onto a
        daemon thread; simulated-time rigs keep the synchronous
        default."""
        self.incidents = recorder
        self._incident_node = node
        self._incident_background = background
        return recorder

    def attach_canary(
        self,
        fn: Callable[[Callable], None],
        interval_micros: Optional[int] = None,
        deadman_micros: Optional[int] = None,
    ) -> CanaryProbe:
        """Wire the canary probe + its deadman alert. `fn(complete)`
        launches one synthetic round trip and arranges for
        `complete(ok=...)` to be called when it finishes."""
        pol = self.policy
        self.canary = CanaryProbe(
            fn,
            self.now_micros,
            interval_micros or pol.canary_interval_micros,
            deadman_micros or pol.canary_deadman_micros,
            self.canary_latency,
        )
        probe = self.canary
        self.add_rule(
            AlertRule(
                "canary.deadman",
                lambda now: (
                    probe.overdue(now),
                    probe.snapshot(now),
                ),
                severity=SEV_CRITICAL,
                for_micros=0,        # the deadman window IS the hold
                clear_for_micros=0,
                trace_filter="canary",
            )
        )
        return probe

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[int] = None) -> None:
        """One health-plane step (node pump cadence): watchdog check,
        canary launch, rule evaluation, alert state walks."""
        if now is None:
            now = self.now_micros()
        states = self.watchdog.check(now)
        ok = all(st["state"] == HB_OK for st in states.values())
        if ok != self._last_healthz_ok:
            if self._last_healthz_ok is not None:
                self.events.append({
                    "at_micros": now,
                    "event": "healthz",
                    "ok": ok,
                    "unhealthy": sorted(
                        n for n, st in states.items()
                        if st["state"] != HB_OK
                    ),
                })
            self._last_healthz_ok = ok
        for name, st in states.items():
            alert = self._alert_for_watchdog(name)
            self._walk(
                alert, st["state"] != HB_OK, dict(st), now
            )
        if self.canary is not None:
            self.canary.maybe_launch(now)
        with self._rules_lock:
            alerts = [
                a for a in self._alerts.values()
                if not a.rule.name.startswith("watchdog.")
            ]
        for alert in alerts:
            try:
                cond, detail = alert.rule.check(now)
            except Exception as e:   # a broken rule must not stop the tick
                cond, detail = False, {"rule_error": repr(e)}
            self._walk(alert, cond, detail, now)

    def _alert_for_watchdog(self, hb_name: str) -> _Alert:
        name = f"watchdog.{hb_name}"
        with self._rules_lock:
            alert = self._alerts.get(name)
            if alert is None:
                # watchdog alerts fire/resolve immediately: the
                # heartbeat deadline already IS the for-duration
                alert = _Alert(
                    AlertRule(
                        name,
                        check=lambda now: (False, {}),
                        severity=SEV_CRITICAL,
                        for_micros=0,
                        clear_for_micros=0,
                        trace_filter=hb_name.split(".")[0],
                    )
                )
                self._alerts[name] = alert
        return alert

    def _walk(self, alert: _Alert, cond: bool, detail: dict, now: int) -> None:
        pol = self.policy
        rule = alert.rule
        hold = (
            rule.for_micros
            if rule.for_micros is not None
            else pol.alert_for_micros
        )
        clear_hold = (
            rule.clear_for_micros
            if rule.clear_for_micros is not None
            else pol.alert_clear_for_micros
        )
        alert.detail = detail
        if cond:
            alert.clear_since_micros = None
            if alert.state in (ALERT_INACTIVE, ALERT_RESOLVED):
                alert.state = ALERT_PENDING
                alert.since_micros = now
            if (
                alert.state == ALERT_PENDING
                and now - alert.since_micros >= hold
            ):
                alert.state = ALERT_FIRING
                alert.fired_at_micros = now
                alert.fire_count += 1
                alert.evidence = self._capture_evidence(rule, detail)
                if self.incidents is not None:
                    # the forensics bundle: captured AT the firing
                    # transition (rare — hysteresis gates it), never
                    # fatal to the tick
                    try:
                        alert.evidence["incident_id"] = (
                            self.incidents.record(
                                "alert", rule.name,
                                detail=detail,
                                severity=rule.severity,
                                evidence=alert.evidence,
                                monitor=self,
                                node=self._incident_node,
                                background=self._incident_background,
                            )
                        )
                    except Exception:
                        pass
                self.events.append({
                    "at_micros": now,
                    "event": "firing",
                    "alert": rule.name,
                    "severity": rule.severity,
                    "detail": detail,
                    "evidence": alert.evidence,
                })
        else:
            if alert.state == ALERT_PENDING:
                # never fired: silently back off — this is the
                # anti-flap half of the hysteresis
                alert.state = ALERT_INACTIVE
                alert.since_micros = None
            elif alert.state == ALERT_FIRING:
                if alert.clear_since_micros is None:
                    alert.clear_since_micros = now
                if now - alert.clear_since_micros >= clear_hold:
                    alert.state = ALERT_RESOLVED
                    alert.resolved_at_micros = now
                    self.events.append({
                        "at_micros": now,
                        "event": "resolved",
                        "alert": rule.name,
                        "severity": rule.severity,
                        "detail": detail,
                    })

    def _capture_evidence(self, rule: AlertRule, detail: dict) -> dict:
        """What a firing alert pins: the flight recorder's slowest
        matching trace ids (the 'which request' answer) and a metrics
        snapshot (the 'what else moved' answer)."""
        traces: list[dict] = []
        recorder = getattr(self.tracer, "recorder", None)
        if recorder is not None:
            try:
                filt = rule.trace_filter
                if callable(filt):
                    filt = filt()
                for t in recorder.slowest():
                    if filt and not (
                        t.matches(filt) if hasattr(t, "matches")
                        else any(filt in s.name for s in t.spans)
                    ):
                        continue
                    traces.append({
                        "trace_id": f"{t.trace_id:#x}",
                        "name": t.name,
                        "duration_ms": round(t.duration_s * 1e3, 3),
                    })
                    if len(traces) >= self.policy.evidence_traces:
                        break
            except Exception:
                pass
        return {"traces": traces, "metrics": self._metrics_snapshot()}

    def _metrics_snapshot(self) -> dict:
        """JSON-safe scalar snapshot of the registry — counters,
        gauges, meter/timer counts, histogram p99s."""
        from . import metrics as mlib

        out: dict[str, Any] = {}
        for name in self.metrics.names():
            m = self.metrics.get(name)
            try:
                if isinstance(m, mlib.Counter):
                    out[name] = m.count
                elif isinstance(m, mlib._Gauge):
                    v = m.value()
                    out[name] = round(v, 6) if v == v else None
                elif isinstance(m, (mlib.Meter, mlib.Timer)):
                    out[name] = m.count
                elif isinstance(m, mlib.Histogram):
                    out[name] = {
                        "count": m.count,
                        "p99": round(m.quantile(0.99), 3),
                    }
            except Exception:
                out[name] = None
        return out

    # -- readouts ------------------------------------------------------------

    def alerts_firing(self) -> int:
        with self._rules_lock:
            return sum(
                1 for a in self._alerts.values()
                if a.state == ALERT_FIRING
            )

    def healthz(self) -> tuple[bool, dict]:
        """The GET /healthz answer, judged live: ok iff no registered
        heartbeat is stalled or livelocked. Alerts deliberately do NOT
        flip liveness — an SLO burn wants paging, not a restart loop."""
        now = self.now_micros()
        states = self.watchdog.check(now)
        bad = {
            name: st["state"]
            for name, st in states.items()
            if st["state"] != HB_OK
        }
        ok = not bad
        return ok, {
            "status": "ok" if ok else "unhealthy",
            "unhealthy": bad,
            "alerts_firing": self.alerts_firing(),
        }

    def snapshot(self, summary: bool = False) -> dict:
        """The GET /health payload; `summary=True` is the condensed
        form ClusterHealth pulls per peer."""
        now = self.now_micros()
        heartbeats = self.watchdog.check(now)
        ok = all(st["state"] == HB_OK for st in heartbeats.values())
        with self._rules_lock:
            alerts = {
                name: a.snapshot() for name, a in self._alerts.items()
            }
        firing = sum(
            1 for a in alerts.values() if a["state"] == ALERT_FIRING
        )
        status = "ok" if ok and not firing else (
            "degraded" if ok else "unhealthy"
        )
        if summary:
            return {
                "healthy": ok,
                "status": status,
                "alerts_firing": firing,
                "alerts": {
                    n: a["state"] for n, a in alerts.items()
                    if a["state"] != ALERT_INACTIVE
                },
                "heartbeats_unhealthy": sorted(
                    n for n, st in heartbeats.items()
                    if st["state"] != HB_OK
                ),
                "canary_overdue": (
                    self.canary.overdue(now)
                    if self.canary is not None else None
                ),
            }
        return {
            "healthy": ok,
            "status": status,
            "now_micros": now,
            "heartbeats": heartbeats,
            "alerts": alerts,
            "alerts_firing": firing,
            "canary": (
                self.canary.snapshot(now)
                if self.canary is not None else None
            ),
            "events": self.events.tail(32),
            "events_total": self.events.appended,
        }


# ---------------------------------------------------------------------------
# cluster rollup


class ClusterHealth:
    """Fleet-wide rollup any node can serve at GET /cluster.

    `peers_fn() -> {name: health_url}` comes from the network-map peer
    list (NodeInfo.host + web_port); per-peer summaries are pulled over
    plain HTTP with a short timeout and cached for `cache_ttl_micros`.
    An unreachable peer is marked STALE — its last-known summary (if
    any) stays in the rollup with `stale: true` — never fatal: the
    rollup's whole point is answering during a partial outage."""

    STATUS_RANK = {"ok": 0, "degraded": 1, "unhealthy": 2}

    def __init__(
        self,
        self_name: str,
        local_summary: Callable[[], dict],
        peers_fn: Callable[[], dict],
        fetch: Optional[Callable[[str], dict]] = None,
        clock_fn: Optional[Callable[[], int]] = None,
        cache_ttl_micros: int = 2_000_000,
        timeout: float = 2.0,
    ):
        self.self_name = self_name
        self._local_summary = local_summary
        self._peers_fn = peers_fn
        self._fetch = fetch or self._http_fetch
        self._clock_fn = clock_fn or (
            lambda: __import__("time").time_ns() // 1_000
        )
        self.cache_ttl_micros = cache_ttl_micros
        self.timeout = timeout
        self._lock = locks.make_lock("ClusterHealth._lock")
        # name -> {"summary", "fetched_at_micros", "stale", "error"}
        self._cache: dict[str, dict] = {}

    def _http_fetch(self, url: str) -> dict:
        import urllib.request

        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _pull(self, name: str, url: str, now: int) -> dict:
        with self._lock:
            entry = self._cache.get(name)
            # the TTL covers FAILED pulls too: an unreachable peer must
            # not make every /cluster request block `timeout` seconds
            # per dead peer — exactly the partial outage the rollup is
            # supposed to answer during
            if (
                entry is not None
                and now - entry["checked_at_micros"] < self.cache_ttl_micros
            ):
                return entry
        try:
            summary = self._fetch(url)
            entry = {
                "summary": summary,
                "fetched_at_micros": now,
                "checked_at_micros": now,
                "stale": False,
                "error": None,
            }
        except Exception as e:   # unreachable peer: stale, never fatal
            with self._lock:
                prev = self._cache.get(name)
            entry = {
                "summary": prev["summary"] if prev else None,
                "fetched_at_micros": (
                    prev["fetched_at_micros"] if prev else None
                ),
                "checked_at_micros": now,
                "stale": True,
                "error": f"{type(e).__name__}: {e}",
            }
        with self._lock:
            self._cache[name] = entry
        return entry

    @classmethod
    def _status_of(cls, summary: Optional[dict]) -> str:
        if not summary:
            return "unknown"
        return summary.get("status") or (
            "ok" if summary.get("healthy") else "unhealthy"
        )

    def snapshot(self) -> dict:
        """The GET /cluster payload: per-node summaries (self included,
        read locally), fleet worst-state, per-node firing-alert counts,
        stale marking for unreachable peers."""
        now = self._clock_fn()
        nodes: dict[str, dict] = {
            self.self_name: {
                "summary": self._local_summary(),
                "stale": False,
                "error": None,
                "source": "local",
            }
        }
        for name, url in sorted(self._peers_fn().items()):
            if name == self.self_name:
                continue
            nodes[name] = dict(self._pull(name, url, now), url=url)
        worst, worst_rank = "ok", 0
        alert_counts: dict[str, int] = {}
        stale = []
        for name, entry in nodes.items():
            if entry["stale"]:
                stale.append(name)
            status = self._status_of(entry.get("summary"))
            entry["status"] = status
            rank = self.STATUS_RANK.get(status)
            if rank is not None and rank > worst_rank:
                worst, worst_rank = status, rank
            summary = entry.get("summary") or {}
            alert_counts[name] = int(summary.get("alerts_firing") or 0)
        return {
            "self": self.self_name,
            "worst": worst,
            "nodes": nodes,
            "alerts_firing": alert_counts,
            "alerts_firing_total": sum(alert_counts.values()),
            "stale_peers": sorted(stale),
            "at_micros": now,
        }


# ---------------------------------------------------------------------------
# incident forensics bundles


class IncidentRecorder:
    """Durable evidence bundles for firing alerts and failed fleet
    invariants, written to `base_dir/incidents/<id>.json` with bounded
    retention and served at GET /incidents.

    A bundle is everything a post-hoc debugger reaches for, captured
    AT the moment the alert fired instead of reconstructed later: the
    firing alert (name, severity, detail), the slowest matching traces
    — INCLUDING their remote halves when a cross-node assembler
    (`tracing.ClusterTraces.assemble`) is wired — a metrics snapshot,
    the health-event tail, and the chaos plane's injected-reality log
    when one exists (fleet rigs: what was DONE to the system next to
    what the system SAID). Capture is best-effort end to end: an
    unreachable peer or full disk degrades the bundle, never the
    health tick that triggered it."""

    def __init__(
        self,
        dir_path: str,
        clock_fn: Optional[Callable[[], int]] = None,
        keep: int = 32,
        assemble: Optional[Callable[[int], dict]] = None,
        chaos_log: Optional[Callable[[], list]] = None,
        max_traces: int = 3,
    ):
        import os

        self.dir_path = dir_path
        self._clock_fn = clock_fn or (
            lambda: __import__("time").time_ns() // 1_000
        )
        self.keep = max(1, int(keep))
        self.assemble = assemble
        self.chaos_log = chaos_log
        self.max_traces = max(0, int(max_traces))
        self._lock = locks.make_lock("IncidentRecorder._lock")
        self._seq = 0
        self.recorded = 0
        # GET /incidents headline cache: bundles embed whole assembled
        # traces, so the index must not re-read and re-parse every
        # bundle file per request — rows cache by (name, mtime)
        self._headlines: dict[str, tuple[float, dict]] = {}
        os.makedirs(dir_path, exist_ok=True)

    # -- capture -------------------------------------------------------------

    def record(
        self,
        kind: str,
        name: str,
        detail: Optional[dict] = None,
        severity: str = SEV_WARNING,
        evidence: Optional[dict] = None,
        monitor: Optional["HealthMonitor"] = None,
        node: Optional[str] = None,
        background: bool = False,
    ) -> str:
        """Snapshot one incident; returns its id. `kind` is "alert" or
        "reconciliation"; `evidence` is the alert's captured evidence
        (trace ids + metrics snapshot) whose trace ids get their
        cross-node assembly pulled via `assemble`.

        `background=True` mints and returns the id immediately and
        runs the CAPTURE (the cross-node pulls + the disk write) on a
        daemon thread: an alert fires exactly when peers tend to be
        unreachable, and N peers x the fetch timeout of synchronous
        assembly would stall the very pump tick that fired it —
        flipping healthz and escalating the incident being recorded.
        Simulated-time rigs keep the synchronous default (deterministic
        bundles, no clock to stall)."""
        now = self._clock_fn()
        with self._lock:
            self._seq += 1
            seq = self._seq
        slug = "".join(
            ch if ch.isalnum() or ch in "._-" else "-" for ch in name
        )[:48]
        incident_id = f"inc-{now}-{seq:03d}-{slug}"
        # snapshot the caller's dicts NOW: the firing path mutates the
        # live alert.evidence right after this call returns (it stores
        # the incident id into it), and a background capture iterating
        # the same dict mid-mutation would die on 'dictionary changed
        # size'. The JSON round-trip doubles as the JSON-safety check
        # _write would otherwise hit at dump time.
        detail = json.loads(json.dumps(detail or {}, default=str))
        evidence = json.loads(json.dumps(evidence or {}, default=str))
        if background:
            def run():
                try:
                    self._capture(
                        incident_id, now, kind, name, detail, severity,
                        evidence, monitor, node,
                    )
                except Exception:   # a dead capture must not be silent
                    import logging

                    logging.getLogger("corda_tpu.health").exception(
                        "incident capture %s failed", incident_id
                    )

            threading.Thread(
                target=run, daemon=True, name=f"incident-{seq}",
            ).start()
        else:
            self._capture(
                incident_id, now, kind, name, detail, severity,
                evidence, monitor, node,
            )
        return incident_id

    def _capture(
        self, incident_id, now, kind, name, detail, severity,
        evidence, monitor, node,
    ) -> None:
        bundle: dict = {
            "id": incident_id,
            "at_micros": now,
            "kind": kind,
            "node": node,
            "alert": {
                "name": name,
                "severity": severity,
                "detail": detail or {},
            },
            "evidence": evidence or {},
        }
        traces = []
        for row in (evidence or {}).get("traces", ())[: self.max_traces]:
            tid_text = row.get("trace_id") if isinstance(row, dict) else row
            assembled = self._assemble_one(tid_text)
            if assembled is not None:
                traces.append(assembled)
        bundle["traces"] = traces
        if monitor is not None:
            try:
                bundle["events"] = monitor.events.tail(64)
            except Exception:
                bundle["events"] = []
            if "metrics" not in bundle["evidence"]:
                try:
                    bundle["evidence"]["metrics"] = (
                        monitor._metrics_snapshot()
                    )
                except Exception:
                    pass
        if self.chaos_log is not None:
            try:
                bundle["chaos"] = list(self.chaos_log())
            except Exception:
                bundle["chaos"] = []
        self._write(incident_id, bundle)
        self.recorded += 1

    def _assemble_one(self, tid_text) -> Optional[dict]:
        from . import tracing as tracelib

        tid = tracelib.parse_trace_id(tid_text)
        if tid is None:
            return None
        if self.assemble is None:
            return {"trace_id": f"{tid:#x}", "assembled": False}
        try:
            out = dict(self.assemble(tid))
            out["assembled"] = True
            return out
        except Exception as e:   # partial evidence beats no bundle
            return {
                "trace_id": f"{tid:#x}",
                "assembled": False,
                "error": f"{type(e).__name__}: {e}",
            }

    def _write(self, incident_id: str, bundle: dict) -> None:
        import os

        path = os.path.join(self.dir_path, incident_id + ".json")
        try:
            with open(path, "w") as f:
                json.dump(bundle, f, default=str, indent=1)
            self._prune()
        except OSError:
            pass   # full disk: the alert still fired, the node serves on

    def _prune(self) -> None:
        import os

        names = sorted(
            n for n in os.listdir(self.dir_path) if n.endswith(".json")
        )
        # ids sort chronologically (micros-stamped), oldest first
        for n in names[: max(0, len(names) - self.keep)]:
            try:
                os.remove(os.path.join(self.dir_path, n))
            except OSError:
                pass

    # -- serving (GET /incidents) --------------------------------------------

    def list(self) -> list[dict]:
        """Newest-first index: id plus the alert headline per bundle.
        Each bundle file is parsed once per (name, mtime) — the cache
        keeps repeated GET /incidents hits from re-reading every
        multi-trace bundle in full for seven scalar fields."""
        import os

        out = []
        try:
            names = sorted(os.listdir(self.dir_path), reverse=True)
        except OSError:
            return []
        seen = set()
        for n in names:
            if not n.endswith(".json"):
                continue
            seen.add(n)
            try:
                mtime = os.path.getmtime(
                    os.path.join(self.dir_path, n)
                )
            except OSError:
                continue
            with self._lock:
                cached = self._headlines.get(n)
            if cached is not None and cached[0] == mtime:
                out.append(cached[1])
                continue
            bundle = self.load(n[:-5])
            if bundle is None:
                continue
            row = {
                "id": bundle.get("id", n[:-5]),
                "at_micros": bundle.get("at_micros"),
                "kind": bundle.get("kind"),
                "node": bundle.get("node"),
                "alert": (bundle.get("alert") or {}).get("name"),
                "severity": (bundle.get("alert") or {}).get("severity"),
                "traces": len(bundle.get("traces") or ()),
            }
            with self._lock:
                self._headlines[n] = (mtime, row)
            out.append(row)
        with self._lock:
            for n in [k for k in self._headlines if k not in seen]:
                del self._headlines[n]   # pruned bundles leave the cache
        return out

    def load(self, incident_id: str) -> Optional[dict]:
        import os

        if "/" in incident_id or ".." in incident_id:
            return None   # path traversal via the URL id
        path = os.path.join(self.dir_path, incident_id + ".json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


# ---------------------------------------------------------------------------
# the canary transaction (shared by node wiring, bench and tests)


def _register_canary_contract() -> None:
    """The canary's state/command/contract: a zero-input transaction
    whose uniqueness commit is vacuous (nothing to consume), so probes
    exercise stage -> dispatch -> validate -> commit -> sign on the
    REAL flush without ever touching the uniqueness store's real
    namespace. Registered lazily so utils/health.py stays importable
    without the core layer."""
    global CanaryState, CanaryBeat
    if CanaryState is not None:
        return
    from dataclasses import dataclass as _dc

    from ..core import serialization as ser
    from ..core.contracts import register_contract

    @ser.serializable
    @_dc(frozen=True)
    class _CanaryState:
        seq: int
        owner: Any

        @property
        def participants(self):
            return (self.owner,)

    @ser.serializable
    @_dc(frozen=True)
    class _CanaryBeat:
        seq: int = 0

    class _CanaryContract:
        def verify(self, ltx) -> None:
            # a synthetic probe is always valid; the point is the PATH
            pass

    register_contract(CANARY_CONTRACT, _CanaryContract())
    CanaryState, CanaryBeat = _CanaryState, _CanaryBeat


CANARY_CONTRACT = "corda_tpu.health.Canary"
CanaryState: Any = None
CanaryBeat: Any = None


def canary_transaction(services, notary_party, owner_key, seq: int):
    """Build + sign one canary notarisation (no inputs, one output in
    the canary namespace) through the hub's normal signing path."""
    _register_canary_contract()
    from ..core.transactions import TransactionBuilder

    b = TransactionBuilder(notary_party)
    b.add_output_state(CanaryState(seq, owner_key), CANARY_CONTRACT)
    b.add_command(CanaryBeat(seq), owner_key)
    return services.sign_initial_transaction(b)


def notary_canary_fn(services, requester_party, tracer=None):
    """A CanaryProbe `fn` that rides the REAL batching-notary flush:
    each launch enqueues one canary _PendingNotarisation (marked with a
    `health.canary` root span when tracing is on); the flush stages,
    dispatches, validates, commits (vacuously) and signs it like any
    other request, and the future's resolution calls `complete`.

    `requester_party` must be a party whose key `services` can sign
    with — normally the serving node's OWN identity (the canary is the
    notary's own synthetic traffic), or the flush's required-signature
    check rejects the probe as missing signatures."""
    state = {"seq": 0}

    def fn(complete) -> None:
        from ..flows.api import FlowFuture
        from ..node.notary import _PendingNotarisation

        svc = services.notary_service
        state["seq"] += 1
        stx = canary_transaction(
            services, svc.identity, requester_party.owning_key, state["seq"]
        )

        def on_done(f) -> None:
            try:
                complete(ok=hasattr(f.result(), "by"))
            except Exception:
                complete(ok=False)

        fut = FlowFuture()
        fut.add_done_callback(on_done)
        span = None
        if tracer is not None and tracer.enabled:
            span = tracer.start_trace(
                "health.canary", canary=True, seq=state["seq"]
            )
        p = _PendingNotarisation(stx, requester_party, fut, span=span)
        # synthetic probe, NOT an admitted client request: it must not
        # journal into the intent WAL (a crash would replay it into a
        # boot where the canary contract isn't codec-registered yet,
        # and replaying a probe is meaningless anyway) — the sentinel
        # skips the journal append while staying "already stamped"
        p.intent_seq = -1
        enqueue = getattr(svc, "enqueue_pending", None)
        if enqueue is not None:
            # routes to the owning SHARD on a sharded plane — a bare
            # _pending.append would starve there (the sharded tick
            # only drains shard queues) and trip the deadman on a
            # healthy node
            enqueue(p)
        else:
            svc._pending.append(p)

    return fn
