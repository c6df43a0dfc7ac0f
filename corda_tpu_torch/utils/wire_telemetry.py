"""Wire and gateway telemetry: what the fabric and the web gateway cost.

Port of corda_tpu/utils/wire_telemetry.py. The wire is the fabric's
per-frame CTS encode/decode and its sqlite journal writes, and the web
gateway's handler threads, which share the interpreter lock with the
pump. Three pieces behind one `WirePlane` facade (built in node.py,
ticked on the pump):

  WireAccounting     - per-link fabric accounting recorded at both
      fabrics' send/recv seams: frames and bytes per (direction, peer,
      topic) link, per-frame encode/decode wall split by codec path
      (the Python CTS codec vs the native library's), journal append
      and commit latency histograms, redelivery counters, dedupe hits,
      and the dedupe table depth. A pure recorder: the fabric holds it
      as one mutable `telemetry` attribute (None costs one attribute
      check per frame).

  GatewayAccounting  - request accounting at the web gateway's dispatch
      table: per-endpoint request count, handler wall, bytes served,
      slow-handler count, recorded by client/webserver.py's dispatch
      wrapper. The plane windows these into requests/s and the share of
      wall time spent in handlers (they share the interpreter lock with
      the pump).

  WirePlane          - the facade: `tick()` on the pump cadence pulls
      journal/backlog/dedupe depths from the attached fabric and
      windows the cumulative counters; `snapshot()` is the wire
      payload; `install_rules()` puts `wire.journal_growth`,
      `wire.backlog` and `gateway.saturated` on a HealthMonitor
      (`HealthMonitor.watch_wire` calls it); `wire_host_seconds()`
      feeds the capacity roofline's `wire` resource.

Clock-injected throughout; host logic, snapshots and rules are the
reference's.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import locks
from .metrics import Histogram, MetricRegistry


@dataclass(frozen=True)
class WirePolicy:
    """Operator knobs (config.py gates the plane on/off; thresholds
    live here like DevicePolicy's). Windows are node-clock
    microseconds."""

    # one sample per tick at most this often (0 = every tick — A/B
    # A/B and simulated-time rigs)
    sample_gap_micros: int = 1_000_000
    # frame-rate / gateway / journal-growth windows
    window_micros: int = 30_000_000
    # wire.journal_growth: outbound journal at least this deep AND
    # growing across the window — frames are landing faster than the
    # bridges drain them (or a peer is down and the journal is the
    # store-and-forward buffer doing its job: the alert names which)
    journal_min_depth: int = 256
    # wire.backlog: any single peer's unacked outbound backlog at or
    # over this
    backlog_threshold: int = 512
    # gateway.saturated: windowed handler-seconds / wall-seconds at or
    # over this fraction — the gateway is eating pump time
    gateway_saturation_fraction: float = 0.25


# ---------------------------------------------------------------------------
# fabric accounting (the send/recv-seam feed)


class WireAccounting:
    """Cumulative per-link counters recorded at the fabric seams. The
    WirePlane windows these on its tick; tests read the raw
    snapshot. Link keys are (direction, peer, topic) — direction "out"
    is this node's journal draining toward `peer`, "in" is frames
    arriving from `peer`."""

    def __init__(self):
        self._lock = locks.make_lock("WireAccounting._lock")
        self._links: dict[tuple[str, str, str], dict] = {}
        # codec rows keyed (kind, path, topic): kind encode|decode,
        # path native|python — the cost-attribution split
        self._codec: dict[tuple[str, str, str], dict] = {}
        self._journal_append = Histogram()    # micros per journaled send
        self._journal_commit = Histogram()    # micros in commit/fsync
        # exact journal aggregates — the reservoirs above are fed a
        # 1-in-N subsample (see record_journal) so the per-send cost
        # stays a few hundred ns on the fabric hot path
        self._journal_n = 0
        self._journal_append_s = 0.0
        self._journal_commit_s = 0.0
        self._redelivered: dict[str, int] = {}
        self._dedupe_hits: dict[str, int] = {}

    def record_frame(
        self, direction: str, peer: str, topic: str, nbytes: int
    ) -> None:
        """One msg frame moved on one link (payload bytes)."""
        with self._lock:
            key = (direction, peer, topic)
            row = self._links.get(key)
            if row is None:
                row = self._links[key] = {"frames": 0, "bytes": 0}
            row["frames"] += 1
            row["bytes"] += int(nbytes)

    def record_codec(
        self,
        kind: str,
        native: bool,
        topic: str,
        seconds: float,
        nbytes: int,
    ) -> None:
        """One CTS encode/decode of a msg frame: `native` is whether
        the native library's codec served it (ser._native_codec())."""
        with self._lock:
            key = (kind, "native" if native else "python", topic)
            row = self._codec.get(key)
            if row is None:
                row = self._codec[key] = {
                    "calls": 0, "seconds": 0.0, "bytes": 0,
                }
            row["calls"] += 1
            row["seconds"] += float(seconds)
            row["bytes"] += int(nbytes)

    # every Nth journaled send also feeds the latency reservoirs: the
    # exact sums/counts keep totals()/host_seconds() honest while the
    # quantile feed subsamples — the reservoir is itself already a
    # 1024-slot subsample, so sampling ahead of it is the same
    # statistical estimate at a fraction of the per-send wall
    JOURNAL_SAMPLE_EVERY = 8

    def record_journal(
        self, append_seconds: float, commit_seconds: float
    ) -> None:
        """One durable send: INSERT wall vs commit/fsync wall (the
        transaction exit — WAL mode's fsync cost lands there)."""
        with self._lock:
            self._journal_n += 1
            self._journal_append_s += append_seconds
            self._journal_commit_s += commit_seconds
            sample = self._journal_n % self.JOURNAL_SAMPLE_EVERY == 1
        if sample:
            self._journal_append.update(append_seconds * 1e6)
            self._journal_commit.update(commit_seconds * 1e6)

    def record_redelivery(self, peer: str, n: int = 1) -> None:
        """Journal rows re-sent after a reconnect (seq at or below the
        bridge's high-water — at-least-once doing the healing)."""
        with self._lock:
            self._redelivered[peer] = self._redelivered.get(peer, 0) + n

    def record_dedupe_hit(self, sender: str) -> None:
        """An inbound frame the (sender, uid) PRIMARY KEY swallowed."""
        with self._lock:
            self._dedupe_hits[sender] = self._dedupe_hits.get(sender, 0) + 1

    # -- readouts ------------------------------------------------------------

    def totals(self) -> dict:
        """Cumulative aggregates (the plane's window anchors)."""
        with self._lock:
            t = {
                "frames_in": 0, "frames_out": 0,
                "bytes_in": 0, "bytes_out": 0,
            }
            for (direction, _, _), row in self._links.items():
                t[f"frames_{direction}"] += row["frames"]
                t[f"bytes_{direction}"] += row["bytes"]
            for kind in ("encode", "decode"):
                t[f"{kind}_calls"] = sum(
                    row["calls"] for (k, _, _), row in self._codec.items()
                    if k == kind
                )
                t[f"{kind}_seconds"] = sum(
                    row["seconds"] for (k, _, _), row in self._codec.items()
                    if k == kind
                )
            t["redelivered"] = sum(self._redelivered.values())
            t["dedupe_hits"] = sum(self._dedupe_hits.values())
            t["journal_appends"] = self._journal_n
            t["journal_seconds"] = (
                self._journal_append_s + self._journal_commit_s
            )
        return t

    def host_seconds(self) -> float:
        """Total measured wire-side host wall: codec + journal — the
        capacity roofline's `wire` input."""
        t = self.totals()
        return t["encode_seconds"] + t["decode_seconds"] + t["journal_seconds"]

    def link_rows(self) -> dict[tuple[str, str, str], dict]:
        with self._lock:
            return {k: dict(row) for k, row in self._links.items()}

    def snapshot(self) -> dict:
        """JSON-safe cumulative view (the /wire `fabric` section's
        counter half; the plane adds windowed rates and depths)."""
        with self._lock:
            links = [
                {
                    "direction": d, "peer": p, "topic": t,
                    "frames": row["frames"], "bytes": row["bytes"],
                }
                for (d, p, t), row in sorted(self._links.items())
            ]
            codec: dict = {}
            for (kind, path, topic), row in sorted(self._codec.items()):
                seat = codec.setdefault(topic, {}).setdefault(kind, {})
                seat[path] = {
                    "calls": row["calls"],
                    "seconds": round(row["seconds"], 9),
                    "bytes": row["bytes"],
                    "micros_per_frame": round(
                        row["seconds"] * 1e6 / row["calls"], 2
                    ) if row["calls"] else None,
                }
            redelivered = dict(sorted(self._redelivered.items()))
            dedupe_hits = dict(sorted(self._dedupe_hits.items()))
        return {
            "links": links,
            "codec": codec,
            "journal": {
                "appends": self._journal_n,
                "sampled_1_in": self.JOURNAL_SAMPLE_EVERY,
                "append_micros": _histo_row(self._journal_append),
                "commit_micros": _histo_row(self._journal_commit),
            },
            "redelivered": redelivered,
            "dedupe_hits": dedupe_hits,
        }


def _histo_row(h: Histogram) -> Optional[dict]:
    if not h.count:
        return None
    return {
        "mean": round(h.mean, 2),
        "p50": round(h.quantile(0.5), 2),
        "p95": round(h.quantile(0.95), 2),
        "p99": round(h.quantile(0.99), 2),
        "max": round(h.max, 2),
    }


# ---------------------------------------------------------------------------
# gateway accounting (the webserver dispatch-table feed)


class GatewayAccounting:
    """Per-endpoint request counters recorded by the webserver at its
    dispatch choke point. Endpoints are normalized labels (`/tx/<id>`
    collapses to one row), so the table stays bounded."""

    def __init__(self):
        self._lock = locks.make_lock("GatewayAccounting._lock")
        self._endpoints: dict[str, dict] = {}
        self._slow = 0

    def record_request(
        self,
        endpoint: str,
        seconds: float,
        nbytes: int,
        slow: bool = False,
    ) -> None:
        with self._lock:
            row = self._endpoints.get(endpoint)
            if row is None:
                row = self._endpoints[endpoint] = {
                    "requests": 0, "seconds": 0.0, "bytes": 0,
                }
            row["requests"] += 1
            row["seconds"] += float(seconds)
            row["bytes"] += int(nbytes)
            if slow:
                self._slow += 1

    def totals(self) -> dict:
        with self._lock:
            return {
                "requests": sum(
                    r["requests"] for r in self._endpoints.values()
                ),
                "seconds": sum(
                    r["seconds"] for r in self._endpoints.values()
                ),
                "bytes": sum(r["bytes"] for r in self._endpoints.values()),
                "slow_requests": self._slow,
            }

    def snapshot(self) -> dict:
        with self._lock:
            endpoints = {
                ep: {
                    "requests": row["requests"],
                    "seconds": round(row["seconds"], 9),
                    "bytes": row["bytes"],
                    "mean_micros": round(
                        row["seconds"] * 1e6 / row["requests"], 1
                    ) if row["requests"] else None,
                }
                for ep, row in sorted(self._endpoints.items())
            }
            slow = self._slow
        return {"endpoints": endpoints, "slow_requests": slow}


# ---------------------------------------------------------------------------
# alert rules (installed on a HealthMonitor by WirePlane.install_rules)


def _wire_rules(plane: "WirePlane"):
    """The journal-growth / backlog / gateway-saturation AlertRules
    over one WirePlane. Imported lazily from utils.health so
    wire_telemetry stays importable standalone (the device-plane
    pattern)."""
    from . import health as hlib

    pol = plane.policy

    class _JournalGrowthRule(hlib.AlertRule):
        """The outbound journal is deep AND growing across the window:
        sends are outrunning the bridges (or a peer is down and
        store-and-forward is buffering — the backlog rule names which
        peer)."""

        def __init__(self):
            super().__init__(
                "wire.journal_growth", self._check,
                severity=hlib.SEV_WARNING,
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            depth, growth = plane.journal_window()
            cond = depth >= pol.journal_min_depth and growth > 0
            return cond, {
                "journal_depth": depth,
                "growth_in_window": growth,
                "min_depth": pol.journal_min_depth,
            }

    class _BacklogRule(hlib.AlertRule):
        """One peer's unacked outbound backlog crossed the threshold —
        that link is the stall (dead peer, partition, or a slow
        drain)."""

        def __init__(self):
            super().__init__(
                "wire.backlog", self._check,
                severity=hlib.SEV_WARNING,
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            peer, depth = plane.backlog_worst()
            cond = depth >= pol.backlog_threshold
            return cond, {
                "peer": peer,
                "backlog": depth,
                "threshold": pol.backlog_threshold,
                "high_water": plane.backlog_high_water(peer)
                if peer is not None else 0,
            }

    class _GatewaySaturatedRule(hlib.AlertRule):
        """Gateway handler wall is eating a sustained fraction of wall
        clock — under one GIL that is pump time being stolen from
        notarisation."""

        def __init__(self):
            super().__init__(
                "gateway.saturated", self._check,
                severity=hlib.SEV_WARNING,
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            frac = plane.gateway_stolen_fraction()
            cond = frac >= pol.gateway_saturation_fraction
            return cond, {
                "stolen_fraction": round(frac, 4),
                "threshold": pol.gateway_saturation_fraction,
                "requests_per_sec": round(
                    plane.gateway_requests_per_sec(), 1
                ),
            }

    return _JournalGrowthRule(), _BacklogRule(), _GatewaySaturatedRule()


# ---------------------------------------------------------------------------
# the facade


class WirePlane:
    """What the node, the chip script and tests hold.

    Owns a WireAccounting (the fabric records into it through its
    `telemetry` attribute — `attach_fabric` wires that) and a
    GatewayAccounting (the webserver records into it); `tick()` on the
    pump cadence pulls journal/backlog/dedupe depths and windows the
    counters; `snapshot()` is the GET /wire payload.
    `install_rules()` puts the three wire alerts on a HealthMonitor
    (`HealthMonitor.watch_wire` calls it)."""

    def __init__(
        self,
        clock=None,
        metrics: Optional[MetricRegistry] = None,
        policy: Optional[WirePolicy] = None,
    ):
        self.policy = policy or WirePolicy()
        self._clock = clock
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.fabric = WireAccounting()
        self.gateway = GatewayAccounting()
        self._depth_fn: Optional[Callable[[], dict]] = None
        # depths pulled on tick
        self._journal_depth = 0
        self._dedupe_depth = 0
        self._backlog: dict[str, int] = {}
        self._backlog_hw: dict[str, int] = {}
        self._gauged_peers: set[str] = set()
        # window anchors: (micros, cumulative...) deques pruned past
        # the policy horizon (the device-plane discipline)
        self._totals_win: deque = deque()
        self._journal_win: deque = deque()   # (micros, journal_depth)
        self._gateway_win: deque = deque()   # (micros, requests, secs, bytes)
        self._link_wins: dict[tuple[str, str, str], deque] = {}
        self._last_tick: Optional[int] = None
        self._register_gauges()

    # -- clock ---------------------------------------------------------------

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    # -- wiring --------------------------------------------------------------

    def attach_fabric(self, fabric) -> None:
        """Point the fabric's telemetry seam at this plane's
        accounting, and adopt its depth feed (`wire_depths()` on both
        fabrics: journal/backlog/dedupe depths pulled per tick so the
        send path never pays a COUNT query)."""
        fabric.telemetry = self.fabric
        fn = getattr(fabric, "wire_depths", None)
        if fn is not None:
            self._depth_fn = fn

    def install_rules(self, monitor) -> None:
        """Wire the journal-growth + backlog + gateway-saturation
        alerts onto a HealthMonitor (HealthMonitor.watch_wire
        delegates here)."""
        for rule in _wire_rules(self):
            monitor.add_rule(rule)

    # -- the tick ------------------------------------------------------------

    def tick(self, now: Optional[int] = None) -> None:
        if now is None:
            now = self.now_micros()
        if (
            self._last_tick is not None
            and now - self._last_tick < self.policy.sample_gap_micros
        ):
            return
        self._last_tick = now
        horizon = now - self.policy.window_micros
        # depths from the attached fabric
        if self._depth_fn is not None:
            try:
                depths = self._depth_fn()
            except Exception:
                depths = {}
            self._journal_depth = int(depths.get("journal_depth", 0))
            self._dedupe_depth = int(depths.get("dedupe_depth", 0))
            backlog = depths.get("backlog") or {}
            self._backlog = {p: int(n) for p, n in backlog.items()}
            for peer, depth in self._backlog.items():
                if depth > self._backlog_hw.get(peer, 0):
                    self._backlog_hw[peer] = depth
                if peer not in self._gauged_peers:
                    self._gauged_peers.add(peer)
                    self._register_peer_gauges(peer)
        # cumulative anchors
        t = self.fabric.totals()
        self._totals_win.append((
            now, t["frames_in"], t["frames_out"],
            t["bytes_in"], t["bytes_out"],
            t["encode_seconds"], t["decode_seconds"],
            t["encode_calls"], t["decode_calls"],
        ))
        _prune(self._totals_win, horizon)
        self._journal_win.append((now, self._journal_depth))
        _prune(self._journal_win, horizon)
        g = self.gateway.totals()
        self._gateway_win.append((
            now, g["requests"], g["seconds"], g["bytes"],
        ))
        _prune(self._gateway_win, horizon)
        for key, row in self.fabric.link_rows().items():
            dq = self._link_wins.setdefault(key, deque())
            dq.append((now, row["frames"], row["bytes"]))
            _prune(dq, horizon)

    # -- gauges --------------------------------------------------------------

    def _register_gauges(self) -> None:
        g = self.metrics.gauge
        g("Wire.FramesInPerSec", lambda: self._totals_rate(1))
        g("Wire.FramesOutPerSec", lambda: self._totals_rate(2))
        g("Wire.BytesInPerSec", lambda: self._totals_rate(3))
        g("Wire.BytesOutPerSec", lambda: self._totals_rate(4))
        g("Wire.EncodeMicrosPerFrame",
          lambda: self._codec_micros_per_frame(5, 7))
        g("Wire.DecodeMicrosPerFrame",
          lambda: self._codec_micros_per_frame(6, 8))
        g("Wire.JournalDepth", lambda: self._journal_depth)
        g("Wire.JournalAppendMicrosP99",
          lambda: self.fabric._journal_append.quantile(0.99))
        g("Wire.JournalCommitMicrosP99",
          lambda: self.fabric._journal_commit.quantile(0.99))
        g("Wire.Redelivered",
          lambda: self.fabric.totals()["redelivered"])
        g("Wire.DedupeDepth", lambda: self._dedupe_depth)
        g("Wire.DedupeHits",
          lambda: self.fabric.totals()["dedupe_hits"])
        g("Wire.BacklogMax",
          lambda: max(self._backlog.values(), default=0))
        g("Wire.BacklogHighWater",
          lambda: max(self._backlog_hw.values(), default=0))
        g("Gateway.RequestsPerSec", self.gateway_requests_per_sec)
        g("Gateway.BytesServedPerSec",
          lambda: self._gateway_rate(3))
        g("Gateway.PumpStolenFraction", self.gateway_stolen_fraction)
        g("Gateway.SlowRequests",
          lambda: self.gateway.totals()["slow_requests"])

    def _register_peer_gauges(self, peer: str) -> None:
        g = self.metrics.gauge
        g(f"Wire.Peer.{peer}.Backlog",
          lambda p=peer: self._backlog.get(p, 0))
        g(f"Wire.Peer.{peer}.BacklogHighWater",
          lambda p=peer: self._backlog_hw.get(p, 0))

    # -- windowed readouts ---------------------------------------------------

    def _win_delta(self, dq: deque, idx: int) -> Optional[tuple]:
        """(wall_seconds, delta of column idx) across a window deque."""
        if len(dq) < 2:
            return None
        t0, t1 = dq[0][0], dq[-1][0]
        if t1 <= t0:
            return None
        return (t1 - t0) / 1e6, dq[-1][idx] - dq[0][idx]

    def _totals_rate(self, idx: int) -> float:
        d = self._win_delta(self._totals_win, idx)
        return d[1] / d[0] if d and d[0] > 0 else 0.0

    def _codec_micros_per_frame(
        self, seconds_idx: int, calls_idx: int
    ) -> float:
        d_s = self._win_delta(self._totals_win, seconds_idx)
        d_c = self._win_delta(self._totals_win, calls_idx)
        if d_s is None or d_c is None or d_c[1] <= 0:
            return 0.0
        return d_s[1] * 1e6 / d_c[1]

    def _gateway_rate(self, idx: int) -> float:
        d = self._win_delta(self._gateway_win, idx)
        return d[1] / d[0] if d and d[0] > 0 else 0.0

    def gateway_requests_per_sec(self) -> float:
        return self._gateway_rate(1)

    def gateway_stolen_fraction(self) -> float:
        """Windowed gateway handler seconds over wall seconds — the
        pump-time-stolen proxy (one GIL)."""
        d = self._win_delta(self._gateway_win, 2)
        if d is None or d[0] <= 0:
            return 0.0
        return max(0.0, min(1.0, d[1] / d[0]))

    def journal_window(self) -> tuple[int, int]:
        """(current outbound journal depth, growth across window)."""
        if len(self._journal_win) < 2:
            return self._journal_depth, 0
        return self._journal_depth, (
            self._journal_win[-1][1] - self._journal_win[0][1]
        )

    def backlog_worst(self) -> tuple[Optional[str], int]:
        """The peer with the deepest unacked outbound backlog."""
        if not self._backlog:
            return None, 0
        peer = max(self._backlog, key=self._backlog.get)
        return peer, self._backlog[peer]

    def backlog_high_water(self, peer: str) -> int:
        return self._backlog_hw.get(peer, 0)

    def _link_rates(self) -> dict[tuple[str, str, str], tuple]:
        out = {}
        for key, dq in self._link_wins.items():
            df = self._win_delta(dq, 1)
            db = self._win_delta(dq, 2)
            out[key] = (
                df[1] / df[0] if df and df[0] > 0 else 0.0,
                db[1] / db[0] if db and db[0] > 0 else 0.0,
            )
        return out

    # -- capacity feed -------------------------------------------------------

    def wire_host_seconds(self) -> Optional[float]:
        """Total measured wire-side host wall (codec encode+decode +
        journal append+commit) — the DevicePlane's `set_wire_feed`
        input; None until any framed traffic is measured."""
        s = self.fabric.host_seconds()
        return s if s > 0 else None

    # -- exports -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The GET /wire payload: per-link rates + codec attribution +
        journal/backlog/dedupe + gateway accounting."""
        fab = self.fabric.snapshot()
        rates = self._link_rates()
        for row in fab["links"]:
            fps, bps = rates.get(
                (row["direction"], row["peer"], row["topic"]), (0.0, 0.0)
            )
            row["frames_per_sec"] = round(fps, 2)
            row["bytes_per_sec"] = round(bps, 1)
        depth, growth = self.journal_window()
        fab["journal"]["depth"] = depth
        fab["journal"]["growth_in_window"] = growth
        fab["dedupe_depth"] = self._dedupe_depth
        fab["backlog"] = {
            peer: {
                "current": self._backlog.get(peer, 0),
                "high_water": self._backlog_hw.get(peer, 0),
            }
            for peer in sorted(set(self._backlog) | set(self._backlog_hw))
        }
        gw = self.gateway.snapshot()
        gw["requests_per_sec"] = round(self.gateway_requests_per_sec(), 2)
        gw["bytes_served_per_sec"] = round(self._gateway_rate(3), 1)
        gw["pump_stolen_fraction"] = round(
            self.gateway_stolen_fraction(), 4
        )
        return {
            "now_micros": self.now_micros(),
            "fabric": fab,
            "gateway": gw,
            "wire_host_seconds": round(self.fabric.host_seconds(), 9),
        }


def _prune(dq: deque, horizon: int) -> None:
    while len(dq) > 1 and dq[0][0] < horizon:
        dq.popleft()
