"""End-to-end hot-path tracing: spans, flight recorder, Chrome export.

Port of corda_tpu/utils/tracing.py: spans, `ClockSync`, `Trace`,
the `FlightRecorder`, the tracer's export, `chrome_trace`,
`stage_summary`, `fan_out`, `parse_trace_id`, the cross-node
`ClusterTraces` and `phase_summary`. Beside the recorder the port's
`Tracer` keeps its last `keep` completed traces, each as its spans in
start order, in `completed`. `annotate(name)` is
`torch.profiler.record_function(name)`: the notary's verify dispatch
shows as a named region in a torch.profiler capture, so host spans line
up with the card's kernels.

A throughput target is only defendable if a regression can be
*attributed*: the serving path crosses the fabric, the ingest pipeline,
the batching notary and the verification SPI, and a loss anywhere in
that chain looks identical from the outside. Hardware-verifier work (the FPGA ECDSA
engine of arXiv:2112.02229, SZKP arXiv:2408.05890) keeps finding the
same thing: the accelerator is rarely the bottleneck — the host
staging/dispatch stages are. This module makes those stages visible on
EVERY batch, not just in one-off profile runs:

  Tracer / Span   — trace_id/span_id/parent links, monotonic
                    timestamps, attributes + events. A span is cheap
                    (one object, two perf_counter reads); a DISABLED
                    tracer returns one shared no-op singleton so the
                    hot path pays a single attribute check.
  FlightRecorder  — bounded retention of completed traces: the N most
                    RECENT (what just happened) and the N SLOWEST (what
                    an operator is hunting). Churn evicts from the
                    recent ring only; a slow trace survives until a
                    slower one displaces it.
  Chrome export   — `chrome_trace(traces)` renders trace-event JSON
                    loadable by chrome://tracing / Perfetto; the node
                    webserver serves it at GET /traces next to
                    /metrics.
  annotate(name)  — a named region in a torch.profiler capture (so
                    host spans line up with the card's kernels).

Propagation: `Span.context` is a (trace_id, span_id) pair that rides
as an optional message header across the MessagingService fabric
(messaging.Message.trace) and as `trace_parents` through the ingest
pipeline — `start_trace(name, parent=ctx)` on the receiving side
continues the SAME trace, so one notarisation is one connected tree
from wire-frame arrival to uniqueness commit.

Enable process-wide with CORDA_TPU_TRACE=1 (the default tracer is
disabled otherwise), or construct/set an explicit `Tracer`.
"""

from __future__ import annotations

import heapq
import os
import random
import threading
from . import locks
import time
from collections import deque
from typing import Any, Callable, Iterable, Optional


class SpanContext(tuple):
    """(trace_id, span_id) — the wire-propagatable identity of a span.

    A plain tuple subclass: it serializes anywhere a 2-tuple does (the
    fabric's optional message header is exactly this pair), and
    `from_header` accepts whatever a codec round-trip produced."""

    __slots__ = ()

    def __new__(cls, trace_id: int, span_id: int):
        return super().__new__(cls, (int(trace_id), int(span_id)))

    @property
    def trace_id(self) -> int:
        return self[0]

    @property
    def span_id(self) -> int:
        return self[1]

    @classmethod
    def from_header(cls, header) -> Optional["SpanContext"]:
        """None-tolerant decode of a propagated header (a sequence of
        >= 2 ints, a SpanContext, or None/malformed -> None). Extra
        elements — the wire form appends a send timestamp for clock-
        offset estimation (`wire_trace`) — are ignored here."""
        if header is None:
            return None
        try:
            return cls(int(header[0]), int(header[1]))
        except Exception:
            return None


def wire_trace(parent) -> Optional[tuple]:
    """The fabric-header form of a trace context: `(trace_id, span_id,
    sent_at_us)` where `sent_at_us` is the SENDER's monotonic clock
    (time.perf_counter microseconds) at send time. The receiver pairs
    it with its own arrival clock (`ClockSync.observe`), which is what
    lets `ClusterTraces` put two processes' span timestamps on one
    honest axis. Accepts a live Span, a SpanContext, or a prior wire
    header (re-stamping the timestamp for the new hop); None in,
    None out."""
    if parent is None:
        return None
    ctx = parent.context if isinstance(parent, (Span, _NoopSpan)) \
        else SpanContext.from_header(parent)
    if ctx is None:
        return None
    return (ctx.trace_id, ctx.span_id, int(time.perf_counter() * 1e6))


class ClockSync:
    """Per-peer clock-offset evidence from fabric send/recv pairs.

    Span timestamps are process-local `time.perf_counter` readings —
    two nodes' spans live on unrelated axes. Every traced frame's wire
    header carries the sender's send time; the receiver records
    `skew = recv_local - sent_peer = offset + network_delay`, so the
    MINIMUM skew over many frames is the tightest available upper
    bound on `offset` (local minus peer). With the PEER's minimum for
    the reverse direction (pulled from its /traces export),
    `ClusterTraces` takes the NTP-style midpoint
    `(fwd_min - bwd_min) / 2`, accurate to half the minimum RTT."""

    def __init__(self):
        self._lock = locks.make_lock("ClockSync._lock")
        # peer -> [min skew micros, observation count]
        self._obs: dict[str, list] = {}

    def observe(self, peer: str, sent_us, recv_us: Optional[int] = None) -> None:
        if recv_us is None:
            recv_us = int(time.perf_counter() * 1e6)
        skew = int(recv_us) - int(sent_us)
        with self._lock:
            row = self._obs.get(peer)
            if row is None:
                self._obs[peer] = [skew, 1]
            else:
                if skew < row[0]:
                    row[0] = skew
                row[1] += 1

    def observe_header(self, peer: str, header) -> None:
        """Record a wire-header observation if the header carries a
        send timestamp (3rd element); no-op otherwise."""
        if header is not None and len(header) >= 3:
            try:
                self.observe(peer, int(header[2]))
            except (TypeError, ValueError):
                pass

    def min_skew(self, peer: str) -> Optional[int]:
        with self._lock:
            row = self._obs.get(peer)
            return row[0] if row else None

    def export(self) -> dict:
        """JSON-safe per-peer evidence — served inside GET /traces so a
        remote assembler can read this node's view of the reverse
        direction."""
        with self._lock:
            return {
                peer: {"min_skew_us": row[0], "count": row[1]}
                for peer, row in sorted(self._obs.items())
            }


class _NoopSpan:
    """The disabled-tracer span: every operation is a no-op, `bool()`
    is False so call sites can gate work with `if span:`. ONE shared
    instance — a disabled run allocates nothing per frame."""

    __slots__ = ()

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attributes) -> None:
        pass

    def end(self, end_time: Optional[float] = None) -> None:
        pass

    @property
    def context(self) -> Optional[SpanContext]:
        return None

    @property
    def ended(self) -> bool:
        return True

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed operation in a trace. Monotonic timestamps
    (time.perf_counter), attributes (set any time before export),
    events (point-in-time marks inside the span)."""

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "start", "end_time", "attributes", "events",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: int,
        span_id: int,
        parent_id: Optional[int],
        start: float,
        attributes: Optional[dict] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_time: Optional[float] = None
        self.attributes = attributes or {}
        self.events: list[tuple[float, str, dict]] = []

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes) -> None:
        self.events.append((time.perf_counter(), name, attributes))

    def end(self, end_time: Optional[float] = None) -> None:
        """Idempotent: the first end wins (error paths may race the
        normal completion path to it)."""
        if self.end_time is not None:
            return
        self.end_time = end_time if end_time is not None else time.perf_counter()
        self._tracer._complete(self)

    @property
    def ended(self) -> bool:
        return self.end_time is not None

    @property
    def duration_s(self) -> float:
        if self.end_time is None:
            return 0.0
        return self.end_time - self.start

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Span({self.name!r}, trace={self.trace_id:#x}, "
            f"span={self.span_id}, dur={self.duration_s * 1e6:.1f}us)"
        )


class Trace:
    """A completed trace: every span this tracer opened for one
    trace_id, in start order. `duration_s` is the ROOT span's wall
    (the first span opened locally — frame arrival to final answer),
    which is what the flight recorder ranks slowness by."""

    __slots__ = ("trace_id", "spans")

    def __init__(self, trace_id: int, spans: list[Span]):
        self.trace_id = trace_id
        self.spans = sorted(spans, key=lambda s: s.start)

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def name(self) -> str:
        return self.root.name

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def matches(self, token: str) -> bool:
        """Does any span in this trace carry `token` — as a substring
        of its name, or as `shard<k>` when a flush stamped a `shard`
        attribute on its phase spans? The health plane's alert
        evidence filters on this, so a per-shard alert (one hot shard
        on the sharded commit plane) cites the slowest traces that
        actually touched that shard."""
        for s in self.spans:
            if token in s.name:
                return True
            shard = s.attributes.get("shard")
            if shard is not None and token == f"shard{shard}":
                return True
        return False

    def __len__(self) -> int:
        return len(self.spans)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Trace({self.name!r}, {len(self.spans)} spans, "
            f"{self.duration_s * 1e3:.2f}ms)"
        )


class FlightRecorder:
    """Bounded retention of completed traces: `keep_recent` most recent
    plus `keep_slowest` slowest. The slow set is a min-heap keyed on
    duration, so under churn a slow outlier survives until a SLOWER one
    displaces it — the post-hoc 'what was that 300ms spike' question
    the recent ring alone cannot answer."""

    def __init__(self, keep_recent: int = 64, keep_slowest: int = 16):
        self.keep_recent = max(1, keep_recent)
        self.keep_slowest = max(1, keep_slowest)
        self._lock = locks.make_lock("FlightRecorder._lock")
        self._recent: list[Trace] = []
        self._slow: list[tuple[float, int, Trace]] = []   # min-heap
        self._seq = 0
        self.recorded = 0   # lifetime total, for the /traces summary

    def record(self, trace: Trace) -> None:
        with self._lock:
            self.recorded += 1
            self._seq += 1
            self._recent.append(trace)
            if len(self._recent) > self.keep_recent:
                del self._recent[0]
            entry = (trace.duration_s, self._seq, trace)
            if len(self._slow) < self.keep_slowest:
                heapq.heappush(self._slow, entry)
            elif entry[0] > self._slow[0][0]:
                heapq.heapreplace(self._slow, entry)

    def recent(self) -> list[Trace]:
        with self._lock:
            return list(self._recent)

    def slowest(self) -> list[Trace]:
        """Slowest-first."""
        with self._lock:
            return [t for _, _, t in sorted(self._slow, reverse=True)]

    def traces(self) -> list[Trace]:
        """Union of the slow and recent sets, deduplicated, slowest
        set first — what GET /traces exports."""
        seen: set[int] = set()
        out: list[Trace] = []
        for t in self.slowest() + self.recent():
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()
            self.recorded = 0


class Tracer:
    """Span factory + per-trace assembly.

    A trace completes (and reaches the flight recorder) when every span
    this tracer opened for its trace_id has ended — completion is
    ref-counted, so out-of-order ends (a batch phase span finishing
    after the per-frame root) assemble correctly. `max_open_traces`
    bounds the in-flight table against spans that are never ended
    (oldest trace dropped, not leaked)."""

    def __init__(
        self,
        enabled: bool = True,
        recorder: Optional[FlightRecorder] = None,
        max_open_traces: int = 4096,
        keep: int = 64,
    ):
        self.enabled = enabled
        self.recorder = recorder if recorder is not None else FlightRecorder()
        # the last `keep` completed traces, each its spans in start order
        self.completed: deque = deque(maxlen=max(1, keep))
        # per-peer clock-offset evidence (see ClockSync): consensus
        # layers feed it from traced fabric frames; /traces exports it
        self.clock_sync = ClockSync()
        self._lock = locks.make_lock("Tracer._lock")
        # trace AND span ids are salted per-tracer: two processes'
        # spans merge into one cross-node assembly (ClusterTraces), so
        # a bare per-tracer counter would collide span ids across
        # nodes — every node's first span would be id 1, and the
        # merged tree's parent links would be ambiguous
        self._trace_salt = random.getrandbits(32) << 20
        self._span_salt = random.getrandbits(32) << 20
        self._next_trace = 0
        self._next_span = 0
        self._open: dict[int, list] = {}   # trace_id -> [spans, n_open]
        self._max_open = max(16, max_open_traces)

    # -- span factories -----------------------------------------------------

    def start_trace(self, name: str, parent=None, **attributes):
        """Root (or hop-continuation) span. `parent` is a propagated
        SpanContext / (trace_id, span_id) header from an upstream hop:
        given one, the new span JOINS that trace instead of starting a
        fresh id — span parenting survives the fabric hop."""
        if not self.enabled:
            return NOOP_SPAN
        ctx = SpanContext.from_header(parent) if parent is not None else None
        if ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            with self._lock:
                self._next_trace += 1
                trace_id = self._trace_salt + self._next_trace
            parent_id = None
        return self._open_span(name, trace_id, parent_id, attributes)

    def start_span(self, name: str, parent, **attributes):
        """Child span under a live Span or a SpanContext. A None/noop
        parent yields the noop span — callers thread `entry.span`
        through unconditionally and only real traces pay."""
        if not self.enabled:
            return NOOP_SPAN
        ctx = parent.context if isinstance(parent, (Span, _NoopSpan)) \
            else SpanContext.from_header(parent)
        if ctx is None:
            return NOOP_SPAN
        return self._open_span(name, ctx.trace_id, ctx.span_id, attributes)

    def span_at(self, name: str, parent, start: float, end: float,
                **attributes):
        """A pre-timed, immediately-completed child span: batch stages
        (one decode pass over 512 frames) measure ONE interval and
        attribute it to every member frame's trace without holding 512
        live spans open."""
        span = self.start_span(name, parent, **attributes)
        if span:
            span.start = start
            span.end(end)
        return span

    # -- assembly -----------------------------------------------------------

    def _open_span(self, name, trace_id, parent_id, attributes) -> Span:
        with self._lock:
            self._next_span += 1
            span = Span(
                self, name, trace_id, self._span_salt + self._next_span,
                parent_id, time.perf_counter(),
                dict(attributes) if attributes else None,
            )
            state = self._open.get(trace_id)
            if state is None:
                if len(self._open) >= self._max_open:
                    # drop the oldest in-flight trace, not the new one:
                    # an abandoned span must not wedge the table
                    self._open.pop(next(iter(self._open)))
                state = self._open[trace_id] = [[], 0]
            state[0].append(span)
            state[1] += 1
        return span

    def _complete(self, span: Span) -> None:
        done: Optional[Trace] = None
        with self._lock:
            state = self._open.get(span.trace_id)
            if state is None:
                return   # trace was evicted from the open table
            state[1] -= 1
            if state[1] <= 0:
                del self._open[span.trace_id]
                done = Trace(span.trace_id, state[0])
                self.completed.append(sorted(state[0], key=lambda s: s.start))
        if done is not None and self.recorder is not None:
            self.recorder.record(done)

    # -- export -------------------------------------------------------------

    def export(
        self,
        trace_id: Optional[int] = None,
        name: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> dict:
        """The GET /traces payload: chrome://tracing-loadable (object
        form with `traceEvents`) plus the per-stage latency summary.

        Server-side filtering (the ClusterTraces pull path, and the
        cure for the unbounded serialize-everything payload):
        `trace_id` keeps only traces with that id (a cross-node trace
        may retain SEVERAL Trace objects per id — remote phase spans
        complete independently — all are kept), `name` keeps traces
        with any span name containing the substring, `limit` caps the
        trace count AFTER filtering (slowest-first order, so the cap
        keeps what an operator is hunting)."""
        traces = self.recorder.traces() if self.recorder else []
        total_retained = len(traces)
        if trace_id is not None:
            traces = [t for t in traces if t.trace_id == trace_id]
        if name:
            traces = [
                t for t in traces
                if any(name in s.name for s in t.spans)
            ]
        if limit is not None and limit >= 0:
            traces = traces[:limit]
        out = chrome_trace(traces)
        out["stageSummary"] = stage_summary(traces)
        out["tracesRecorded"] = self.recorder.recorded if self.recorder else 0
        out["tracesRetained"] = total_retained
        out["tracesReturned"] = len(traces)
        out["clockSync"] = self.clock_sync.export()
        out["enabled"] = self.enabled
        return out

    def stage_summary(self) -> dict:
        traces = self.recorder.traces() if self.recorder else []
        return stage_summary(traces)


def chrome_trace(traces: Iterable[Trace]) -> dict:
    """Chrome trace-event JSON (object form): one 'X' (complete) event
    per span, ts/dur in microseconds, one tid per trace so each
    notarisation renders as its own row; events become 'i' instants.
    Extra top-level keys are permitted by the format and carry the
    summary the webserver adds."""
    events: list[dict] = []
    for tid, trace in enumerate(traces, start=1):
        for s in trace.spans:
            if not s.ended:
                continue
            args = dict(s.attributes)
            args["trace_id"] = f"{s.trace_id:#x}"
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_span_id"] = s.parent_id
            events.append({
                "name": s.name,
                "cat": "corda_tpu",
                "ph": "X",
                "ts": round(s.start * 1e6, 3),
                "dur": round((s.end_time - s.start) * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": args,
            })
            for t, name, attrs in s.events:
                events.append({
                    "name": name,
                    "cat": "corda_tpu",
                    "ph": "i",
                    "s": "t",
                    "ts": round(t * 1e6, 3),
                    "pid": 1,
                    "tid": tid,
                    "args": dict(attrs),
                })
    return {"displayTimeUnit": "ms", "traceEvents": events}


def stage_summary(traces: Iterable[Trace]) -> dict:
    """Per-span-name latency aggregate over `traces`: count / total /
    mean / max seconds. The reading guide lives in
    docs/serving-notary.md; bench.py folds this into the BENCH record
    so the perf trajectory pins regressions to a stage."""
    agg: dict[str, dict] = {}
    for trace in traces:
        for s in trace.spans:
            if not s.ended:
                continue
            row = agg.get(s.name)
            if row is None:
                row = agg[s.name] = {
                    "count": 0, "total_s": 0.0, "max_s": 0.0,
                }
            d = s.duration_s
            row["count"] += 1
            row["total_s"] += d
            if d > row["max_s"]:
                row["max_s"] = d
    for row in agg.values():
        row["total_s"] = round(row["total_s"], 9)
        row["max_s"] = round(row["max_s"], 9)
        row["mean_s"] = round(row["total_s"] / row["count"], 9)
    return agg


# -- cross-node trace assembly ------------------------------------------------


def fan_out(
    jobs: dict, workers: int = 8
) -> tuple[dict, dict]:
    """Run `jobs` ({key: zero-arg thunk}) concurrently on a bounded
    batch of worker threads and return `(results, errors)` keyed like
    the input (`errors` values are `"TypeName: message"` strings —
    the unreachable-peer format every rollup surface already prints).

    This is the peer-pull primitive the cluster surfaces share
    (ClusterTraces.assemble, txstory.ClusterTxStory.assemble, incident
    bundles via the former): a sequential pull costs N x timeout when
    N peers are slow or partitioned — exactly the moment those
    surfaces are being read — while the fan-out costs ~one timeout.
    Threads are spawned per call (bounded by `workers`) and joined
    before returning: no pool outlives the request, and a caller
    processing `results` in sorted-key order stays deterministic."""
    results: dict = {}
    errors: dict = {}
    if not jobs:
        return results, errors
    items = list(jobs.items())
    if len(items) == 1:
        key, thunk = items[0]
        try:
            results[key] = thunk()
        except Exception as e:   # noqa: BLE001 - partial, not fatal
            errors[key] = f"{type(e).__name__}: {e}"
        return results, errors
    lock = locks.make_lock("fan_out.<lock>")
    cursor = [0]

    def worker() -> None:
        while True:
            with lock:
                i = cursor[0]
                if i >= len(items):
                    return
                cursor[0] = i + 1
            key, thunk = items[i]
            try:
                value = thunk()
            except Exception as e:   # noqa: BLE001 - partial, not fatal
                with lock:
                    errors[key] = f"{type(e).__name__}: {e}"
            else:
                with lock:
                    results[key] = value

    threads = [
        threading.Thread(target=worker, daemon=True, name=f"fan-out-{k}")
        for k in range(min(max(1, workers), len(items)))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, errors


def parse_trace_id(text) -> Optional[int]:
    """Trace-id query decode: hex (`0x...` — the form every export and
    evidence row prints) or decimal; None on garbage."""
    if text is None:
        return None
    try:
        s = str(text).strip()
        return int(s, 16) if s.lower().startswith("0x") else int(s)
    except ValueError:
        return None


class ClusterTraces:
    """Cross-node trace assembly: serve `GET /cluster/trace/<id>` from
    ANY node (the ClusterHealth shape, riding the same network-map
    `web_port` advertisement).

    `assemble(trace_id)` pulls the matching span set from every peer's
    flight recorder (`GET /traces?trace_id=...` — the filtered form),
    estimates each peer's clock offset from fabric send/recv timestamp
    pairs (this node's ClockSync forward minimum paired with the
    peer's exported reverse minimum — NTP-style midpoint, one-way
    upper bound when only one direction has evidence), shifts remote
    span timestamps onto the LOCAL monotonic axis, and merges
    everything into one causally-linked tree plus a per-member
    consensus-phase summary — the artifact that answers "where did
    this distributed commit spend its time, per replica".

    `peers_fn() -> {name: base_url}`; unreachable peers degrade to an
    `errors` entry, never a failed assembly (same stance as the
    health rollup)."""

    def __init__(
        self,
        self_name: str,
        tracer: Tracer,
        peers_fn: Callable[[], dict],
        fetch: Optional[Callable[[str], dict]] = None,
        timeout: float = 1.5,
        workers: int = 8,
    ):
        self.self_name = self_name
        self.tracer = tracer
        self._peers_fn = peers_fn
        self._fetch = fetch or self._http_fetch
        self.timeout = timeout
        # peer pulls fan out on a bounded worker batch (fan_out): N
        # slow peers cost ~one timeout per assembly, not N — the
        # incident recorder assembles at exactly the moment peers are
        # most likely to be unreachable
        self.workers = workers

    def _http_fetch(self, url: str) -> dict:
        import json
        import urllib.request

        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    # -- span collection -----------------------------------------------------

    def _local_payload(self, trace_id: int) -> dict:
        return self.tracer.export(trace_id=trace_id)

    @staticmethod
    def _span_events(payload: dict) -> list[dict]:
        """The complete ('X') span events of one /traces payload."""
        return [
            e for e in payload.get("traceEvents", ())
            if e.get("ph") == "X"
        ]

    def _offset_for(self, peer: str, payload: dict) -> tuple[int, str]:
        """(offset_us, quality): add `offset_us` to the PEER's span
        timestamps to land them on the local monotonic axis."""
        fwd = self.tracer.clock_sync.min_skew(peer)
        bwd_row = (payload.get("clockSync") or {}).get(self.self_name)
        bwd = bwd_row.get("min_skew_us") if bwd_row else None
        if fwd is not None and bwd is not None:
            # fwd = off + d1, bwd = -off + d2: the midpoint cancels the
            # offset's sign, residual error <= min-RTT / 2
            return (int(fwd) - int(bwd)) // 2, "paired"
        if fwd is not None:
            return int(fwd), "one_way"
        if bwd is not None:
            return -int(bwd), "one_way"
        return 0, "none"

    # -- the rollup ----------------------------------------------------------

    def assemble(self, trace_id: int) -> dict:
        spans: list[dict] = []
        offsets: dict[str, dict] = {}
        errors: dict[str, str] = {}

        def add(node: str, payload: dict, offset_us: int) -> None:
            for e in self._span_events(payload):
                args = e.get("args") or {}
                spans.append({
                    "name": e["name"],
                    "node": node,
                    "ts_us": round(e["ts"] + offset_us, 3),
                    "dur_us": e["dur"],
                    "span_id": args.get("span_id"),
                    "parent_span_id": args.get("parent_span_id"),
                    "attributes": {
                        k: v for k, v in args.items()
                        if k not in ("span_id", "parent_span_id", "trace_id")
                    },
                })

        add(self.self_name, self._local_payload(trace_id), 0)
        peers = {
            name: base
            for name, base in self._peers_fn().items()
            if name != self.self_name
        }
        # parallel peer pulls (fan_out): fetches overlap, then offsets
        # and the merge run in sorted order so assembly stays
        # deterministic; a failed fetch degrades to an `errors` entry
        fetched, errors = fan_out(
            {
                name: (
                    lambda b=base: self._fetch(
                        f"{b}/traces?trace_id={trace_id:#x}"
                    )
                )
                for name, base in peers.items()
            },
            workers=self.workers,
        )
        for name in sorted(fetched):
            payload = fetched[name]
            offset_us, quality = self._offset_for(name, payload)
            offsets[name] = {"offset_us": offset_us, "quality": quality}
            add(name, payload, offset_us)

        spans.sort(key=lambda s: s["ts_us"])
        have = {s["span_id"] for s in spans}
        roots = [
            s["span_id"] for s in spans
            if s.get("parent_span_id") not in have
        ]
        return {
            "trace_id": f"{trace_id:#x}",
            "self": self.self_name,
            "found": bool(spans),
            "spans": spans,
            "span_count": len(spans),
            "roots": roots,
            "members": sorted({s["node"] for s in spans}),
            "offsets_micros": offsets,
            "errors": errors,
            "phase_summary": phase_summary(spans),
        }


def phase_summary(spans: list[dict]) -> dict:
    """Per-(member, phase) aggregate over assembled spans that carry a
    `member` attribute (the consensus phase spans): busy micros, span
    count, and the LAST node-clock completion stamp (`at` attribute,
    absolute node-clock micros) per member. The slow replica of a
    distributed commit is the row with the largest `last_at_micros` /
    busy time — identifiable from the bundle alone."""
    out: dict[str, dict] = {}
    for s in spans:
        member = (s.get("attributes") or {}).get("member")
        if member is None:
            continue
        row = out.setdefault(
            member,
            {"phases": {}, "busy_us": 0.0, "last_at_micros": None},
        )
        ph = row["phases"].setdefault(
            s["name"], {"count": 0, "total_us": 0.0}
        )
        ph["count"] += 1
        ph["total_us"] = round(ph["total_us"] + s["dur_us"], 3)
        row["busy_us"] = round(row["busy_us"] + s["dur_us"], 3)
        at = (s.get("attributes") or {}).get("at")
        if at is not None and (
            row["last_at_micros"] is None or at > row["last_at_micros"]
        ):
            row["last_at_micros"] = at
    return out


# -- profiler alignment -------------------------------------------------------

def annotate(name: str):
    """A named region in a torch.profiler capture."""
    import torch

    return torch.profiler.record_function(name)


# -- process default ----------------------------------------------------------

_default_tracer: Optional[Tracer] = None
_default_lock = locks.make_lock("tracing._default_lock")


def get_tracer() -> Tracer:
    """The process-wide tracer. Disabled unless CORDA_TPU_TRACE is set
    to a non-empty, non-'0' value at first use (or a later set_tracer
    installs an enabled one) — the disabled path costs one attribute
    check per instrumented seam."""
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer(
                    enabled=os.environ.get("CORDA_TPU_TRACE", "")
                    not in ("", "0")
                )
    return _default_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    global _default_tracer
    with _default_lock:
        _default_tracer = tracer
