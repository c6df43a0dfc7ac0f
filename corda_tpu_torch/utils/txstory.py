"""Transaction provenance plane: per-tx lifecycle timelines.

Port of corda_tpu/utils/txstory.py, whole: `shed_reason`, `TxStory`
(the bounded lifecycle ledger with its typed emission helpers, the
derived `Tx.Stage.*` histograms, the slowest-transactions leaderboard
and the `txstory.stage_slo` rule) and `ClusterTxStory` (cross-member
assembly over the network map's advertised web port). The event
vocabulary, the terminal table and every exported dict are the
reference's, so one drive leaves equal stories in both packages. The
sqlite spill is `persistence.TxStoryIndex`.

The question an operator of the serving path asks is about ONE
transaction: "why was tx X rejected / slow / retried?" This module is
the continuous, bounded join of every seam that touches it:

  TxStory        — the lifecycle ledger. Every serving-path seam emits
                   typed events keyed by tx id (ingest decode/stage,
                   QoS admit/shed with reason, intent-WAL journal/
                   replay, flush membership with batch id + shard,
                   degraded/quarantine outcomes, verifier dispatch/
                   redispatch/hedge per attempt, consensus commit
                   index) into a bounded per-node ring of per-tx
                   stories. A story CLOSES at its terminal event —
                   committed, rejected, shed, quarantined or
                   unavailable, exactly one per admitted transaction (a
                   re-answer after an intent-WAL replay records as
                   `tx.reanswer`, never a second terminal) — at which
                   point the derived per-stage latencies land in the
                   `Tx.Stage.*` histograms and the slowest-transactions
                   leaderboard.
  TxStoryIndex   — optional sqlite spill (node/persistence.py):
                   ring-evicted stories stay queryable.
  ClusterTxStory — cross-member assembly: pulls every peer's local
                   story, shifts remote monotonic timestamps onto one
                   axis using the tracer's ClockSync offsets, and
                   merges one timeline.
  stage-SLO rule — `txstory.stage_slo` (install_rules): fires when a
                   serving stage's recent p99 breaches its target,
                   with the offending tx ids IN the alert detail.

Event names follow the dotted lowercase `component.event` convention.
The emission API is `record(tx_id, name, **attrs)`; shared vocabulary
(terminals, consensus commits, batch events) goes through the typed
helpers below so each literal has one stamp site.

Overhead: one lock + dict probe + list append per event; seams gate on
`story is not None`, so a node with the plane off pays one attribute
check.
"""

from __future__ import annotations

import heapq
import json
import time
import urllib.request
from collections import OrderedDict, deque
from typing import Any, Callable, Optional

from . import locks
from . import tracing as tracelib


def _wall_micros() -> int:
    return time.time_ns() // 1_000


def _mono_micros() -> int:
    return int(time.perf_counter() * 1e6)


# terminal kinds -> the event literal each records. ONE table: every
# terminal event is stamped from _close below, so the vocabulary
# cannot fork (committed/rejected/shed/quarantined/unavailable are the
# exhaustive outcomes the fleet reconciliation accounts for).
TERMINALS = {
    "committed": "tx.committed",
    "rejected": "tx.rejected",
    "shed": "tx.shed",
    "quarantined": "tx.quarantined",
    "unavailable": "tx.unavailable",
}

# terminal + dedupe events are EXEMPT from the per-tx event cap: a
# retry storm filling a story must not swallow its close — the spilled
# index record would read open-forever for a committed transaction
_UNCAPPED_EVENTS = frozenset(TERMINALS.values()) | {"tx.reanswer"}

# milestone events that mark a transaction ADMITTED (the reconciliation
# contract: every story carrying one reaches exactly one terminal)
ADMIT_EVENTS = frozenset({"notary.admit", "qos.admit", "wal.replay"})


def shed_reason(text: str) -> str:
    """Canonicalize a shed description — a `Qos.Shed.*` reason
    constant ('BrownoutBulk', 'Admission', 'ExpiredFlush', ...) or a
    shed NotaryError's message — to the terminal-reason vocabulary the
    fleet reconciliation matches: brownout / admission / expired. ONE
    derivation: the qos pre-queue close, the answer-path terminal and
    the fleet model all call this, so a reworded shed message cannot
    fork the attribution."""
    t = text.lower()
    if "brownout" in t:
        return "brownout"
    if "admission" in t:
        return "admission"
    return "expired"

# stage boundaries for the derived Tx.Stage.* histograms:
# admitted -> staged (queue wait) -> verified (stage+dispatch+verify)
# -> terminal (commit+sign). Total spans admitted -> terminal.
STAGE_QUEUE = "queue"
STAGE_VERIFY = "verify"
STAGE_COMMIT = "commit"
STAGE_TOTAL = "total"
STAGES = (STAGE_QUEUE, STAGE_VERIFY, STAGE_COMMIT, STAGE_TOTAL)

class _Story:
    """One transaction's event list + derived state. Mutated only
    under the owning TxStory's lock."""

    __slots__ = (
        "tx_id", "events", "terminal", "trace_id", "first_mono",
        "admitted_mono", "staged_mono", "verified_mono", "closed_mono",
        "stages", "reason",
    )

    def __init__(self, tx_id: str):
        self.tx_id = tx_id
        # (name, at_micros, mono_us, attrs-or-None) — tuples, not
        # objects: the hot path appends thousands per second
        self.events: list[tuple] = []
        self.terminal: Optional[str] = None     # terminal KIND
        self.reason: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.first_mono: Optional[int] = None
        self.admitted_mono: Optional[int] = None
        self.staged_mono: Optional[int] = None
        self.verified_mono: Optional[int] = None
        self.closed_mono: Optional[int] = None
        self.stages: dict[str, int] = {}

    def export(self) -> dict:
        events = []
        for name, at, mono, attrs in self.events:
            row = {"name": name, "at_micros": at, "mono_us": mono}
            if attrs:
                row.update(attrs)
            events.append(row)
        return {
            "tx_id": self.tx_id,
            "events": events,
            "event_count": len(self.events),
            "terminal": self.terminal,
            "reason": self.reason,
            "trace_id": self.trace_id,
            "stages_micros": dict(self.stages),
            "total_micros": self.stages.get(STAGE_TOTAL),
            "open": self.terminal is None,
        }


class TxStory:
    """The bounded per-node lifecycle ledger (module docstring)."""

    def __init__(
        self,
        metrics=None,
        clock=None,
        tracer=None,
        index=None,
        max_open: int = 4096,
        keep_done: int = 2048,
        keep_slowest: int = 64,
        max_events_per_tx: int = 96,
        slo_window: int = 256,
    ):
        """`metrics`: a MetricRegistry for the Tx.Stage.* histograms +
        plane counters (None skips both). `clock`: an object with
        `now_micros()` (the node clock — TestClock in simulated rigs,
        so cross-member `at_micros` stamps share an axis there); None
        uses the wall clock. `tracer`: the node's Tracer — its
        ClockSync export rides the local payload so a remote assembler
        can clock-shift this member's events. `index`: an optional
        persistence.TxStoryIndex; every event also lands in its buffer
        (group-committed by tick()) and ring-evicted stories stay
        queryable through it."""
        self.metrics = metrics
        self.tracer = tracer
        self.index = index
        if clock is None:
            self._now = _wall_micros
        elif callable(clock):
            self._now = clock
        else:
            self._now = clock.now_micros
        self._lock = locks.make_lock("TxStory._lock")
        self._open: "OrderedDict[str, _Story]" = OrderedDict()
        self._done: "OrderedDict[str, _Story]" = OrderedDict()
        self._max_open = max(16, max_open)
        self._keep_done = max(16, keep_done)
        self._keep_slowest = max(1, keep_slowest)
        self._max_events = max(8, max_events_per_tx)
        # min-heap of (total_micros, seq, story-export) — the slowest
        # COMPLETED transactions survive ring churn (GET /tx/slowest)
        self._slow: list[tuple] = []
        self._seq = 0
        self._batch_seq = 0
        self.recorded = 0        # lifetime events
        self.closed = 0          # lifetime terminals
        self.evicted = 0         # open stories dropped at the cap
        self.dropped_events = 0  # per-tx cap hits
        self.reanswers = 0
        # per-stage recent completions for the SLO rule:
        # deque of (at_micros, delta_micros, tx_id)
        self._slo_recent: dict[str, deque] = {
            s: deque(maxlen=max(16, slo_window)) for s in STAGES
        }
        self._stage_histos = None
        if metrics is not None:
            self._stage_histos = {
                STAGE_QUEUE: metrics.histogram("Tx.Stage.QueueMicros"),
                STAGE_VERIFY: metrics.histogram("Tx.Stage.VerifyMicros"),
                STAGE_COMMIT: metrics.histogram("Tx.Stage.CommitMicros"),
                STAGE_TOTAL: metrics.histogram("Tx.Stage.TotalMicros"),
            }
            metrics.gauge("Tx.Stories.Open", lambda: len(self._open))
            metrics.gauge("Tx.Stories.Closed", lambda: self.closed)
            metrics.gauge("Tx.Stories.Evicted", lambda: self.evicted)

    # -- emission (the seam API) --------------------------------------------

    def record(self, tx_id, name: str, **attrs) -> None:
        """Append one lifecycle event to `tx_id`'s story. `name` is a
        dotted lowercase `component.event` literal (lint-enforced);
        `attrs` must be JSON-safe and SMALL (reason codes, batch ids,
        attempt numbers — not payloads)."""
        tid = tx_id if isinstance(tx_id, str) else str(tx_id)
        at = self._now()
        mono = _mono_micros()
        with self._lock:
            self._record_locked(tid, name, at, mono, attrs or None)

    def _record_locked(self, tid, name, at, mono, attrs) -> None:
        self.recorded += 1
        story = self._open.get(tid)
        if story is None:
            story = self._done.get(tid)
            if story is None:
                story = _Story(tid)
                story.first_mono = mono
                self._open[tid] = story
                if len(self._open) > self._max_open:
                    # drop the OLDEST open story, never the new event:
                    # an abandoned tx must not wedge the table
                    self._open.popitem(last=False)
                    self.evicted += 1
        if (
            len(story.events) >= self._max_events
            and name not in _UNCAPPED_EVENTS
        ):
            self.dropped_events += 1
            return
        story.events.append((name, at, mono, attrs))
        if attrs:
            t = attrs.get("trace_id")
            if t is not None and story.trace_id is None:
                story.trace_id = t
        if name in ADMIT_EVENTS and story.admitted_mono is None:
            story.admitted_mono = mono
        elif name == "notary.flush" and story.staged_mono is None:
            story.staged_mono = mono
        elif name == "notary.verified" and story.verified_mono is None:
            story.verified_mono = mono
        if self.index is not None:
            self.index.append(tid, name, at, mono, attrs)

    # -- typed helpers (one literal stamp site per shared event) ------------

    def admit(
        self, tx_id, trace_id=None, deadline=None, requester=None
    ) -> None:
        attrs: dict = {}
        if trace_id is not None:
            attrs["trace_id"] = trace_id
        if deadline is not None:
            attrs["deadline"] = deadline
        if requester is not None:
            attrs["requester"] = requester
        self.record(tx_id, "notary.admit", **attrs)

    def journal(self, tx_id, seq) -> None:
        self.record(tx_id, "wal.journal", seq=seq)

    def replay(self, tx_id, seq) -> None:
        self.record(tx_id, "wal.replay", seq=seq)

    def flush_membership(
        self, tx_ids, shard: Optional[int] = None
    ) -> int:
        """The per-flush batch event: every member transaction records
        `notary.flush` with a freshly-allocated batch id (+ owning
        shard on the sharded plane) under ONE lock hold — the ledger
        allocates the id so concurrent shard-worker flushes stay
        atomic. Returns the batch id."""
        n = len(tx_ids)
        at = self._now()
        mono = _mono_micros()
        with self._lock:
            self._batch_seq += 1
            batch_id = self._batch_seq
            attrs = {"batch_id": batch_id, "batch": n}
            if shard is not None:
                attrs["shard"] = shard
            for tid in tx_ids:
                self._record_locked(
                    str(tid), "notary.flush", at, mono, attrs
                )
        return batch_id

    def degraded_flush(self, tx_ids, error: str) -> None:
        """A flush fell back to the CPU reference: every member
        transaction carries the degraded outcome + the device error."""
        at = self._now()
        mono = _mono_micros()
        attrs = {"error": error[:200]}
        with self._lock:
            for tid in tx_ids:
                self._record_locked(
                    str(tid), "notary.degraded", at, mono, attrs
                )

    def ingest_batch(self, tx_ids, decode_s: float, stage_s: float) -> None:
        """One decoded wire batch: per-tx decode + stage events with
        the shared batch-stage seconds, one lock hold for the batch."""
        n = len(tx_ids)
        if not n:
            return
        at = self._now()
        mono = _mono_micros()
        d = {"batch": n, "seconds": round(decode_s, 6)}
        s = {"batch": n, "seconds": round(stage_s, 6)}
        with self._lock:
            for tid in tx_ids:
                tid = str(tid)
                self._record_locked(tid, "ingest.decode", at, mono, d)
                self._record_locked(tid, "ingest.stage", at, mono, s)

    def consensus_commit(
        self, tx_id, index: int, member: Optional[str] = None,
        term: Optional[int] = None,
    ) -> None:
        """The consensus layer (raft/bft) applied this transaction's
        commit at log/sequence `index` on `member` — stamped by EVERY
        member that applies, so a cluster-wide assembly shows the
        commit landing replica by replica."""
        attrs: dict = {"index": index}
        if member is not None:
            attrs["member"] = member
        if term is not None:
            attrs["term"] = term
        self.record(tx_id, "consensus.commit", **attrs)

    # -- terminals ----------------------------------------------------------

    def close(self, tx_id, kind: str, reason: Optional[str] = None) -> None:
        """Record `tx_id`'s terminal event (TERMINALS keys). Exactly
        once per story: a close on an already-closed story records
        `tx.reanswer` (the intent-WAL replay window re-answering an
        answered-but-undeleted intent) and leaves the first terminal
        authoritative."""
        name = TERMINALS.get(kind)
        if name is None:
            raise ValueError(f"unknown terminal kind {kind!r}")
        tid = tx_id if isinstance(tx_id, str) else str(tx_id)
        at = self._now()
        mono = _mono_micros()
        attrs = {"reason": reason} if reason else None
        with self._lock:
            done = self._done.get(tid)
            if done is not None:
                # second answer for a closed story: never a second
                # terminal (the reconciliation invariant)
                self.reanswers += 1
                a = dict(attrs or ())
                a["duplicate_of"] = done.terminal
                self._record_locked(tid, "tx.reanswer", at, mono, a)
                return
            self._record_locked(tid, name, at, mono, attrs)
            story = self._open.pop(tid, None)
            if story is None:
                return   # evicted between record and pop — bounded loss
            story.terminal = kind
            story.reason = reason
            story.closed_mono = mono
            self._derive_stages_locked(story, at)
            self._done[tid] = story
            if len(self._done) > self._keep_done:
                self._done.popitem(last=False)
            self.closed += 1

    def terminal_from(self, tx_id, outcome) -> None:
        """Map a notary answer object to its terminal kind: a
        NotaryError's `kind` routes to rejected/shed/quarantined/
        unavailable (reason = the kind, or the shed reason), anything
        else (a TransactionSignature / signature list) is committed."""
        kind = getattr(outcome, "kind", None)
        if kind is None:
            self.close(tx_id, "committed")
        elif kind == "shed":
            self.close(tx_id, "shed", reason=_shed_reason(outcome))
        elif kind == "conflict":
            self.close(tx_id, "rejected", reason="conflict")
        elif kind == "poison-quarantined":
            self.close(tx_id, "quarantined", reason=kind)
        elif kind.endswith("-unavailable") or kind == "unavailable":
            self.close(tx_id, "unavailable", reason=kind)
        else:
            # invalid-transaction, time-window-invalid, wrong-notary,
            # invalid-proof, incomplete-tearoff ... — typed rejections
            self.close(tx_id, "rejected", reason=kind)

    def watch_future(self, tx_id, future) -> None:
        """Attach the terminal hook to a notary answer future: when it
        resolves, the outcome maps to this tx's terminal event. Safe
        on futures that resolve with an exception (unavailable)."""
        tid = tx_id if isinstance(tx_id, str) else str(tx_id)

        def _done(fut, _tid=tid) -> None:
            try:
                outcome = fut.result()
            except Exception as e:   # noqa: BLE001 - typed close below
                self.close(_tid, "unavailable", reason=type(e).__name__)
                return
            self.terminal_from(_tid, outcome)

        future.add_done_callback(_done)

    # -- derived stages / leaderboard / SLO ---------------------------------

    def _derive_stages_locked(self, story: _Story, at: int) -> None:
        end = story.closed_mono
        marks = [
            (STAGE_QUEUE, story.admitted_mono, story.staged_mono),
            (STAGE_VERIFY, story.staged_mono, story.verified_mono),
            (STAGE_COMMIT, story.verified_mono, end),
            (STAGE_TOTAL, story.admitted_mono, end),
        ]
        for stage, t0, t1 in marks:
            if t0 is None or t1 is None:
                continue
            delta = max(0, int(t1 - t0))
            story.stages[stage] = delta
            if self._stage_histos is not None:
                self._stage_histos[stage].update(delta)
            self._slo_recent[stage].append((at, delta, story.tx_id))
        total = story.stages.get(STAGE_TOTAL)
        if total is None:
            return
        self._seq += 1
        entry = (total, self._seq, story.export())
        if len(self._slow) < self._keep_slowest:
            heapq.heappush(self._slow, entry)
        elif entry[0] > self._slow[0][0]:
            heapq.heapreplace(self._slow, entry)

    def slowest(self, limit: Optional[int] = None) -> list[dict]:
        """The completed-transaction leaderboard, slowest first."""
        with self._lock:
            rows = [e for _, _, e in sorted(self._slow, reverse=True)]
        return rows[:limit] if limit is not None else rows

    def stage_p99(
        self, stage: str, window_micros: Optional[int] = None
    ) -> tuple[Optional[float], list[str]]:
        """(p99 micros, worst tx ids) over the recent completions of
        one stage — the SLO rule's input. `window_micros` restricts to
        completions within that window of now (None = the whole
        bounded deque)."""
        now = self._now()
        with self._lock:
            rows = list(self._slo_recent[stage])
        if window_micros is not None:
            rows = [r for r in rows if now - r[0] <= window_micros]
        if not rows:
            return None, []
        vals = sorted(r[1] for r in rows)
        p99 = float(vals[min(len(vals) - 1, int(0.99 * len(vals)))])
        worst = [
            tid for _, _, tid in sorted(rows, key=lambda r: -r[1])[:5]
        ]
        return p99, worst

    def install_rules(
        self,
        monitor,
        targets: dict,
        window_micros: Optional[int] = None,
    ) -> None:
        """Register the `txstory.stage_slo` rule on a HealthMonitor:
        fires while any stage in `targets` ({stage: p99 micros}) has
        its recent p99 past target, the detail citing the offending
        stage AND the worst tx ids — the alert an operator can act on
        without a dashboard safari."""
        from .health import AlertRule

        bad = set(targets) - set(STAGES)
        if bad:
            raise ValueError(f"unknown stages {sorted(bad)}; use {STAGES}")

        def check(now: int):
            breaches = {}
            for stage, target in targets.items():
                p99, worst = self.stage_p99(stage, window_micros)
                if p99 is not None and p99 > target:
                    breaches[stage] = {
                        "p99_micros": p99,
                        "target_micros": target,
                        "tx_ids": worst,
                    }
            return bool(breaches), {"stages": breaches}

        monitor.add_rule(
            AlertRule("txstory.stage_slo", check, trace_filter="notar")
        )

    # -- queries (the webserver surface) ------------------------------------

    def story(self, tx_id) -> Optional[dict]:
        tid = tx_id if isinstance(tx_id, str) else str(tx_id)
        with self._lock:
            story = self._open.get(tid) or self._done.get(tid)
            if story is not None:
                return story.export()
        if self.index is not None:
            # ring-evicted: serve from the sqlite spill
            events = self.index.events_for(tid)
            if events:
                terminal = None
                reason = None
                trace_id = None
                for e in events:
                    for kind, name in TERMINALS.items():
                        if e["name"] == name:
                            terminal = kind
                            reason = e.get("reason")
                    if trace_id is None and e.get("trace_id") is not None:
                        trace_id = e.get("trace_id")
                return {
                    "tx_id": tid,
                    "events": events,
                    "event_count": len(events),
                    "terminal": terminal,
                    "reason": reason,
                    "trace_id": trace_id,
                    "stages_micros": {},
                    "total_micros": None,
                    "open": terminal is None,
                    "from_index": True,
                }
        return None

    def local_payload(self, tx_id) -> dict:
        """The ?local=1 / peer-pull form of GET /tx/<id>: this
        member's story (found or not) plus the ClockSync export a
        remote assembler needs to shift our monotonic stamps."""
        story = self.story(tx_id)
        out = {
            "tx_id": tx_id if isinstance(tx_id, str) else str(tx_id),
            "found": story is not None,
            "story": story,
        }
        if self.tracer is not None:
            out["clockSync"] = self.tracer.clock_sync.export()
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "open": len(self._open),
                "completed_retained": len(self._done),
                "recorded": self.recorded,
                "closed": self.closed,
                "evicted": self.evicted,
                "dropped_events": self.dropped_events,
                "reanswers": self.reanswers,
                "slowest_retained": len(self._slow),
            }

    def tick(self) -> None:
        """Pump hook: group-commit the sqlite index buffer (the intent
        journal's flush_resolved discipline — one transaction per tick)."""
        if self.index is not None:
            self.index.flush()

    # -- reconciliation surface ---------------------------------------------

    def stories(self) -> list[dict]:
        """Every retained story (open + completed) — a lifecycle
        reconciliation's input."""
        with self._lock:
            out = [s.export() for s in self._open.values()]
            out += [s.export() for s in self._done.values()]
        return out


def _shed_reason(outcome) -> str:
    return shed_reason(str(getattr(outcome, "message", "")))


# -- cross-member assembly ----------------------------------------------------


class ClusterTxStory:
    """Cluster-wide GET /tx/<id> from ANY member (the ClusterTraces
    shape, riding the network map's advertised `web_port`): pull each
    peer's `/tx/<id>?local=1` payload — in PARALLEL via
    tracing.fan_out, so N slow peers cost ~one timeout, not N — shift
    remote `mono_us` stamps onto the local monotonic axis with the
    tracer's ClockSync offsets, and merge one timeline ordered by
    shifted time. Unreachable peers degrade to an `errors` entry,
    never a failed assembly."""

    def __init__(
        self,
        self_name: str,
        story: TxStory,
        peers_fn: Callable[[], dict],
        tracer=None,
        fetch: Optional[Callable[[str], dict]] = None,
        timeout: float = 1.5,
        workers: int = 8,
    ):
        self.self_name = self_name
        self.story = story
        self.tracer = tracer if tracer is not None else story.tracer
        self._peers_fn = peers_fn
        self._fetch = fetch or self._http_fetch
        self.timeout = timeout
        self.workers = workers

    def _http_fetch(self, url: str) -> dict:
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _offset_for(self, peer: str, payload: dict) -> tuple[int, str]:
        """(offset_us, quality) — identical math to
        ClusterTraces._offset_for: paired NTP-style midpoint when both
        directions have ClockSync evidence, one-way upper bound
        otherwise."""
        fwd = (
            self.tracer.clock_sync.min_skew(peer)
            if self.tracer is not None else None
        )
        bwd_row = (payload.get("clockSync") or {}).get(self.self_name)
        bwd = bwd_row.get("min_skew_us") if bwd_row else None
        if fwd is not None and bwd is not None:
            return (int(fwd) - int(bwd)) // 2, "paired"
        if fwd is not None:
            return int(fwd), "one_way"
        if bwd is not None:
            return -int(bwd), "one_way"
        return 0, "none"

    def assemble(self, tx_id) -> dict:
        tid = tx_id if isinstance(tx_id, str) else str(tx_id)
        events: list[dict] = []
        offsets: dict[str, dict] = {}
        errors: dict[str, str] = {}
        terminal = None
        reason = None
        trace_id = None

        def add(node: str, payload: dict, offset_us: int) -> None:
            nonlocal terminal, reason, trace_id
            story = payload.get("story")
            if not story:
                return
            for e in story.get("events", ()):
                row = dict(e)
                row["node"] = node
                if row.get("mono_us") is not None:
                    row["ts_us"] = row.pop("mono_us") + offset_us
                events.append(row)
            if story.get("terminal") is not None and terminal is None:
                terminal = story["terminal"]
                reason = story.get("reason")
            if trace_id is None and story.get("trace_id") is not None:
                trace_id = story["trace_id"]

        add(self.self_name, self.story.local_payload(tid), 0)
        peers = {
            name: base for name, base in self._peers_fn().items()
            if name != self.self_name
        }
        fetched, fetch_errors = tracelib.fan_out(
            {
                name: (
                    lambda b=base: self._fetch(f"{b}/tx/{tid}?local=1")
                )
                for name, base in peers.items()
            },
            workers=self.workers,
        )
        errors.update(fetch_errors)
        for name in sorted(fetched):
            payload = fetched[name]
            offset_us, quality = self._offset_for(name, payload)
            offsets[name] = {"offset_us": offset_us, "quality": quality}
            add(name, payload, offset_us)

        events.sort(key=lambda e: e.get("ts_us", e.get("at_micros", 0)))
        members = sorted({e["node"] for e in events})
        return {
            "tx_id": tid,
            "self": self.self_name,
            "found": bool(events),
            "events": events,
            "event_count": len(events),
            "members": members,
            "terminal": terminal,
            "reason": reason,
            "trace_id": trace_id,
            "offsets_micros": offsets,
            "errors": errors,
        }
