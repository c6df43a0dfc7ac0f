"""Performance-attribution plane: why is it slow, answered in-process.

Port of corda_tpu/utils/perf.py. Traces answer "which request was
slow" and the health plane "is it slow now"; this plane answers why.
The serving wall splits across host Python (decode, staging, contract
checks, commit), the first launch of a kernel shape (on the card: the
nvcc build and module load of crypto/build.py behind cuda_ec), the
launch wall of every later call, the host-to-card copy, and the
balance across shard pipelines. Four pieces behind one `PerfPlane`:

  SamplingProfiler  - a statistical profiler over the node's long-lived
      threads (messaging pump, shard flush workers, the ingest decode
      pool, the verifier drain), built on `sys._current_frames()` from
      one sampler thread. Samples fold into collapsed stacks (the
      flamegraph.pl format) and the profiler measures its own cost
      (sample wall over elapsed wall) as a gauge.

  KernelAccounting  - timers at the verify seam per (scheme, batch):
      COMPILE is a verifier instance's first call of a key (where the
      kernels are built and loaded), EXECUTE every later call (the
      launch wall the host pays), plus host-to-card transfer bytes and
      seconds. A first call after `mark_warm()` counts as a retrace,
      which the retrace alert watches.

  ShardSkew         - per-shard load/depth/latency imbalance over the
      sharded commit plane: the hottest shard's windowed load share
      over the fair 1/N share, with an alert carrying the slowest
      traces that touched that shard. Wave flushes also report their
      dispatch-vs-consume overlap efficiency (`WaveOverlap`).

  PerfHistory       - a bounded time-series ring per key, sampled by
      `tick()` on the pump cadence, holding benchmark-shaped keys
      (notarisations/s, ingested frames/s). `baseline_diff()` compares
      the sustained window against a benchmark record given by path.

Everything is clock-injected (simulated-time rigs stay deterministic;
the profiler alone runs on real time). Host logic, snapshots and alert
rules are the reference's, so equal inputs give equal snapshots.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from . import locks
from .metrics import MetricRegistry


@dataclass(frozen=True)
class PerfPolicy:
    """Operator knobs (config.py maps node TOML onto this).

    `profile_hz` is the sampler rate — 0 keeps the profiler thread
    unstarted (start()/stop() still work for on-demand captures). The
    default 19 Hz is deliberately off any round pump cadence so
    periodic loops don't alias into phantom hot frames. Windows are
    node-clock microseconds like the health plane's."""

    profile_hz: float = 19.0
    profiler_max_stacks: int = 4096
    # history sampling: one point per key at most every this often
    sample_gap_micros: int = 1_000_000
    history_capacity: int = 512
    history_window: int = 32          # points the sustained value ranks
    # skew alert: hottest shard's windowed load share over the fair
    # 1/N share; 1.0 = balanced, N = everything on one shard
    skew_threshold: float = 2.0
    skew_window_micros: int = 30_000_000
    skew_min_requests: int = 64       # below this the ratio is noise
    # retraces during warmup are expected (every (scheme, shape) pays
    # one trace); the alert arms only after this grace from attach
    retrace_warmup_micros: int = 60_000_000
    # baseline gate: a history key this far under its baseline
    # reads as an in-process regression
    baseline_gate_pct: float = 10.0


# ---------------------------------------------------------------------------
# sampling profiler


class SamplingProfiler:
    """Statistical wall-stack profiler over named long-lived threads.

    One daemon thread wakes `hz` times a second, snapshots
    `sys._current_frames()` (one C call — the GIL makes the snapshot
    consistent), keeps the threads whose names match a watched prefix
    (all non-sampler threads when none are registered), and folds each
    stack into a bounded `{collapsed_stack: count}` table. Export is
    the flamegraph.pl folded format: `thread;file:func;... count` —
    pipe `GET /profile` straight into a flamegraph renderer.

    Self-overhead is MEASURED: `overhead()` is the cumulative wall the
    sampler spent inside sample passes over the wall since start —
    the gauge an overhead bound reads."""

    def __init__(
        self,
        hz: float = 19.0,
        max_stacks: int = 4096,
        depth: int = 48,
    ):
        self.hz = max(0.1, float(hz))
        self.max_stacks = max(1, int(max_stacks))
        self.depth = max(4, int(depth))
        self._prefixes: list[str] = []
        self._lock = locks.make_lock("SamplingProfiler._lock")
        self._stacks: dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.samples = 0          # sample passes taken
        self.frames_seen = 0      # thread stacks folded in
        self.truncated = 0        # stacks dropped at the table bound
        self._sample_wall = 0.0   # seconds spent inside sample passes
        self._started_at: Optional[float] = None
        self._run_wall = 0.0      # wall accumulated over past runs

    def watch(self, *prefixes: str) -> "SamplingProfiler":
        """Restrict sampling to threads whose name starts with any of
        `prefixes` (cumulative). With none registered every thread but
        the sampler itself is profiled."""
        with self._lock:
            for p in prefixes:
                if p and p not in self._prefixes:
                    self._prefixes.append(p)
        return self

    # -- one pass ------------------------------------------------------------

    def _fold(self, frame) -> str:
        parts: list[str] = []
        depth = self.depth
        while frame is not None and len(parts) < depth:
            code = frame.f_code
            parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                         f"{code.co_name}")
            frame = frame.f_back
        parts.reverse()           # root first — the folded convention
        return ";".join(parts)

    def sample_once(self) -> int:
        """One sample pass (the sampler loop's body; callable directly
        for deterministic tests). Returns stacks folded in."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        names = {
            t.ident: t.name for t in threading.enumerate()
            if t.ident is not None and t.ident != me
        }
        prefixes = self._prefixes
        folded = 0
        frames = sys._current_frames()
        for ident, frame in frames.items():
            name = names.get(ident)
            if name is None:
                continue
            if prefixes and not any(name.startswith(p) for p in prefixes):
                continue
            stack = f"{name};{self._fold(frame)}"
            with self._lock:
                n = self._stacks.get(stack)
                if n is None and len(self._stacks) >= self.max_stacks:
                    self.truncated += 1
                    continue
                self._stacks[stack] = (n or 0) + 1
            folded += 1
        del frames
        self.samples += 1
        self.frames_seen += folded
        self._sample_wall += time.perf_counter() - t0
        return folded

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:   # a torn frame walk must not kill the loop
                pass

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        if not self.running:
            self._stop.clear()
            self._started_at = time.perf_counter()
            self._thread = threading.Thread(
                target=self._run, name="perf-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        if self._started_at is not None:
            self._run_wall += time.perf_counter() - self._started_at
            self._started_at = None

    # -- readouts ------------------------------------------------------------

    def elapsed(self) -> float:
        run = self._run_wall
        if self._started_at is not None:
            run += time.perf_counter() - self._started_at
        return run

    def overhead(self) -> float:
        """Measured self-cost: sample wall / profiled wall."""
        wall = self.elapsed()
        return self._sample_wall / wall if wall > 0 else 0.0

    def collapsed(self) -> str:
        """The folded-stack export (`stack count` lines, count-sorted)
        — flamegraph.pl / speedscope load this directly."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{stack} {count}" for stack, count in items)

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
        self.samples = 0
        self.frames_seen = 0
        self.truncated = 0
        self._sample_wall = 0.0
        self._run_wall = 0.0
        if self._started_at is not None:
            self._started_at = time.perf_counter()

    def snapshot(self) -> dict:
        with self._lock:
            distinct = len(self._stacks)
        return {
            "running": self.running,
            "hz": self.hz,
            "watched": list(self._prefixes),
            "samples": self.samples,
            "frames_seen": self.frames_seen,
            "distinct_stacks": distinct,
            "truncated": self.truncated,
            "overhead_fraction": round(self.overhead(), 5),
        }


# ---------------------------------------------------------------------------
# device/host kernel accounting


class KernelAccounting:
    """Per-(scheme, batch-shape) timers at the verify dispatch seam.

    The FIRST call per key is charged to `compile_seconds` (on the
    card: the kernels' build and module load). Every later call is the
    launch wall, charged to `execute_seconds` (the device wait itself
    shows up downstream as the notary's kernel/link_wait phase — this
    seam measures what the HOST pays to launch). `transfer_bytes` is
    the staged operand payload headed to the card.

    Retraces: after `mark_warm()` (the perf plane arms it once the
    warmup grace passes) any further first-call-per-shape increments
    `retraces` — the cold-shape signal the retrace alert watches. A
    healthy serving node holds it at ZERO: the padded batch shapes keep
    the keys warm, and a nonzero count means some caller is feeding the
    verifier novel shapes inside the serving path."""

    def __init__(self):
        self._lock = locks.make_lock("KernelAccounting._lock")
        self._keys: dict[tuple, dict] = {}
        self._warm = False
        self.compiles = 0
        self.retraces = 0

    def mark_warm(self) -> None:
        """Arm the retrace counter: compiles past this point are cache
        misses inside the serving window, not boot warmup."""
        self._warm = True

    def _row(self, scheme_id: int, batch: int) -> dict:
        """Get-or-create one key's row. Called under the lock."""
        key = (int(scheme_id), int(batch))
        row = self._keys.get(key)
        if row is None:
            row = self._keys[key] = {
                "compiles": 0, "compile_seconds": 0.0,
                "executes": 0, "execute_seconds": 0.0,
                "transfer_bytes": 0, "transfer_seconds": 0.0,
            }
        return row

    def record_call(
        self,
        scheme_id: int,
        batch: int,
        seconds: float,
        first: bool,
        transfer_bytes: int = 0,
        transfer_seconds: float = 0.0,
    ) -> None:
        with self._lock:
            row = self._row(scheme_id, batch)
            if first:
                row["compiles"] += 1
                row["compile_seconds"] += seconds
                self.compiles += 1
                if self._warm:
                    self.retraces += 1
            else:
                row["executes"] += 1
                row["execute_seconds"] += seconds
            row["transfer_bytes"] += int(transfer_bytes)
            row["transfer_seconds"] += transfer_seconds

    def timed_call(self, scheme_id: int, batch: int, fn, /, *args, **kw):
        """Run `fn`, timing it into this accounting — first call per
        (scheme, batch) is the compile. The helper the verifier's
        dispatch path and a retrace probe share, so the
        first-call bookkeeping cannot fork."""
        first = self.is_cold(scheme_id, batch)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.record_call(
            scheme_id, batch, time.perf_counter() - t0, first=first
        )
        return out

    def is_cold(self, scheme_id: int, batch: int) -> bool:
        with self._lock:
            row = self._keys.get((int(scheme_id), int(batch)))
            return row is None or row["compiles"] == 0

    def record_transfer(
        self, scheme_id: int, batch: int, nbytes: int, seconds: float
    ) -> None:
        """A host→device transfer on its own (the staging copy of a
        chunk) — touches ONLY the transfer fields. It must
        not ride record_call: a phantom zero-second execute per
        dispatch would halve the execute mean the split exists for."""
        with self._lock:
            row = self._row(scheme_id, batch)
            row["transfer_bytes"] += int(nbytes)
            row["transfer_seconds"] += seconds

    def snapshot(self) -> dict:
        with self._lock:
            keys = {
                f"scheme{s}/batch{b}": dict(row)
                for (s, b), row in sorted(self._keys.items())
            }
        # derived: per-key compile-vs-execute split and transfer rate
        for row in keys.values():
            ex = row["executes"]
            row["execute_mean_s"] = (
                round(row["execute_seconds"] / ex, 6) if ex else 0.0
            )
            ts = row["transfer_seconds"]
            row["transfer_bytes_per_sec"] = (
                round(row["transfer_bytes"] / ts, 1) if ts > 0 else None
            )
            row["compile_seconds"] = round(row["compile_seconds"], 6)
            row["execute_seconds"] = round(row["execute_seconds"], 6)
            row["transfer_seconds"] = round(row["transfer_seconds"], 6)
        return {
            "keys": keys,
            "compiles": self.compiles,
            "retraces": self.retraces,
            "warm": self._warm,
        }


# the process default (what CudaBatchVerifier records into when no
# explicit accounting is injected) — mirrors tracing.get_tracer()
_default_kernels: Optional[KernelAccounting] = None
_default_kernels_lock = locks.make_lock("perf._default_kernels_lock")


def get_kernel_accounting() -> KernelAccounting:
    global _default_kernels
    if _default_kernels is None:
        with _default_kernels_lock:
            if _default_kernels is None:
                _default_kernels = KernelAccounting()
    return _default_kernels


def set_kernel_accounting(acct: Optional[KernelAccounting]) -> None:
    global _default_kernels
    with _default_kernels_lock:
        _default_kernels = acct


# ---------------------------------------------------------------------------
# per-shard skew + wave overlap


class ShardSkew:
    """Windowed load/depth/latency imbalance over the sharded commit
    plane. Fed one observation per shard flush; the watchdog question
    it answers is "is ONE shard carrying the node" — a hot state-ref
    prefix serialises on a single partition while its siblings idle,
    which no aggregate metric shows."""

    def __init__(self, clock_fn: Callable[[], int], policy: PerfPolicy):
        self._clock_fn = clock_fn
        self._policy = policy
        self._lock = locks.make_lock("ShardSkew._lock")
        self.n_shards = 0
        self._requests: list[int] = []      # cumulative answered
        self._flushes: list[int] = []       # cumulative flush count
        self._wall: list[float] = []        # cumulative flush wall s
        self._depth_fns: list[Callable[[], int]] = []
        # window anchors: (micros, [requests...], [flushes...], [wall...])
        self._window: deque = deque()
        self._last_sample: Optional[int] = None

    def ensure_shards(
        self, n: int, depth_fns: Optional[list] = None
    ) -> None:
        with self._lock:
            while self.n_shards < n:
                self.n_shards += 1
                self._requests.append(0)
                self._flushes.append(0)
                self._wall.append(0.0)
            if depth_fns is not None:
                self._depth_fns = list(depth_fns)

    def observe_flush(self, shard: int, n: int, wall_s: float) -> None:
        # anchor BEFORE folding the observation in: window deltas are
        # (current - window[0]), so an anchor taken after the first
        # flush's counts would swallow that flush's load forever
        self._maybe_anchor()
        with self._lock:
            if shard >= self.n_shards:
                return
            self._requests[shard] += n
            self._flushes[shard] += 1
            self._wall[shard] += wall_s

    def anchor(self) -> None:
        """Advance the window on the clock WITHOUT an observation —
        PerfPlane.tick calls this so an idle plane's window keeps
        sliding: deltas decay to zero and a fired skew alert resolves
        when the traffic stops, instead of freezing at the last
        burst's ratio forever (no flush, no _maybe_anchor otherwise)."""
        self._maybe_anchor()

    def _maybe_anchor(self) -> None:
        now = self._clock_fn()
        pol = self._policy
        with self._lock:
            if (
                self._last_sample is not None
                and now - self._last_sample < pol.sample_gap_micros
            ):
                return
            self._last_sample = now
            self._window.append(
                (now, list(self._requests), list(self._flushes),
                 list(self._wall))
            )
            horizon = now - pol.skew_window_micros
            while len(self._window) > 1 and self._window[0][0] < horizon:
                self._window.popleft()

    def window_deltas(self) -> tuple[list[int], list[int], list[float]]:
        """Per-shard (requests, flushes, wall seconds) over the window."""
        with self._lock:
            if not self._window:
                return (
                    list(self._requests), list(self._flushes),
                    list(self._wall),
                )
            _, req0, fl0, w0 = self._window[0]
            n = self.n_shards
            req0 = req0 + [0] * (n - len(req0))
            fl0 = fl0 + [0] * (n - len(fl0))
            w0 = w0 + [0.0] * (n - len(w0))
            return (
                [a - b for a, b in zip(self._requests, req0)],
                [a - b for a, b in zip(self._flushes, fl0)],
                [a - b for a, b in zip(self._wall, w0)],
            )

    def depths(self) -> list[Optional[int]]:
        """Live per-shard pending depth via the registered depth fns
        (None where a fn is missing or raising) — the ONE collection
        point the snapshot and the skew alert's detail both read."""
        with self._lock:
            fns = list(self._depth_fns)
        out: list[Optional[int]] = []
        for fn in fns:
            try:
                out.append(int(fn()))
            except Exception:
                out.append(None)
        while len(out) < self.n_shards:
            out.append(None)
        return out

    def skew(self) -> tuple[float, int, int]:
        """(skew ratio, hottest shard, windowed total requests). The
        ratio is the hottest shard's load share over the fair 1/N
        share: 1.0 balanced, N all-on-one. 1.0 with < 2 shards or an
        idle window — an unsharded plane cannot skew."""
        reqs, _, _ = self.window_deltas()
        total = sum(reqs)
        if self.n_shards < 2 or total <= 0:
            return 1.0, 0, max(total, 0)
        hot = max(range(self.n_shards), key=lambda k: reqs[k])
        share = reqs[hot] / total
        return share * self.n_shards, hot, total

    def snapshot(self) -> dict:
        reqs, flushes, wall = self.window_deltas()
        ratio, hot, total = self.skew()
        depths = self.depths()
        per_shard = []
        for k in range(self.n_shards):
            per_shard.append({
                "requests_in_window": reqs[k] if k < len(reqs) else 0,
                "flushes_in_window": flushes[k] if k < len(flushes) else 0,
                "flush_wall_s": round(wall[k], 6) if k < len(wall) else 0.0,
                "mean_flush_wall_s": (
                    round(wall[k] / flushes[k], 6)
                    if k < len(flushes) and flushes[k] else 0.0
                ),
                "depth": depths[k] if k < len(depths) else None,
                "load_share": (
                    round(reqs[k] / total, 4) if total > 0 else 0.0
                ),
            })
        return {
            "n_shards": self.n_shards,
            "skew_ratio": round(ratio, 3),
            "hot_shard": hot,
            "requests_in_window": total,
            "per_shard": per_shard,
        }


class WaveOverlap:
    """Dispatch-vs-consume overlap efficiency of the sharded wave flush.

    The wave's whole point is that shard k+1's device compute runs
    under shard k's host consume; the efficiency is the fraction of
    the wave wall NOT spent blocked on the device (the link_wait /
    stream-join marks). 1.0 = the device never made the host wait;
    falling efficiency means the plane has stopped overlapping."""

    def __init__(self):
        self._lock = locks.make_lock("WaveOverlap._lock")
        self.waves = 0
        self.wall_s = 0.0
        self.blocked_s = 0.0
        self.last_efficiency: Optional[float] = None

    BLOCKED_PHASES = ("link_wait",)

    def observe(self, shard_marks: list) -> None:
        """`shard_marks` is [(shard_id, n, marks)] for one wave, marks
        being the flush's (phase, t0, t1) interval list."""
        t_lo = t_hi = None
        blocked = 0.0
        for _sid, _n, marks in shard_marks:
            for phase, t0, t1 in marks:
                t_lo = t0 if t_lo is None else min(t_lo, t0)
                t_hi = t1 if t_hi is None else max(t_hi, t1)
                if phase in self.BLOCKED_PHASES:
                    blocked += t1 - t0
        if t_lo is None or t_hi <= t_lo:
            return
        wall = t_hi - t_lo
        eff = max(0.0, min(1.0, 1.0 - blocked / wall))
        with self._lock:
            self.waves += 1
            self.wall_s += wall
            self.blocked_s += blocked
            self.last_efficiency = eff

    def snapshot(self) -> dict:
        with self._lock:
            eff = (
                max(0.0, min(1.0, 1.0 - self.blocked_s / self.wall_s))
                if self.wall_s > 0 else None
            )
            return {
                "waves": self.waves,
                "wall_s": round(self.wall_s, 6),
                "device_blocked_s": round(self.blocked_s, 6),
                "overlap_efficiency": (
                    round(eff, 4) if eff is not None else None
                ),
                "last_efficiency": (
                    round(self.last_efficiency, 4)
                    if self.last_efficiency is not None else None
                ),
            }


# ---------------------------------------------------------------------------
# in-process time series + baseline diff


class PerfHistory:
    """Bounded (capacity per key) time-series ring: the node's own
    perf memory between offline benchmark runs."""

    def __init__(self, capacity: int = 512):
        self._lock = locks.make_lock("PerfHistory._lock")
        self._series: dict[str, deque] = {}
        self.capacity = max(8, int(capacity))

    def record(self, key: str, micros: int, value: float) -> None:
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = deque(maxlen=self.capacity)
            dq.append((int(micros), float(value)))

    def series(self, key: str) -> list[tuple[int, float]]:
        with self._lock:
            return list(self._series.get(key, ()))

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, key: str) -> Optional[float]:
        with self._lock:
            dq = self._series.get(key)
            return dq[-1][1] if dq else None

    def sustained(self, key: str, window: int = 32) -> Optional[float]:
        """Lower median of the last `window` points — the offline
        benchmark's convention, so the in-process number and the
        offline record rank noise the same way."""
        with self._lock:
            dq = self._series.get(key)
            if not dq:
                return None
            vals = sorted(v for _, v in list(dq)[-max(1, window):])
        return vals[(len(vals) - 1) // 2]

    def snapshot(self, window: int = 32) -> dict:
        out = {}
        for key in self.keys():
            pts = self.series(key)
            out[key] = {
                "n": len(pts),
                "latest": round(pts[-1][1], 3),
                "sustained": round(self.sustained(key, window), 3),
                "at_micros": pts[-1][0],
            }
        return out


def flush_phase_seconds(metrics: MetricRegistry) -> dict[str, dict]:
    """count / total_s / mean_s per `Notary.FlushPhase.*` timer on a
    registry. ONE reader for the flush phase truth: PerfPlane's
    host-stage attribution and the device plane's capacity model
    (utils/device_telemetry) both consume this, so the roofline's
    host-pump input can never drift from what GET /perf displays."""
    from . import metrics as mlib

    out: dict[str, dict] = {}
    prefix = "Notary.FlushPhase."
    for name in metrics.names():
        if not name.startswith(prefix):
            continue
        m = metrics.get(name)
        if not isinstance(m, mlib.Timer):
            continue
        h = m.histogram
        out[name[len(prefix):]] = {
            "count": h.count,
            "total_s": h.sum,
            "mean_s": h.mean,
        }
    return out


def parse_bench_record(path: str) -> dict[str, dict]:
    """metric name -> record from one benchmark record file (the
    capture shape: per-metric JSON lines inside the `tail` text, later
    lines winning, and a `parsed` record as the fallback)."""
    with open(path) as f:
        doc = json.load(f)
    metrics: dict[str, dict] = {}
    tail = doc.get("tail", "") if isinstance(doc, dict) else ""
    for line in tail.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "metric" in rec and "value" in rec:
            metrics[rec["metric"]] = rec
    parsed = doc.get("parsed") if isinstance(doc, dict) else None
    if isinstance(parsed, dict) and "metric" in parsed and "value" in parsed:
        metrics.setdefault(parsed["metric"], parsed)
    return metrics


# ---------------------------------------------------------------------------
# alert rules (installed on a HealthMonitor by PerfPlane.install_rules)


def _perf_rules(plane: "PerfPlane"):
    """The retrace + skew AlertRules over one PerfPlane. Imported
    lazily from utils.health to keep perf importable standalone."""
    from . import health as hlib

    pol = plane.policy

    class _RetraceRule(hlib.AlertRule):
        """Cold kernel shapes inside the serving window. The kernel
        accounting arms (`mark_warm`) after the warmup grace; any
        compile past that point is a retrace and the condition holds
        while the count keeps moving within the sample window."""

        def __init__(self):
            self._window: deque = deque()
            self._last_sample: Optional[int] = None
            super().__init__(
                "perf.jit_retrace", self._check,
                severity=hlib.SEV_WARNING, trace_filter="notar",
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            kern = plane.kernels
            if not kern._warm and now >= plane.armed_at_micros:
                kern.mark_warm()
            count = kern.retraces
            if (
                self._last_sample is None
                or now - self._last_sample >= pol.sample_gap_micros
            ):
                self._last_sample = now
                self._window.append((now, count))
            horizon = now - pol.skew_window_micros
            while len(self._window) > 1 and self._window[0][0] < horizon:
                self._window.popleft()
            growth = count - self._window[0][1]
            return count > 0 and growth > 0, {
                "retraces": count,
                "retraces_in_window": growth,
                "compiles": kern.compiles,
                "warm": kern._warm,
            }

    class _SkewRule(hlib.AlertRule):
        """One hot shard: the windowed skew ratio over the threshold
        with enough load for the ratio to mean anything. Evidence is
        filtered to traces that touched the CURRENT hot shard (the
        flush stamps a `shard` attribute on its phase spans)."""

        def __init__(self):
            self._hot = 0
            super().__init__(
                "perf.shard_skew", self._check,
                severity=hlib.SEV_WARNING,
                trace_filter=lambda: f"shard{self._hot}",
            )

        def _check(self, now: int) -> tuple[bool, dict]:
            ratio, hot, total = plane.skew.skew()
            self._hot = hot
            depths = plane.skew.depths()
            cond = (
                ratio >= pol.skew_threshold
                and total >= pol.skew_min_requests
            )
            return cond, {
                "skew_ratio": round(ratio, 3),
                "hot_shard": hot,
                "requests_in_window": total,
                "threshold": pol.skew_threshold,
                "depths": depths,
            }

    return _RetraceRule(), _SkewRule()


# ---------------------------------------------------------------------------
# the facade


class PerfPlane:
    """What the node, the worker, the chip script and tests hold.

    Owns the profiler, the kernel accounting (adopted from the process
    default so every CudaBatchVerifier in-process records into it), the
    shard skew window, the wave-overlap accounting and the history
    ring; `tick()` (node pump cadence) samples the watched rate/value
    keys. `snapshot()` is the GET /perf payload; `collapsed_profile()`
    is GET /profile."""

    def __init__(
        self,
        clock=None,
        metrics: Optional[MetricRegistry] = None,
        tracer=None,
        policy: Optional[PerfPolicy] = None,
        baseline_path: Optional[str] = None,
        install_default_kernels: bool = True,
    ):
        self.policy = policy or PerfPolicy()
        self._clock = clock
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.tracer = tracer
        self.profiler = SamplingProfiler(
            hz=self.policy.profile_hz,
            max_stacks=self.policy.profiler_max_stacks,
        )
        # kernel accounting is PROCESS-scoped, like the built kernels
        # it observes: by default the plane ADOPTS the shared process
        # accounting (creating it on first use) rather than replacing
        # it — two in-process nodes then read one truthful compile/
        # retrace ledger instead of the second silently stealing the
        # first's attribution. install_default_kernels=False keeps a
        # private ledger (tests, embedded rigs).
        self.kernels = (
            get_kernel_accounting() if install_default_kernels
            else KernelAccounting()
        )
        self.metrics.gauge(
            "Perf.KernelRetraces", lambda: self.kernels.retraces
        )
        self.metrics.gauge(
            "Perf.KernelCompiles", lambda: self.kernels.compiles
        )
        self.skew = ShardSkew(self.now_micros, self.policy)
        self.wave = WaveOverlap()
        self.history = PerfHistory(self.policy.history_capacity)
        self.baseline_path = baseline_path
        self._baseline: Optional[dict] = None
        self._baseline_label: Optional[str] = None
        self._baseline_error: Optional[str] = None
        # rate keys: name -> [count_fn, last_count, last_micros]
        self._rates: dict[str, list] = {}
        self._values: dict[str, Callable[[], float]] = {}
        self._ingest_lock = locks.make_lock("PerfPlane._ingest_lock")
        self.ingest_frames = 0
        self._ingest_stage_s = {"decode": 0.0, "merkle": 0.0, "stage": 0.0}
        self._last_tick: Optional[int] = None
        self.armed_at_micros = (
            self.now_micros() + self.policy.retrace_warmup_micros
        )
        self.metrics.gauge(
            "Perf.ProfilerOverhead", self.profiler.overhead
        )
        self.metrics.gauge("Perf.SkewRatio", lambda: self.skew.skew()[0])

        def _wave_eff() -> float:
            # explicit None check: 0.0 is the WORST reading (a fully
            # link-blocked wave) and must never render as the 1.0 an
            # `or` shortcut would hand back
            eff = self.wave.snapshot()["overlap_efficiency"]
            return 1.0 if eff is None else eff

        self.metrics.gauge("Perf.WaveOverlapEfficiency", _wave_eff)
        self.watch_rate(
            "wire_ingest_pipelined_per_sec", lambda: self.ingest_frames
        )

    # -- clock ---------------------------------------------------------------

    def now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    # -- wiring --------------------------------------------------------------

    def watch_rate(self, key: str, count_fn: Callable[[], int]) -> None:
        """History key derived as d(count)/dt at the sample gap — how
        the node mirrors the benchmark's per-second keys in-process."""
        self._rates[key] = [count_fn, None, None]

    def watch_value(self, key: str, fn: Callable[[], float]) -> None:
        self._values[key] = fn

    def attach_shards(
        self, n: int, depth_fns: Optional[list] = None
    ) -> None:
        """Called by the sharded notary's attach_perf: sizes the skew
        window and registers per-shard gauges."""
        first = self.skew.n_shards == 0
        self.skew.ensure_shards(n, depth_fns)
        if first and n > 0:
            for k in range(n):
                self.metrics.gauge(
                    f"Perf.Shard{k}.LoadShare",
                    (lambda k=k: self._shard_share(k)),
                )

    def _shard_share(self, k: int) -> float:
        reqs, _, _ = self.skew.window_deltas()
        total = sum(reqs)
        if total <= 0 or k >= len(reqs):
            return 0.0
        return reqs[k] / total

    def observe_flush(self, shard: int, n: int, marks: list) -> None:
        """One shard flush's phase marks (the notary's (phase, t0, t1)
        list): feeds the skew window. Phase timers already live on the
        notary registry (Notary.FlushPhase.*) — this records the
        per-SHARD cost the aggregate timers blend away. The wall is
        the SUM of the phase intervals (busy time), not last-end minus
        first-start: in a wave, shard k's marks straddle the other
        shards' consume phases, and a span-based wall would charge the
        LAST-consumed shard the whole wave regardless of its own work."""
        if not marks:
            return
        busy = sum(t1 - t0 for _, t0, t1 in marks)
        self.skew.observe_flush(shard, n, busy)

    def observe_wave(self, shard_marks: list) -> None:
        """One inline wave ([(shard_id, n, marks)]): overlap efficiency
        plus the per-shard skew feeds."""
        self.wave.observe(shard_marks)
        for sid, n, marks in shard_marks:
            self.observe_flush(sid, n, marks)

    def observe_ingest(
        self, n: int, decode_s: float, merkle_s: float, stage_s: float
    ) -> None:
        """One ingest batch (IngestPipeline hook): frames + host stage
        seconds, so /perf attributes the pre-flush host work too."""
        with self._ingest_lock:
            self.ingest_frames += n
            self._ingest_stage_s["decode"] += decode_s
            self._ingest_stage_s["merkle"] += merkle_s
            self._ingest_stage_s["stage"] += stage_s

    def install_rules(self, monitor) -> None:
        """Wire the retrace + skew alerts onto a HealthMonitor."""
        for rule in _perf_rules(self):
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
        if not self.kernels._warm and now >= self.armed_at_micros:
            self.kernels.mark_warm()
        # keep the skew window sliding while the plane is idle (see
        # ShardSkew.anchor)
        self.skew.anchor()
        for key, state in self._rates.items():
            fn, last_count, last_micros = state
            try:
                count = int(fn())
            except Exception:
                continue
            if last_micros is not None and now > last_micros:
                rate = (count - last_count) * 1e6 / (now - last_micros)
                self.history.record(key, now, max(0.0, rate))
            state[1], state[2] = count, now
        for key, fn in self._values.items():
            try:
                self.history.record(key, now, float(fn()))
            except Exception:
                continue

    # -- baseline diff -------------------------------------------------------

    def load_baseline(self, path: Optional[str] = None) -> Optional[dict]:
        path = path or self.baseline_path
        if path is None:
            return None
        if self._baseline is None or path != self.baseline_path:
            self.baseline_path = path
            import os

            self._baseline_label = os.path.basename(path)
            try:
                self._baseline = parse_bench_record(path)
                self._baseline_error = None
            except (OSError, ValueError) as e:
                # a missing/corrupt baseline file degrades THIS section
                # of /perf, never the whole attribution surface: the
                # snapshot keeps serving with the error named
                self._baseline = {}
                self._baseline_error = f"{type(e).__name__}: {e}"
        return self._baseline

    def baseline_diff(
        self, baseline: Optional[dict] = None, label: Optional[str] = None
    ) -> dict:
        """Sustained history vs the baseline record, per overlapping
        key: the node's own "regressed N% vs <record>" answer. Rows
        carry delta_pct (positive = improved, throughput-shaped);
        `regressions` is the human sentence list the operator (and
        the acceptance test) reads."""
        if baseline is None:
            baseline = self.load_baseline()
        label = label or self._baseline_label or "baseline"
        pol = self.policy
        rows = []
        regressions = []
        for key in sorted(baseline or {}):
            base_val = baseline[key].get("value")
            current = self.history.sustained(key, pol.history_window)
            if base_val in (None, 0) or current is None:
                continue
            delta = 100.0 * (current - base_val) / abs(base_val)
            regressed = delta < -pol.baseline_gate_pct
            rows.append({
                "metric": key,
                "baseline": base_val,
                "current": round(current, 3),
                "delta_pct": round(delta, 2),
                "regressed": regressed,
            })
            if regressed:
                regressions.append(
                    f"{key} regressed {-delta:.1f}% vs {label}"
                )
        out = {
            "baseline": label if rows else None,
            "rows": rows,
            "regressions": regressions,
        }
        if self._baseline_error is not None:
            out["error"] = self._baseline_error
        return out

    # -- exports -------------------------------------------------------------

    def collapsed_profile(self) -> str:
        return self.profiler.collapsed()

    def _host_stages(self) -> dict:
        """The host-side stage attribution: the notary's flush phase
        timers (shared registry) plus the ingest stage accumulators."""
        out: dict[str, dict] = {}
        for stage, row in flush_phase_seconds(self.metrics).items():
            out[stage] = {
                "count": row["count"],
                "total_s": round(row["total_s"], 6),
                "mean_s": round(row["mean_s"], 6),
            }
        with self._ingest_lock:
            for stage, total in self._ingest_stage_s.items():
                if total > 0:
                    out[f"ingest.{stage}"] = {
                        "count": self.ingest_frames,
                        "total_s": round(total, 6),
                        "mean_s": (
                            round(total / self.ingest_frames, 9)
                            if self.ingest_frames else 0.0
                        ),
                    }
        return out

    def snapshot(self) -> dict:
        """The GET /perf payload."""
        return {
            "now_micros": self.now_micros(),
            "profiler": self.profiler.snapshot(),
            "kernels": self.kernels.snapshot(),
            "host_stages": self._host_stages(),
            "shards": self.skew.snapshot(),
            "wave": self.wave.snapshot(),
            "ingest_frames": self.ingest_frames,
            "history": self.history.snapshot(self.policy.history_window),
            "baseline": self.baseline_diff(),
        }
