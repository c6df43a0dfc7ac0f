"""Runtime concurrency sanitizer + crash-schedule explorer.

Port of corda_tpu/testing/sanitizer.py, its dynamic half:

1. **Runtime lockdep** — :class:`ConcurrencySanitizer` is the monitor
   behind the instrumented lock factory (``utils/locks.py``; every
   lock constructor site of the port routes through it, raw-primitive
   passthrough while disarmed). Armed, it records per-thread held
   stacks, acquisition-order edges with call-site evidence, contention
   counts and hold-time profiles per static lock identity, and detects
   — at runtime, as they happen — lock-order inversions (a new edge
   closing a cycle), self-deadlock on a non-reentrant lock (fail-fast
   raise instead of the hang) and pump-hot locks held past a wall-time
   budget. The findings carry the reference's fingerprints and go
   through its baseline gate (:func:`gate`, :func:`write_baseline`).
   :func:`standard_soak` is the representative armed exercise: a
   sharded batching notary with worker threads plus a concurrent
   metrics reader, verifying on the card unless the caller passes
   another verifier (the reference's soak verifies on the CPU).

2. **Crash-schedule explorer** — :class:`CrashScheduleExplorer`
   systematically enumerates kill points at EVERY
   ``XShardCoordinatorJournal`` / ``XShardReservationJournal`` /
   intent-WAL append boundary (pre and post — the fsync-window halves),
   and at the commit-log store's boundaries when ``store_factory``
   builds one (``CommitLogStateStore.set_boundary``), plus seeded
   message-delivery permutation schedules over the cross-member 2PC,
   restarts over the surviving state, and asserts the exactly-once /
   zero-orphan / serial-replay invariants after every schedule. Given
   the same seed, its schedule fingerprints and outcomes are the
   reference's. :func:`make_broken_provider_cls` is the negative pin: a
   coordinator whose first ``ShardCommit`` leaves before the durable
   commit mark — the explorer must catch it.

3. **The static half** — :func:`static_lock_view` builds a
   :class:`StaticLockView` from ``tools/lint``'s fact core run over the
   port's own tree (``extract_repo(root, subdirs=("corda_tpu_torch",))``,
   imported lazily, as the reference does);
   ``ConcurrencySanitizer.diff_static`` reconciles the observed graph
   against it into a :class:`SanitizerDiff`, and ``split_report`` /
   :func:`render_split_report` give the process-split feasibility
   report. The port's committed-tree gate reads
   ``SANITIZER_BASELINE_TORCH.json``.
"""

from __future__ import annotations

import hashlib
import os
import random
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils import locks as lockslib

# severity tiers (the reference's lint vocabulary)
P0 = "P0"
P1 = "P1"
P2 = "P2"

DEFAULT_BASELINE = "SANITIZER_BASELINE.json"

# rules whose presence is deterministic for a fixed workload (code-path
# driven, not schedule-driven): the CI gate diffs these. Hold/contention
# findings are timing-dependent and ride the report, not the gate.
GATED_RULES = (
    "sanitizer-lock-cycle",
    "sanitizer-self-deadlock",
    "sanitizer-edge-unseen",
)


def fingerprint(rule: str, file: str, scope: str, detail: str) -> str:
    h = hashlib.sha256(f"{rule}|{file}|{scope}|{detail}".encode()).hexdigest()
    return h[:16]


@dataclass
class Finding:
    """One sanitizer result — same identity model as the lint plane:
    `detail` is the stable fingerprint key (lock names, never line
    numbers); `message`/`evidence` render freely."""

    rule: str
    severity: str
    file: str
    line: int
    scope: str
    detail: str
    message: str
    evidence: list = field(default_factory=list)

    @property
    def fingerprint(self) -> str:
        return fingerprint(self.rule, self.file, self.scope, self.detail)

    def render(self) -> str:
        head = (
            f"[{self.severity}] {self.rule} {self.file}:{self.line}"
            + (f" ({self.scope})" if self.scope else "")
            + f" [{self.fingerprint}]"
        )
        out = [head, f"    {self.message}"]
        for ev in self.evidence:
            out.append(f"      - {ev}")
        return "\n".join(out)


def load_baseline(path: str) -> list:
    import json

    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    rows = doc.get("baselined", []) if isinstance(doc, dict) else []
    return [r for r in rows if isinstance(r, dict)]


def gate(findings: list, baseline_rows: list) -> tuple:
    """(new, stale, unjustified) — the lint gate's semantics: only a
    justified baseline row suppresses; a row matching nothing live is
    stale (reported, never fatal)."""
    justified = {
        r["fingerprint"]
        for r in baseline_rows
        if r.get("fingerprint") and str(r.get("justification", "")).strip()
    }
    unjustified = [
        r
        for r in baseline_rows
        if r.get("fingerprint")
        and not str(r.get("justification", "")).strip()
    ]
    live = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in justified]
    stale = [
        r
        for r in baseline_rows
        if r.get("fingerprint") and r["fingerprint"] not in live
    ]
    return new, stale, unjustified


def write_baseline(path: str, findings: list) -> list:
    """(Re)seed the sanitizer baseline, preserving hand-written
    justifications by fingerprint (the lint --write-baseline merge
    discipline). Returns justification-DRIFT warnings — a justified
    row whose live finding no longer matches the recorded severity
    carries prose written against a finding that no longer exists in
    that form (the reference's lint baseline contract)."""
    import json

    existing = {r.get("fingerprint"): r for r in load_baseline(path)}
    rows = []
    seen = set()
    drift: list = []
    for f in findings:
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        prior = existing.get(f.fingerprint, {})
        justification = str(prior.get("justification", ""))
        if (
            justification.strip()
            and str(prior.get("severity", f.severity)) != f.severity
        ):
            # byte-identical to the reference's message: the lint and
            # sanitizer planes share one baseline discipline
            drift.append(
                f"baseline row {f.fingerprint} ({f.rule} {f.file}): "
                f"recorded severity {prior.get('severity')} but the "
                f"live finding is {f.severity} — the carried-over "
                "justification may no longer apply, re-verify it"
            )
        rows.append(
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "severity": f.severity,
                "file": f.file,
                "scope": f.scope,
                "detail": f.detail,
                "justification": justification,
            }
        )
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "baselined": rows}, f, indent=2)
        f.write("\n")
    return drift


# ---------------------------------------------------------------------------
# call-site attribution


def _rel(path: str) -> str:
    p = path.replace(os.sep, "/")
    for marker in ("corda_tpu_torch/", "corda_tpu/", "tools/", "tests/"):
        i = p.rfind("/" + marker)
        if i >= 0:
            return p[i + 1:]
        if p.startswith(marker):
            return p
    return p.rsplit("/", 1)[-1]


# exact plumbing files to skip in the caller walk (a suffix match
# would eat any caller file that happens to end in "...sanitizer.py")
_PLUMBING_FILES = frozenset(
    {os.path.abspath(__file__), os.path.abspath(lockslib.__file__)}
)


def _caller_site() -> tuple:
    """(relfile, line, function) of the first frame outside the
    sanitizer/locks plumbing."""
    f = sys._getframe(1)
    while f is not None and (
        os.path.abspath(f.f_code.co_filename) in _PLUMBING_FILES
    ):
        f = f.f_back
    if f is None:
        return ("<unknown>", 0, "<unknown>")
    return (_rel(f.f_code.co_filename), f.f_lineno, f.f_code.co_name)


# ---------------------------------------------------------------------------
# the runtime lockdep monitor


class _HeldEntry:
    __slots__ = ("lock", "t0", "site", "depth")

    def __init__(self, lock, t0, site):
        self.lock = lock
        self.t0 = t0
        self.site = site
        self.depth = 1


class LockStats:
    __slots__ = (
        "acquisitions", "contended", "wait_ns", "hold_ns", "hold_max_ns",
        "holders", "sites",
    )

    def __init__(self):
        self.acquisitions = 0
        self.contended = 0
        self.wait_ns = 0
        self.hold_ns = 0
        self.hold_max_ns = 0
        self.holders: set = set()
        self.sites: set = set()

    def as_dict(self) -> dict:
        mean_us = (
            self.hold_ns / self.acquisitions / 1000.0
            if self.acquisitions
            else 0.0
        )
        return {
            "acquisitions": self.acquisitions,
            "contended": self.contended,
            "contention_ratio": round(
                self.contended / self.acquisitions, 4
            ) if self.acquisitions else 0.0,
            "wait_us_total": round(self.wait_ns / 1000.0, 1),
            "hold_us_total": round(self.hold_ns / 1000.0, 1),
            "hold_us_mean": round(mean_us, 2),
            "hold_us_max": round(self.hold_max_ns / 1000.0, 1),
            "threads": sorted(self.holders),
            "sites": sorted(f"{f}:{ln}" for f, ln in self.sites)[:8],
        }


class ConcurrencySanitizer:
    """The armed monitor behind ``utils/locks.py`` — records the
    observed lock discipline and flags violations as they happen.

    Zero-overhead note: NOTHING here runs while disarmed — the factory
    hands out raw primitives. Armed, every acquisition pays the
    held-stack push, the edge probe and (first time per edge) a
    call-site capture.
    """

    def __init__(
        self,
        hot_locks=(),
        hold_budget_micros: int = 5_000,
        now_ns: Optional[Callable[[], int]] = None,
        max_evidence: int = 3,
    ):
        self.hot_locks = set(hot_locks)
        self.hold_budget_ns = int(hold_budget_micros) * 1_000
        self._now = now_ns or time.perf_counter_ns
        self._max_evidence = max_evidence
        # the monitor's own guard is a RAW lock — instrumenting it
        # would recurse
        self._plain = threading.Lock()
        self._tls = threading.local()
        self.edges: dict = {}        # (a, b) -> [evidence, ...]
        self._adj: dict = {}         # a -> set(b)  (cycle probe index)
        self.stats: dict = {}        # name -> LockStats
        self._findings: list = []
        self._finding_keys: set = set()

    # -- arming --------------------------------------------------------------

    def arm(self) -> "ConcurrencySanitizer":
        lockslib.install_monitor(self)
        return self

    def disarm(self) -> None:
        if lockslib.active_monitor() is self:
            lockslib.install_monitor(None)

    def __enter__(self) -> "ConcurrencySanitizer":
        return self.arm()

    def __exit__(self, exc_type, exc, tb):
        self.disarm()
        return False

    # -- monitor protocol (called by the lock wrappers) ----------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def check_blocking_acquire(self, lock) -> None:
        if lock.reentrant:
            return
        # compare PRIMITIVES, not wrappers: a condition built over a
        # held SanitizedLock is a different wrapper around the same
        # physical deadlock
        phys = lock.primitive()
        for entry in self._held():
            if entry.lock.primitive() is phys:
                site = _caller_site()
                self._finding(
                    "sanitizer-self-deadlock",
                    P0,
                    site[0],
                    site[1],
                    site[2],
                    lock.name,
                    f"non-reentrant {lock.name} re-acquired by the "
                    f"thread already holding it (first taken at "
                    f"{entry.site[0]}:{entry.site[1]}) — guaranteed "
                    "self-deadlock",
                    [f"thread {threading.current_thread().name}"],
                )
                raise lockslib.SanitizerDeadlockError(
                    f"self-deadlock: {lock.name} re-acquired while held "
                    f"(first at {entry.site[0]}:{entry.site[1]}, "
                    f"again at {site[0]}:{site[1]})"
                )

    def on_acquired(self, lock, wait_ns: int, contended: bool) -> None:
        held = self._held()
        for entry in held:
            if entry.lock is lock:       # RLock re-entry
                entry.depth += 1
                return
        site = _caller_site()
        now = self._now()
        thread = threading.current_thread().name
        with self._plain:
            st = self.stats.get(lock.name)
            if st is None:
                st = self.stats[lock.name] = LockStats()
            st.acquisitions += 1
            st.holders.add(thread)
            if len(st.sites) < 8:
                st.sites.add((site[0], site[1]))
            if contended:
                st.contended += 1
                st.wait_ns += wait_ns
            for entry in held:
                self._edge_locked(entry.lock.name, lock.name, site, thread)
        held.append(_HeldEntry(lock, now, site))

    def on_release(self, lock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry.lock is lock:
                if entry.depth > 1:
                    entry.depth -= 1
                    return
                held.pop(i)
                dt = self._now() - entry.t0
                with self._plain:
                    st = self.stats.get(lock.name)
                    if st is not None:
                        st.hold_ns += dt
                        if dt > st.hold_max_ns:
                            st.hold_max_ns = dt
                if (
                    lock.name in self.hot_locks
                    and dt > self.hold_budget_ns
                ):
                    self._finding(
                        "sanitizer-hold-hazard",
                        P1,
                        entry.site[0],
                        entry.site[1],
                        entry.site[2],
                        f"{lock.name}@{entry.site[2]}",
                        f"pump-hot {lock.name} held "
                        f"{dt / 1000:.0f}us in {entry.site[2]} — over "
                        f"the {self.hold_budget_ns / 1000:.0f}us budget",
                        [f"acquired at {entry.site[0]}:{entry.site[1]}"],
                    )
                return

    # a Condition.wait releases the lock for the park and re-acquires
    # at wake: hold spans split at the wait, edges re-derive at wake.
    # Condition._release_save drops EVERY re-entry level of an
    # RLock-backed condition, so the whole entry closes (its depth is
    # returned for the wake-side restore) — a park must never read as
    # a hold, whatever the nesting
    def on_wait_release(self, cond) -> int:
        held = self._held()
        saved = 1
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry.lock is cond:
                saved = entry.depth
                entry.depth = 1
                break
        self.on_release(cond)
        return saved

    def on_wait_reacquired(self, cond, saved: int = 1) -> None:
        self.on_acquired(cond, 0, False)
        if saved > 1:
            held = self._held()
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is cond:
                    held[i].depth = saved
                    break

    # -- recording -----------------------------------------------------------

    def _edge_locked(self, a: str, b: str, site, thread: str) -> None:
        key = (a, b)
        ev_list = self.edges.get(key)
        is_new = ev_list is None
        if is_new:
            ev_list = self.edges[key] = []
            self._adj.setdefault(a, set()).add(b)
        if len(ev_list) < self._max_evidence:
            ev_list.append(
                f"{site[0]}:{site[1]} [{thread}] {b} acquired holding {a}"
            )
        if is_new and a != b:
            cycle = self._find_path(b, a)
            if cycle is not None:
                nodes = sorted(set(cycle + [b]))
                self._finding_unlocked(
                    "sanitizer-lock-cycle",
                    P0,
                    site[0],
                    site[1],
                    "",
                    "<->".join(nodes),
                    "lock-order inversion OBSERVED at runtime: "
                    + " -> ".join(cycle + [b])
                    + f" closed by {a} -> {b}",
                    ev_list[:2],
                )

    def _find_path(self, src: str, dst: str) -> Optional[list]:
        """DFS src -> dst over observed edges; returns the node path
        [src, ..., dst] or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _finding(self, rule, sev, file, line, scope, detail, msg, ev):
        with self._plain:
            self._finding_unlocked(
                rule, sev, file, line, scope, detail, msg, ev
            )

    def _finding_unlocked(
        self, rule, sev, file, line, scope, detail, msg, ev
    ):
        key = (rule, detail)
        if key in self._finding_keys:
            return
        self._finding_keys.add(key)
        self._findings.append(
            Finding(rule, sev, file, line, scope, detail, msg, list(ev))
        )

    # -- views ---------------------------------------------------------------

    def findings(self, rules=None) -> list:
        with self._plain:
            out = list(self._findings)
        if rules is not None:
            out = [f for f in out if f.rule in rules]
        return out

    def graph(self) -> dict:
        """Observed lock graph: {(a, b): [evidence, ...]}."""
        with self._plain:
            return {k: list(v) for k, v in self.edges.items()}

    def lock_stats(self) -> dict:
        with self._plain:
            return {name: st.as_dict() for name, st in self.stats.items()}

    def export(self) -> dict:
        """JSON-safe dump: graph + stats + findings (the runtime
        analogue of `python -m tools.lint --format json`)."""
        return {
            "edges": [
                {"from": a, "to": b, "evidence": ev}
                for (a, b), ev in sorted(self.graph().items())
            ],
            "locks": self.lock_stats(),
            "findings": [
                {
                    "fingerprint": f.fingerprint,
                    "rule": f.rule,
                    "severity": f.severity,
                    "file": f.file,
                    "line": f.line,
                    "scope": f.scope,
                    "detail": f.detail,
                    "message": f.message,
                }
                for f in self.findings()
            ],
        }

    # -- static <-> dynamic --------------------------------------------------

    def diff_static(self, view: "StaticLockView") -> "SanitizerDiff":
        """Reconcile the observed graph against the lockcheck fact
        core. Runtime edges the static pass missed become findings
        (they strengthen facts.py or get baselined with a written
        justification); static edges never exercised become the
        coverage report; runtime locks with no static identity are
        listed (factory names that drifted from the tree)."""
        def variants(name: str) -> tuple:
            # runtime factory names are exact (`_NotaryShard.cond`);
            # the static walk spells an acquisition `?.attr` when
            # several classes define the attribute and the receiver's
            # class cannot be inferred — an observed edge matches a
            # static one under either spelling of either endpoint
            fb = "?." + name.rsplit(".", 1)[-1]
            return (name,) if fb == name else (name, fb)

        def static_matches(a: str, b: str) -> set:
            return {
                (x, y)
                for x in variants(a)
                for y in variants(b)
                if (x, y) in view.edges
            }

        observed = self.graph()
        exercised: set = set()
        unseen: list = []
        for (a, b), ev in sorted(observed.items()):
            # a runtime (a, a) edge — two instances of one static id
            # nested — matches the static instance-order pairs, which
            # the view's edge set carries as (a, a)
            hits = static_matches(a, b)
            if hits:
                exercised |= hits
                continue
            site_file = "<runtime>"
            site_line = 0
            if ev:
                head = ev[0].split(" ", 1)[0]
                if ":" in head:
                    site_file, _, ln = head.rpartition(":")
                    site_line = int(ln) if ln.isdigit() else 0
            unseen.append(
                Finding(
                    "sanitizer-edge-unseen",
                    P1,
                    site_file,
                    site_line,
                    "",
                    f"{a}->{b}",
                    f"runtime lock-order edge {a} -> {b} is absent "
                    "from the static lockcheck graph (dynamic "
                    "dispatch or callback the AST walk cannot "
                    "resolve) — teach facts.py or baseline with the "
                    "reason",
                    ev[:3],
                )
            )
        unexercised = sorted(view.edges - exercised)
        unknown = sorted(
            name for name in self.lock_stats() if name not in view.locks
        )
        return SanitizerDiff(
            unseen_edges=unseen,
            unexercised_edges=unexercised,
            unknown_locks=unknown,
            observed_edge_count=len(observed),
            static_edge_count=len(view.edges),
        )

    def split_report(self, view: "StaticLockView") -> dict:
        """The process-split feasibility report: every lock that
        mediates cross-thread-group state — statically reachable from
        more than one entry group (the lockcheck sharing map), or
        observed held by more than one thread at runtime — with its
        measured contention and hold profile. The `pump_hot` section
        names the locks a GIL-escape split must either keep on the
        pump side, shard, or replace with a queue; `hold_us_*` is the
        evidence the planning argues from."""
        stats = self.lock_stats()
        rows = []
        for name, st in sorted(stats.items()):
            groups = set(view.groups.get(name, ()))
            if not groups:
                # the static sharing map may know this lock under its
                # ambiguous `?.attr` spelling
                groups = set(
                    view.groups.get(
                        "?." + name.rsplit(".", 1)[-1], ()
                    )
                )
            rgroups = {_thread_group(t) for t in st["threads"]}
            combined = groups | rgroups
            if len(combined) < 2 and len(st["threads"]) < 2:
                continue
            rows.append(
                {
                    "lock": name,
                    "kind": view.kinds.get(name, "Lock"),
                    "pump_hot": name in view.hot_locks,
                    "static_groups": sorted(groups),
                    "runtime_groups": sorted(rgroups),
                    **st,
                }
            )
        rows.sort(key=lambda r: -r["hold_us_total"])
        pump_hot = [
            r for r in rows if r["pump_hot"] and r["acquisitions"] > 0
        ]
        return {
            "shared_locks": rows,
            "pump_hot": pump_hot,
            "observed_locks": len(stats),
            "static_locks": len(view.locks),
        }


def _thread_group(thread_name: str) -> str:
    if thread_name == "MainThread":
        return "pump"
    if thread_name.startswith("notary-shard"):
        return "shard-flush"
    if thread_name.startswith("notary-collect"):
        return "shard-flush"
    if thread_name.startswith("cts-ingest"):
        return "ingest"
    if thread_name.startswith(("web", "http")):
        return "web"
    return thread_name


def render_split_report(report: dict) -> str:
    lines = [
        "process-split feasibility (static sharing map x measured "
        "contention/hold)",
        f"  observed locks: {report['observed_locks']} of "
        f"{report['static_locks']} statically known",
        "",
        "  pump-hot locks (measured hold times — the split's critical "
        "path):",
    ]
    for r in report["pump_hot"] or ():
        lines.append(
            f"    {r['lock']:<44} acq={r['acquisitions']:<6} "
            f"contended={r['contended']:<4} "
            f"hold mean={r['hold_us_mean']}us max={r['hold_us_max']}us "
            f"total={r['hold_us_total']}us"
        )
    if not report["pump_hot"]:
        lines.append("    (none observed)")
    lines.append("")
    lines.append("  cross-group shared state:")
    for r in report["shared_locks"]:
        groups = ",".join(
            sorted(set(r["static_groups"]) | set(r["runtime_groups"]))
        ) or "-"
        lines.append(
            f"    {r['lock']:<44} [{r['kind']}] groups={groups} "
            f"contention={r['contention_ratio']} "
            f"hold_total={r['hold_us_total']}us"
            + ("  PUMP-HOT" if r["pump_hot"] else "")
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# static view (lazy tools/lint import — tests run from the repo root,
# where `tools` is importable); the fact core walks corda_tpu_torch/


@dataclass
class StaticLockView:
    edges: set
    locks: set
    hot_locks: set
    groups: dict
    kinds: dict


@dataclass
class SanitizerDiff:
    """The static<->dynamic reconciliation: `unseen_edges` are
    findings (runtime truths the AST walk missed), `unexercised_edges`
    is the coverage report (statically proven orderings this run never
    drove), `unknown_locks` are factory names with no static identity
    (drift between a make_lock string and the tree)."""

    unseen_edges: list
    unexercised_edges: list
    unknown_locks: list
    observed_edge_count: int
    static_edge_count: int

    @property
    def coverage(self) -> float:
        if not self.static_edge_count:
            return 1.0
        exercised = self.static_edge_count - len(self.unexercised_edges)
        return exercised / self.static_edge_count

    def findings(self) -> list:
        return list(self.unseen_edges)


def static_lock_view(root: Optional[str] = None) -> StaticLockView:
    if root is None:
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    if root not in sys.path:
        sys.path.insert(0, root)
    from tools.lint import lockcheck
    from tools.lint.facts import extract_repo

    repo = extract_repo(root, subdirs=("corda_tpu_torch",))
    g = lockcheck.build_lock_graph(repo)
    edges = set(g.edges)
    for lock_id in list(g.self_same_recv) + list(g.self_diff_recv):
        edges.add((lock_id, lock_id))
    groups: dict = {}
    for key, fn in repo.functions.items():
        fn_groups = repo.reachable_groups.get(key, set())
        if not fn_groups:
            continue
        for acq in fn.acquires:
            groups.setdefault(acq.lock_id, set()).update(fn_groups)
    kinds = {name: meta[0] for name, meta in repo.locks.items()}
    return StaticLockView(
        edges=edges,
        locks=set(repo.locks),
        hot_locks=set(repo.hot_locks),
        groups=groups,
        kinds=kinds,
    )


# ---------------------------------------------------------------------------
# the standard soak: a representative sanitized exercise of the tree
# (pump tick + shard worker threads + a concurrent reader)


def standard_soak(issues: int = 8, shards: int = 4,
                  batch_verifier=None) -> dict:
    """Drive a sharded BatchingNotaryService (worker threads ON) plus a
    concurrent metrics reader through a real cash workload. The
    sanitizer must already be ARMED: every lock these objects construct
    reports in. `batch_verifier`: the network's verifier; None is the
    card (MockNetwork's CudaBatchVerifier), where the reference's soak
    verifies on the CPU. Returns {"signed": n, "rejected": n}."""
    assert lockslib.active_monitor() is not None, (
        "arm a ConcurrencySanitizer before building the soak rig"
    )
    from ..core.contracts import Amount, Issued, StateRef
    from ..core.identity import PartyAndReference
    from ..core.transactions import TransactionBuilder
    from ..finance.cash import CASH_CONTRACT, CashIssue, CashMove, CashState
    from ..node.notary import (
        BatchingNotaryService,
        ShardedUniquenessProvider,
    )
    from ..utils.txstory import TxStory
    from .mock_network import MockNetwork

    net = MockNetwork(seed=33, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary", batching=True)
    bank = net.create_node("Bank")
    alice = net.create_node("Alice")
    token = Issued(PartyAndReference(bank.party, b"\x01"), "USD")

    issued = []
    for i in range(issues):
        ib = TransactionBuilder(notary.party)
        ib.add_output_state(
            CashState(Amount(100 + i, token), alice.party.owning_key),
            CASH_CONTRACT,
        )
        ib.add_command(CashIssue(i + 1), bank.party.owning_key)
        issue = bank.services.sign_initial_transaction(ib)
        notary.services.record_transactions([issue])
        alice.services.record_transactions([issue])
        issued.append(issue)

    def spend(inputs, dest):
        sb = TransactionBuilder(notary.party)
        for issue in inputs:
            sb.add_input_state(
                alice.vault.state_and_ref(StateRef(issue.id, 0))
            )
        sb.add_output_state(
            CashState(
                Amount(
                    sum(100 + issued.index(i) for i in inputs), token
                ),
                dest.owning_key,
            ),
            CASH_CONTRACT, notary.party,
        )
        sb.add_command(CashMove(), alice.party.owning_key)
        return alice.services.sign_initial_transaction(sb)

    stxs = []
    for a, b in zip(issued[0::2], issued[1::2]):
        stxs.append(spend([a, b], bank.party))       # usually cross-shard
        stxs.append(spend([b], notary.party))        # single-shard rival

    # record_decisions drives the `cond -> _decision_lock` edge, the
    # health attach the `cond -> Heartbeat._lock` one, and the intent
    # WAL puts the sqlite serialization boundary (NodeDatabase._lock,
    # the tree's known long-hold lock) on the measured profile
    from ..node.persistence import NodeDatabase, NotaryIntentJournal
    from ..node.services import TestClock
    from ..utils.health import HealthMonitor

    uniq = ShardedUniquenessProvider(shards, record_decisions=True)
    svc = BatchingNotaryService(
        notary.services, uniq, shards=shards, shard_workers=True,
        max_batch=4096,
        intent_journal=NotaryIntentJournal(NodeDatabase(":memory:")),
    )
    svc.attach_txstory(TxStory())
    svc.attach_health(HealthMonitor(TestClock()))

    stop_reader = threading.Event()

    def reader():
        # snapshot reads racing the pump + workers (registry.get, not
        # counter() — a read must not become a second registration
        # site)
        while not stop_reader.is_set():
            c = svc.metrics.get("Notary.RequestsBatched")
            _ = c.count if c is not None else 0
            _ = dict(uniq.committed)
            time.sleep(0.0002)

    rt = threading.Thread(target=reader, name="web-reader", daemon=True)
    rt.start()
    try:
        futs = [svc.submit(stx, alice.party) for stx in stxs]
        svc.flush()
    finally:
        stop_reader.set()
        rt.join(timeout=5)
        svc.stop()
    signed = rejected = 0
    for f in futs:
        try:
            out = f.result()
        except Exception:  # noqa: BLE001 - conflicts answer as errors
            rejected += 1
            continue
        if hasattr(out, "by"):
            signed += 1
        else:
            rejected += 1
    return {"signed": signed, "rejected": rejected}


# ---------------------------------------------------------------------------
# crash-schedule explorer


class SimulatedCrash(Exception):
    """Control-flow marker: the armed kill point fired — the member
    named dies NOW (kill -9: in-memory state gone, sqlite survives)."""

    def __init__(self, member: str):
        super().__init__(member)
        self.member = member


# journal methods that are durability boundaries: each call is one
# enumerable crossing, killable immediately before (op never happened)
# or immediately after (op durable, nothing else is)
_BOUNDARY_OPS = frozenset(
    {
        "begin", "decide_commit", "finish",          # coordinator WAL
        "reserve", "release",                        # reservation journal
        "append", "mark_resolved", "flush_resolved",  # intent WAL
    }
)


class _JournalTap:
    """Forwarding proxy around a journal; every boundary op reports a
    pre/post crossing to the explorer."""

    def __init__(self, inner, member: str, prefix: str, explorer):
        self._inner = inner
        self._member = member
        self._prefix = prefix
        self._explorer = explorer

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if callable(attr) and name in _BOUNDARY_OPS:
            member, prefix, explorer = (
                self._member, self._prefix, self._explorer
            )

            def wrapped(*a, **kw):
                explorer._boundary(member, f"{prefix}.{name}", "pre")
                out = attr(*a, **kw)
                explorer._boundary(member, f"{prefix}.{name}", "post")
                return out

            return wrapped
        return attr


class _Chooser:
    """Deterministic delivery-permutation schedule: the fabric pump's
    rng seam only needs `randrange`. The recorded choice sequence IS
    the schedule's identity."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self.sig: list = []

    def randrange(self, n: int) -> int:
        c = self._rng.randrange(n)
        self.sig.append(c)
        return c


@dataclass
class Schedule:
    kind: str                    # "kill" | "reorder" | "trace"
    kill_index: int = -1         # boundary crossing (1-based) to kill at
    kill_phase: str = "pre"      # "pre" | "post"
    seed: int = 0                # reorder permutation seed
    label: str = ""


@dataclass
class ScheduleResult:
    schedule: Schedule
    violations: list
    fingerprint: str
    killed_at: Optional[tuple] = None
    steps: int = 0
    outcomes: dict = field(default_factory=dict)


@dataclass
class ExplorerReport:
    results: list

    @property
    def schedules(self) -> int:
        return len({r.fingerprint for r in self.results})

    @property
    def violations(self) -> list:
        return [
            (r.schedule.label, v)
            for r in self.results
            for v in r.violations
        ]

    def summary(self) -> str:
        kinds: dict = {}
        for r in self.results:
            kinds[r.schedule.kind] = kinds.get(r.schedule.kind, 0) + 1
        return (
            f"{self.schedules} distinct schedule(s) "
            f"({', '.join(f'{k}={n}' for k, n in sorted(kinds.items()))}), "
            f"{len(self.violations)} violation(s)"
        )


class CrashScheduleExplorer:
    """Systematic kill/reorder exploration of the cross-member 2PC +
    WAL protocols on the TestClock.

    A canonical cross-shard workload (three members, cross-member
    spends, one deterministic double-spend rival, one local fast-path
    commit) runs under every schedule:

      * ``kill`` schedules: the k-th journal-boundary crossing —
        coordinator WAL begin/decide/finish, participant reservation
        reserve/release, intent-WAL append/mark/flush — kills its
        member immediately before or immediately after the durable op;
        the member restarts two steps later over its surviving sqlite
        state (``recover()`` + intent replay) and the run drives to
        quiescence.
      * ``reorder`` schedules: no crash; every message-delivery choice
        point takes the seeded permutation's pick among the
        deliverable per-pair queues (per-pair FIFO holds — the fabric
        contract — so these are exactly the schedules a real cluster
        can exhibit).

    After each schedule the invariants must hold: every submission
    reaches exactly one, stable outcome; accepted transactions are
    atomically committed at every owner and rejected ones nowhere;
    zero residual reservations/orphans/WAL rows; and the decision log
    replays serially to the merged committed state.
    """

    STEP_MICROS = 120_000
    MAX_STEPS = 600
    RESTART_DELAY_STEPS = 2
    DELIVERIES_PER_STEP = 6

    def __init__(
        self,
        members=("A", "B", "C"),
        n_partitions: int = 6,
        provider_cls=None,
        seed: int = 0,
        store_factory=None,
    ):
        from ..node.distributed_uniqueness import (
            DistributedUniquenessProvider,
            XShardPolicy,
        )

        self.members = tuple(members)
        self.n_partitions = n_partitions
        self.provider_cls = provider_cls or DistributedUniquenessProvider
        self.seed = seed
        # pluggable committed-state backend: called as
        # store_factory(world_id, member) for every (re)build — a
        # restart within one world MUST reopen the same durable state
        # (the commit-log store's directory), a new world must get a
        # fresh one. When the store exposes durability boundaries
        # (set_boundary), they enter the kill-schedule enumeration as
        # `store.<op>` crossings: segment append/seal, snapshot write,
        # index publish, compaction swap.
        self.store_factory = store_factory
        self._world_seq = 0
        # generous silence bound: every kill heals within a few steps,
        # so `shard-unavailable` must never be the answer — any
        # unavailability IS a violation in this rig
        self.policy = XShardPolicy(
            timeout_micros=60_000_000,
            backoff_base_micros=40_000,
            backoff_cap_micros=300_000,
            reservation_ttl_micros=1_500_000,
        )
        # armed-run state
        self._mode = "idle"
        self._crossing = 0
        self._trace: list = []
        self._kill_index = -1
        self._kill_phase = "pre"
        self._kill_member_op: Optional[tuple] = None
        self._kill_pending_member: Optional[str] = None

    # -- boundary hook -------------------------------------------------------

    def _boundary(self, member: str, op: str, when: str) -> None:
        if when == "pre":
            self._crossing += 1
            if self._mode == "trace":
                self._trace.append((member, op))
            if (
                self._mode == "armed"
                and self._crossing == self._kill_index
            ):
                self._kill_member_op = (member, op)
                if self._kill_phase == "pre":
                    raise SimulatedCrash(member)
                self._kill_pending_member = member
        else:
            if self._kill_pending_member is not None:
                m, self._kill_pending_member = (
                    self._kill_pending_member, None
                )
                raise SimulatedCrash(m)

    # -- world ---------------------------------------------------------------

    def _build_world(self):
        from ..core.identity import Party
        from ..crypto import schemes
        from ..node.messaging import FabricFaults, InMemoryMessagingNetwork
        from ..node.persistence import (
            NodeDatabase,
            NotaryIntentJournal,
            ShardedPersistentUniquenessProvider,
            XShardCoordinatorJournal,
            XShardReservationJournal,
        )
        from ..node.services import TestClock

        class _World:
            pass

        w = _World()
        w.clock = TestClock()
        w.faults = FabricFaults(clock=w.clock)
        w.net = InMemoryMessagingNetwork(clock=w.clock, faults=w.faults)
        w.dbs = {m: NodeDatabase(":memory:") for m in self.members}
        w.decisions = []
        w.incarnation = {m: 0 for m in self.members}
        w.down_until: dict = {}
        w.first_restart_step: Optional[int] = None
        kp = schemes.generate_keypair(
            schemes.ECDSA_SECP256R1_SHA256, seed=91
        )
        w.requester = Party("explorer", kp.public)
        w.intents = {}
        w.provs = {}
        w.stores = {}
        w.world_id = self._world_seq
        self._world_seq += 1
        for m in self.members:
            db = w.dbs[m]
            w.intents[m] = _JournalTap(
                NotaryIntentJournal(db), m, "intent", self
            )
            w.provs[m] = self._build_provider(w, m)
        w.store_cls = ShardedPersistentUniquenessProvider
        w.coord_journal_cls = XShardCoordinatorJournal
        w.res_journal_cls = XShardReservationJournal
        return w

    def _build_provider(self, w, m: str):
        from ..node.persistence import (
            ShardedPersistentUniquenessProvider,
            XShardCoordinatorJournal,
            XShardReservationJournal,
        )

        db = w.dbs[m]
        if self.store_factory is not None:
            # reopening the member's surviving store directory IS the
            # boot replay under test; the old incarnation's handles
            # close first (the process died, its fds died with it)
            old = w.stores.get(m)
            if old is not None and hasattr(old, "close"):
                old.close()
            store = self.store_factory(w.world_id, m)
            if hasattr(store, "set_boundary"):
                store.set_boundary(
                    lambda op, when, _m=m: self._boundary(
                        _m, f"store.{op}", when
                    )
                )
            w.stores[m] = store
        else:
            store = ShardedPersistentUniquenessProvider(
                db, self.n_partitions
            )
        return self.provider_cls(
            m,
            self.members,
            w.net.endpoint(m),
            w.clock,
            n_partitions=self.n_partitions,
            store=store,
            journal=_JournalTap(
                XShardCoordinatorJournal(db), m, "coord", self
            ),
            reservations=_JournalTap(
                XShardReservationJournal(db), m, "res", self
            ),
            policy=self.policy,
            # NOT hash(): PYTHONHASHSEED randomizes it per process and
            # a schedule must replay identically across interpreters
            seed=(sum(ord(c) * 31 ** i for i, c in enumerate(m))
                  ^ self.seed) & 0xFFFF,
            decision_log=w.decisions,
        )

    # -- workload ------------------------------------------------------------

    def _ref(self, n: int):
        from ..core.contracts import StateRef
        from ..crypto.hashes import SecureHash

        return StateRef(
            SecureHash(bytes([n % 251 + 1]) * 31 + bytes([n // 251])), 0
        )

    def _h(self, n: int):
        from ..crypto.hashes import SecureHash

        return SecureHash(bytes([n % 251 + 1]) * 30 + b"\xee" + bytes([n // 251]))

    def _owned_refs(self, owner: str, count: int, start: int) -> list:
        from ..node.distributed_uniqueness import ShardMap

        sm = ShardMap(self.members, self.n_partitions)
        out, n = [], start
        while len(out) < count:
            ref = self._ref(n)
            if sm.owner_of(ref) == owner:
                out.append(ref)
            n += 1
        return out

    def _workload(self) -> list:
        a = self._owned_refs("A", 4, 1)
        b = self._owned_refs("B", 4, 200)
        c = self._owned_refs("C", 4, 400)
        # dicts: coordinator, tx, refs, due step (None = rival —
        # activates after the first restart, or step 4 when the
        # schedule never crashes)
        return [
            {"coord": "A", "tx": self._h(1), "refs": [a[0], b[0]], "due": 0},
            {"coord": "B", "tx": self._h(2), "refs": [b[1], c[0]], "due": 0},
            {"coord": "C", "tx": self._h(3), "refs": [a[1], c[1]], "due": 1},
            {"coord": "A", "tx": self._h(4), "refs": [a[2]], "due": 1},
            # the rival: contends b[0] with tx 1 — the double-spend
            # whose loser must name the true winner
            {"coord": "C", "tx": self._h(5), "refs": [b[0], c[2]],
             "due": None},
        ]

    # -- schedule enumeration ------------------------------------------------

    def trace_boundaries(self) -> list:
        """Baseline run, no crash: the ordered journal-boundary
        crossings a clean execution performs — the kill-schedule
        enumeration domain."""
        self._mode = "trace"
        self._crossing = 0
        self._trace = []
        try:
            result = self._run(Schedule("trace", label="trace"))
        finally:
            self._mode = "idle"
        if result.violations:
            raise AssertionError(
                f"trace run violated invariants: {result.violations}"
            )
        return list(self._trace)

    def schedules(
        self,
        reorder_seeds: int = 40,
        boundary_filter: Optional[Callable[[str], bool]] = None,
    ) -> list:
        trace = self.trace_boundaries()
        out = []
        for i, (member, op) in enumerate(trace, start=1):
            if boundary_filter is not None and not boundary_filter(op):
                continue
            for phase in ("pre", "post"):
                out.append(
                    Schedule(
                        "kill", kill_index=i, kill_phase=phase,
                        label=f"kill#{i}-{phase}:{member}:{op}",
                    )
                )
        for s in range(reorder_seeds):
            out.append(
                Schedule("reorder", seed=s, label=f"reorder#{s}")
            )
        return out

    def explore(
        self,
        reorder_seeds: int = 40,
        boundary_filter: Optional[Callable[[str], bool]] = None,
    ) -> ExplorerReport:
        results = []
        for sched in self.schedules(reorder_seeds, boundary_filter):
            results.append(self.run_schedule(sched))
        return ExplorerReport(results)

    # -- one schedule --------------------------------------------------------

    def run_schedule(self, sched: Schedule) -> ScheduleResult:
        if sched.kind == "kill":
            self._mode = "armed"
            self._kill_index = sched.kill_index
            self._kill_phase = sched.kill_phase
        else:
            self._mode = "trace" if sched.kind == "trace" else "idle"
        self._crossing = 0
        self._kill_member_op = None
        self._kill_pending_member = None
        try:
            return self._run(sched)
        finally:
            self._mode = "idle"

    def _run(self, sched: Schedule) -> ScheduleResult:
        from ..node.notary import ShardUnavailableError, UniquenessConflict

        w = self._build_world()
        subs = self._workload()
        for sub in subs:
            sub.update(future=None, inc=None, outcome=None, seq=None)
        chooser = _Chooser(sched.seed) if sched.kind == "reorder" else None
        violations: list = []
        step = 0

        def crash(exc: SimulatedCrash) -> None:
            m = exc.member
            if m in w.down_until:
                return
            w.faults.kill(m)
            try:
                w.provs[m].stop()
            except Exception:  # noqa: BLE001 - the member is dying
                pass
            # kill -9 semantics for the intent WAL: the in-memory
            # resolution buffer dies with the process; answered-but-
            # unflushed intents must replay and re-resolve
            w.intents[m].lose_unflushed_resolutions()
            w.down_until[m] = step + self.RESTART_DELAY_STEPS
            if w.first_restart_step is None:
                w.first_restart_step = (
                    step + self.RESTART_DELAY_STEPS
                )

        def alive(m: str) -> bool:
            return m not in w.down_until

        for step in range(self.MAX_STEPS):
            # restarts due: revive the endpoint, rebuild over the
            # surviving sqlite, recover (presumed abort / re-drive)
            for m, until in list(w.down_until.items()):
                if step >= until:
                    del w.down_until[m]
                    w.faults.revive(m)
                    w.incarnation[m] += 1
                    w.provs[m] = self._build_provider(w, m)
                    try:
                        w.provs[m].recover()
                    except SimulatedCrash as e:
                        crash(e)
            # submissions due (incl. re-asks after a coordinator died
            # with the answer unresolved — the intent-WAL replay path)
            for sub in subs:
                if sub["outcome"] is not None:
                    continue
                due = sub["due"]
                if due is None:
                    due = (
                        w.first_restart_step + 1
                        if w.first_restart_step is not None
                        else 4
                    )
                if step < due or not alive(sub["coord"]):
                    continue
                if sub["future"] is not None:
                    if sub["inc"] == w.incarnation[sub["coord"]]:
                        continue   # in flight on a live coordinator
                    # the coordinator died holding the answer: the
                    # client re-asks after its retry backoff (a real
                    # client never re-sends instantly), which is also
                    # what lets rival traffic race the recovery window
                    sub["future"] = None
                    sub["retry_at"] = step + 3
                    continue
                if step < sub.get("retry_at", 0):
                    continue
                try:
                    self._submit(w, sub)
                except SimulatedCrash as e:
                    crash(e)
            # delivery window
            delivered = 0
            while delivered < self.DELIVERIES_PER_STEP:
                try:
                    n = w.net.pump(1, chooser)
                except SimulatedCrash as e:
                    crash(e)
                    n = 1
                if not n:
                    break
                delivered += n
            # pump ticks
            for m in self.members:
                if alive(m):
                    try:
                        w.provs[m].tick()
                    except SimulatedCrash as e:
                        crash(e)
            # harvest answers -> resolve intents
            for sub in subs:
                fut = sub["future"]
                if fut is None or not fut.done:
                    continue
                try:
                    fut.result()
                    outcome = ("accept", None)
                except UniquenessConflict as e:
                    outcome = (
                        "reject",
                        tuple(sorted(e.conflict.items())),
                    )
                except ShardUnavailableError as e:
                    outcome = ("unavailable", str(e))
                except Exception as e:  # noqa: BLE001 - recorded
                    outcome = ("error", f"{type(e).__name__}: {e}")
                sub["future"] = None
                if sub["outcome"] is None:
                    sub["outcome"] = outcome
                elif sub["outcome"] != outcome:
                    violations.append(
                        f"tx {sub['tx']} answered twice with different "
                        f"outcomes: {sub['outcome']} then {outcome}"
                    )
                try:
                    self._resolve_intent(w, sub)
                except SimulatedCrash as e:
                    crash(e)
            # quiescence: everything answered, fabric drained, no
            # in-flight coordination, no residual holds, nobody down
            if (
                all(s["outcome"] is not None for s in subs)
                and not w.down_until
                and w.net.deliverable == 0
                and all(
                    w.provs[m].in_flight_count() == 0
                    and w.provs[m].reservation_count() == 0
                    for m in self.members
                )
            ):
                break
            w.clock.advance(self.STEP_MICROS)
        else:
            violations.append(
                f"schedule did not converge in {self.MAX_STEPS} steps"
            )
        violations.extend(self._invariants(w, subs))
        for store in w.stores.values():
            if hasattr(store, "close"):
                store.close()
        sig = hashlib.sha256(
            (
                f"{sched.kind}|{sched.kill_index}|{sched.kill_phase}|"
                + ",".join(map(str, chooser.sig if chooser else ()))
            ).encode()
        ).hexdigest()[:16]
        return ScheduleResult(
            schedule=sched,
            violations=violations,
            fingerprint=sig,
            killed_at=self._kill_member_op,
            steps=step + 1,
            outcomes={
                str(s["tx"]): s["outcome"] for s in subs
            },
        )

    # -- submissions ---------------------------------------------------------

    def _submit(self, w, sub) -> None:
        """Admit through the intent WAL, then drive commit_async — the
        batching notary's durable-intake discipline. A re-ask after a
        coordinator death reuses the surviving WAL row (replay), or
        appends a fresh one when the crash preceded the append."""
        coord = sub["coord"]
        journal = w.intents[coord]
        existing = None
        for seq, stx, _who, _deadline in journal.unresolved():
            if getattr(stx, "id", None) == sub["tx"]:
                existing = seq
                break
        if existing is not None:
            sub["seq"] = existing
        else:
            sub["seq"] = journal.append(
                ExplorerSpend(sub["tx"], tuple(sub["refs"])),
                w.requester, None,
            )
        sub["inc"] = w.incarnation[coord]
        sub["future"] = w.provs[coord].commit_async(
            list(sub["refs"]), sub["tx"], w.requester
        )

    def _resolve_intent(self, w, sub) -> None:
        if sub["seq"] is None:
            return
        journal = w.intents[sub["coord"]]
        journal.mark_resolved(sub["seq"])
        journal.flush_resolved()
        sub["seq"] = None

    # -- invariants ----------------------------------------------------------

    def _invariants(self, w, subs) -> list:
        from ..node.distributed_uniqueness import ShardMap

        v: list = []
        sm = ShardMap(self.members, self.n_partitions)
        refs_of = {s["tx"]: list(s["refs"]) for s in subs}

        # answered-but-unmarked intents (a kill between the answer and
        # the group-commit delete, or a lost resolution buffer):
        # re-mark from the explorer's recorded outcomes — the
        # replay-then-idempotent-answer path a real boot takes — then
        # every WAL must drain to empty
        by_tx = {s["tx"]: s for s in subs}
        for m in self.members:
            journal = w.intents[m]
            for seq, stx, _who, _deadline in journal.unresolved():
                sub = by_tx.get(getattr(stx, "id", None))
                if sub is not None and sub["outcome"] is not None:
                    journal.mark_resolved(seq)
                    journal.flush_resolved()

        def owner_committed(ref):
            owner = sm.owner_of(ref)
            return w.provs[owner].store.committed.get(ref)

        # 1. exactly one stable outcome per submission; nothing
        #    unavailable/errored in a rig where every fault heals
        for sub in subs:
            out = sub["outcome"]
            if out is None:
                v.append(f"tx {sub['tx']} never answered")
            elif out[0] in ("unavailable", "error"):
                v.append(f"tx {sub['tx']} answered {out}")

        # 2. atomic exactly-once: accepted -> every ref committed to
        #    it at its owner; rejected -> none
        for sub in subs:
            out = sub["outcome"]
            if out is None:
                continue
            mine = [
                ref for ref in refs_of[sub["tx"]]
                if owner_committed(ref) == sub["tx"]
            ]
            if out[0] == "accept" and len(mine) != len(refs_of[sub["tx"]]):
                v.append(
                    f"accepted tx {sub['tx']} committed only "
                    f"{len(mine)}/{len(refs_of[sub['tx']])} refs — "
                    "partial commit"
                )
            if out[0] == "reject" and mine:
                v.append(
                    f"rejected tx {sub['tx']} still owns "
                    f"{len(mine)} committed ref(s)"
                )

        # 3. zero orphans / residual durable state
        for m in self.members:
            p = w.provs[m]
            if p.reservation_count() != 0:
                v.append(f"{m}: {p.reservation_count()} residual holds")
            if p.in_flight_count() != 0:
                v.append(f"{m}: {p.in_flight_count()} in-flight txns")
            if p.journal is not None and p.journal.unresolved_count:
                v.append(
                    f"{m}: {p.journal.unresolved_count} coordinator "
                    "WAL row(s) never finished"
                )
            if (
                p.reservations is not None
                and p.reservations.held_count
            ):
                v.append(
                    f"{m}: {p.reservations.held_count} journaled "
                    "reservation row(s) never released"
                )
            if w.intents[m].unresolved_count:
                v.append(
                    f"{m}: {w.intents[m].unresolved_count} intent "
                    "WAL row(s) never resolved"
                )

        # 4. serial replay of the decision log: every accept/reject
        #    must be the decision a serial single-map replay makes at
        #    that point, and committed rows must trace back to logged
        #    or re-driven accepts with accept outcomes
        serial: dict = {}
        for tx_id, conflict in w.decisions:
            refs = refs_of.get(tx_id)
            if refs is None:
                v.append(f"decision log names unknown tx {tx_id}")
                continue
            want = {
                r: serial[r]
                for r in refs
                if r in serial and serial[r] != tx_id
            }
            if conflict is None:
                if want:
                    v.append(
                        f"log accepts {tx_id} where serial replay "
                        f"conflicts on {sorted(want)} — decision order "
                        "broken"
                    )
                else:
                    for r in refs:
                        serial[r] = tx_id
            else:
                if not want:
                    v.append(
                        f"log rejects {tx_id} where serial replay "
                        "accepts — the 'winner' it cites was never a "
                        "serially-visible commit"
                    )
                elif dict(conflict) != want:
                    v.append(
                        f"log conflict set for {tx_id} "
                        f"({dict(conflict)}) != serial ({want})"
                    )
        # serial state vs the merged committed registry (owner view)
        outcomes = {s["tx"]: s["outcome"] for s in subs}
        for ref, tx_id in serial.items():
            if owner_committed(ref) != tx_id:
                v.append(
                    f"serial replay commits {ref} to {tx_id} but the "
                    f"owner holds {owner_committed(ref)}"
                )
        for sub in subs:
            for ref in refs_of[sub["tx"]]:
                got = owner_committed(ref)
                if got is None:
                    continue
                out = outcomes.get(got)
                if got not in outcomes:
                    v.append(f"{ref} committed to unknown tx {got}")
                elif out is None or out[0] != "accept":
                    v.append(
                        f"{ref} committed to {got} whose outcome is "
                        f"{out}"
                    )
        return v


# the explorer's intent payload: the minimal `stx` shape the intent
# WAL journals (id + canonical encode)
from ..core import serialization as _ser  # noqa: E402


@_ser.serializable
@dataclass(frozen=True)
class ExplorerSpend:
    tx_id: object
    refs: tuple

    @property
    def id(self):
        return self.tx_id


def make_broken_provider_cls():
    """The negative pin: a coordinator that ships the first remote
    ShardCommit BEFORE the durable commit mark — inverting the 2PC
    commit point. A kill in that window leaves a participant applying
    a commit the restarted coordinator will presume aborted; the
    explorer's serial-replay invariant must catch the resulting
    decision-order break."""
    from ..node.distributed_uniqueness import (
        DistributedUniquenessProvider,
        ShardCommit,
    )

    class BrokenWalOrderingProvider(DistributedUniquenessProvider):
        def _decide_commit(self, txn):
            remote = sorted(
                {o for _, o, _ in txn.parts if o != self.name}
            )
            if remote and txn.journaled:
                owner = remote[0]
                refs = [
                    r
                    for _, o, rs in txn.parts
                    if o == owner
                    for r in rs
                ]
                # THE BUG: commit visible on the wire before the WAL
                # mark — the exact ordering decide_commit's contract
                # forbids
                self._send(
                    owner,
                    ShardCommit(
                        txn.xid, txn.tx_id, tuple(refs),
                        txn.requester, self.name,
                    ),
                )
            super()._decide_commit(txn)

    return BrokenWalOrderingProvider
