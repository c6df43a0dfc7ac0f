"""The runtime concurrency sanitizer and the crash-schedule explorer
(testing/sanitizer.py) and the instrumented lock factory
(utils/locks.py) in the port, held against the reference.

- Every case of the reference's tests/test_sanitizer.py but those in
  LEFT_OUT runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module; its autouse disarm runs after
  each): the raw passthrough while disarmed, the seeded lock-order
  inversion and hold-time hazard, the self-deadlock raised instead of
  hung, contention and wait times, the three condition-variable cases,
  the JSON export, the baseline write round trip, and the four explorer
  cases (every journal boundary traced, 100+ schedules with zero
  violations, the broken WAL ordering caught, determinism).
- Cross-package: for one seed, the explorer's traced boundaries and,
  per schedule, its fingerprint, outcomes, kill point, step count and
  violations equal the reference's.
- The armed standard soak over the port's sharded batching notary with
  worker threads observes the lock names the reference's soak does, with
  no inversion and no self-deadlock.
- The static half: the reference's four static cases run on the port
  against its own tree and its own baseline (the fact core's lock
  identities and a known ordering, the edge the static graph lacks
  flagged and gated, the committed tree's soak diff clean against
  SANITIZER_BASELINE_TORCH.json, the split report's pump-hot locks).
  Source changes, in SUBS: the soak verifies on a CpuBatchVerifier (the
  port's soak defaults to the card) and the baseline is the port's; the
  module fixtures `view` and `soaked` are built once, as in the
  reference. The lint CLI's case stays out: `python -m tools.lint`
  walks the reference's tree.
- Each of the six static-half functions, run in both packages over
  each package's own tree, gives equal results once `corda_tpu/` and
  `corda_tpu_torch/` are read alike, but for the differences
  STATIC_DIFFERENCES names with their causes.
"""

from __future__ import annotations

import importlib
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_fleet import _once  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_lint_cli_report_split_subprocess":
        "the lint CLI (`python -m tools.lint --report split`), which walks "
        "and imports the reference's tree",
    "test_bench_quick_sanitizer_smoke":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}


SUBS = (
    ("        out = szr.standard_soak()\n",
     "        from corda_tpu.crypto.batch_verifier import CpuBatchVerifier\n\n"
     "        out = szr.standard_soak(batch_verifier=CpuBatchVerifier())\n"),
    ('"SANITIZER_BASELINE.json"', '"SANITIZER_BASELINE_TORCH.json"'),
)


def sanitizer_port_module():
    mod = port_test_module("test_sanitizer", subs=SUBS)
    if not getattr(mod, "_fixtures_once", False):
        for name in ("view", "soaked"):
            setattr(mod, name, _once(getattr(mod, name)))
        mod._fixtures_once = True
    return mod


@pytest.mark.parametrize("name,case", port_cases("test_sanitizer", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    from corda_tpu_torch.utils import locks

    try:
        run_port_case(sanitizer_port_module(), case, tmp_path)
    finally:
        locks.install_monitor(None)


def test_case_count():
    assert len(port_cases("test_sanitizer", LEFT_OUT)) == 19
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_sanitizer")))


def _szr(prefix: str):
    return importlib.import_module(f"{prefix}.testing.sanitizer")


def _explore(prefix: str, seed: int) -> dict:
    szr = _szr(prefix)
    ex = szr.CrashScheduleExplorer(seed=seed)
    scheds = ex.schedules(reorder_seeds=4)
    picked = scheds[::7] + scheds[-4:]
    runs = []
    for sched in picked:
        r = ex.run_schedule(sched)
        runs.append((sched.label, r.fingerprint, repr(sorted(r.outcomes.items())),
                     r.killed_at, r.steps, r.violations))
    return {"trace": ex.trace_boundaries(), "runs": runs}


@pytest.mark.parametrize("seed", [0, 5])
def test_explorer_schedules_equal_the_references(seed):
    ref, port = (_explore(p, seed) for p in PACKAGES)
    assert port["trace"] == ref["trace"]
    assert len(port["runs"]) == len(ref["runs"]) >= 10
    for r, p in zip(ref["runs"], port["runs"]):
        assert p == r, r[0]
    assert all(not run[-1] for run in ref["runs"])


def _soak(prefix: str) -> tuple:
    szr = _szr(prefix)
    bv = importlib.import_module(f"{prefix}.crypto.batch_verifier")
    san = szr.ConcurrencySanitizer()
    try:
        with san:
            kw = {"batch_verifier": bv.CpuBatchVerifier()} if prefix != "corda_tpu" else {}
            out = szr.standard_soak(**kw)
    finally:
        importlib.import_module(f"{prefix}.utils.locks").install_monitor(None)
    return san, out


def test_armed_soak_observes_the_references_locks():
    """The standard soak on a CPU verifier in both packages: the same
    answers, the same lock names observed, no lock-order inversion or
    self-deadlock, and shard worker threads among the holders."""
    (r_san, r_out), (p_san, p_out) = (_soak(p) for p in PACKAGES)
    assert p_out == r_out and p_out["signed"] >= 1 and p_out["rejected"] >= 1
    assert set(p_san.lock_stats()) == set(r_san.lock_stats())
    gated = ("sanitizer-lock-cycle", "sanitizer-self-deadlock")
    assert p_san.findings(gated) == [] and r_san.findings(gated) == []
    assert any(t.startswith("notary-shard") for st in p_san.lock_stats().values()
               for t in st["threads"])



ROOT = str(Path(__file__).resolve().parents[1])
_BY_RUN_CHUNK = (
    "port only: acquired under CudaBatchVerifier._run_chunk, which records "
    "each chunk into the process kernel and device ledgers and which the "
    "fact core takes for a serving-loop root by its name; the reference "
    "records in TpuBatchVerifier._dispatch, which is no root"
)
# (kind, lock) -> cause: every way the port's static view differs from
# the reference's
STATIC_DIFFERENCES = {
    ("lock", "?._cache_initialized_mutex"):
        "reference only: utils/jaxenv.py's JAX compile-cache mutex (the "
        "port has no JAX; its kernel store is crypto/aot_store.py)",
    ("lock", "__init__._LOCK"):
        "port only: native/__init__.py loads the native codec at its first "
        "use under a lock, from the codec's decode in fabric handlers, shard "
        "workers and the ingest thread; the reference's loads at import",
    ("lock", "build._LOCK"):
        "port only: crypto/build.py's table of nvcc-built kernel libraries",
    ("lock", "cuda_ec._COUNT_LOCK"):
        "port only: crypto/cuda_ec.py's launch counters, taken by shard "
        "workers launching on several cards at once",
    ("hot", "?._cache_initialized_mutex"): "reference only, as its lock",
    ("hot", "__init__._LOCK"): "port only, as its lock",
    ("hot", "DeviceAccounting._lock"): _BY_RUN_CHUNK,
    ("hot", "KernelAccounting._lock"): _BY_RUN_CHUNK,
    ("hot", "device_telemetry._default_devices_lock"): _BY_RUN_CHUNK,
    ("hot", "perf._default_kernels_lock"): _BY_RUN_CHUNK,
}


def _views() -> dict:
    return {p: _szr(p).static_lock_view(ROOT) for p in PACKAGES}


def _plain(x):
    """Sets sorted, package paths read alike, so the two packages'
    results compare."""
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in sorted(x.items(), key=repr)}
    if isinstance(x, (set, frozenset)):
        return sorted((_plain(v) for v in x), key=repr)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, str):
        return x.replace("corda_tpu_torch/", "corda_tpu/").replace("corda_tpu_torch.", "corda_tpu.")
    return x


def _named(kind: str, ref: set, port: set) -> None:
    """`ref` and `port` differ in exactly the (kind, lock) rows of
    STATIC_DIFFERENCES."""
    got = {(kind, x) for x in (ref ^ port)}
    want = {k for k in STATIC_DIFFERENCES if k[0] == kind}
    assert got == want, sorted(got ^ want)


def _static_lock_view() -> None:
    v = _views()
    ref, port = v["corda_tpu"], v["corda_tpu_torch"]
    _named("lock", ref.locks, port.locks)
    _named("hot", ref.hot_locks, port.hot_locks)
    assert _plain(port.edges) == _plain(ref.edges) and ref.edges
    shared = ref.locks & port.locks
    assert {k: port.kinds[k] for k in shared} == {k: ref.kinds[k] for k in shared}
    assert _plain({k: g for k, g in port.groups.items() if k in shared}) == \
        _plain({k: g for k, g in ref.groups.items() if k in shared})
    assert len(shared) >= 50


def _static_lock_view_class() -> None:
    got = {}
    for p in PACKAGES:
        view = _szr(p).StaticLockView({("A", "B")}, {"A", "B"}, {"A"}, {"A": {"pump"}},
                                      {"A": "RLock"})
        got[p] = _plain(vars(view))
    assert got["corda_tpu_torch"] == got["corda_tpu"]


def _sanitizer_diff() -> None:
    got = {}
    for p in PACKAGES:
        d = _szr(p).SanitizerDiff([], [("A", "B")], ["X"], 3, 4)
        got[p] = (d.coverage, d.findings(), _plain(vars(d)))
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert got["corda_tpu"][0] == 0.75


def _drive(p: str, view, hot=()):
    """An armed drive: one statically proven ordering, one the static
    graph lacks (a callback table), and a lock held from two threads."""
    szr, locks = _szr(p), importlib.import_module(f"{p}.utils.locks")
    san = szr.ConcurrencySanitizer(hot_locks=set(hot))
    try:
        with san:
            qos, reg = locks.make_lock("NotaryQos._lock"), locks.make_lock("MetricRegistry._lock")
            a, b = locks.make_lock("Dyn.a"), locks.make_lock("Dyn.b")
            acct = locks.make_lock("KernelAccounting._lock")
            with qos:
                with reg:
                    pass
            def hold(lock):
                with lock:
                    pass

            table = {"cb": lambda: hold(b)}
            with a:
                table["cb"]()
            t = threading.Thread(target=hold, args=(acct,), name="notary-shard-0")
            t.start()
            t.join()
            with acct:
                pass
    finally:
        locks.install_monitor(None)
    return san


def _diff_static() -> None:
    got = {}
    for p, view in _views().items():
        d = _drive(p, view).diff_static(view)
        got[p] = ([(f.fingerprint, f.rule, f.detail) for f in d.findings()],
                  _plain(d.unexercised_edges), d.unknown_locks, d.observed_edge_count,
                  d.static_edge_count)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    findings, _, unknown, observed, _ = got["corda_tpu"]
    assert [f[2] for f in findings] == ["Dyn.a->Dyn.b"] and unknown == ["Dyn.a", "Dyn.b"]
    assert observed == 2


def _split_rows(report: dict) -> dict:
    return {r["lock"]: {k: r[k] for k in ("kind", "pump_hot", "static_groups",
                                          "runtime_groups", "acquisitions")}
            for r in report["shared_locks"]}


def _split_report() -> None:
    got = {}
    for p, view in _views().items():
        report = _drive(p, view, view.hot_locks).split_report(view)
        got[p] = (_plain(_split_rows(report)), report["observed_locks"], report["static_locks"])
    ref, port = got["corda_tpu"], got["corda_tpu_torch"]
    assert set(port[0]) == set(ref[0]) >= {"KernelAccounting._lock", "NotaryQos._lock"}
    for lock, row in ref[0].items():
        if row["pump_hot"] != port[0][lock]["pump_hot"]:
            assert ("hot", lock) in STATIC_DIFFERENCES, lock
            row = dict(row, pump_hot=port[0][lock]["pump_hot"])
        assert port[0][lock] == row, lock
    # the lock held from a shard worker and the pump
    assert ref[0]["KernelAccounting._lock"]["runtime_groups"] == ["pump", "shard-flush"]
    assert port[0]["KernelAccounting._lock"]["pump_hot"] is True
    assert port[1] == ref[1] == 5
    # the port's static locks: the reference's, less the JAX mutex, plus
    # the port-only rows of STATIC_DIFFERENCES
    port_only = sum(1 for kind, _ in STATIC_DIFFERENCES if kind == "lock") - 1
    assert (ref[2], port[2]) == (54, 54 - 1 + port_only) == (54, 56)


def _render_split_report() -> None:
    report = {
        "observed_locks": 3, "static_locks": 9,
        "pump_hot": [{"lock": "NodeDatabase._lock", "acquisitions": 4, "contended": 1,
                      "hold_us_mean": 12, "hold_us_max": 30, "hold_us_total": 48}],
        "shared_locks": [{"lock": "NodeDatabase._lock", "kind": "RLock",
                          "static_groups": ["pump"], "runtime_groups": ["shard-flush"],
                          "contention_ratio": 0.25, "hold_us_total": 48, "pump_hot": True},
                         {"lock": "Tracer._lock", "kind": "Lock", "static_groups": [],
                          "runtime_groups": [], "contention_ratio": 0.0,
                          "hold_us_total": 0, "pump_hot": False}],
    }
    ref, port = (_szr(p).render_split_report(report) for p in PACKAGES)
    assert port == ref and "PUMP-HOT" in ref
    empty = dict(report, pump_hot=[])
    assert _szr("corda_tpu_torch").render_split_report(empty) == \
        _szr("corda_tpu").render_split_report(empty)


STATIC_HALF = [
    ("static_lock_view", _static_lock_view),
    ("StaticLockView", _static_lock_view_class),
    ("SanitizerDiff", _sanitizer_diff),
    ("ConcurrencySanitizer.diff_static", _diff_static),
    ("ConcurrencySanitizer.split_report", _split_report),
    ("render_split_report", _render_split_report),
]


@pytest.mark.parametrize("name,check", STATIC_HALF, ids=[s[0] for s in STATIC_HALF])
def test_static_half_equals_the_references(name, check):
    check()
