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
- The static half raises NotImplementedError naming ROADMAP Queue 1 #12.
"""

from __future__ import annotations

import importlib
import re

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
STATIC = "the sanitizer's static half over tools/lint (ROADMAP Queue 1 #12)"
LEFT_OUT = {
    "test_static_lock_view_extracts_the_fact_core": STATIC,
    "test_diff_flags_edge_the_static_graph_lacks": STATIC,
    "test_committed_tree_soak_diff_clean_vs_baseline": f"the soak's static diff: {STATIC}",
    "test_split_report_names_pump_hot_locks_with_hold_times": f"the split report: {STATIC}",
    "test_lint_cli_report_split_subprocess": f"the lint CLI: {STATIC}",
    "test_bench_quick_sanitizer_smoke":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}


@pytest.mark.parametrize("name,case", port_cases("test_sanitizer", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    from corda_tpu_torch.utils import locks

    try:
        run_port_case(port_test_module("test_sanitizer"), case, tmp_path)
    finally:
        locks.install_monitor(None)


def test_case_count():
    assert len(port_cases("test_sanitizer", LEFT_OUT)) == 15
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


STATIC_HALF = [
    ("static_lock_view", lambda szr, san: szr.static_lock_view()),
    ("StaticLockView", lambda szr, san: szr.StaticLockView(set(), set(), set(), {}, {})),
    ("SanitizerDiff", lambda szr, san: szr.SanitizerDiff([], [], [], 0, 0)),
    ("ConcurrencySanitizer.diff_static", lambda szr, san: san.diff_static(None)),
    ("ConcurrencySanitizer.split_report", lambda szr, san: san.split_report(None)),
    ("render_split_report", lambda szr, san: szr.render_split_report({})),
]


@pytest.mark.parametrize("name,call", STATIC_HALF, ids=[s[0] for s in STATIC_HALF])
def test_static_half_raises_naming_its_roadmap_item(name, call):
    szr = _szr("corda_tpu_torch")
    with pytest.raises(NotImplementedError, match=re.escape("ROADMAP Queue 1 #12")) as e:
        call(szr, szr.ConcurrencySanitizer())
    assert name in str(e.value)
