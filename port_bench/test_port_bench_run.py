"""A run end to end on the CPU: the result line's keys, `correct` for the
program, and `correct` false for the control and for each fault a cell
can have. The test marked `gpu` runs the command itself on a card."""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time

import pytest

from port_bench import check, spec
from port_bench import run as runner

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def small(cell: str, **traffic) -> spec.Cell:
    c = spec.cell(cell)
    t = {**c.traffic, "rows_per_call": 24, "distinct_rows": 48, "call_layouts": 3, **traffic}
    return dataclasses.replace(c, traffic=t)


def run(cell: str, make_verifier, trace=False, seconds=0.3, seed=2**35 + 1, **traffic):
    return runner.run_cell(cell, seed, seconds, trace, device="cpu", cell=small(cell, **traffic),
                           make_verifier=lambda k: make_verifier(), t_start=time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_exactly_the_contract_s_keys(trace):
    result, numbers = run("mixed3.call1024", check.ReferenceVerifier, trace=trace)
    keys = KEYS[:-1] + (["breakdown"] if trace else []) + ["check"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 24
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "submit_ms_per_call" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"verifies_per_s", "call_p95_ms", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["check"]) == {"mismatched_rows", "unanswered_rows", "failed_rows",
                                    "calls_checked"}
    json.dumps(result)


@pytest.mark.parametrize("fault", check.Faulty.FAULTS)
@pytest.mark.parametrize("cell", ["p256.call1024", "mixed3.call1024"])
def test_each_fault_comes_out_not_correct(cell, fault):
    """The harness's look for a chip skipped, the rest of a run driven
    with the timed path broken underneath: a stale answer (state left
    unchanged), half of each call answered from the other half, one
    answer flipped where it is produced."""
    result, numbers = run(cell, lambda: check.Faulty(check.ReferenceVerifier(), fault))
    assert result["correct"] is False
    assert numbers["mismatched_rows"] > 0


def test_an_unanswered_row_and_a_failed_call_are_not_correct():
    class Short(check.ReferenceVerifier):
        def verify_batch_async(self, requests):
            done = super().verify_batch_async(requests)
            done.answers = done.answers[:-1]
            return done

    class Long(check.ReferenceVerifier):
        def verify_batch_async(self, requests):
            done = super().verify_batch_async(requests)
            done.answers = done.answers + done.answers[:1]
            return done

    class Raises(check.ReferenceVerifier):
        """Sound through the warm-up, then every call raises."""
        calls = 0

        def verify_batch_async(self, requests):
            self.calls += 1
            if self.calls > runner.WARM_ROUNDS * 2:
                raise RuntimeError("device fault")
            return super().verify_batch_async(requests)

    for answers_off_by_one in (Short, Long):
        result, numbers = run("p256.call1024", answers_off_by_one)
        assert not result["correct"] and numbers["unanswered_rows"] > 0
        assert numbers["mismatched_rows"] == 0
    result, numbers = run("p256.call1024", Raises)
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("cell", ["p256.call1024", "mixed3.call1024"])
def test_the_control_comes_out_not_correct(cell):
    """The control at a size a test holds: the reference in the
    program's place, its verdicts memoised by (key, signature)."""
    result, numbers = run(cell, check.MemoControl, rows_per_call=64, distinct_rows=64)
    assert result["correct"] is False
    assert numbers["mismatched_rows"] >= 1


def test_the_program_on_the_cpu_is_correct():
    """corda_tpu_torch's CudaBatchVerifier on the CPU (its plain torch
    versions) through the whole harness, one small call at a time."""
    c = spec.cell("mixed3.call1024")
    cell = dataclasses.replace(
        c, config={**c.config, "batch_sizes": [8]},
        traffic={**c.traffic, "rows_per_call": 12, "distinct_rows": 24, "call_layouts": 2,
                 "in_flight": 1})
    result, numbers = runner.run_cell("mixed3.call1024", 2**40 + 3, 0.05, False, device="cpu",
                                      cell=cell, t_start=time.perf_counter())
    assert result["correct"] is True, numbers
    assert numbers["calls_checked"] >= 1


def test_without_a_card_it_prints_no_result(tmp_path):
    """Here there is no card: the command exits non-zero and prints no
    line on standard output. On a card, a directory with only the
    benchmark's files fails the same way (test_on_the_card)."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: test_on_the_card covers this")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "p256.call1024",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def _bench_only_copy(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.mark.gpu
def test_on_the_card(tmp_path):
    """The command as the driver runs it, on a card: a short traced and
    untraced run of the smallest cell, and a directory holding only the
    benchmark's files, which must fail."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in ("0", "1"):
        p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "p256.call1024",
                            "--seed", str(2**33 + 17), "--seconds", "2", "--trace", trace],
                           cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        result = json.loads(p.stdout.strip().splitlines()[-1])
        assert result["correct"] is True and result["device"]["platform"] == "gpu"
        assert list(result)[-1] == "check"
    bare = _bench_only_copy(tmp_path)
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "p256.call1024",
                        "--seed", "3", "--seconds", "1", "--trace", "0"],
                       cwd=bare, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_several_callers_each_keep_their_calls_in_flight():
    result, numbers = run("p256.call1024", check.ReferenceVerifier, callers=3, in_flight=2)
    assert result["correct"] is True
    assert numbers["calls_checked"] >= 3
