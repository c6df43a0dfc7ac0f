"""The perf plane (utils/perf.py) and its seams in the port, held against
the reference.

- Every case of the reference's tests/test_perf.py but those in
  LEFT_OUT runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module), GET /perf and /profile through
  the port's gateway among them. The reference's
  TpuBatchVerifier is the port's CudaBatchVerifier on device="cpu",
  and its `_stub_kernels` (an
  accept-all `TpuBatchVerifier._kernel`) becomes a stub of the
  verify functions CudaBatchVerifier dispatches to, so the seam
  (staging, buckets, the kernel and device ledgers) runs for real.
  Among the cases: the profiler's folded stacks and its own overhead,
  the first-call-vs-execute split with retraces after warm-up, the
  retrace and skew alerts, the notary's attach_perf feeding the skew
  window, the wave overlap and the history key, the baseline diff, and
  the ingest pipeline's perf= hook (its `frame_cache_size=0` dropped:
  the port's frame cache is a module constant, and the case's fresh
  pipeline misses it anyway).
- The same TestClock drive (kernel records, waves, ingest batches,
  rates, ticks, a baseline record) through both packages' PerfPlane
  and HealthMonitor gives byte-equal snapshot JSON at every step.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

BENCH = "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)"
LEFT_OUT = {
    "test_bench_quick_perf_bounds_overhead_and_counts_retrace": BENCH,
}


def _cpu_verifier_class():
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    class CudaBatchVerifierOnTheCpu(CudaBatchVerifier):
        """The reference cases' TpuBatchVerifier: the port's verifier on
        device="cpu" (its plain torch versions), with the reference's
        keywords."""

        def __init__(self, batch_sizes=(128, 1024, 4096), perf=None):
            super().__init__(batch_sizes=batch_sizes, device="cpu", perf=perf)

    return CudaBatchVerifierOnTheCpu


def stub_kernels(monkeypatch) -> None:
    """The port's `_stub_kernels`: CudaBatchVerifier's verify functions
    accept every row of the chunk they are given."""
    import torch

    from corda_tpu_torch.crypto import batch_verifier as bv

    def accept(*args, windowed=None):
        packed = next(a for a in args if isinstance(a, torch.Tensor))
        return torch.ones(packed.shape[0], dtype=torch.bool)

    monkeypatch.setattr(bv, "ecdsa_verify_packed", accept)
    monkeypatch.setattr(bv, "ed25519_verify_packed", accept)


def verifier_port_module(name: str, subs=(), **overrides) -> types.ModuleType:
    """tests/<name>.py on the port (test_torch_health.port_test_module),
    with its TpuBatchVerifier read as the port's verifier on the CPU and
    its `_stub_kernels` the port's."""
    return port_test_module(name, subs=(*subs, ("TpuBatchVerifier", "CudaBatchVerifier")),
                            CudaBatchVerifier=_cpu_verifier_class(),
                            _stub_kernels=stub_kernels, **overrides)


def perf_port_module() -> types.ModuleType:
    return verifier_port_module(
        "test_perf",
        subs=[("IngestPipeline(perf=plane, frame_cache_size=0)", "IngestPipeline(perf=plane)")],
    )


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


@pytest.mark.parametrize("name,case", port_cases("test_perf", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path, monkeypatch):
    run_port_case(perf_port_module(), case, tmp_path, monkeypatch=monkeypatch)


def test_case_count():
    assert len(port_cases("test_perf", LEFT_OUT)) == 17
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_perf")))


def _baseline(tmp_path) -> str:
    """A benchmark record in the capture shape parse_bench_record reads."""
    path = tmp_path / "baseline.json"
    tail = [json.dumps({"metric": "batching_notary_notarisations_per_sec", "value": 900.0}),
            json.dumps({"metric": "wire_ingest_pipelined_per_sec", "value": 150.0}),
            "a line that is not JSON"]
    path.write_text(json.dumps({"rc": 0, "tail": "\n".join(tail),
                                "parsed": {"metric": "never_recorded", "value": 1.0}}))
    return str(path)


def _perf_drive(prefix: str, baseline: str) -> list:
    plib, hlib = _m(prefix, "utils.perf"), _m(prefix, "utils.health")
    clock = _m(prefix, "node.services").TestClock()
    metrics = _m(prefix, "utils.metrics").MetricRegistry()
    plane = plib.PerfPlane(
        clock=clock, metrics=metrics,
        policy=plib.PerfPolicy(sample_gap_micros=0, retrace_warmup_micros=3_000_000,
                               skew_window_micros=4_000_000, skew_min_requests=8,
                               history_window=8),
        baseline_path=baseline, install_default_kernels=False,
    )
    monitor = hlib.HealthMonitor(clock=clock, metrics=metrics, policy=hlib.HealthPolicy(
        alert_for_micros=0, alert_clear_for_micros=0))
    monitor.watch_perf(plane)
    depth = [0, 0, 0, 0]
    plane.attach_shards(4, [lambda k=k: depth[k] for k in range(4)])
    served = {"n": 0}
    plane.watch_rate("batching_notary_notarisations_per_sec", lambda: served["n"])
    plane.watch_value("queue_depth", lambda: float(sum(depth)))
    snaps = []
    for step in range(24):
        clock.advance(500_000)
        batch = 4096 if step in (0, 9) else 128
        plane.kernels.record_call(3, batch, 0.002 * (step % 5 + 1), first=step in (0, 1, 9),
                                  transfer_bytes=160 * batch)
        plane.kernels.record_transfer(4, 1024, 128 * 1024, 0.0005 * (step % 3 + 1))
        hot = 6 <= step < 12          # one shard carries the load for a while
        wave = []
        for k in range(4):
            n = (40 if k == 2 else 0) if hot else 10
            t = step + 0.01 * k
            marks = [("stage", t, t + 0.001 * (k + 1)), ("dispatch", t + 0.004, t + 0.005),
                     ("link_wait", t + 0.005, t + 0.005 + 0.002 * (step % 3)),
                     ("commit", t + 0.011, t + 0.012)]
            wave.append((k, n, marks if n else []))
        plane.observe_wave(wave)
        plane.observe_ingest(64, 0.01, 0.002 * (step % 4), 0.003)
        for phase, secs in (("stage", 0.01), ("dispatch", 0.002), ("commit", 0.004)):
            metrics.timer(f"Notary.FlushPhase.{phase}").update(secs * (1 + step % 2))
        served["n"] += 400 + 40 * (step % 3)
        depth[step % 4] = step
        plane.tick()
        monitor.tick()
        snaps.append(json.dumps([plane.snapshot(), monitor.snapshot()], sort_keys=True,
                                default=str))
    snaps.append(json.dumps([plane.baseline_diff(), plib.parse_bench_record(baseline),
                             plane.collapsed_profile()], sort_keys=True))
    return snaps


def test_perf_drive_equals_the_references(tmp_path):
    baseline = _baseline(tmp_path)
    ref = _perf_drive("corda_tpu", baseline)
    port = _perf_drive("corda_tpu_torch", baseline)
    for step, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {step}"
    assert len(ref) == len(port) == 25
    # the drive reached what it is for: retraces after warm-up, the skew
    # alert firing on the hot shard, and the baseline rows
    assert '"retraces": 1' in ref[10] and '"perf.shard_skew"' in ref[8]
    assert '"state": "firing"' in ref[8] and '"regressed"' in ref[-1]
