"""The device plane (utils/device_telemetry.py) in the port, held against
the reference.

- Every case of the reference's tests/test_device_telemetry.py but
  those in LEFT_OUT runs on the port (test_torch_perf.verifier_port_module:
  imports read as corda_tpu_torch, TpuBatchVerifier as
  CudaBatchVerifier on device="cpu" with its verify functions stubbed).
  Among them: the capacity model naming host_pump with headroom, the
  what_if substitutions, unmeasured resources unbounded, the knob
  parser's errors, the staging copy timed into both ledgers, the
  hbm-pressure, utilization-collapse and fallback-bridge alerts, the
  config knob, and /device and /capacity served by a booted node's
  gateway (a node that verifies on the CPU samples the host as one cpu
  device, as the reference samples its CPU backend), and the fleet's
  device_fault arc telling the telemetry story (testing/fleet.py over a
  CpuBatchVerifier: test_torch_fleet.FLEET_SUBS; the degraded fallback
  it needs runs only off the card, divergence D10).
- Three cases read the device itself and get port-side versions: the
  default sampler lists the card through torch.cuda (and raises where
  there is none, instead of the reference's empty CPU-backend list),
  the live-buffer census reads the caching allocator's active blocks
  instead of walking jax.live_arrays(), and the multi-device dispatch
  attribution pins its two verifiers to `torch.device("cpu", k)` where
  the reference takes two of jax's virtual CPU devices.
- The same TestClock drive (scripted memory stats, dispatches,
  transfers, queue depths, the degraded flag, the wire feed, what_if
  knobs) through both packages' DevicePlane, capacity model and
  HealthMonitor gives byte-equal JSON at every step.
"""

from __future__ import annotations

import importlib
import json

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_fleet import FLEET_SUBS, cpu_fleet_sim  # noqa: E402
from test_torch_perf import BENCH, verifier_port_module  # noqa: E402

LEFT_OUT = {
    "test_bench_quick_device_bounds_overhead_and_names_host_pump": BENCH,
}


def _sampler_memory_stats_absent_not_fatal():
    """Port version: the injected devices degrade as the reference's do;
    the default sampler reads the card through torch.cuda, and raises
    where there is none (the reference lists jax's CPU devices)."""
    import torch

    dlib = importlib.import_module("corda_tpu_torch.utils.device_telemetry")
    fake = device_port_module().FakeDevice

    class Bare:
        id, platform, device_kind = 7, "cpu", "cpu"

    sampler = dlib.DeviceSampler(lambda: [fake(0, platform="cpu", limit=None), Bare()])
    rows = sampler.sample(census=False)
    assert [r["id"] for r in rows] == [0, 7]
    assert all(r["hbm"] is None for r in rows)
    # an injected function that fails samples as no devices
    assert dlib.DeviceSampler(lambda: 1 / 0).sample(census=False) == []

    if torch.cuda.is_available():
        real = dlib.DeviceSampler().sample(census=False)
        assert len(real) == torch.cuda.device_count() >= 1
        assert all(r["platform"] == "gpu" and r["hbm"]["bytes_limit"] > 0 for r in real)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dlib.DeviceSampler().sample(census=False)


def _sampler_live_buffer_census_counts_resident_arrays(monkeypatch):
    """Port version: the census reads the caching allocator's active
    blocks per CUDA device. Without a card the allocator is stood in for
    (one device holding 3 blocks of 1,536 bytes); on a card a resident
    tensor is counted for real."""
    import torch

    dlib = importlib.import_module("corda_tpu_torch.utils.device_telemetry")
    if not torch.cuda.is_available():
        assert dlib.DeviceSampler(lambda: []).live_buffers() == {}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        stats = {0: {"active.all.current": 3, "active_bytes.all.current": 1536}, 1: {}}
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d])
        buffers = dlib.DeviceSampler(lambda: []).live_buffers()
        assert buffers == {0: {"count": 3, "bytes": 1536}}   # device 1 never allocated
        return
    pin = torch.ones((128,), dtype=torch.float32, device="cuda")   # keep one resident
    buffers = dlib.DeviceSampler().live_buffers()
    assert buffers, "no live tensors visible to the census"
    assert sum(row["count"] for row in buffers.values()) >= 1
    assert buffers[pin.device.index]["bytes"] >= pin.numel() * pin.element_size()
    del pin


def _multi_device_dispatch_attribution(monkeypatch):
    """Port version: two verifiers pinned to CPU devices 0 and 1 (the
    sharded notary's per-card path) attribute busy wall, request counts,
    queue wait and transfer to their device rows, and the plane windows
    them into per-device busy fractions and mapped queue depths."""
    import torch

    mod = device_port_module()
    dlib = importlib.import_module("corda_tpu_torch.utils.device_telemetry")
    bv = importlib.import_module("corda_tpu_torch.crypto.batch_verifier")
    devices = [torch.device("cpu", k) for k in range(8)]
    mod._stub_kernels(monkeypatch)
    devacct = dlib.DeviceAccounting()
    dlib.set_device_accounting(devacct)
    try:
        v0 = bv.CudaBatchVerifier(batch_sizes=(4,), device=devices[0])
        v1 = bv.CudaBatchVerifier(batch_sizes=(4,), device=devices[1])
        assert all(v0.verify_batch(mod._p256_requests(3)))
        for _ in range(3):
            assert all(v1.verify_batch(mod._p256_requests(4)))
    finally:
        dlib.set_device_accounting(None)
    snap = devacct.snapshot()["devices"]
    d0, d1 = devices[0].index, devices[1].index
    assert snap[d0]["dispatches"] == 1 and snap[d0]["requests"] == 3
    assert snap[d1]["dispatches"] == 3 and snap[d1]["requests"] == 12
    for did in (d0, d1):
        assert snap[did]["busy_seconds"] > 0
        assert snap[did]["queue_wait_seconds"] > 0
        assert snap[did]["transfer_bytes"] > 0
        assert snap[did]["transfer_seconds"] > 0

    clock = mod.TestClock()
    plane = dlib.DevicePlane(
        clock=clock,
        policy=dlib.DevicePolicy(sample_gap_micros=0, live_buffer_census=False),
        sampler=dlib.DeviceSampler(lambda: [dlib.HostDevice(d.index) for d in devices[:2]]),
        accounting=devacct,
    )
    depths = {d0: 5, d1: 11}
    plane.attach_queues([lambda: depths[d0], lambda: depths[d1]], [d0, d1])
    plane.tick()
    clock.advance(1_000_000)
    devacct.record_dispatch(d1, 4, 0.25, 0.001)   # busy inside window
    plane.tick()
    assert plane.queue_depth(d0) == 5
    assert plane.queue_depth(d1) == 11
    assert plane.backlog() == 16
    body = plane.snapshot()
    rows = {r["id"]: r for r in body["devices"]}
    assert rows[d1]["busy_fraction"] == pytest.approx(0.25, rel=0.05)
    assert rows[d1]["busy_fraction"] > rows[d0]["busy_fraction"]
    assert rows[d1]["dispatch_totals"]["requests"] == 16


PORT_CASES = {
    "test_multi_device_dispatch_attribution": _multi_device_dispatch_attribution,
    "test_sampler_memory_stats_absent_not_fatal": _sampler_memory_stats_absent_not_fatal,
    "test_sampler_live_buffer_census_counts_resident_arrays":
        _sampler_live_buffer_census_counts_resident_arrays,
}


def device_port_module():
    return verifier_port_module("test_device_telemetry", subs=FLEET_SUBS,
                                _fleet_sim=cpu_fleet_sim, **PORT_CASES)


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


@pytest.mark.parametrize("name,case", port_cases("test_device_telemetry", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path, monkeypatch):
    run_port_case(device_port_module(), case, tmp_path, monkeypatch=monkeypatch)


def test_case_count():
    assert len(port_cases("test_device_telemetry", LEFT_OUT)) == 16
    ref = vars(importlib.import_module("tests.test_device_telemetry"))
    assert set(LEFT_OUT) <= set(ref) and set(PORT_CASES) <= set(ref)


class _Dev:
    """A device row with scripted memory stats (either package reads it)."""

    def __init__(self, did, limit):
        self.id, self.platform, self.device_kind = did, "gpu", "scripted"
        self.limit, self.in_use = limit, 0

    def memory_stats(self):
        return {"bytes_in_use": self.in_use, "peak_bytes_in_use": self.in_use,
                "bytes_limit": self.limit}


WHAT_IFS = ("", "shards:8", "devices:4", "device_us_per_tx:2000",
            "transfer_bytes_per_sec:1000000,transfer_bytes_per_tx:1000", "wire_us_per_tx:2.5",
            "pump_us_per_tx:10,commit_us_per_tx:3")


def _device_drive(prefix: str) -> list:
    dlib, plib = _m(prefix, "utils.device_telemetry"), _m(prefix, "utils.perf")
    hlib = _m(prefix, "utils.health")
    clock = _m(prefix, "node.services").TestClock()
    metrics = _m(prefix, "utils.metrics").MetricRegistry()
    perf = plib.PerfPlane(clock=clock, metrics=metrics, install_default_kernels=False,
                          policy=plib.PerfPolicy(sample_gap_micros=0))
    devs = [_Dev(0, 80 * 2**30), _Dev(1, 16 * 2**30)]
    acct = dlib.DeviceAccounting()
    plane = dlib.DevicePlane(
        clock=clock, metrics=metrics, perf=perf, accounting=acct,
        policy=dlib.DevicePolicy(sample_gap_micros=0, window_micros=5_000_000,
                                 live_buffer_census=False),
        sampler=dlib.DeviceSampler(lambda: list(devs)),
    )
    monitor = hlib.HealthMonitor(clock=clock, metrics=metrics, policy=hlib.HealthPolicy(
        alert_for_micros=1_000_000, alert_clear_for_micros=1_000_000))
    monitor.watch_device(plane)
    depth = {"q0": 0, "q1": 0}
    plane.attach_queues([lambda: depth["q0"], lambda: depth["q1"]], [0, None])
    degraded = {"on": False}
    plane.watch_fallback(lambda: degraded["on"], lambda: {"error": "DeviceFaultError: x"})
    wire = {"s": None}
    plane.set_wire_feed(lambda: wire["s"])
    served = metrics.counter("Notary.RequestsBatched")
    perf.watch_rate("batching_notary_notarisations_per_sec", lambda: served.count)
    out = []
    for step in range(30):
        clock.advance(500_000)
        devs[0].in_use = int(devs[0].limit * (0.95 if 8 <= step < 16 else 0.2))
        devs[1].in_use = 2**20 * step
        if step < 6 or step >= 20:        # the pump feeds the card ...
            acct.record_dispatch(0, 4096, 0.3 + 0.01 * (step % 4), 0.002 * (step % 3))
            acct.record_transfer(0, 655_360, 0.0004)
            served.inc(4000)
            depth["q0"] = max(0, depth["q0"] - 512)
        else:                             # ... then starves it while the backlog grows
            depth["q0"] += 128
        depth["q1"] = step % 5
        degraded["on"] = 17 <= step < 19
        wire["s"] = 0.05 * step if step else None
        for phase, secs in (("stage", 0.02), ("dispatch", 0.01), ("resolve_verify", 0.005),
                            ("commit", 0.004), ("stream_commit", 0.2)):
            metrics.timer(f"Notary.FlushPhase.{phase}").update(secs)
        perf.tick()
        plane.tick()
        monitor.tick()
        out.append(json.dumps([plane.snapshot(), plane.capacity(), monitor.snapshot(),
                               plane.busy_fraction_max(), plane.backlog_window()],
                              sort_keys=True, default=str))
    for text in WHAT_IFS:
        knobs = dlib.parse_what_if(text)
        out.append(json.dumps([knobs, plane.capacity(knobs)], sort_keys=True))
    for bad in ("warp:9", "shards:many", "shards:0", "shards"):
        try:
            dlib.parse_what_if(bad)
        except ValueError as e:
            out.append(str(e))
    synth = {"pump_seconds_per_tx": 24e-6, "commit_seconds_per_tx": 4e-6,
             "device_seconds_per_tx": 2e-6, "device_count": 1,
             "transfer_bytes_per_tx": 160.0, "transfer_bytes_per_sec": 50e6,
             "current_per_sec": 30_000.0}
    for extra in ({}, {"lock_hold_seconds_per_tx": 60e-6}, {"wire_seconds_per_tx": 40e-6}):
        out.append(json.dumps(dlib.capacity_model({**synth, **extra}), sort_keys=True))
    return out


def test_device_drive_equals_the_references():
    ref = _device_drive("corda_tpu")
    port = _device_drive("corda_tpu_torch")
    for step, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {step}"
    assert len(ref) == len(port) == 30 + len(WHAT_IFS) + 4 + 3
    joined = "".join(ref[:30])
    # the drive reached every rule and both named constraints
    for alert in ("device.hbm_pressure", "device.fallback_active",
                  "device.utilization_collapse"):
        i = joined.index(f'"{alert}"')
        assert '"fire_count": 1' in joined[i:] or '"fire_count": 2' in joined[i:]
    assert '"binding_constraint": "device_compute"' in joined
    assert '"binding_constraint": "transfer"' in "".join(ref[30:])
