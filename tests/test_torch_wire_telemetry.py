"""The wire plane (utils/wire_telemetry.py) and the fabrics' telemetry
seams in the port, held against the reference.

- Every case of the reference's tests/test_wire_telemetry.py but those
  in LEFT_OUT runs on the port (test_torch_health.port_test_module: its
  imports read as corda_tpu_torch). Among them: per-link accounting, the
  codec split native vs Python, the journal's exact sums beside its
  sampled reservoirs, redelivery and dedupe counters, the plane's
  windows and depths, the in-memory fabric's seam and its bounded dedupe
  table, the journal-growth, backlog and gateway-saturation alerts, the
  capacity model naming `wire`, the what_if wire knob, the device
  plane's wire feed, the config knobs, and GET /wire through the port's
  gateway accounting every request it served.
- Every case of tests/test_wire_link_accounting.py runs on the port the
  same way: two real processes over TCP, a redelivery cycle under
  injected faults reconciled in both planes' books, the durable dedupe
  table pinned by the watermark prune, and the redelivery counter
  against the fault log (the TCP fabric's seam, node/fabric.py).
- The same TestClock drive (frames, codec and journal records,
  redeliveries, dedupe hits, gateway requests, scripted depths, ticks)
  through both packages' WirePlane and HealthMonitor gives byte-equal
  snapshot JSON at every step.
- A booted node's wire plane records its own RPC frames over TCP.
"""

from __future__ import annotations

import importlib
import json
import time

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_perf import BENCH  # noqa: E402

LEFT_OUT = {
    "test_bench_quick_wire_bounds_overhead_and_accounts_gateway": BENCH,
}


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


@pytest.mark.parametrize("name,case", port_cases("test_wire_telemetry", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path, monkeypatch, caplog):
    run_port_case(port_test_module("test_wire_telemetry"), case, tmp_path,
                  monkeypatch=monkeypatch, caplog=caplog)


@pytest.mark.parametrize("name,case", port_cases("test_wire_link_accounting", {}))
def test_link_accounting_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_wire_link_accounting"), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_wire_telemetry", LEFT_OUT)) == 23
    assert len(port_cases("test_wire_link_accounting", {})) == 3
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_wire_telemetry")))


class _Fabric:
    def __init__(self):
        self.telemetry = None
        self.depths = {"journal_depth": 0, "dedupe_depth": 0, "backlog": {}}

    def wire_depths(self):
        return dict(self.depths)


def _wire_drive(prefix: str) -> list:
    wlib, hlib = _m(prefix, "utils.wire_telemetry"), _m(prefix, "utils.health")
    clock = _m(prefix, "node.services").TestClock()
    metrics = _m(prefix, "utils.metrics").MetricRegistry()
    plane = wlib.WirePlane(clock=clock, metrics=metrics,
                           policy=wlib.WirePolicy(sample_gap_micros=0, window_micros=4_000_000))
    fab = _Fabric()
    plane.attach_fabric(fab)
    monitor = hlib.HealthMonitor(clock=clock, metrics=metrics, policy=hlib.HealthPolicy(
        alert_for_micros=1_000_000, alert_clear_for_micros=1_000_000))
    monitor.watch_wire(plane)
    tel = fab.telemetry
    out = []
    for step in range(30):
        clock.advance(500_000)
        for k in range(3 + step % 4):
            peer = "BCD"[k % 3]
            tel.record_frame("out", peer, "notary.request", 200 + k)
            tel.record_frame("in", peer, "rpc.reply", 64 * k)
            tel.record_codec("encode", k % 2 == 0, "notary.request", 1e-5 * (k + 1), 200 + k)
            tel.record_codec("decode", True, "rpc.reply", 4e-6 * (step % 3 + 1), 64 * k)
            tel.record_journal(2e-5 * (k + 1), 1e-4 * (step % 5 + 1))
        if step % 7 == 3:
            tel.record_redelivery("C", step % 3 + 1)
            tel.record_dedupe_hit("B")
        if 10 <= step < 18:
            plane.gateway.record_request("/wire", 0.3, 4096, slow=True)
        plane.gateway.record_request("/metrics", 0.001, 512)
        fab.depths = {
            "journal_depth": 300 + 100 * step if 4 <= step < 12 else 10,
            "dedupe_depth": 40 + step,
            "backlog": {"B": 3, "C": 800 if 14 <= step < 22 else step},
        }
        plane.tick()
        monitor.tick()
        out.append(json.dumps([plane.snapshot(), monitor.snapshot(), plane.backlog_worst(),
                               plane.journal_window(), plane.wire_host_seconds()],
                              sort_keys=True, default=str))
    out.append(metrics.to_prometheus())
    return out


def test_wire_drive_equals_the_references():
    ref = _wire_drive("corda_tpu")
    port = _wire_drive("corda_tpu_torch")
    for step, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {step}"
    assert len(ref) == len(port) == 31
    joined = "".join(ref[:30])
    for alert in ("wire.journal_growth", "wire.backlog", "gateway.saturated"):
        i = joined.index(f'"{alert}"')
        assert '"state": "firing"' in joined[i:], alert


def test_booted_node_records_its_own_frames(tmp_path):
    """The non-gateway half of the reference's booted-node case: a node's
    wire plane is its fabric's telemetry, and a loopback RPC call over
    the real fabric lands frames, codec rows and journal appends in it."""
    from corda_tpu_torch.node.config import NodeConfig, RpcUserConfig
    from corda_tpu_torch.node.node import Node

    node = Node(NodeConfig(name="WireNode", base_dir=str(tmp_path / "n"), notary="batching",
                           use_tls=False, verifier_backend="cpu",
                           rpc_users=(RpcUserConfig("ops", "pw", ("ALL",)),))).start()
    try:
        assert node.wire_plane is not None
        assert node.messaging.telemetry is node.wire_plane.fabric
        client = node.rpc_client("ops", "pw")
        fut = client.call("current_node_time")
        deadline = time.monotonic() + 30
        while not fut.done:
            assert time.monotonic() < deadline
            node.pump(timeout=0.05)
        node.wire_plane.tick()
        t = node.wire_plane.fabric.totals()
        assert t["frames_out"] > 0 and t["frames_in"] > 0 and t["journal_appends"] > 0
        snap = node.wire_plane.snapshot()
        assert snap["wire_host_seconds"] > 0 and snap["fabric"]["codec"]
        assert any(r["topic"].startswith("rpc.") for r in snap["fabric"]["links"])
        # the capacity model knows the wire resource, fed by the device plane
        assert "wire" in node.device_plane.capacity()["resources"]
    finally:
        node.stop()
