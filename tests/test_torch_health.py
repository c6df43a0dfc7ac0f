"""The health plane (utils/health.py) and the rest of utils/tracing.py in
the port, held against the reference.

- Every case of the reference's tests/test_health.py but those in
  LEFT_OUT runs with its imports read as corda_tpu_torch on the port;
  the reference side is the reference's own module. Among them: a
  wedged verifier drain thread (the worker's `health=`), the watchdog's
  stall and livelock detection, alert hysteresis, the ring rule, the
  event log, the canary riding a real batching-notary flush
  (`attach_health`), its deadman, the cluster rollup's stale peer over
  two gateways, and /healthz, /health and the gateway's index served by
  the port's gateway and by booted nodes.
- The same health drive in both packages leaves equal snapshots and
  event logs; the same spans give equal Chrome exports, stage and phase
  summaries.
- Traced Raft and BFT frames feed the tracer's ClockSync in both
  packages.
- The QoS, txstory and distributed-uniqueness watchers install the
  reference's rules (the burn-rate and shed-ratio cases above drive the
  QoS pair; `shard.unreachable` and `reservation.orphaned` walk a
  partitioned owner and an orphaned hold); the perf, device and wire
  watchers are held in
  tests/test_torch_{perf,device_telemetry,wire_telemetry}.py.
"""

from __future__ import annotations

import importlib
import json
import re
import sys
import types

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_persistence import TESTS  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_bench_quick_health_emits_wellformed_record":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}


def port_test_module(name: str, subs=(), **overrides) -> types.ModuleType:
    """tests/<name>.py on the port: `subs` ((old, new) source pairs)
    applied, `corda_tpu.` read as `corda_tpu_torch.`, and `overrides`
    set on the module (port-side versions of its helpers and cases)."""
    key = f"_torch_port_{name}"
    if key not in sys.modules:
        src = (TESTS / f"{name}.py").read_text()
        for a, b in subs:
            assert a in src, a
            src = src.replace(a, b)
        src = re.sub(r"\bcorda_tpu\.", "corda_tpu_torch.", src)
        mod = types.ModuleType(key)
        mod.__file__ = str(TESTS / f"{name}.py")
        sys.modules[key] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        vars(mod).update(overrides)
    return sys.modules[key]


def health_port_module() -> types.ModuleType:
    """tests/test_health.py on the port."""
    return port_test_module("test_health")


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


@pytest.mark.parametrize("name,case", port_cases("test_health", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(health_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_health", LEFT_OUT)) == 17
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_health")))


def _health_drive(prefix: str, log_path) -> list:
    hlib, svc = _m(prefix, "utils.health"), _m(prefix, "node.services")
    metrics = _m(prefix, "utils.metrics").MetricRegistry()
    clock = svc.TestClock()
    monitor = hlib.HealthMonitor(clock=clock, metrics=metrics, event_log_path=str(log_path),
                                 policy=hlib.HealthPolicy(heartbeat_deadline_micros=100_000))
    busy = monitor.heartbeat("pump", queue_depth=lambda: 3)
    idle = monitor.heartbeat("drain")
    level = {"v": 0}
    monitor.add_rule(hlib.AlertRule("depth.high", lambda now: (level["v"] > 5, {"v": level["v"]}),
                                    for_micros=50_000, clear_for_micros=50_000))
    snaps = []
    for step in range(40):
        clock.advance(20_000)
        level["v"] = 10 if 5 <= step < 20 else 0
        if step < 10 or step > 25:
            busy.beat(progress=step)
        idle.beat()
        monitor.tick()
        snaps.append(json.dumps(monitor.snapshot(), sort_keys=True, default=str))
    snaps.append(json.dumps(monitor.healthz(), sort_keys=True, default=str))
    return snaps + [log_path.read_text()]


def test_health_drive_equals_the_references(tmp_path):
    ref = _health_drive("corda_tpu", tmp_path / "ref.jsonl")
    port = _health_drive("corda_tpu_torch", tmp_path / "port.jsonl")
    assert port == ref
    assert '"firing"' in "".join(ref) and ref[-1].count("\n") >= 4


def _traces(prefix: str) -> list:
    tr = _m(prefix, "utils.tracing")
    tracer = tr.Tracer(enabled=False)
    out = []
    for t in range(3):
        spans = []
        for k, (name, parent) in enumerate((("notary.request", None), ("notary.stage", 0),
                                            ("raft.append", 0), ("notary.commit", 1))):
            s = tr.Span(tracer, name, 1000 + t, 10 * t + k,
                        None if parent is None else 10 * t + parent,
                        1.0 + t + k * 0.001, {"shard": t % 2, "member": f"N{k}"})
            s.end_time = s.start + 0.0005 * (k + 1) * (t + 1)
            spans.append(s)
        out.append(tr.Trace(1000 + t, spans))
    return out


def test_trace_exports_equal_the_references():
    got = {}
    for prefix in PACKAGES:
        tr = _m(prefix, "utils.tracing")
        traces = _traces(prefix)
        chrome = tr.chrome_trace(traces)
        got[prefix] = json.dumps([chrome, tr.stage_summary(traces),
                                  tr.phase_summary(chrome["traceEvents"]),
                                  tr.parse_trace_id("0x3e8"), tr.parse_trace_id("junk")],
                                 sort_keys=True, default=str)
    assert got["corda_tpu_torch"] == got["corda_tpu"]


@pytest.mark.parametrize("kind", ["raft", "bft"])
def test_traced_consensus_frames_feed_clock_sync(kind):
    for prefix in PACKAGES:
        tr, msg = _m(prefix, "utils.tracing"), _m(prefix, "node.messaging")
        ser, svc = _m(prefix, "core.serialization"), _m(prefix, "node.services")
        raft = _m(prefix, "node.raft")
        net = msg.InMemoryMessagingNetwork()
        tracer = tr.Tracer(enabled=True)
        peers = ["A", "B", "C", "D"]
        if kind == "raft":
            node = raft.RaftNode("A", peers, net.endpoint("A"), lambda cmd: None,
                                 svc.TestClock(), tracer=tracer)
            topic = node.topic
        else:
            node = _m(prefix, "node.bft").BftReplica("A", peers, net.endpoint("A"),
                                                    lambda cmd, ts: (None, None),
                                                    svc.TestClock(), tracer=tracer)
            topic = node.topic
        payload = ser.encode(raft.VoteReply(0, False, "B"))
        sent = tr.wire_trace(tracer.start_trace("client"))
        node._on_message(msg.Message(topic, payload, "B", 1, trace=sent))
        node._on_message(msg.Message(topic, payload, "C", 2))       # untraced: no evidence
        assert tracer.clock_sync.min_skew("B") is not None, prefix
        assert tracer.clock_sync.min_skew("C") is None


def _watch(prefix: str, kind: str) -> list:
    hlib, svc = _m(prefix, "utils.health"), _m(prefix, "node.services")
    clock = svc.TestClock()
    if kind == "xshard":
        policy = hlib.HealthPolicy(alert_for_micros=200_000, alert_clear_for_micros=200_000)
        return _watch_xshard(prefix, hlib.HealthMonitor(clock=clock, policy=policy), clock)
    monitor = hlib.HealthMonitor(clock=clock)
    if kind == "qos":
        plane = _m(prefix, "node.qos").NotaryQos(clock=clock)
        monitor.watch_qos(plane)
    else:
        plane = _m(prefix, "utils.txstory").TxStory(clock=clock)
        monitor.watch_txstory(plane, {"queue": 10, "commit": 10})
        for k in range(3):
            plane.admit(f"t{k}")
            clock.advance(50)
            plane.close(f"t{k}", "committed")
    for _ in range(4):
        clock.advance(1_000_000)
        monitor.tick()
    return sorted(monitor.snapshot()["alerts"].items())


def _watch_xshard(prefix: str, monitor, clock) -> list:
    """A partitioned owner past the reserve timeout, then a hold whose
    coordinator went quiet, walked to their alerts and back."""
    du, msg = _m(prefix, "node.distributed_uniqueness"), _m(prefix, "node.messaging")
    c, h = _m(prefix, "core.contracts"), _m(prefix, "crypto.hashes")
    faults = msg.FabricFaults(clock=clock)
    net = msg.InMemoryMessagingNetwork(clock=clock, faults=faults)
    policy = du.XShardPolicy(timeout_micros=300_000, reservation_ttl_micros=300_000)
    provs = {n: du.DistributedUniquenessProvider(n, ("A", "B"), net.endpoint(n), clock,
                                                 n_partitions=2, policy=policy, seed=k)
             for k, n in enumerate("AB")}
    provs["A"].attach_health(monitor)
    refs = [c.StateRef(h.SecureHash(bytes([k + 1]) * 32), 0) for k in range(8)]
    ra = next(r for r in refs if provs["A"].shard_map.owner_of(r) == "A")
    rb = next(r for r in refs if provs["A"].shard_map.owner_of(r) == "B")
    walk = []

    def step(n):
        for _ in range(n):
            net.run()
            for p in provs.values():
                p.tick()
            monitor.tick()
            clock.advance(100_000)
            walk.append(sorted((k, v["state"]) for k, v in monitor.snapshot()["alerts"].items()))

    faults.partition({"A"}, {"B"})
    provs["A"].commit_async([ra, rb], h.SecureHash(b"\x07" * 32), None)
    step(6)
    faults.heal()
    provs["B"].commit_async([rb], h.SecureHash(b"\x08" * 32), None)
    step(4)
    provs["A"]._reserve_local(provs["A"].shard_map.partition_of(ra), [ra],
                              h.SecureHash(b"\x09" * 32), 9, "B", None)
    provs["B"].stop()
    step(12)
    return walk


@pytest.mark.parametrize("kind", ["qos", "txstory", "xshard"])
def test_plane_watchers_install_the_references_rules(kind):
    """watch_qos, watch_txstory and watch_distributed_uniqueness install
    the reference's rules, which walk to the same states on one
    TestClock in both packages."""
    got = {p: json.dumps(_watch(p, kind), sort_keys=True, default=str) for p in PACKAGES}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    want = {"qos": "qos.shed_ratio", "txstory": "txstory.stage_slo",
            "xshard": "reservation.orphaned"}[kind]
    assert want in got["corda_tpu"]
    if kind == "xshard":
        walk = json.loads(got["corda_tpu"])
        assert ["shard.unreachable", "firing"] in walk[5]
        assert ["shard.unreachable", "firing"] not in walk[-1]
        assert ["reservation.orphaned", "firing"] in walk[-1]
