"""The QoS plane (node/qos.py) and the batching notary's QoS seam in the
port, held against the reference.

- Every case of the reference's tests/test_qos.py but those in LEFT_OUT
  runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): the deadline header, the token
  bucket, the lanes, the pre-decode ingest shed, the AIMD controller,
  brownout, the flush-time and arrival sheds with their typed `shed`
  answers and span events, the flow-carried deadline, the admission
  gate, the verifier worker's shed, the config knobs and the 2x
  overload soak on a TestClock, each over CpuBatchVerifier as the
  reference's cases are, the soak ending with its read of GET /qos
  through the port's gateway, and GET /qos served by a booted node.
- One TestClock drive through both packages' NotaryQos (admission,
  lanes, brownout, per-shard controllers, admitted latencies) leaves
  equal `snapshot()`s and equal controller trajectories after every
  step.
- The same overload drive through both packages' batching notaries
  (each over its own CpuBatchVerifier, on its own MockNetwork of one
  seed) gives equal answers, equal snapshots and equal controller
  trajectories flush by flush.
"""

from __future__ import annotations

import importlib
import json

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_persistence import TESTS  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_bench_quick_qos_emits_wellformed_overload_record":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}


def qos_port_module():
    return port_test_module("test_qos")


@pytest.mark.parametrize("name,case", port_cases("test_qos", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(qos_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_qos", LEFT_OUT)) == 17
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_qos")))


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _controller_drive(prefix: str) -> list:
    qlib, svc, msg = _m(prefix, "node.qos"), _m(prefix, "node.services"), _m(prefix, "node.messaging")
    clock = svc.TestClock()
    qos = qlib.NotaryQos(
        qlib.QosPolicy(target_p99_micros=20_000, min_batch=4, max_batch=64,
                       max_wait_micros=8_000, wait_step_micros=500,
                       admission_rate_per_sec=200, admission_burst=3,
                       brownout_after_flushes=3),
        clock=clock,
    )
    qos.ensure_shards(2)
    steps = []
    latencies = [1_000, 2_000, 40_000, 60_000, 3_000, 500, 500, 500] * 4
    for k, lat in enumerate(latencies):
        clock.advance(1_700 + 37 * k)
        deadline = clock.now_micros() + (5_000 if k % 3 else -1)
        topic = "tx.resolution" if k % 4 == 0 else "platform.notarise"
        qos.lanes.offer(msg.Message(topic, b"", f"peer{k % 2}", k, None, deadline))
        if k % 5 == 0:
            qos.lanes.drain(budget=3)
        qos.record_admitted(lat, shard=k % 2)
        backlog = (k * 7) % 23 if k < 20 else max(0, 30 - k)
        qos.observe_flush(batch_size=(4, 16, 64)[k % 3], backlog=backlog)
        qos.observe_shard_flush(k % 2, batch_size=8, backlog=backlog // 2)
        if k % 6 == 0:
            qos.shed_tx(qlib.SHED_EXPIRED_FLUSH)
        steps.append(json.dumps([qos.snapshot(), qos.controller.batch,
                                 qos.controller.wait_micros,
                                 [(c.batch, c.wait_micros) for c in qos.shard_controllers],
                                 qos.brownout_level], sort_keys=True))
    return steps


def test_controller_drive_equals_the_references():
    ref, port = _controller_drive("corda_tpu"), _controller_drive("corda_tpu_torch")
    assert port == ref
    last = json.loads(ref[-1])[0]
    assert last["shed"] and last["brownout"]["transitions"] and last["admission"]["clients"] == 2


def _notary_overload(prefix: str) -> dict:
    """The reference soak's shape, smaller (6 rounds of 2x a capacity of
    4): arrivals with deadlines onto the batching notary's queue, one
    tick per round on the TestClock, the answers by kind and the
    controller's batch and wait after every tick."""
    mod = importlib.import_module("tests.test_qos") if prefix == "corda_tpu" else qos_port_module()
    qlib, notary = _m(prefix, "node.qos"), _m(prefix, "node.notary")
    api = _m(prefix, "flows.api")
    qos = qlib.NotaryQos(qlib.QosPolicy(target_p99_micros=25_000, min_batch=2, max_batch=4,
                                        max_wait_micros=0, brownout_after_flushes=2))
    net, svc, requester, spends = mod._rig(48, qos=qos, seed=9)
    qos._clock = net.clock
    futs, trajectory = [], []
    it = iter(spends)
    for rnd in range(12):
        now = net.clock.now_micros()
        for j in range(8 if rnd < 6 else 0):
            fut = api.FlowFuture()
            svc._pending.append(notary._PendingNotarisation(
                next(it), requester, fut,
                deadline=now + (15_000 if j % 3 else 40_000), arrival_micros=now))
            futs.append(fut)
        svc.tick()
        trajectory.append((qos.controller.batch, qos.controller.wait_micros,
                           qos.brownout_level, len(svc._pending)))
        net.clock.advance(10_000)
    answers = []
    for f in futs:
        r = f.result()
        answers.append(r.kind if isinstance(r, notary.NotaryError) else "signed")
    return {"answers": answers, "trajectory": trajectory,
            "snapshot": json.dumps(qos.snapshot(), sort_keys=True),
            "committed": len(svc.uniqueness.committed)}


def test_notary_overload_equals_the_references():
    ref, port = _notary_overload("corda_tpu"), _notary_overload("corda_tpu_torch")
    assert port == ref
    assert {"signed", "shed"} <= set(ref["answers"]) and ref["committed"] == ref["answers"].count("signed")
