"""The fleet soak (testing/fleet.py) in the port, held against the
reference.

- Every case of the reference's tests/test_fleet.py but the one in
  LEFT_OUT runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): the fabric fault plane, the
  chaos plane's schedule, the QoS-flavour soak of 1,024 identities with
  its SLO and brownout, its health story, the sharded plane's
  cross-shard conflicts, the Raft soak through churn and its cluster
  story, the BFT soak (slow, as in the reference), the checker's
  forged-ledger catch, and the intent WAL's exact accounting. One
  source change, SUBS: every FleetSim gets a CpuBatchVerifier (the
  port's fleet verifies on the card by default, the reference's on its
  CPU verifier); `batching_report` and `raft_report`, module fixtures
  in the reference, are built once each here too.
- The batching fixture's soak and a small distributed soak give equal
  records (every field, ids as hex), outcomes and ledgers in both
  packages.
- Divergence D10, both sides: over a CPU verifier the batching notary
  serves with the reference's degraded fallback, and a device_fault soak
  reconciles its degraded flushes; over a verifier on the card (None,
  or a CudaBatchVerifier) a device_fault soak is refused with ValueError
  naming D2 before anything runs, and the verifier pool's workers
  verify on the fleet's verifier.
"""

from __future__ import annotations

import functools
import importlib

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_bench_quick_fleet_emits_wellformed_record":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}
# every FleetSim of a reference case verifies on a CpuBatchVerifier:
# port_test_module(name, subs=FLEET_SUBS, _fleet_sim=cpu_fleet_sim)
FLEET_SUBS = (("fl.FleetSim(", "_fleet_sim("),)


def cpu_fleet_sim(*args, **kw):
    """The port's FleetSim over a CpuBatchVerifier unless one is given
    (the reference's fleet verifies on its CPU verifier by default)."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing import fleet

    kw.setdefault("batch_verifier", CpuBatchVerifier())
    return fleet.FleetSim(*args, **kw)


def _once(fixture):
    """A module-scoped reference fixture, built once for every case that
    takes it (run_port_case calls `__wrapped__`, with the fixtures it
    names)."""
    box = []

    @functools.wraps(fixture.__wrapped__)
    def build(**kw):
        if not box:
            box.append(fixture.__wrapped__(**kw))
        return box[0]

    return type("Once", (), {"__wrapped__": staticmethod(build)})()


def fleet_port_module():
    mod = port_test_module("test_fleet", subs=FLEET_SUBS, _fleet_sim=cpu_fleet_sim)
    if not getattr(mod, "_fixtures_once", False):
        for name in ("batching_report", "raft_report"):
            setattr(mod, name, _once(getattr(mod, name)))
        mod._fixtures_once = True
    return mod


@pytest.mark.parametrize("name,case", port_cases("test_fleet", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(fleet_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_fleet", LEFT_OUT)) == 15
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_fleet")))


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _cpu(prefix: str):
    return _m(prefix, "crypto.batch_verifier").CpuBatchVerifier()


def _hex(x) -> str:
    return x.hex() if hasattr(x, "hex") and callable(x.hex) else str(x)


def _summary(rep) -> dict:
    """A report's records (every field), outcome counts and ledgers as
    plain values."""
    records = [
        (r.rid, r.client, _hex(r.tx_id), tuple(str(i) for i in r.inputs), r.kind, r.phase,
         r.member, r.deadline, r.submitted_at, r.answered_at, r.outcome, r.shed_reason,
         r.rival_of)
        for r in rep.records
    ]
    outcomes: dict = {}
    for r in rep.records:
        outcomes[r.outcome] = outcomes.get(r.outcome, 0) + 1
    ledgers = {m: sorted((str(ref), _hex(tx)) for ref, tx in led.items())
               for m, led in rep.ledgers.items()}
    return {"records": records, "outcomes": outcomes, "ledgers": ledgers,
            "members": list(rep.members), "bulk": (rep.bulk_offered, rep.bulk_served,
                                                   rep.bulk_shed_brownout),
            "clients": rep.distinct_clients, "window": (rep.started_micros,
                                                        rep.finished_micros)}


def _batching_soak(prefix: str):
    """The reference's batching fixture (tests/test_fleet.py), on a CPU
    verifier."""
    fl, qos = _m(prefix, "testing.fleet"), _m(prefix, "node.qos")
    R, CAP = 20_000, 8
    mix = fl.TrafficMix(deadline_micros=6 * R, conflict_fraction=0.06)
    scenario = fl.FleetScenario(
        clients=1024,
        phases=(fl.Phase("ramp", 3, CAP // 2, mix), fl.Phase("steady", 14, CAP, mix),
                fl.Phase("spike", 8, 3 * CAP, fl.TrafficMix(
                    deadline_micros=6 * R, bulk_fraction=0.34, conflict_fraction=0.06)),
                fl.Phase("steady2", 8, CAP - 2, mix)),
        round_micros=R, drain_rounds=60, seed=11)
    policy = qos.QosPolicy(target_p99_micros=5 * R, min_batch=CAP, max_batch=CAP,
                           max_wait_micros=0, brownout_after_flushes=3)
    return fl.FleetSim(scenario, "batching", chaos=(fl.freeze(0, at=0.12, until=0.22),),
                       qos_policy=policy, batch_verifier=_cpu(prefix)).run()


def _distributed_soak(prefix: str):
    """Three distributed-uniqueness members over cash spends, half of
    them cross-shard, through a partition and a member's kill and
    restart, with the intent WAL."""
    fl = _m(prefix, "testing.fleet")
    R = 20_000
    mix = fl.TrafficMix(deadline_micros=300 * R, conflict_fraction=0.05,
                        cross_shard_fraction=0.5)
    scenario = fl.FleetScenario(clients=96, phases=(fl.Phase("steady", 6, 16, mix),),
                                round_micros=R, drain_rounds=100, seed=31)
    sim = fl.FleetSim(scenario, "distributed", cluster_size=3, intent_wal=True,
                      chaos=(fl.partition(1, at=0.25, heal_at=0.5),
                             fl.kill_restart(0, at=0.6, restart_at=0.75)),
                      batch_verifier=_cpu(prefix))
    rep = sim.run()
    fl.InvariantChecker(rep).check_all()
    return rep


@pytest.mark.parametrize("soak", [_batching_soak, _distributed_soak],
                         ids=["batching", "distributed"])
def test_soak_equals_the_references(soak):
    ref, port = (_summary(soak(p)) for p in PACKAGES)
    assert port["outcomes"] == ref["outcomes"]
    assert port["ledgers"] == ref["ledgers"]
    assert port == ref
    assert ref["outcomes"].get("signed", 0) >= 16 and ref["outcomes"].get("conflict", 0) >= 1


def _small(fl):
    R = 20_000
    scenario = fl.FleetScenario(
        clients=16, phases=(fl.Phase("steady", 6, 4, fl.TrafficMix(
            deadline_micros=400 * R, conflict_fraction=0.2)),),
        round_micros=R, drain_rounds=60, seed=13)
    return scenario


def test_degraded_fallback_serves_over_a_cpu_verifier():
    """D10 off the card: the batching notary serves with the reference's
    degraded fallback, and a device_fault soak's degraded flushes
    reconcile as the reference's do, with equal records."""
    out = {}
    for prefix in PACKAGES:
        fl = _m(prefix, "testing.fleet")
        sim = fl.FleetSim(_small(fl), "batching",
                          chaos=(fl.device_fault(at=0.2, heal_at=0.6, flushes=2),),
                          batch_verifier=_cpu(prefix))
        assert sim.members[0].services.notary_service.degraded_fallback is True
        rep = sim.run()
        fl.InvariantChecker(rep).check_all(expect_conflicts=True)
        assert rep.device_faults >= 1 and rep.degraded_flushes >= 1
        out[prefix] = (_summary(rep), rep.device_faults, rep.degraded_flushes)
    assert out["corda_tpu_torch"] == out["corda_tpu"]


def _card_verifier(monkeypatch):
    """A CudaBatchVerifier built as on a machine with a card (no launch)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    return _m("corda_tpu_torch", "crypto.batch_verifier").CudaBatchVerifier()


@pytest.mark.parametrize("verifier", ["default", "cuda", "wrapped"])
def test_device_fault_on_the_card_is_refused(verifier, monkeypatch):
    """D10 on the card: a device_fault soak would need the notary to
    move a flush to the CPU, which D2 refuses; FleetSim raises before
    it builds anything, and no other chaos is refused."""
    fl = _m("corda_tpu_torch", "testing.fleet")
    bv = _m("corda_tpu_torch", "crypto.batch_verifier")
    v = {"default": lambda: None, "cuda": lambda: _card_verifier(monkeypatch),
         "wrapped": lambda: bv.DispatchFaultInjector(_card_verifier(monkeypatch))}[verifier]()
    assert fl.verifier_on_card(v)
    with pytest.raises(ValueError, match="D2"):
        fl.FleetSim(_small(fl), "batching", chaos=(fl.device_fault(at=0.2, heal_at=0.6),),
                    batch_verifier=v)
    assert not fl.verifier_on_card(bv.CpuBatchVerifier())
    assert not fl.verifier_on_card(bv.CudaBatchVerifier(device="cpu", batch_sizes=(16,)))


def test_pool_workers_verify_on_the_fleets_verifier():
    """D10: the verifier pool's workers take the fleet's verifier (the
    reference builds each a CpuBatchVerifier), never the fault injector
    the notary's hub sees; over a CPU verifier the pool soak's records
    equal the reference's."""
    out = {}
    for prefix in PACKAGES:
        fl = _m(prefix, "testing.fleet")
        v = _cpu(prefix)
        sim = fl.FleetSim(_small(fl), "batching", verifier_pool=2, intent_wal=True,
                          chaos=(fl.kill_verifier(0, at=0.3),), batch_verifier=v)
        if prefix == "corda_tpu_torch":
            assert all(w._verifier is v for w in sim._verify_workers)
        rep = sim.run()
        checker = fl.InvariantChecker(rep)
        checker.check_all(expect_conflicts=True)
        checker.check_exact_accounting()
        assert rep.intent_unresolved == 0 and rep.verify_workers_lost == 1
        out[prefix] = (_summary(rep), rep.verify_offered, rep.verify_resolved,
                       rep.verify_failed)
    assert out["corda_tpu_torch"] == out["corda_tpu"]
