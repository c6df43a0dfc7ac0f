"""The port's sharded commit plane (shards = 4, ShardedUniquenessProvider)
against the reference's, on test_torch_notary.py's fixture: the
dispatch-all-then-consume wave on the port's device path (plain
versions on the CPU), streamed and joined, and the worker-thread plane
on the CPU reference verifiers. Same checks as shards = 1: answer kinds
equal to the labels, byte-equal notary signatures, equal conflicts and
equal committed maps.

Per-shard verifiers (`shard_verifiers=`): each shard verifying on its
own `per_shard_verifiers` verifier pinned to a CPU device gives the
reference's answers, each verifier's dispatches on its own device row;
attach_device maps the queues as the reference's does; D2 holds for a
shard verifier on the card; the reference's wedged-shard case
(tests/test_sharded_notary.py) runs on the port; and a node with several
cards builds one verifier per shard, and stops its boot where it cannot
(divergence D11).
"""

from __future__ import annotations

import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import corda_tpu.crypto.batch_verifier as rbv  # noqa: E402
import corda_tpu.node.notary as rnot  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.node.notary as pnot  # noqa: E402
from corda_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from corda_tpu_torch.testing.notary_fixture import notary_hub  # noqa: E402
from corda_tpu_torch.utils import device_telemetry as dlib  # noqa: E402

from test_torch_fabric import run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_notary import (  # noqa: E402,F401  (one_torch_thread: autouse)
    OnCard,
    StreamedCpu,
    _reference_hub,
    assert_same_answers,
    check_against_reference,
    fixture,
    one_torch_thread,
    run_port,
    run_reference,
)

CPU_DEVICES = [torch.device("cpu", k) for k in range(4)]


@pytest.mark.parametrize("streamed", [True, False], ids=["streamed", "join"])
def test_notary_matches_reference_four_shards(streamed):
    svc = check_against_reference(4, streamed)
    fx = fixture()
    homes = {svc.shard_of(s) for s, lab in zip(fx.spends, fx.labels) if lab != "wrong-notary"}
    assert svc.batches_dispatched == len(homes) > 1   # one dispatch per due shard
    assert sum(svc.metrics.counter(f"Notary.Shard{k}.Answered").count for k in range(4)) == sum(
        lab != "wrong-notary" for lab in fx.labels)
    assert svc.uniqueness.partition_depth(0) + svc.uniqueness.partition_depth(1) + \
        svc.uniqueness.partition_depth(2) + svc.uniqueness.partition_depth(3) == len(
            svc.uniqueness.committed)


def test_worker_threads_match_reference():
    fx = fixture()
    r_svc, r_ans = run_reference(rbv.CpuBatchVerifier(), 4, shard_workers=True)
    p_svc, p_ans = run_port(pbv.CpuBatchVerifier(), 4, shard_workers=True)
    try:
        assert_same_answers(r_svc, r_ans, p_svc, p_ans, fx.labels)
    finally:
        r_svc.stop()
        p_svc.stop()
    assert all(not t.is_alive() for t in p_svc._workers)


def test_cross_shard_commit_is_first_wins():
    """A transaction whose inputs live on two partitions takes the
    two-phase reserve→commit; a later one sharing an input loses with
    the full conflict set, and nothing of it is left reserved."""
    fx = fixture()
    uniq = pnot.ShardedUniquenessProvider(4, record_decisions=True)
    refs = [s.wtx.inputs[0] for s in fx.spends]
    by_shard = {}
    for r in refs:
        by_shard.setdefault(uniq.shard_of(r), r)
    a, b = list(by_shard.values())[:2]
    tx1, tx2 = fx.spends[0].id, fx.spends[1].id
    out = uniq.commit_many([([a, b], tx1, fx.requester), ([b], tx2, fx.requester)])
    assert out[0] is None and isinstance(out[1], pnot.UniquenessConflict)
    assert out[1].conflict == {b: tx1}
    assert uniq.committed == {a: tx1, b: tx1}
    assert [d[0] for d in uniq.decisions] == [tx1, tx2]
    assert all(not p.reserved for p in uniq._parts)


class Unused(pbv.BatchSignatureVerifier):
    """The hub's verifier where every shard has its own: never called."""

    def verify_batch(self, requests):
        raise AssertionError("a shard dispatched to the hub's verifier")


def test_per_shard_verifiers_behind_four_shards():
    """shard_verifiers=per_shard_verifiers(4, devices=4 CPU devices): the
    reference's answer kinds, byte-equal notary signatures and committed
    maps; each verifier's dispatches land on its own device row, with
    the requests of its shard."""
    fx = fixture()
    r_svc, r_ans = run_reference(StreamedCpu(), 4,
                                 shard_verifiers=[StreamedCpu() for _ in range(4)])
    ledger = dlib.DeviceAccounting()
    dlib.set_device_accounting(ledger)
    try:
        vs = pbv.per_shard_verifiers(4, batch_sizes=(16,), devices=CPU_DEVICES)
        p_svc, p_ans = run_port(Unused(), 4, shard_verifiers=vs)
    finally:
        dlib.set_device_accounting(None)
    assert_same_answers(r_svc, r_ans, p_svc, p_ans, fx.labels)
    assert [s.verifier for s in p_svc._shards] == vs
    rows = ledger.snapshot()["devices"]
    want = {}
    for stx, label in zip(fx.spends, fx.labels):
        if label != "wrong-notary":
            k = p_svc.shard_of(stx)
            want[k] = want.get(k, 0) + len(stx.sigs)
    assert len(want) > 1 and {k: rows[k]["requests"] for k in rows} == want
    assert all(rows[k]["dispatches"] >= 1 for k in want)


class _Plane:
    """Records what attach_device hands the device plane."""

    def attach_queues(self, depths, ids):
        self.ids = list(ids)

    def watch_fallback(self, active, evidence):
        pass


@pytest.mark.parametrize("n_dev", [4, 1, 0], ids=["pinned", "one-device", "none"])
def test_attach_device_maps_queues_to_pinned_cards(n_dev):
    fx = fixture()
    r_vs = rbv.per_shard_verifiers(4, devices=jax.devices()[:n_dev]) if n_dev else None
    p_vs = pbv.per_shard_verifiers(4, devices=CPU_DEVICES[:n_dev]) if n_dev else None
    r_svc = rnot.BatchingNotaryService(_reference_hub(fx, rbv.CpuBatchVerifier())[0],
                                       rnot.ShardedUniquenessProvider(4), shards=4,
                                       shard_verifiers=r_vs)
    p_svc = pnot.BatchingNotaryService(notary_hub(fx, pbv.CpuBatchVerifier()),
                                       pnot.ShardedUniquenessProvider(4), shards=4,
                                       shard_verifiers=p_vs)
    r_plane, p_plane = _Plane(), _Plane()
    r_svc.attach_device(r_plane)
    p_svc.attach_device(p_plane)
    assert p_plane.ids == r_plane.ids == ([0, 1, 2, 3] if n_dev == 4 else [None] * 4)


def test_degraded_fallback_refused_with_a_shard_verifier_on_the_card():
    """D2 holds for each shard verifier: one on the card (or a mesh with
    a card) refuses degraded_fallback=True; CPU shard verifiers take it."""
    hub = notary_hub(fixture(), pbv.CpuBatchVerifier())
    on_mesh = types.SimpleNamespace(device=None,
                                    mesh=pmesh.make_mesh([torch.device("cuda", 0)]))
    for card in (OnCard(), pbv.DispatchFaultInjector(OnCard()), on_mesh):
        with pytest.raises(ValueError, match="a shard verifier runs on the card"):
            pnot.BatchingNotaryService(hub, pnot.ShardedUniquenessProvider(4), shards=4,
                                       shard_verifiers=[pbv.CpuBatchVerifier(), card],
                                       degraded_fallback=True)
    svc = pnot.BatchingNotaryService(hub, pnot.ShardedUniquenessProvider(4), shards=4,
                                     shard_verifiers=pbv.per_shard_verifiers(
                                         4, devices=CPU_DEVICES),
                                     degraded_fallback=True)
    assert svc.degraded_fallback


def test_wedged_shard_flush_flips_healthz_and_recovers(tmp_path):
    """The reference's case on the port: two shards in worker mode, shard
    0's verifier (`shard_verifiers=[blocker, plain]`) parked mid-flush
    flips /healthz naming that shard while shard 1 serves; releasing it
    recovers."""
    mod = port_test_module("test_sharded_notary")
    run_port_case(mod, "test_wedged_shard_flush_flips_healthz_and_recovers", tmp_path)


def test_node_builds_per_card_verifiers_and_stops_on_their_error(tmp_path, monkeypatch):
    """A batching node with notary_shards = 4 on the card backend and no
    verifier of its own builds per_shard_verifiers(4) where it sees
    several cards, and none where it sees one, verifies on the CPU or
    was handed a verifier (the reference builds them over a handed one
    too). Card shard verifiers take the default degraded fallback away
    (D2), as a card hub verifier does; a handed CpuBatchVerifier keeps it
    on two cards. D11: where building them fails, the boot fails, where
    the reference would serve every shard on the shared verifier."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node

    built = []

    class OnCard:
        """A stand-in shard verifier pinned to a card."""

        mesh = None

        def __init__(self, k):
            self.device = torch.device("cuda", k)

    def fake(n_shards, batch_sizes=(128, 1024, 4096), devices=None):
        built.append(n_shards)
        return [OnCard(k % 2) for k in range(n_shards)]

    monkeypatch.setattr(pbv, "per_shard_verifiers", fake)
    cards = {"n": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards["n"])

    def boot(name, backend="tpu", verifier=None):
        cfg = NodeConfig(name=name, base_dir=str(tmp_path / name), notary="batching",
                         notary_shards=4, verifier_backend=backend, use_tls=False)
        return Node(cfg, batch_verifier=verifier)

    node = boot("TwoCards")
    try:
        assert built == [4]
        svc = node.services.notary_service
        assert [str(s.verifier.device) for s in svc._shards] == ["cuda:0", "cuda:1"] * 2
        assert svc.degraded_fallback is False
    finally:
        node.stop()
    for name, n, backend, verifier in (("OneCard", 1, "tpu", None), ("OnTheCpu", 2, "cpu", None),
                                       ("Handed", 2, "tpu", pbv.CpuBatchVerifier())):
        cards["n"] = n
        node = boot(name, backend, verifier)
        try:
            svc = node.services.notary_service
            assert all(s.verifier is None for s in svc._shards)
            assert svc.degraded_fallback is (verifier is not None or backend == "cpu")
        finally:
            node.stop()
    assert built == [4]

    def refuse(n_shards, batch_sizes=(128, 1024, 4096), devices=None):
        raise RuntimeError("cuda:1 is not a visible card")

    monkeypatch.setattr(pbv, "per_shard_verifiers", refuse)
    cards["n"] = 2
    with pytest.raises(RuntimeError, match="cuda:1 is not a visible card"):
        boot("Refused")
