"""Distributed uniqueness (node/distributed_uniqueness.py), its journals
(persistence.XShardCoordinatorJournal, XShardReservationJournal) and
raft.partition_raft_groups in the port, held against the reference.

- Every case of the reference's tests/test_distributed_uniqueness.py
  but those in LEFT_OUT runs on the port with its imports read as
  corda_tpu_torch (test_torch_health.port_test_module): the ownership
  map, the two-phase wire walkthrough, the full conflict set,
  exactly-one-winner against a serial replay, the partitioned owner's
  typed answer and alert, the three kill arcs, the same-tx re-commit,
  the unreachable mark, the orphan against an empty journal, the
  xshard spans, the QoS lane, the per-partition raft groups, the config
  knobs, GET /shards through the port's gateway, the three-process
  TCP kill -9 (its child processes run the port), and the four
  fleet-driven cases (testing/fleet.py, every FleetSim on a
  CpuBatchVerifier: test_torch_fleet.FLEET_SUBS): the batching members'
  cross-member spends, chaos in the reserve window, the 10k-identity
  acceptance arc (slow, as in the reference) and its small twin.
- Cross-package:
  - the same seeded rig in both packages gives equal decision logs,
    equal committed maps, byte-equal `TOPIC_XSHARD` frames, and equal
    sqlite dumps (the XShard journals' DDL and rows) after a kill and
    `recover()`;
  - journal databases left mid-protocol by either package recover in
    both to the same outcome;
  - two batching members over the provider serve cross-member spends on
    `CudaBatchVerifier(device="cpu")` with the answers, signatures,
    decision logs and committed maps of the reference's members on
    `CpuBatchVerifier`; with the other owner partitioned away the
    answer is `shard-unavailable` in both.
"""

from __future__ import annotations

import importlib
import shutil

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_fleet import FLEET_SUBS, cpu_fleet_sim  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_persistence import _dump_sqlite  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
MEMBERS = ("A", "B", "C")
BENCH = "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)"
LEFT_OUT = {
    "test_bench_quick_distributed_smoke": BENCH,
    "test_bench_history_gates_xshard_verdicts": f"tools/bench_history over {BENCH}",
}


def du_port_module():
    return port_test_module("test_distributed_uniqueness", subs=FLEET_SUBS,
                            _fleet_sim=cpu_fleet_sim)


@pytest.mark.parametrize("name,case", port_cases("test_distributed_uniqueness", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(du_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_distributed_uniqueness", LEFT_OUT)) == 23
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_distributed_uniqueness")))


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _module(prefix: str):
    """The test module whose `_Rig`, `_h` and `ALICE` are `prefix`'s."""
    if prefix == "corda_tpu":
        return importlib.import_module("tests.test_distributed_uniqueness")
    return du_port_module()


def _plain(committed: dict) -> dict:
    return {(bytes(r.txhash.bytes_), r.index): bytes(t.bytes_) for r, t in committed.items()}


def _decisions(log: list) -> list:
    return [(bytes(tx.bytes_), None if c is None else sorted(_plain(c).items()))
            for tx, c in log]


def _outcome(fut) -> str:
    if fut is None or not fut.done:
        return "pending"
    try:
        fut.result()
    except Exception as e:  # noqa: BLE001 - the outcome is the record
        return type(e).__name__
    return "accept"


def _tap(rig, topic: str) -> list:
    """(sender, target, payload) of every `topic` frame the rig's fabric
    is handed, in send order."""
    frames = []
    enqueue = rig.net._enqueue

    def tap(msg, target):
        if msg.topic == topic:
            frames.append((msg.sender, target, bytes(msg.payload)))
        enqueue(msg, target)

    rig.net._enqueue = tap
    return frames


def _state(rig) -> dict:
    return {
        "committed": {m: _plain(p.store.committed) for m, p in rig.provs.items()},
        "reservations": {m: p.reservation_count() for m, p in rig.provs.items()},
        "dumps": {m: _dump_sqlite(rig.dbs[m]._conn) for m in rig.members},
    }


def _xshard_drive(prefix: str) -> dict:
    """Cross-member commits, a double spend, an all-local commit, a
    coordinator killed after its durable decision and a participant
    killed mid-reserve, each restarted over its database."""
    mod = _module(prefix)
    rig = mod._Rig(members=MEMBERS, n_partitions=6, durable=True)
    frames = _tap(rig, _m(prefix, "node.messaging").TOPIC_XSHARD)
    a, b, c = (rig.owned_refs(m, 6) for m in MEMBERS)
    futs = {}

    def submit(coord, n, refs):
        futs[n] = rig.provs[coord].commit_async(refs, mod._h(n), mod.ALICE)

    submit("A", 300, [a[0], b[0], c[0]])
    submit("B", 301, [b[1], c[1]])
    submit("C", 302, [a[0], c[2]])      # the rival of 300 on a[0]
    submit("C", 303, [a[1], b[2]])
    submit("A", 304, [a[2]])            # all-local fast path
    rig.drive(20, advance=50_000)
    submit("A", 305, [a[3], b[3]])
    rig.net.pump(1)                     # reserve -> B
    rig.net.pump(1)                     # ack -> A: decided, commit unacked
    killed = _state(rig)
    recovered = rig.restart("A")
    submit("C", 306, [b[4], c[3]])
    rig.net.pump(1)
    rig.restart("B")                    # mid-reserve participant
    rig.drive(40)
    return {"frames": frames, "decisions": _decisions(rig.decisions), "killed": killed,
            "recovered": recovered, "end": _state(rig),
            "outcomes": {n: _outcome(f) for n, f in sorted(futs.items())}}


def test_seeded_rig_equals_the_references():
    """Decision logs, committed maps, every TOPIC_XSHARD frame and the
    XShard journals' DDL and rows, at the kill and at the end."""
    ref, port = (_xshard_drive(p) for p in PACKAGES)
    assert len(port["frames"]) == len(ref["frames"])
    for i, (r, p) in enumerate(zip(ref["frames"], port["frames"])):
        assert p == r, f"frame {i}"
    for key in ("decisions", "killed", "recovered", "end", "outcomes"):
        assert port[key] == ref[key], key
    assert ref["recovered"] == 1
    rivals = sorted(ref["outcomes"].pop(n) for n in (300, 302))
    assert rivals == ["UniquenessConflict", "accept"]
    assert set(ref["outcomes"].values()) == {"accept"}
    assert all(n == 0 for n in ref["end"]["reservations"].values())
    tables = {t for dump in ref["killed"]["dumps"].values() for _k, t, _s, _r in dump}
    assert {"xshard_intents", "xshard_reservations"} <= tables


def _file_rig(mod, root):
    """`mod`'s durable rig over <root>/<member>.db files."""
    rig = mod._Rig(members=MEMBERS, n_partitions=6, durable=True)
    for p in rig.provs.values():
        p.stop()
    rig.dbs = {m: mod.NodeDatabase(str(root / f"{m}.db")) for m in MEMBERS}
    rig.provs = {m: rig.build(m) for m in MEMBERS}
    return rig


def _crash_mid_protocol(prefix: str, root) -> None:
    """Leave the journals mid-protocol: C's intent 401 undecided (A holds
    its journaled reservation, C dies before the ack), A's intent 400
    commit-marked with its ShardCommit to B undelivered."""
    mod = _module(prefix)
    rig = _file_rig(mod, root)
    a, b, c = (rig.owned_refs(m, 2) for m in MEMBERS)
    rig.provs["C"].commit_async([a[1], c[1]], mod._h(401), mod.ALICE)
    rig.net.pump(1)
    rig.provs["C"].stop()
    fut = rig.provs["A"].commit_async([a[0], b[0]], mod._h(400), mod.ALICE)
    for _ in range(8):
        if fut.done:
            break
        rig.net.pump(1)
    assert fut.done and fut.result() is None
    assert rig.provs["A"].journal.unresolved_count == 1
    assert rig.provs["A"].reservations.held_count == 1
    for m in MEMBERS:
        rig.provs[m].stop()
        rig.dbs[m].close()


def _recover(prefix: str, root) -> dict:
    mod = _module(prefix)
    rig = _file_rig(mod, root)
    frames = _tap(rig, _m(prefix, "node.messaging").TOPIC_XSHARD)
    recovered = [rig.provs[m].recover() for m in MEMBERS]
    rig.drive(40, advance=200_000)
    out = {"recovered": recovered, "frames": frames, **_state(rig),
           "unresolved": [rig.provs[m].journal.unresolved_count for m in MEMBERS],
           "held": [rig.provs[m].reservations.held_count for m in MEMBERS]}
    owners = rig.provs["A"].shard_map
    out["rows"] = sorted((owners.owner_of(ref), bytes(tx.bytes_))
                         for p in rig.provs.values() for ref, tx in p.store.committed.items())
    for m in MEMBERS:
        rig.provs[m].stop()
        rig.dbs[m].close()
    return out


@pytest.mark.parametrize("writer", PACKAGES)
def test_journals_left_by_one_package_recover_in_both(writer, tmp_path):
    """The databases a package leaves mid-protocol recover in both
    packages to equal frames, maps and dumps: the commit-marked intent
    re-drives to every owner, the undecided one presumed-aborts and
    releases its orphaned reservation."""
    src = tmp_path / "src"
    src.mkdir()
    _crash_mid_protocol(writer, src)
    got = {}
    for prefix in PACKAGES:
        shutil.copytree(src, tmp_path / prefix)
        got[prefix] = _recover(prefix, tmp_path / prefix)
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    out = got["corda_tpu"]
    assert out["recovered"] == [1, 0, 0]
    tx400 = bytes(_module(writer)._h(400).bytes_)
    assert out["rows"] == [("A", tx400), ("B", tx400)]
    assert out["unresolved"] == [0, 0, 0] and out["held"] == [0, 0, 0]
    assert all(n == 0 for n in out["reservations"].values())


# -- the kernel path: batching members over the provider ---------------------

N_SERVED = 16


def _start(gens) -> list:
    out = []
    for gen in gens:
        try:
            out.append((gen, next(gen).future))
        except StopIteration as stop:
            out.append(stop.value)
    return out


def _finish(started) -> list:
    out = []
    for entry in started:
        if isinstance(entry, tuple):
            gen, fut = entry
            try:
                try:
                    value = fut.result()
                except Exception as e:  # noqa: BLE001 - handed to the flow
                    gen.throw(e)
                else:
                    gen.send(value)
            except StopIteration as stop:
                entry = stop.value
        out.append(entry)
    return out


def serve_on_members(prefix: str, hubs: dict, spends: list, requester,
                     partition: bool = False) -> dict:
    """`spends` round robin over two BatchingNotaryService members, each
    over a DistributedUniquenessProvider (4 partitions, in-memory
    fabric, one TestClock): one flush per member, then the fabric and
    the providers' ticks until every answer is in."""
    du, msg = _m(prefix, "node.distributed_uniqueness"), _m(prefix, "node.messaging")
    nm, svc_mod = _m(prefix, "node.notary"), _m(prefix, "node.services")
    names = tuple(hubs)
    clock = svc_mod.TestClock()
    faults = msg.FabricFaults(clock=clock)
    net = msg.InMemoryMessagingNetwork(clock=clock, faults=faults)
    decisions: list = []
    policy = du.XShardPolicy(timeout_micros=1_000_000, backoff_base_micros=50_000,
                             backoff_cap_micros=200_000, reservation_ttl_micros=1_000_000)
    provs = {n: du.DistributedUniquenessProvider(n, names, net.endpoint(n), clock,
                                                 n_partitions=4, policy=policy, seed=k,
                                                 decision_log=decisions)
             for k, n in enumerate(names)}
    svcs = {n: nm.BatchingNotaryService(hubs[n], provs[n], max_batch=10**6) for n in names}
    if partition:
        faults.partition({names[0]}, {names[1]})
    started = {n: _start([svcs[n].process(s, requester)
                          for s in spends[k::len(names)]])
               for k, n in enumerate(names)}
    for n in names:
        svcs[n].flush()
    for _ in range(40):
        net.run()
        for p in provs.values():
            p.tick()
        clock.advance(100_000)
    answers = [None] * len(spends)
    for k, n in enumerate(names):
        answers[k::len(names)] = _finish(started[n])
    return {"answers": answers, "decisions": decisions,
            "committed": {n: p.store.committed for n, p in provs.items()},
            "dispatches": sum(s.batches_dispatched for s in svcs.values()),
            "reservations": sum(p.reservation_count() for p in provs.values())}


@pytest.mark.parametrize("partition", [False, True], ids=["healed", "partitioned"])
def test_batching_members_on_the_kernel_path_equal_the_references(partition):
    import corda_tpu.core.serialization as rser
    import corda_tpu.crypto.batch_verifier as rbv
    import corda_tpu_torch.core.serialization as pser
    import corda_tpu_torch.crypto.batch_verifier as pbv
    from corda_tpu_torch.testing.notary_fixture import (
        answer_kind,
        notary_hub,
        rival_free_mismatches,
    )
    from test_torch_notary import _reference_hub, fixture

    fx = fixture()
    spends = fx.spends[:N_SERVED]
    verifier = pbv.CudaBatchVerifier(batch_sizes=(16,), device="cpu")
    port = serve_on_members("corda_tpu_torch",
                            {n: notary_hub(fx, verifier) for n in ("M0", "M1")},
                            spends, fx.requester, partition)
    r_hubs = {}
    for n in ("M0", "M1"):
        r_hubs[n], _, requester = _reference_hub(fx, rbv.CpuBatchVerifier())
    ref = serve_on_members("corda_tpu", r_hubs, [rser.decode(pser.encode(s)) for s in spends],
                           requester, partition)
    kinds = [answer_kind(a) for a in port["answers"]]
    assert kinds == [answer_kind(a) for a in ref["answers"]]
    for p, r in zip(port["answers"], ref["answers"]):
        if answer_kind(p) == "ok":
            assert p.signature == r.signature
            assert pser.encode(p.partial_merkle) == rser.encode(r.partial_merkle)
    assert _decisions(port["decisions"]) == _decisions(ref["decisions"])
    assert {n: _plain(c) for n, c in port["committed"].items()} == {
        n: _plain(c) for n, c in ref["committed"].items()}
    assert port["dispatches"] == 2 and port["reservations"] == ref["reservations"] == 0
    if partition:
        assert "shard-unavailable" in kinds and "ok" in kinds
    else:
        assert rival_free_mismatches(kinds, fx.labels, spends) == []
        assert kinds != fx.labels[:N_SERVED]   # a double spend's rival won here
