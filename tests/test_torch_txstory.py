"""The transaction story (utils/txstory.py), its sqlite spill
(persistence.TxStoryIndex) and its seams in the port, held against the
reference.

- Every case of the reference's tests/test_txstory.py but those in
  LEFT_OUT runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): exactly-once terminals and
  re-answer dedupe, the terminal mapping of every notary answer, the
  bounded tables and event cap, the stage histograms and leaderboard,
  the stage-SLO rule, the index spill and its retention, QoS shed
  attribution, the batching notary's complete stories, the intent WAL's
  journal and replay events across a kill, the degraded flush's
  outcome, the parallel peer fan-out and the cross-member merge, and
  the config knobs, and GET /tx/<id> and /tx/slowest served by the
  gateway, one timeline assembled across two processes, and the three
  fleet cases (testing/fleet.py: the chaos soak's lifecycle
  reconciliation, the doctored ledger caught, the stories required).
  Source changes, all named in SUBS: every FleetSim gets a
  CpuBatchVerifier (test_torch_fleet.FLEET_SUBS), and the reference's
  MockNetworks, which build the default device verifier, get
  CpuBatchVerifier (the port's default is the card); the degraded-flush case turns the
  notary's `degraded_fallback` on, which the port leaves off by default
  (divergence D2; the verifier here is on the CPU, where the port
  allows it).
- One TestClock drive through both packages' TxStory, with a
  TxStoryIndex on each, leaves equal stories, snapshots and index rows
  (the monotonic stamps and the stage durations derived from them
  aside: they are wall readings).
- The same notary drive with the story attached in both packages
  (submissions, a flush, a shed) leaves equal stories.
"""

from __future__ import annotations

import importlib
import json
import sqlite3

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_fleet import FLEET_SUBS, cpu_fleet_sim  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_persistence import _dump_sqlite  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_bench_quick_txstory_smoke":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}
SUBS = FLEET_SUBS + (
    ("    net = MockNetwork(seed=3)\n",
     "    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier\n\n"
     "    net = MockNetwork(seed=3, batch_verifier=CpuBatchVerifier())\n"),
    # the two-process case's MockNetworks, in this process and the child
    ("    net = MockNetwork(seed=11)\n",
     "    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier\n\n"
     "    net = MockNetwork(seed=11, batch_verifier=CpuBatchVerifier())\n"),
    ("\nnet = MockNetwork(seed=11)\n", "\nnet = MockNetwork(seed=11, batch_verifier=CpuBatchVerifier())\n"),
    ("    svc.attach_txstory(story)\n    injector = DispatchFaultInjector(",
     "    svc.attach_txstory(story)\n    svc.degraded_fallback = True\n"
     "    injector = DispatchFaultInjector("),
)


def txstory_port_module():
    return port_test_module("test_txstory", subs=SUBS, _fleet_sim=cpu_fleet_sim)


@pytest.mark.parametrize("name,case", port_cases("test_txstory", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(txstory_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_txstory", LEFT_OUT)) == 23
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_txstory")))


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _wall_free(stories: list) -> str:
    """Stories without their wall readings: each event's monotonic stamp
    and the stage durations derived from those stamps."""
    out = []
    for s in stories:
        s = dict(s, stages_micros=None, total_micros=None)
        s["events"] = [{k: v for k, v in e.items() if k != "mono_us"} for e in s["events"]]
        out.append(s)
    return json.dumps(out, sort_keys=True, default=str)


def _story_drive(prefix: str, path) -> dict:
    svc, per = _m(prefix, "node.services"), _m(prefix, "node.persistence")
    tx, notary = _m(prefix, "utils.txstory"), _m(prefix, "node.notary")
    clock = svc.TestClock()
    db = per.NodeDatabase(str(path))
    story = tx.TxStory(clock=clock, index=per.TxStoryIndex(db), max_open=16, keep_done=16,
                       max_events_per_tx=8)
    for k in range(24):
        tid = f"TX{k:02d}"
        clock.advance(100 + k)
        story.admit(tid, trace_id=f"{k:#x}", deadline=10_000 + k, requester="O=Alice")
        if k % 2:
            story.journal(tid, k)
        story.flush_membership([tid], shard=k % 3)
        story.record(tid, "notary.verified")
        if k % 7 == 0:
            for j in range(10):                     # past the per-tx event cap
                story.record(tid, "verify.dispatch", attempt=j, worker="w0")
        clock.advance(50)
        answer = (notary.NotaryError("conflict", "x") if k % 5 == 0 else
                  notary.NotaryError("shed", "brownout: deadline-less") if k % 5 == 1 else None)
        if answer is None:
            story.close(tid, "committed")
        else:
            story.terminal_from(tid, answer)
        if k % 4 == 0:
            story.close(tid, "committed")          # a re-answer: dedupe
        if k % 6 == 0:
            story.tick()
    for k in range(20):                             # left open: past max_open
        clock.advance(7)
        story.admit(f"OPEN{k:02d}")
    story.tick()
    rows = _dump_sqlite(sqlite3.connect(str(path)))
    rows = [(kind, tbl, sql, None if r is None else [row[:4] + row[5:] for row in r])
            for kind, tbl, sql, r in rows if tbl.startswith("tx_story")]
    out = {"stories": _wall_free(story.stories()), "snapshot": story.snapshot(),
           "index": json.dumps(rows, default=str),
           "evicted": _wall_free([story.story("TX00")])}
    db.close()
    return out


def test_story_drive_equals_the_references(tmp_path):
    """`tx_story_events` rows are compared without their `mono_us`
    column (the wall reading), every other column byte for byte."""
    ref = _story_drive("corda_tpu", tmp_path / "ref.db")
    port = _story_drive("corda_tpu_torch", tmp_path / "port.db")
    assert port == ref
    assert ref["snapshot"]["evicted"] and ref["snapshot"]["reanswers"]
    assert '"from_index": true' in ref["evicted"] and "tx.rejected" in ref["stories"]


def _notary_story(prefix: str) -> str:
    from test_torch_qos import qos_port_module

    mod = importlib.import_module("tests.test_qos") if prefix == "corda_tpu" else qos_port_module()
    qlib, tx = _m(prefix, "node.qos"), _m(prefix, "utils.txstory")
    qos = qlib.NotaryQos(qlib.QosPolicy(min_batch=2, max_batch=64))
    net, svc, requester, spends = mod._rig(4, qos=qos, seed=12)
    qos._clock = net.clock
    story = tx.TxStory(clock=net.clock)
    svc.attach_txstory(story)
    qos.txstory = story
    now = net.clock.now_micros()
    futs = [svc.submit(stx, requester, deadline=now - 1 if i == 3 else None, arrival_micros=now)
            for i, stx in enumerate(spends)]
    svc.flush()
    assert all(f.done for f in futs)
    return _wall_free(sorted(story.stories(), key=lambda s: s["tx_id"]))


def test_notary_stories_equal_the_references():
    ref, port = _notary_story("corda_tpu"), _notary_story("corda_tpu_torch")
    assert port == ref
    stories = json.loads(ref)
    assert [s["terminal"] for s in stories].count("committed") == 3
    assert [s["reason"] for s in stories if s["terminal"] == "shed"] == ["expired"]
