"""Rehearsals of chip_smoke.py's phase 14 (the notary's serving-path
planes: QoS, the transaction story, the intent WAL and the commit-log
store) on the CPU at a small size, and its checks fed wrong answers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import (  # noqa: E402,F401 - one_thread is a fixture
    SMALL_FIXTURE, _counted_plain_versions, _RecordingCpu, one_thread)


def _small(monkeypatch, spends: int = 64):
    monkeypatch.setattr(cs, "PLANES_SPENDS", spends)
    monkeypatch.setattr(cs, "PLANES_TIMED", spends // 2)
    monkeypatch.setattr(cs, "DEFAULT_SPENDS", 32)
    monkeypatch.setattr(cs, "DURABLE_SPENDS", 32)
    monkeypatch.setattr(cs, "NODE_PLANE_SPENDS", 16)
    monkeypatch.setattr(cs, "PLANES_CLIENTS", 32)
    # the flooder's bucket sized to its share of 64 spends
    monkeypatch.setattr(cs, "PLANES_POLICY", dict(cs.PLANES_POLICY, admission_burst=2))


def test_planes_phase_rehearsed_on_the_cpu(monkeypatch, capsys, tmp_path):
    """chip_smoke.phase_planes at 64 spends over CPU verifiers on a
    TestClock: every check of 14a-14d runs and passes (the sheds by
    deadline and by admission, each answer its label or a typed shed,
    the admitted answers equal to a notary's without QoS, every story
    reconciled; the replay after the kill and again before the deletes,
    the commit log's map equal to sqlite's across compaction, reopen and
    migration; the node from node.toml with every plane), and the
    phase's last check — that ed_ladder and wei_ladder_windowed launched
    — refuses a run in which no kernel did."""
    import torch

    from corda_tpu_torch.node.services import TestClock
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    _small(monkeypatch)
    fx = build_fixture(64, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the planes phase"):
        cs.phase_planes(torch.device("cpu"), "cpu rehearsal", fx, clock=TestClock())
    out = capsys.readouterr().out
    for line in ('"Admission": ', '"ExpiredIngress": 2', "every answer its label or a typed shed",
                 "equal to the notary without QoS", "stories reconciled",
                 "planes (14a) flush 0:", "planes (14a) one flush of 32: planes on",
                 "planes (14b) QosPolicy() flush 3:", "planes (14b) QosPolicy(): 32 spends",
                 "planes (14c): 30 spends journaled (2 answered at entry)",
                 "each answered once as its label", "the same answers",
                 "the commit log's 24 refs equal sqlite's", "migration (24 rows)",
                 "planes (14d): a node from node.toml with every plane (unported_planes ())",
                 "16 spends through its notary", "each story's terminal in it"):
        assert line in out, line


def test_planes_qos_on_the_cards_path_on_the_cpu(monkeypatch, capsys, one_thread):
    """14a over the card's path on the CPU (CudaBatchVerifier(device=
    "cpu"), counted plain versions) at 32 spends on a TestClock: the QoS
    notary's flushes and the notary without QoS launch ed_ladder and
    wei_ladder_windowed, and every 14a check passes."""
    import torch

    from corda_tpu_torch.node.services import TestClock
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _counted_plain_versions(monkeypatch)
    _small(monkeypatch, spends=32)
    monkeypatch.setattr(cs, "CHUNK", 16)
    fx = build_fixture(32, **SMALL_FIXTURE)
    cs._zero_counters()
    out = cs.planes_qos(fx, cs._recording_verifier((16,), torch.device("cpu")), TestClock(),
                        "cpu rehearsal")
    launches = cs._read_counters()
    assert launches["ed_ladder"] and launches["wei_ladder_windowed"]
    assert out["sheds"]["ExpiredIngress"] == 1 and out["flushes"]
    assert "equal to the notary without QoS" in capsys.readouterr().out


def test_planes_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-14 check refuses a wrong answer: an answer unlike its
    label, a shed for a reason the part does not allow, an admitted
    answer unlike the notary's without QoS, a story with two terminals,
    a wrong terminal or none, a story of no submission (14a, 14b); a
    replay that answers twice or wrongly, and a commit log that loses a
    row against sqlite (14c); a node whose TxStoryIndex misses the
    stories (14d)."""
    import torch

    from corda_tpu_torch.node import persistence, statestore
    from corda_tpu_torch.node.services import TestClock
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    labels = ["ok", "conflict", "ok", "invalid-signature"]
    ok_reasons = {"ExpiredIngress"}
    cs._check_planes_answers(["shed", "ok", "ok", "invalid-signature"],
                             ["ExpiredIngress", None, None, None], labels, ok_reasons, "t")
    for kinds, reasons in ((["ok", "ok", "ok", "invalid-signature"], [None] * 4),
                           (["shed", "ok", "ok", "invalid-signature"],
                            ["Admission", None, None, None]),
                           (["ok", "conflict", "ok"], [None] * 3)):
        with pytest.raises(RuntimeError, match="answers differ|shed for|answers for"):
            cs._check_planes_answers(kinds, reasons, labels, ok_reasons, "t")
    with pytest.raises(RuntimeError, match="differ from the notary without QoS"):
        cs._check_same_as_plain(["ok", "ok"], {0: "ok", 1: "conflict"}, "t")

    def story(tid, *names, terminal="committed", reason=None):
        return {"tx_id": tid, "events": [{"name": n} for n in names], "terminal": terminal,
                "reason": reason}

    good = [story("a", "notary.admit", "tx.committed"),
            story("b", "qos.shed", "tx.shed", terminal="shed", reason="expired")]
    args = (["a", "b", "c"], ["ok", "shed", "wrong-notary"], [None, "ExpiredIngress", None])
    cs._check_lifecycle(good, *args, "t")
    for stories in ([good[0]],
                    [story("a", "tx.committed", "tx.committed"), good[1]],
                    [story("a", "tx.rejected", terminal="rejected"), good[1]],
                    [good[0], story("b", "tx.shed", terminal="shed", reason="admission")],
                    good + [story("c", "tx.committed")],
                    good + [story("d", "notary.admit", terminal=None)]):
        with pytest.raises(RuntimeError, match="story|terminal|stories"):
            cs._check_lifecycle(stories, *args, "t")
    with pytest.raises(RuntimeError, match="evicted"):
        cs._check_lifecycle(good, *args, "t", evicted=1)

    # 14c: replays answered twice or unlike their labels
    fut = type("F", (), {})
    replayed = [(1, "x", fut), (2, "y", fut)]
    cs._check_replay(replayed, ["x", "y"], {"x": "ok", "y": "conflict"},
                     {"x": "ok", "y": "conflict"}, "t")
    with pytest.raises(RuntimeError, match="intents replayed"):
        cs._check_replay(replayed + [(3, "x", fut)], ["x", "y"], {"x": "ok", "y": "conflict"},
                         {"x": "ok", "y": "conflict"}, "t")
    with pytest.raises(RuntimeError, match="unlike their labels"):
        cs._check_replay(replayed, ["x", "y"], {"x": "ok", "y": "ok"},
                         {"x": "ok", "y": "conflict"}, "t")
    # 14c through the drive: a commit log that drops a row of every batch
    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    monkeypatch.setattr(cs, "DURABLE_SPENDS", 16)
    fx = build_fixture(16, **SMALL_FIXTURE)
    write = statestore.ShardedCommitLogUniquenessProvider._write_rows
    monkeypatch.setattr(statestore.ShardedCommitLogUniquenessProvider, "_write_rows",
                        lambda self, shard, rows: write(self, shard, rows[1:]))
    (tmp_path / "c").mkdir()
    with pytest.raises(RuntimeError, match="the maps differ|replays"):
        cs.planes_durable(fx, _RecordingCpu(), TestClock(), str(tmp_path / "c"), "t")
    monkeypatch.setattr(statestore.ShardedCommitLogUniquenessProvider, "_write_rows", write)
    # 14d: a TxStoryIndex that keeps nothing
    monkeypatch.setattr(cs, "NODE_PLANE_SPENDS", 8)
    monkeypatch.setattr(persistence.TxStoryIndex, "append", lambda self, *a: None)
    (tmp_path / "d").mkdir()
    with pytest.raises(RuntimeError, match="TxStoryIndex holds"):
        cs.planes_node(fx, _RecordingCpu(), str(tmp_path / "d"), "t")
    assert torch is not None
