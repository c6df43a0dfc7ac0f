"""Rehearsals of chip_smoke.py's phases 9 (the verifier pool and the
wire ingest), 10 (persistence and the clusters) and 11 (nodes over TCP,
the CLI, the worker processes) on the CPU at a small size, and their
checks fed wrong answers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import (  # noqa: E402,F401 - one_thread is a fixture
    SMALL_FIXTURE, _counted_plain_versions, _RecordingCpu, one_thread)


def test_pool_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_pool on the CPU at 32 spends: the pool with two
    workers over the device path (9a), the same through the ingest
    pipeline (9b) with the Merkle-id stage timed, a worker lost mid-batch
    (9c) and the ring-fed notary flush (9d); the kernels' plain versions stand in for the kernels and
    count a launch each, so every check of the phase runs — answers
    against labels and against a CpuBatchVerifier worker, one dispatch
    per drain, the launches, phase 6's notary checks."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _counted_plain_versions(monkeypatch)
    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "POOL_WINDOW", 32)
    monkeypatch.setattr(cs, "POOL_SAMPLE", 8)
    monkeypatch.setattr(cs, "POOL_LOSS", 8)
    monkeypatch.setattr(cs, "POOL_CHUNK", 8)
    fx = build_fixture(32, **SMALL_FIXTURE)
    launches = cs.phase_pool(torch.device("cpu"), "cpu rehearsal", fx)
    for tag in ("9a", "9b", "9d"):
        assert launches[tag]["ed_ladder"] and launches[tag]["wei_ladder_windowed"], tag
    assert launches["9c"]["ed_ladder"]
    out = capsys.readouterr().out
    assert "pool (9a): 32 requests in" in out and "rows per dispatch [16, 16]" in out
    assert "frame bytes per request; rows per dispatch [16, 16]" in out
    assert "pool (9b, ingest shards=4): 32 requests in" in out
    assert "request frames to the workers' rings" in out
    assert "id stage: 32 transactions" in out and "gc seconds/gen-2 collections" in out
    assert out.count(" collections (gen 0/1/2)") == 3     # 9a, 9b and 9d
    assert "8 sampled answers equal a CpuBatchVerifier worker's" in out
    assert "pool worker loss (9c): 8 requests answered exactly once by the survivor" in out
    assert "workers lost 1, redispatched 4" in out
    assert "ring-fed notary (9d): 32 spends fed and flushed" in out


def test_pool_checks_raise_on_a_wrong_answer():
    """Phase 9's answer check refuses a flipped signature answered ok, a
    good spend refused, and an unanswered request."""
    labels = ["ok", "invalid-signature", "conflict", "wrong-notary"]
    bad = "VerificationFailedError: InvalidSignature: invalid signature(s) on X"
    cs._check_pool_answers(["ok", bad, "ok", "ok"], labels, "t")
    for answers in (["ok", "ok", "ok", "ok"], ["ok", bad, bad, "ok"],
                    ["ok", bad, "ok", "unanswered"]):
        with pytest.raises(RuntimeError, match="answered"):
            cs._check_pool_answers(answers, labels, "t")



def test_cluster_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_clusters on the CPU over CPU verifiers, at 64
    spends in 10a and 1,024 Raft entries in 10c: every check of 10a-10e
    runs and passes, and the phase's last check — that ed_ladder,
    wei_ladder_windowed and wei_ladder launched — refuses a run in which
    no kernel did."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    monkeypatch.setenv("CORDA_TPU_NOTARY_PROFILE", "1")
    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "DURABLE_REOPEN", 16)
    monkeypatch.setattr(cs, "RAFT_ENTRIES", 1024)
    fx = build_fixture(64, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the cluster phase"):
        cs.phase_clusters(torch.device("cpu"), "cpu rehearsal", fx)
    out = capsys.readouterr().out
    for shards in (1, 4):
        assert f"durable notary (10a) shards={shards}: 64 spends in" in out
        assert (f"durable notary (10a) shards={shards} reopened: 48 committed inputs read back; "
                "16 double spends answered conflict") in out
    assert "raft drive (10b): 6 flows completed and 1 refused" in out
    assert "raft drive (10b) over CpuBatchVerifier" in out
    assert "raft transfer (10c): 1024 commits through the leader" in out
    assert "1 snapshots (snap_index 1024)" in out and "maps equal at 1029 refs" in out
    assert "bft drive (10d): 7 flows completed and 1 refused" in out
    assert "caught up by state transfer (1 catch-up(s))" in out
    assert "crash drive (10e)" in out and "refused a double spend (conflict)" in out


def test_cluster_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-10 check refuses a wrong answer: a double spend the
    reopened notary signs (10a), a card ledger unlike the CPU run's
    (10b), a rebuilt Raft member short of a ref (10c), live maps that
    differ (10b, 10d), a replica that never catches up (10d), a vault
    page unlike the in-memory network's and a restarted notary that
    forgot its commits (10e)."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.node import bft, raft
    from corda_tpu_torch.node.notary import InMemoryUniquenessProvider
    from corda_tpu_torch.testing import mock_network
    from corda_tpu_torch.testing.notary_fixture import build_fixture, notary_hub
    from corda_tpu_torch.core import serialization as ser

    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "DURABLE_REOPEN", 4)
    # 10a: the "double spends" are the committed spends themselves, which
    # the notary accepts again (the same transaction)
    fx = build_fixture(16, **SMALL_FIXTURE)
    verifier = _RecordingCpu()
    wire = [ser.encode(s) for s in fx.spends]
    monkeypatch.setattr(cs, "_double_spends", lambda fx, picks: [fx.spends[i] for i in picks])
    with pytest.raises(RuntimeError, match="the reopened notary answered"):
        cs.durable_flush(fx, notary_hub(fx, verifier), wire, verifier, 1,
                         str(tmp_path / "n.db"), "cpu")
    # 10b: ledgers and maps
    ledger = {"ids": ["a"], "notary_sigs": [], "refused": [], "balances": {}, "leaders": []}
    cs._same_ledger(ledger, dict(ledger), "t")
    with pytest.raises(RuntimeError, match="the card's ids differ"):
        cs._same_ledger(ledger, {**ledger, "ids": ["b"]}, "t")
    with pytest.raises(RuntimeError, match="committed maps differ"):
        cs._maps_equal([{1: 2}, {1: 2}, {1: 3}], "t")
    # 10c: the rebuilt member's restore drops a ref
    (tmp_path / "raft").mkdir()
    drive = cs.raft_drive(CpuBatchVerifier(), str(tmp_path / "raft"))
    restore = raft.RaftUniquenessProvider._restore

    def lossy(self, state):
        restore(self, state)
        self.committed.pop(next(iter(self.committed)))

    monkeypatch.setattr(raft.RaftUniquenessProvider, "_restore", lossy)
    with pytest.raises(RuntimeError, match="the rebuilt member holds"):
        cs.raft_transfer(drive, 1024, "cpu")
    # 10d: a rebuilt replica that never asks to catch up
    monkeypatch.setattr(bft.BftReplica, "_maybe_request_catchup", lambda self, now: 0)
    with pytest.raises(RuntimeError, match="did not settle|did not catch up"):
        cs.bft_drive(drive["net"], [], "cpu")
    # 10e: a notary whose commits do not survive its restart
    monkeypatch.setattr(mock_network, "PersistentUniquenessProvider",
                        lambda db: InMemoryUniquenessProvider())
    (tmp_path / "crash").mkdir()
    with pytest.raises(RuntimeError, match="signed a double spend"):
        cs.crash_drive(CpuBatchVerifier(), str(tmp_path / "crash"))


def _pool_inputs(n: int):
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import build_fixture, notary_hub

    fx = build_fixture(n, **SMALL_FIXTURE)
    hub = notary_hub(fx, CpuBatchVerifier())
    return fx, [stx.to_ledger_transaction(hub) for stx in fx.spends]


def test_node_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase 11 on the CPU at small depth: (a) the trio over
    verifier_backend "cpu" nodes twice, with one concurrent payment per
    payer, leaving the equal ledgers phase 11 requires of the card's run
    and the CPU's; (b) the Raft cluster (its leader stopped, a payment
    under the new one) and the BFT cluster; (c) the two CLI node
    processes over RPC; (d) 32 phase-6 spends through two `--cpu` worker
    processes over TCP, worker 0 killed mid-batch. Every check of each
    part runs and passes; 11d at the pool's default lease."""
    from corda_tpu_torch.node.verifier import RedispatchPolicy

    monkeypatch.setattr(cs, "NODE_CONCURRENT", 1)
    one = cs.node_trio_drive(str(tmp_path / "a1"), "cpu")
    two = cs.node_trio_drive(str(tmp_path / "a2"), "cpu")
    cs._same_node_ledger(one["ledger"], two["ledger"])
    assert [r[2] for r in one["ledger"]["refused"]] == [None, "invalid-transaction", "conflict"]
    assert one["ledger"]["balances"]["Carol"] == 140 and len(one["ledger"]["commits"]) >= 7
    assert one["concurrent_flushes"] >= 1 and one["tls"]
    raft = cs.node_cluster_drive(str(tmp_path / "raft"), "cpu", "raft")
    assert len(set(raft["leaders"])) == 2 and raft["refused"][0][2] == "conflict"
    bft = cs.node_cluster_drive(str(tmp_path / "bft"), "cpu", "bft")
    assert bft["balances"] == {"Hub": 100, "Alice": 0}
    cli = cs.cli_drive(str(tmp_path / "cli"), backend="cpu", check_contexts=False)
    assert cli["balances"] == {"CliHub": 300, "CliBob": 700}
    fx, ltxs = _pool_inputs(32)
    pool = cs.pool_tcp_drive(str(tmp_path / "pool"), ltxs, fx.spends, cpu_workers=True,
                             check_contexts=False)
    cs._check_pool_answers(pool["answers"], fx.labels, "t")
    assert pool["lost"] == 1 and pool["redispatched"] > 0 and pool["deliver_s"] is not None
    assert 0 < pool["silence_s"] < pool["lease_s"] == RedispatchPolicy().lease_micros / 1e6
    assert pool["survivor"][0].startswith("verifier worker w1: ")


def test_node_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-11 check refuses a wrong answer: card and CPU ledgers
    that differ, a "double spend" the notary signs (11a), a balance off
    by one (11b), node processes that add no CUDA context (11c), and a
    pool run in which no worker is killed (11d)."""
    ledger = {"ids": ["a"], "refused": [], "balances": {}, "consumed": [], "commits": []}
    cs._same_node_ledger(ledger, dict(ledger))
    for key, wrong in (("ids", ["b"]), ("consumed", ["x"]), ("commits", [[1]])):
        with pytest.raises(RuntimeError, match=f"the card nodes' {key} differ"):
            cs._same_node_ledger(ledger, {**ledger, key: wrong})
    # 11a: the double spend spends a fresh coin, which the notary signs
    monkeypatch.setattr(cs, "NODE_CONCURRENT", 1)
    spend, spends = cs._spend, []

    def fresh_second(node, coin, notary, owner):
        spends.append(coin)
        if len(spends) == 2:
            from corda_tpu_torch.finance import CashState

            coin, = [s for s in node.vault.unconsumed_states(CashState) if s != coin][:1]
        return spend(node, coin, notary, owner)

    monkeypatch.setattr(cs, "_spend", fresh_second)
    with pytest.raises(RuntimeError, match="double spend Alice -> Carol: was not refused"):
        cs.node_trio_drive(str(tmp_path / "a"), "cpu")
    monkeypatch.setattr(cs, "_spend", spend)
    # 11b: a balance off by one
    cash = cs._cash_of
    monkeypatch.setattr(cs, "_cash_of", lambda node: cash(node) + (node.config.name == "Hub"))
    with pytest.raises(RuntimeError, match="bft cluster .11b.: balances"):
        cs.node_cluster_drive(str(tmp_path / "bft"), "cpu", "bft")
    monkeypatch.setattr(cs, "_cash_of", cash)
    # 11c: the node processes add no CUDA context
    monkeypatch.setattr(cs, "_cuda_contexts", lambda: 1)
    monkeypatch.setattr(cs, "_smi_apps", lambda: "1, 600 MiB")
    with pytest.raises(RuntimeError, match="0 new CUDA contexts for 2 node processes"):
        cs.cli_drive(str(tmp_path / "cli"), backend="cpu")
    # 11d: worker 0 is never killed (its lease still expires)
    monkeypatch.setattr(cs, "TCP_POOL_KILL_AT", 2.0)
    fx, ltxs = _pool_inputs(16)
    with pytest.raises(RuntimeError, match="killed at None, workers lost 1"):
        cs.pool_tcp_drive(str(tmp_path / "pool"), ltxs, fx.spends, cpu_workers=True,
                          check_contexts=False)
