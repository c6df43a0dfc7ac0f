"""Rehearsals of chip_smoke.py's phase 15 (distributed uniqueness across
a three-member batching cluster, its faults, and the armed sanitizer
soak) on the CPU at a small size, and its checks fed wrong answers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import (  # noqa: E402,F401 - one_thread is a fixture
    SMALL_FIXTURE, _counted_plain_versions, _RecordingCpu, one_thread)


def _small(monkeypatch, spends: int = 64):
    monkeypatch.setattr(cs, "XSHARD_SPENDS", spends)
    monkeypatch.setattr(cs, "XSHARD_FAULT_SPENDS", 24)
    monkeypatch.setattr(cs, "XSHARD_KILL_SPENDS", 8)


def test_xshard_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_xshard at 64 spends (plus 24 through the
    partition and 8 at the killed coordinator) over CPU verifiers: every
    check of 15a-15c runs and passes (the members' answers against the
    single notary's, at-most-once consumption, the serial replay, the
    quiescent journals; shard-unavailable exactly across the partition,
    the alert firing and clearing, the retries signing; recover()
    re-driving the killed coordinator; the armed soak with no inversion
    or self-deadlock), and the phase's last check — that ed_ladder and
    wei_ladder_windowed launched — refuses a run in which no kernel
    did."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    _small(monkeypatch)
    fx = build_fixture(160, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the xshard phase"):
        cs.phase_xshard(torch.device("cpu"), "cpu rehearsal", fx)
    out = capsys.readouterr().out
    for line in ("xshard (15a): 64 spends over 3 members (6 partitions)",
                 "every answer the single notary's", "replays serially to the merged map",
                 "0 reservations, 0 orphans, 0 WAL rows", "notarisations/s",
                 "the member flushes' card calls 3", "shard-unavailable (exactly those across it)",
                 "shard.unreachable fired; healed: the retries signed",
                 "recover() re-drove 8 to completion", "every owner holds the rows",
                 "0 lock-order inversions, 0 self-deadlocks", "xshard (15c) lock "):
        assert line in out, line


def test_xshard_serve_on_the_cards_path_on_the_cpu(monkeypatch, capsys, one_thread, tmp_path):
    """15a over the card's path on the CPU (CudaBatchVerifier(device=
    "cpu"), counted plain versions) at 32 spends: the single notary's and
    the members' flushes launch ed_ladder and wei_ladder_windowed, and
    every 15a check passes."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _counted_plain_versions(monkeypatch)
    _small(monkeypatch, spends=32)
    monkeypatch.setattr(cs, "CHUNK", 16)
    fx = build_fixture(32, **SMALL_FIXTURE)
    verifier = cs._recording_verifier((16,), torch.device("cpu"))
    cs._zero_counters()
    single = cs.xshard_single(fx, verifier, str(tmp_path))
    assert cs._read_counters()["ed_ladder"]
    cs._zero_counters()
    cluster, out = cs.xshard_serve(fx, verifier, str(tmp_path), single, "cpu rehearsal")
    cluster.close()
    launches = cs._read_counters()
    assert launches["ed_ladder"] and launches["wei_ladder_windowed"]
    assert out["calls"] == 3 and out["cross"] > 0
    assert "every answer the single notary's" in capsys.readouterr().out


def test_xshard_serve_refuses_members_that_made_no_card_call(monkeypatch, tmp_path):
    """15a fails when the member flushes made fewer card calls than there
    are members, even with every answer right: here the cluster's serve
    reports none."""
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _small(monkeypatch, spends=32)
    fx = build_fixture(32, **SMALL_FIXTURE)
    verifier = _RecordingCpu()
    single = cs.xshard_single(fx, verifier, str(tmp_path))
    real = cs._XShardCluster.serve
    clusters = []

    def no_calls(self, *args):
        clusters.append(self)
        answers, kinds, _, wall = real(self, *args)
        return answers, kinds, 0, wall

    monkeypatch.setattr(cs._XShardCluster, "serve", no_calls)
    try:
        with pytest.raises(RuntimeError, match="made 0 card calls, fewer than one per member"):
            cs.xshard_serve(fx, verifier, str(tmp_path), single, "t")
    finally:
        for cluster in clusters:
            cluster.close()


def _fault_cluster(monkeypatch, tmp_path):
    """A fresh phase-15 cluster on a CPU verifier and the fixture's "ok"
    spends, for 15b's checks."""
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    _small(monkeypatch)
    fx = build_fixture(160, **SMALL_FIXTURE)
    ok = [s for s, lab in zip(fx.spends, fx.labels) if lab == "ok"]
    return cs._XShardCluster(fx, _RecordingCpu(), str(tmp_path)), ok


def _sticky_unreachable(monitor, provider):
    """A broken shard.unreachable rule: once an owner is unreachable it
    stays so, whatever the provider says after the heal."""
    from corda_tpu_torch.utils.health import SEV_CRITICAL, AlertRule

    seen: set = set()

    def probe(now):
        seen.update(provider.unreachable_owners())
        return bool(seen), {"owners": sorted(seen)}

    monitor.add_rule(AlertRule("shard.unreachable", probe, severity=SEV_CRITICAL,
                               for_micros=0, clear_for_micros=0))


@pytest.mark.parametrize("fault,match", [
    ("no-partition", "are not shard-unavailable exactly for the spends across it"),
    ("no-alert", "shard.unreachable is None under the partition"),
    ("sticky-alert", "after the heal the retries answered \\['ok'\\] and "
                     "shard.unreachable is 'firing'"),
], ids=["no-partition", "no-alert", "sticky-alert"])
def test_xshard_partition_refuses_a_wrong_answer(monkeypatch, tmp_path, fault, match):
    """15b's partition checks each refuse one fault: a partition that
    cuts nothing (every spend signs), a provider that installs no alert
    rule, and an alert that does not clear after the heal."""
    from corda_tpu_torch.node.distributed_uniqueness import DistributedUniquenessProvider
    from corda_tpu_torch.utils.health import HealthMonitor

    cluster, ok = _fault_cluster(monkeypatch, tmp_path)
    if fault == "no-partition":
        monkeypatch.setattr(cluster.faults, "partition", lambda *args, **kw: None)
    elif fault == "no-alert":
        monkeypatch.setattr(DistributedUniquenessProvider, "attach_health",
                            lambda self, monitor: None)
    else:
        monkeypatch.setattr(HealthMonitor, "watch_distributed_uniqueness", _sticky_unreachable)
    try:
        spends = cs._spread(cluster, ok, cs.XSHARD_FAULT_SPENDS)
        with pytest.raises(RuntimeError, match=match):
            cs.xshard_partition(cluster, spends, "t")
    finally:
        cluster.close()


def test_xshard_kill_refuses_a_recovery_that_does_not_re_drive(monkeypatch, tmp_path):
    """15b's kill check refuses a recover() that presumes every decided
    intent aborted (its commit marks read as unset): no intent is
    re-driven and no owner holds the killed coordinator's rows."""
    from corda_tpu_torch.node.persistence import XShardCoordinatorJournal

    real = XShardCoordinatorJournal.unresolved
    monkeypatch.setattr(XShardCoordinatorJournal, "unresolved",
                        lambda self: [row[:4] + (False,) for row in real(self)])
    cluster, ok = _fault_cluster(monkeypatch, tmp_path)
    try:
        with pytest.raises(RuntimeError, match="re-drove 0 of 8 and 8 owners lack their rows"):
            cs.xshard_kill(cluster, ok, "t")
    finally:
        cluster.close()


def test_xshard_checks_raise_on_a_wrong_answer(monkeypatch, tmp_path):
    """Each phase-15 check refuses a wrong answer: an answer unlike the
    single notary's (a double spend with two winners), an input held by a
    non-owner or consumed by a spend answered otherwise, a decision log
    that accepts against the serial replay or ends elsewhere than the
    merged map, and a member left holding a reservation."""
    from corda_tpu_torch.core.contracts import StateRef
    from corda_tpu_torch.crypto.hashes import SecureHash
    from corda_tpu_torch.node.distributed_uniqueness import ShardMap
    from corda_tpu_torch.testing.notary_fixture import build_fixture

    fx = build_fixture(16, **SMALL_FIXTURE)
    spends, labels = fx.spends[:16], fx.labels[:16]
    cs._check_xshard_answers(labels, labels, spends, "t")
    k = labels.index("conflict")
    swapped = list(labels)
    swapped[k - 1], swapped[k] = "conflict", "ok"
    cs._check_xshard_answers(swapped, labels, spends, "t")
    both = list(labels)
    both[k] = "ok"
    with pytest.raises(RuntimeError, match="differ from the single notary"):
        cs._check_xshard_answers(both, labels, spends, "t")

    sm = ShardMap(cs.XSHARD_MEMBERS, cs.XSHARD_PARTITIONS)
    ok = [i for i, lab in enumerate(labels) if lab == "ok"]
    rows = {m: {} for m in cs.XSHARD_MEMBERS}
    for i in ok:
        ref = spends[i].wtx.inputs[0]
        rows[sm.owner_of(ref)][ref] = spends[i].id
    merged = cs._check_consumed_once(rows, sm, spends, labels, "t")
    ref0 = spends[ok[0]].wtx.inputs[0]
    other = next(m for m in cs.XSHARD_MEMBERS if m != sm.owner_of(ref0))
    with pytest.raises(RuntimeError, match="owned by"):
        cs._check_consumed_once({**rows, other: {ref0: spends[ok[0]].id}}, sm, spends,
                                labels, "t")
    wrong = list(labels)
    wrong[ok[0]] = "conflict"
    with pytest.raises(RuntimeError, match="committed to"):
        cs._check_consumed_once(rows, sm, spends, wrong, "t")

    refs_of = {s.id: list(s.wtx.inputs) for s in spends}
    log = [(spends[i].id, None) for i in ok]
    cs._check_serial_replay(log, refs_of, merged, "t")
    rival = spends[k]
    bad_log = log + [(rival.id, None)]
    with pytest.raises(RuntimeError, match="where a serial replay conflicts"):
        cs._check_serial_replay(bad_log, refs_of, merged, "t")
    with pytest.raises(RuntimeError, match="is not the merged committed map"):
        cs._check_serial_replay(log[1:], refs_of, merged, "t")
    with pytest.raises(RuntimeError, match="unknown transaction"):
        cs._check_serial_replay([(SecureHash(b"\x01" * 32), None)], refs_of, merged, "t")
    stray = StateRef(SecureHash(b"\x02" * 32), 0)
    with pytest.raises(RuntimeError, match="conflict set"):
        cs._check_serial_replay(log + [(rival.id, {stray: spends[k - 1].id})], refs_of,
                                merged, "t")

    cluster = cs._XShardCluster(fx, _RecordingCpu(), str(tmp_path))
    try:
        cs._check_xshard_quiescent(cluster, "t")
        p = cluster.provs["N1"]
        p._reserve_local(0, [ref0], SecureHash(b"\x03" * 32), 1, "N0", None)
        with pytest.raises(RuntimeError, match="N1 is not quiescent"):
            cs._check_xshard_quiescent(cluster, "t")
    finally:
        cluster.close()
