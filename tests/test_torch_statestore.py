"""The commit-log state store (node/statestore.py) and the notary intent
WAL (persistence.NotaryIntentJournal) in the port, held against the
reference.

- Every case of the reference's tests/test_statestore.py but those in
  LEFT_OUT runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module; the reference's slow case stays
  slow): append, probe, count and reopen; the torn tail; the doctored
  sealed segment; the boot sweep; the snapshot file-set transfer; the
  crash-schedule explorer over every store boundary; accept/reject bit-exact against
  sqlite (commit_many and a serial replay); the partition primitives;
  the one-way sqlite migration; the re-shard migration; the sqlite
  provider's one-query probes and O(1) counts; the config knob; a node
  booting the store; a node's boot migration; GET /statestore through
  the port's gateway.
- The two fleet-driven cases (testing/fleet.py: the distributed
  commit-log soak through a kill, and the kill during compaction with a
  snapshot join) run with every FleetSim on a CpuBatchVerifier
  (test_torch_fleet.FLEET_SUBS).
- The intent-WAL cases of the reference's tests/test_fault_tolerance.py
  (INTENT_CASES: appends and resolutions, replay after a kill, a node's
  boot replay) run on the port the same way, its FleetSims read the
  same way.
- Cross-package:
  - the same operations leave byte-equal store directories (every file
    name and byte: segments, MANIFEST, snapshots, index, LAYOUT), and a
    directory written by either package opens in the other with an
    equal committed map, before and after compaction and re-shard;
  - `migrate_sqlite_state` over equal sqlite providers gives equal maps
    and equal store directories;
  - the intent journal's sqlite rows (DDL and every row) are equal after
    the same appends, resolutions and a replay.
"""

from __future__ import annotations

import importlib
import os
import sqlite3
from pathlib import Path

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_fleet import FLEET_SUBS, cpu_fleet_sim  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_persistence import _dump_sqlite  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT = {
    "test_bench_quick_statestore_gates_the_scale_story":
        "the reference's bench.py (the port's benchmark is ROADMAP Queue 1 #1)",
}
INTENT_CASES = (
    "test_intent_wal_appends_resolves_and_drains",
    "test_intent_wal_replay_after_kill_recovers_every_admitted_request",
    "test_node_boot_replays_intent_wal",
)


def fault_tolerance_port_module():
    return port_test_module("test_fault_tolerance", subs=FLEET_SUBS,
                            _fleet_sim=cpu_fleet_sim)


@pytest.mark.parametrize("name,case", port_cases("test_statestore", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module("test_statestore", subs=FLEET_SUBS,
                                   _fleet_sim=cpu_fleet_sim), case, tmp_path)


@pytest.mark.parametrize("case", INTENT_CASES)
def test_reference_intent_wal_case_on_the_port(case, tmp_path):
    run_port_case(fault_tolerance_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_statestore", LEFT_OUT)) == 21
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_statestore")))
    assert set(INTENT_CASES) <= set(vars(importlib.import_module("tests.test_fault_tolerance")))


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


class _Party:
    def __init__(self, name="O=PartyA"):
        self.name = name


def _rows(prefix: str, n: int, seed: int):
    """`n` single-or-double-input commits (some conflicting) in one
    package's types: (refs, tx id, requester)."""
    import random

    c, h = _m(prefix, "core.contracts"), _m(prefix, "crypto.hashes")
    rng = random.Random(seed)
    refs = [c.StateRef(h.SecureHash(rng.randbytes(32)), rng.randrange(3)) for _ in range(n)]
    return [(rng.sample(refs, rng.randint(1, 2)), h.SecureHash(rng.randbytes(32)),
             _Party(f"O=P{k % 3}")) for k in range(n)]


def _plain(committed: dict) -> dict:
    return {(bytes(r.txhash.bytes_), r.index): bytes(t.bytes_) for r, t in committed.items()}


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _write_store(prefix: str, path: Path, shards: int, seed: int):
    st = _m(prefix, "node.statestore")
    store = st.ShardedCommitLogUniquenessProvider(str(path), shards, segment_max_records=8,
                                                  compact_min_segments=2)
    outcomes = store.commit_many(_rows(prefix, 60, seed))
    store.maintain()
    committed = _plain(store.committed)
    store.close()
    return [o is None for o in outcomes], committed


@pytest.mark.parametrize("writer", PACKAGES)
def test_store_directory_crosses_the_packages(writer, tmp_path):
    """Both packages write a store from the same commits: equal outcomes,
    equal maps, byte-equal directories. The writer's directory then
    opens in the other package with the same map, which survives a
    forced compaction and a re-shard there, and the directory goes back
    to the writer with the same map again."""
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    out = {p: _write_store(p, tmp_path / p, 3, seed=5) for p in PACKAGES}
    assert out[writer] == out[reader]
    assert _tree(tmp_path / writer) == _tree(tmp_path / reader)
    ok, committed = out[writer]
    assert 0 < sum(ok) < len(ok)
    st = _m(reader, "node.statestore")
    store = st.ShardedCommitLogUniquenessProvider(str(tmp_path / writer), 3)
    assert _plain(store.committed) == committed and store.committed_count == len(committed)
    store.compact_all()
    store.close()
    store = st.ShardedCommitLogUniquenessProvider(str(tmp_path / writer), 5)   # re-shard
    assert _plain(store.committed) == committed
    store.close()
    back = _m(writer, "node.statestore").ShardedCommitLogUniquenessProvider(
        str(tmp_path / writer), 5)
    assert _plain(back.committed) == committed and back.stats()["layout_generation"] == 1
    back.close()


def _migrate(prefix: str, root: Path):
    per, st = _m(prefix, "node.persistence"), _m(prefix, "node.statestore")
    db = per.NodeDatabase(str(root / "n.db"))
    legacy = per.PersistentUniquenessProvider(db)
    for refs, tx, who in _rows(prefix, 40, seed=8):
        try:
            legacy.commit(refs, tx, who)
        except _m(prefix, "node.notary").UniquenessConflict:
            pass
    want = {(bytes(t), i): bytes(c) for t, i, c in
            db.query("SELECT ref_tx, ref_index, consumer FROM notary_commits")}
    store = st.ShardedCommitLogUniquenessProvider(str(root / "store"), 2)
    moved = st.migrate_sqlite_state(db, store)
    got = _plain(store.committed)
    left = db.query("SELECT COUNT(*) FROM notary_commits")[0][0]
    store.close()
    db.close()
    return moved, want, got, left


def test_migrate_sqlite_state_equals_the_references(tmp_path):
    out = {}
    for prefix in PACKAGES:
        (tmp_path / prefix).mkdir()
        out[prefix] = _migrate(prefix, tmp_path / prefix)
    assert out["corda_tpu_torch"] == out["corda_tpu"]
    moved, want, got, left = out["corda_tpu"]
    assert moved == len(want) > 0 and got == want and left == 0
    assert _tree(tmp_path / "corda_tpu" / "store") == _tree(tmp_path / "corda_tpu_torch" / "store")


def _journal_rows(prefix: str, path: Path) -> list:
    """Appends, resolutions, a lost resolution buffer and a replay read
    on one package's intent journal; the table's DDL and rows after."""
    mod = importlib.import_module("tests.test_fault_tolerance") if prefix == "corda_tpu" else \
        fault_tolerance_port_module()
    per = _m(prefix, "node.persistence")
    db = per.NodeDatabase(str(path))
    journal = per.NotaryIntentJournal(db)
    net, notary, svc, requester, spends = mod._rig(5, seed=17)
    seqs = [journal.append(stx, requester, 1_000 * k if k % 2 else None)
            for k, stx in enumerate(spends)]
    journal.mark_resolved(seqs[1])
    journal.mark_resolved(seqs[3])
    assert journal.flush_resolved() == 2
    journal.mark_resolved(seqs[0])
    assert journal.lose_unflushed_resolutions() == 1
    replay = [(seq, bytes(stx.id.bytes_), who.name, dl) for seq, stx, who, dl in journal.unresolved()]
    db.close()
    rows = [t for t in _dump_sqlite(sqlite3.connect(str(path)))
            if t[1] in ("notary_intents", "sqlite_sequence")]
    return [replay, rows]


def test_intent_journal_rows_equal_the_references(tmp_path):
    ref = _journal_rows("corda_tpu", tmp_path / "ref.db")
    port = _journal_rows("corda_tpu_torch", tmp_path / "port.db")
    assert port == ref
    assert [r[0] for r in ref[0]] == [1, 3, 5]
    assert os.path.getsize(tmp_path / "port.db") > 0
