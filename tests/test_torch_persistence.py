"""Persistence, the MappedSchemas and the vault query DSL in both
packages, held against the reference; and a node database carried
across the packages in both directions.

Every case of the reference's tests/test_persistence.py (10),
tests/test_schemas.py (8) and tests/test_vault_query.py (21: the ledger
cases on both the `memory` and the `sqlite` vault) runs twice on the
same seed: as the reference wrote it, on corda_tpu, and with every
`corda_tpu.` import read as `corda_tpu_torch.`, on the port. Each run
must pass its own assertions, over CpuBatchVerifier (the port's
MockNetwork is handed one where it would build a CudaBatchVerifier on
the card). The runs are recorded and must be equal between the
packages:
- every fabric frame in send order (sender, target, topic, unique id,
  payload bytes);
- every vault page a query returned (its states' canonical bytes and
  its total);
- every in-memory uniqueness map, Raft map and BFT map at the end
  (`snapshot_uniqueness_map`);
- every sqlite database the case opened: its DDL and every table's rows
  (`SELECT *`, ordered by every column).
Two of the cases that drive flows also run with the port over
CudaBatchVerifier(device="cpu", batch_sizes=(16,)), the card's path in
plain torch ops (every flow case there would take the file past two
minutes).

The carried-state test writes a seeded MockNetwork(db_dir=) in one
package (an issue, a payment, a validating notary's commits, a
checkpointed flow, the Raft members' logs and snapshots) and opens the
files in the other: equal vault pages, uniqueness map and Raft maps,
the checkpointed flow restores to the same suspension, and the notary
refuses a double spend. (The restored flow does not finish there: the
frame it awaits died with the writer's in-memory fabric. `restart_node`,
which keeps the fabric, finishes such a flow:
test_flow_checkpoint_survives_process_restart; a whole node over the
durable TCP fabric is carried across in test_torch_node.py.)

The reference's cases that boot real nodes over TCP from a node config
(REAL_NODES) run on the port and must pass their own assertions; their
runs are not recorded, since every TLS certificate and handshake nonce
is fresh. The reference's own modules run them on corda_tpu.
"""

from __future__ import annotations

import importlib
import inspect
import re
import sqlite3
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from test_torch_chip_smoke import _counted_plain_versions  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
TESTS = Path(__file__).resolve().parent
# the reference's cases that boot real nodes over TCP from a node config,
# by module: run on the port with their own assertions (module docstring)
REAL_NODES = {
    "test_raft_cluster_over_real_nodes": "test_raft_notary",
    "test_bft_cluster_over_real_nodes": "test_bft",
    "test_config_path_always_installs_signed_certificate_mode": "test_bft",
}
# parametrised fixtures of the reference's cases, with their params
FIXTURE_PARAMS = {"ledger": ("memory", "sqlite")}


# ---------------------------------------------------------------------------
# the reference's cases in both packages


def port_module(name: str) -> types.ModuleType:
    """tests/<name>.py with every `corda_tpu.` import read as
    `corda_tpu_torch.` (and its imports of other reference test modules
    read as their port modules)."""
    key = f"_torch_port_{name}"
    if key not in sys.modules:
        src = (TESTS / f"{name}.py").read_text()
        for dep in re.findall(r"from tests\.(test_\w+) import", src):
            port_module(dep)
            src = src.replace(f"from tests.{dep} import", f"from _torch_port_{dep} import")
        src = re.sub(r"\bcorda_tpu\.", "corda_tpu_torch.", src)
        mod = types.ModuleType(key)
        mod.__file__ = str(TESTS / f"{name}.py")
        sys.modules[key] = mod
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return sys.modules[key]


def reference_module(name: str) -> types.ModuleType:
    return importlib.import_module(f"tests.{name}")


def cases_of(name: str) -> list:
    """(name, case, fixture param) for every case of a reference module
    that is ported."""
    mod = reference_module(name)
    out = []
    for case, fn in vars(mod).items():
        if not case.startswith("test_") or not callable(fn) or case in REAL_NODES:
            continue
        params = [FIXTURE_PARAMS[a] for a in inspect.signature(fn).parameters
                  if a in FIXTURE_PARAMS]
        for param in (params[0] if params else (None,)):
            out.append(pytest.param(name, case, param,
                                    id=case if param is None else f"{case}[{param}]"))
    return out


def _dump_sqlite(conn) -> list:
    out = []
    for kind, tbl, sql in conn.execute(
            "SELECT type, name, sql FROM sqlite_master ORDER BY type, name").fetchall():
        rows = None
        if kind == "table":
            n = len(conn.execute(f"PRAGMA table_info({tbl})").fetchall())
            order = ",".join(str(i + 1) for i in range(n))
            rows = conn.execute(f"SELECT * FROM {tbl} ORDER BY {order}").fetchall()
        out.append((kind, tbl, sql, rows))
    return out


class Recording:
    """Frames, vault pages, uniqueness maps and databases of one case run
    in one package (module docstring)."""

    def __init__(self, prefix: str, root: Path, verifier):
        self.prefix, self.root, self.verifier = prefix, root, verifier
        self.frames: list = []
        self.pages: list = []
        self._maps: list = []
        self._dbs: list = []

    def _m(self, name):
        return importlib.import_module(f"{self.prefix}.{name}")

    def patch(self, mp: pytest.MonkeyPatch) -> None:
        msg, svc, pers = self._m("node.messaging"), self._m("node.services"), \
            self._m("node.persistence")
        ser = self._m("core.serialization")
        enqueue = msg.InMemoryMessagingNetwork._enqueue

        def recording_enqueue(net, m, target):
            self.frames.append((m.sender, target, m.topic, m.unique_id, bytes(m.payload)))
            return enqueue(net, m, target)

        mp.setattr(msg.InMemoryMessagingNetwork, "_enqueue", recording_enqueue)
        for cls in (svc.VaultService, pers.PersistentVaultService):
            query_by = cls.__dict__["query_by"]

            def recording_query(vault, *a, _q=query_by, **kw):
                page = _q(vault, *a, **kw)
                self.pages.append((ser.encode(list(page.states)),
                                   page.total_states_available))
                return page

            mp.setattr(cls, "query_by", recording_query)
        for cls in (self._m("node.notary").InMemoryUniquenessProvider,
                    self._m("node.raft").RaftUniquenessProvider,
                    self._m("node.bft").BFTNotaryService):
            self._track(mp, cls, self._maps)
        self._track(mp, pers.NodeDatabase, self._dbs)
        if self.prefix == "corda_tpu_torch":
            mp.setattr("corda_tpu_torch.testing.mock_network.CudaBatchVerifier", self.verifier)

    @staticmethod
    def _track(mp, cls, into: list) -> None:
        init = cls.__init__

        def tracking_init(obj, *a, **kw):
            into.append(obj)
            init(obj, *a, **kw)

        mp.setattr(cls, "__init__", tracking_init)

    def finish(self) -> dict:
        snap = self._m("node.notary").snapshot_uniqueness_map
        dbs = {}
        for db in self._dbs:
            if db.path == ":memory:":
                if db._conn is not None:
                    dbs[f":memory:{len(dbs)}"] = _dump_sqlite(db._conn)
                continue
            path = Path(db.path)
            key = str(path.relative_to(self.root)) if path.is_relative_to(self.root) else path.name
            if key not in dbs:
                conn = sqlite3.connect(str(path))
                try:
                    dbs[key] = _dump_sqlite(conn)
                finally:
                    conn.close()
        return {"frames": self.frames, "pages": self.pages,
                "maps": [snap(p.committed) for p in self._maps], "dbs": dbs}


def run_case(name: str, case: str, param, prefix: str, root: Path, verifier=None) -> dict:
    """One reference case in one package, recorded."""
    mod = reference_module(name) if prefix == "corda_tpu" else port_module(name)
    if verifier is None:
        verifier = importlib.import_module(f"{prefix}.crypto.batch_verifier").CpuBatchVerifier
    root.mkdir(parents=True, exist_ok=True)
    rec = Recording(prefix, root, verifier)
    fn = getattr(mod, case)
    counter = iter(range(1_000))

    def tmp():
        d = root / f"tmp{next(counter)}"
        d.mkdir()
        return d

    with pytest.MonkeyPatch.context() as mp:
        rec.patch(mp)
        kwargs = {}
        for arg in inspect.signature(fn).parameters:
            if arg == "tmp_path":
                kwargs[arg] = tmp()
                continue
            fixture = getattr(mod, arg).__wrapped__
            fkw = {}
            for farg in inspect.signature(fixture).parameters:
                fkw[farg] = tmp() if farg == "tmp_path" else SimpleNamespace(param=param)
            kwargs[arg] = fixture(**fkw)
        fn(**kwargs)
    return rec.finish()


def assert_equal_runs(ref: dict, port: dict) -> None:
    for i, (a, b) in enumerate(zip(ref["frames"], port["frames"])):
        assert a == b, f"frame {i} differs: reference {a[:4]}, port {b[:4]}"
    assert len(ref["frames"]) == len(port["frames"])
    assert port["pages"] == ref["pages"]
    assert port["maps"] == ref["maps"]
    assert sorted(port["dbs"]) == sorted(ref["dbs"])
    for key, tables in ref["dbs"].items():
        for a, b in zip(tables, port["dbs"][key]):
            assert a == b, f"{key}: {a[0]} {a[1]} differs"
        assert len(tables) == len(port["dbs"][key])


def check_case(name, case, param, tmp_path, verifier=None) -> dict:
    ref = run_case(name, case, param, "corda_tpu", tmp_path / "corda_tpu")
    port = run_case(name, case, param, "corda_tpu_torch", tmp_path / "corda_tpu_torch",
                    verifier)
    assert_equal_runs(ref, port)
    return port


def device_path_verifier():
    """CudaBatchVerifier on the CPU: the card's path in plain torch ops."""
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier

    return CudaBatchVerifier(device="cpu", batch_sizes=(16,))


@pytest.mark.parametrize(
    "name,case,param",
    cases_of("test_persistence") + cases_of("test_schemas") + cases_of("test_vault_query"))
def test_case_equals_the_reference(name, case, param, tmp_path):
    check_case(name, case, param, tmp_path)


def test_case_count():
    """Every case of the three reference modules is held: 10 + 8 + 21."""
    got = [len(cases_of(n)) for n in ("test_persistence", "test_schemas", "test_vault_query")]
    assert got == [10, 8, 21]


@pytest.mark.parametrize("case", sorted(REAL_NODES))
def test_real_node_case_on_the_port(case, tmp_path):
    from test_torch_fabric import run_port_case

    run_port_case(port_module(REAL_NODES[case]), case, tmp_path)


@pytest.mark.parametrize("name,case", [
    ("test_persistence", "test_notary_restart_still_blocks_double_spend"),
    ("test_vault_query", "test_track_by_reports_consumption_and_close"),
])
def test_flow_case_on_the_device_path_equals_the_reference(name, case, tmp_path, monkeypatch):
    """A flow-driving case over CudaBatchVerifier(device="cpu"), each
    ladder launch counted through its plain version."""
    from corda_tpu_torch.crypto import cuda_ec

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cuda_ec, "ed_ladder_launches", 0)
    param = "sqlite" if name == "test_vault_query" else None
    port = check_case(name, case, param, tmp_path, device_path_verifier)
    assert port["frames"] and cuda_ec.ed_ladder_launches


# ---------------------------------------------------------------------------
# a node database carried across the packages


CARRY_SEED = 41
CARRY_RAFT_ENTRIES = 1_030   # past one snapshot at the reference's interval of 1,024


def _carry_net(P, db_dir):
    net = P.mock.MockNetwork(seed=CARRY_SEED, db_dir=str(db_dir),
                             batch_verifier=P.bv.CpuBatchVerifier())
    notary = net.create_notary("Notary", validating=True)
    _, members = net.create_raft_notary_cluster(3)
    alice, bob = net.create_node("Alice"), net.create_node("Bob")
    return net, notary, members, alice, bob


def _pkg(prefix):
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    return SimpleNamespace(
        mock=m("testing.mock_network"), bv=m("crypto.batch_verifier"), cash=m("finance.cash"),
        vq=m("node.vault_query"), notary=m("node.notary"), cf=m("flows.core_flows"),
        tx=m("core.transactions"), contracts=m("core.contracts"), hashes=m("crypto.hashes"),
        ser=m("core.serialization"))


def _vault_page(P, node) -> list:
    page = node.vault.query_by(P.vq.VaultQueryCriteria(status=P.vq.ALL))
    return [P.ser.encode(list(page.states)), page.total_states_available]


def _notary_rows(node) -> list:
    return node.services.db.query(
        "SELECT ref_tx, ref_index, consumer, requester FROM notary_commits"
        " ORDER BY ref_tx, ref_index")


def _settle_raft(net, members) -> None:
    """Heartbeats until every member applied every entry of the log."""
    for _ in range(50):
        last = max(m.raft.last_log_index for m in members)
        if all(m.raft.last_applied == last for m in members):
            return
        net.clock.advance(20_000)
        net.run()
    raise AssertionError("the Raft members did not converge")


def _raft_maps(P, members) -> list:
    return [P.notary.snapshot_uniqueness_map(m.services.notary_service.uniqueness.committed)
            for m in members]


def write_carried_state(prefix: str, db_dir: Path) -> dict:
    """A seeded drive that leaves every kind of durable state in the
    nodes' databases, then closes them."""
    P = _pkg(prefix)
    db_dir.mkdir()
    net, notary, members, alice, bob = _carry_net(P, db_dir)
    leader = net.elect(members)
    alice.run_flow(P.cash.CashIssueFlow(1000, "USD", alice.party, notary.party))
    alice.run_flow(P.cash.CashPaymentFlow(300, "USD", bob.party))
    provider = leader.services.notary_service.uniqueness
    rng = __import__("random").Random(CARRY_SEED)
    futs = []
    for _ in range(CARRY_RAFT_ENTRIES):   # one entry per round, as a notary commits them
        ref = P.contracts.StateRef(P.hashes.SecureHash(rng.randbytes(32)), 0)
        futs.append(provider.commit_async([ref], P.hashes.SecureHash(rng.randbytes(32)),
                                          alice.party))
        net.run()
    assert all(f.done for f in futs) and all(f.result() is None for f in futs)
    _settle_raft(net, members)
    assert all(m.raft.snap_index >= 1024 for m in members)
    # a checkpointed payment: suspended at its first send when the
    # process ends
    alice.start_flow(P.cash.CashPaymentFlow(100, "USD", bob.party))
    assert len(alice.services.checkpoint_storage.all()) == 1
    out = {"pages": {n.name: _vault_page(P, n) for n in (alice, bob)},
           "notary": _notary_rows(notary), "raft": _raft_maps(P, members)}
    for node in net.nodes:
        node.services.db.close()
    return out


def read_carried_state(prefix: str, db_dir: Path) -> dict:
    """Open another run's databases on the same seed: the vault, the
    notary's commits and the Raft members' state come back, the
    checkpointed payment restores and a double spend is refused."""
    P = _pkg(prefix)
    net, notary, members, alice, bob = _carry_net(P, db_dir)
    out = {"pages": {n.name: _vault_page(P, n) for n in (alice, bob)},
           "notary": _notary_rows(notary)}
    net.elect(members)
    _settle_raft(net, members)
    out["raft"] = _raft_maps(P, members)
    out["checkpoints"] = alice.services.checkpoint_storage.all()
    assert alice.smm.restore_checkpoints() == 1
    fsm, = alice.smm.flows.values()
    out["restored"] = [type(fsm.logic).__name__, repr(fsm.waiting)]
    balances = {n.name: sum(s.state.data.amount.quantity
                            for s in n.vault.unconsumed_states(P.cash.CashState))
                for n in (alice, bob)}
    assert balances == {"Alice": 700, "Bob": 300}
    spent = alice.vault.consumed_states(P.cash.CashState)[0]
    b = P.tx.TransactionBuilder(notary.party)
    b.add_input_state(spent)
    b.add_output_state(spent.state.data.with_owner(alice.party.owning_key),
                       P.cash.CASH_CONTRACT)
    b.add_command(P.cash.CashMove(), alice.party.owning_key)
    with pytest.raises(P.notary.NotaryException) as e:
        alice.run_flow(P.cf.FinalityFlow(alice.services.sign_initial_transaction(b)))
    assert e.value.error.kind == "conflict"
    out["conflict"] = sorted(str(h) for h in e.value.error.conflict.values())
    for node in net.nodes:
        node.services.db.close()
    return out


@pytest.mark.parametrize("writer,reader", [("corda_tpu", "corda_tpu_torch"),
                                           ("corda_tpu_torch", "corda_tpu")])
def test_node_databases_carry_across_the_packages(writer, reader, tmp_path):
    import shutil

    written = write_carried_state(writer, tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    own = read_carried_state(writer, tmp_path / "a")
    other = read_carried_state(reader, tmp_path / "b")
    for got in (own, other):
        assert got["pages"] == written["pages"]
        assert got["notary"] == written["notary"] and written["notary"]
        assert got["raft"] == written["raft"]
        assert len(written["raft"][0]) == CARRY_RAFT_ENTRIES
    assert own["checkpoints"] and own["restored"][0] == "CashPaymentFlow"
    assert other == own
