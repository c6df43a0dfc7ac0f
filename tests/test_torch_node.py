"""Node boot, config, the network map and RPC in the port, held against
the reference.

- Every case of the reference's tests/test_node.py (LEFT_OUT is empty
  since the gateway and the shell came in) runs with its imports read as corda_tpu_torch on the port,
  over real sockets (test_torch_fabric.run_port_case); the reference
  side is the reference's own module.
- Byte equality: `write_config` output (each file loads in the other
  package to the same config); the frames of a network-map exchange
  (signed registrations, fetches, map updates and acks) and of an RPC
  session (requests, replies, flow handles, observations) on the
  in-memory fabric, recorded in both packages on the same seed.
- One network over real TCP of both packages: a reference Hub (map host
  and validating notary), a port Alice and a reference Bob; then the
  packages swapped. An issue, a payment each way and a refused double
  spend; both arrangements leave the same transaction ids, balances,
  consumed refs and notary commits.
- A whole node carried across: stopped with undelivered frames in its
  outbound journal, it boots in the other package with the same
  identity, TLS fingerprint and vault, and the frames are delivered
  once. Both directions.
- No fallback: a node with the default backend ("tpu": the card) boots
  without one; its first signature check raises the device error and
  a notary on the default backend answers no flush `ok`; nothing
  answers on the CPU in its place.
- D6: a node builds every plane its config asks for
  (`unported_planes == ()`), and none when the config turns them off.
- `web_port = 0` boots the gateway and serves /healthz; the node CLI's
  `--initial-registration` stores the doorman's TLS chain.
- A node booted from a node.toml with `notary_cluster_shards = 6`
  serves spends over its DistributedUniquenessProvider (`node.xshard`)
  with the reference node's answers and `shards_snapshot()`.
"""

from __future__ import annotations

import dataclasses
import importlib
import logging
import os
import socket
import time

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_persistence import port_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT: dict = {}


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


@pytest.mark.parametrize("name,case", port_cases("test_node", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_module(name), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_node", LEFT_OUT)) == 11
    assert set(LEFT_OUT) <= set(vars(importlib.import_module("tests.test_node")))


# ---------------------------------------------------------------------------
# config, map and RPC bytes


def _configs(prefix: str) -> list:
    cfg = _m(prefix, "node.config")
    users = (cfg.RpcUserConfig("admin", 'p"w\\x', ("ALL", "StartFlow.x")),)
    return [
        cfg.NodeConfig(name="Solo", base_dir="/tmp/solo"),
        cfg.NodeConfig(name="Hub", base_dir="/n/hub", notary="batching", notary_shards=4,
                       notary_batch_wait_micros=250, rpc_users=users, scheme="secp256r1"),
        cfg.NodeConfig(name="N0", base_dir="/n/n0", notary="raft-validating",
                       cluster_peers=("N0", "N1", "N2"), network_map_peer="Hub",
                       network_map_host="10.0.0.1", network_map_port=10001,
                       network_map_fingerprint=bytes(range(32)), verifier_backend="cpu",
                       verifier_type="out_of_process", perf_enabled=False, key_seed=9),
    ]


def test_write_config_is_the_references_and_loads_across(tmp_path):
    for k, (ref, port) in enumerate(zip(_configs("corda_tpu"), _configs("corda_tpu_torch"))):
        paths = {p: tmp_path / f"{p}-{k}.toml" for p in PACKAGES}
        _m("corda_tpu", "node.config").write_config(ref, str(paths["corda_tpu"]))
        _m("corda_tpu_torch", "node.config").write_config(port, str(paths["corda_tpu_torch"]))
        assert paths["corda_tpu_torch"].read_bytes() == paths["corda_tpu"].read_bytes()
        for reader in PACKAGES:
            for writer in PACKAGES:
                got = _m(reader, "node.config").load_config(str(paths[writer]))
                assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _recorded(prefix: str, drive) -> list:
    """Every in-memory frame of `drive(P)` in send order."""
    msg = _m(prefix, "node.messaging")
    frames = []
    enqueue = msg.InMemoryMessagingNetwork._enqueue

    def recording(net, m, target):
        frames.append((m.sender, target, m.topic, m.unique_id, bytes(m.payload)))
        return enqueue(net, m, target)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(msg.InMemoryMessagingNetwork, "_enqueue", recording)
        drive(prefix)
    return frames


def _map_exchange(prefix: str) -> None:
    msg, nm = _m(prefix, "node.messaging"), _m(prefix, "node.network_map")
    svc = _m(prefix, "node.services")
    schemes, identity = _m(prefix, "crypto.schemes"), _m(prefix, "core.identity")
    clock = svc.TestClock()
    net = msg.InMemoryMessagingNetwork(clock=clock)
    hub = nm.NetworkMapService(net.endpoint("Hub"), clock)
    clients = []
    for k, name in enumerate(("Alice", "Bob")):
        kp = schemes.generate_keypair(seed=20 + k)
        party = identity.Party(name, kp.public)
        info = svc.NodeInfo(address=name, legal_identity=party, host="127.0.0.1",
                            port=10002 + k, tls_fingerprint=bytes([k]) * 32)
        hub_svc = svc.ServiceHub(info, svc.KeyManagementService(kp),
                                 svc.IdentityService(party), clock=clock,
                                 batch_verifier=_m(prefix, "crypto.batch_verifier")
                                 .CpuBatchVerifier())
        client = nm.NetworkMapClient(hub_svc, net.endpoint(name), "Hub", kp.private)
        client.register()
        client.fetch(subscribe=True)
        clients.append(client)
        net.run()
    clock.advance(nm.NetworkMapClient.DEFAULT_TTL_MICROS)
    for client in clients:
        client.tick()
    net.run()
    assert hub._version >= 2


def test_network_map_frames_are_the_references():
    ref, port = _recorded("corda_tpu", _map_exchange), _recorded("corda_tpu_torch", _map_exchange)
    assert port == ref and len(ref) >= 8


def _rpc_session(prefix: str) -> None:
    mock, bv = _m(prefix, "testing.mock_network"), _m(prefix, "crypto.batch_verifier")
    rpc, cash = _m(prefix, "node.rpc"), _m(prefix, "finance.cash")
    vq = _m(prefix, "node.vault_query")
    net = mock.MockNetwork(seed=23, batch_verifier=bv.CpuBatchVerifier())
    notary = net.create_notary("Notary", validating=True)
    alice = net.create_node("Alice")
    ops = rpc.CordaRPCOpsImpl(alice.services, alice.smm)
    rpc.RPCServer(ops, alice.messaging, rpc.RPCUserService(rpc.RpcUser("admin", "pw", ("ALL",))))
    client = rpc.RPCClient(net.fabric.endpoint("console"), "Alice", "admin", "pw")
    ident = client.node_identity()
    net.run()
    assert ident.get().legal_identity == alice.party
    fut = client.start_flow(cash.CashIssueFlow(100, "USD", alice.party, notary.party))
    net.run()
    handle = fut.get()
    net.run()
    assert handle.result.get().id is not None
    page = client.vault_query_by(vq.VaultQueryCriteria())
    bad = rpc.RPCClient(net.fabric.endpoint("console2"), "Alice", "admin", "wrong")
    refused = bad.node_identity()
    net.run()
    assert len(page.get().states) == 1
    with pytest.raises(Exception):
        refused.get()


def test_rpc_frames_are_the_references():
    ref, port = _recorded("corda_tpu", _rpc_session), _recorded("corda_tpu_torch", _rpc_session)
    assert port == ref
    topics = {f[2] for f in ref}
    assert {"rpc.requests", "rpc.replies"} <= topics


# ---------------------------------------------------------------------------
# real TCP: both packages in one network, a node carried across


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Net:
    """Nodes of either package over real sockets, pumped together."""

    def __init__(self, root):
        self.root, self.nodes = root, []

    def boot(self, prefix: str, name: str, hub=None, port: int = 0, **kw):
        cfg = _m(prefix, "node.config")
        if hub is not None:
            kw.update(network_map_peer=hub.config.name, network_map_host="127.0.0.1",
                      network_map_port=hub.messaging.listen_port,
                      network_map_fingerprint=hub.tls.fingerprint)
        config = cfg.NodeConfig(name=name, base_dir=str(self.root / name), key_seed=31,
                                p2p_port=port, **kw)
        node = _m(prefix, "node.node").Node(
            config, batch_verifier=_m(prefix, "crypto.batch_verifier").CpuBatchVerifier()).start()
        self.nodes.append(node)
        return node

    def pump_until(self, pred, timeout: float = 60.0) -> None:
        deadline = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < deadline, "not done in time"
            for n in self.nodes:
                n.pump()
            time.sleep(0.002)

    def discover(self) -> None:
        k = len(self.nodes)
        self.pump_until(lambda: all(len(n.services.network_map_cache.all_nodes()) == k
                                    for n in self.nodes))

    def run(self, node, logic):
        fsm = node.smm.start_flow(logic)
        self.pump_until(lambda: fsm.done)
        return fsm.result_or_throw()

    def stop(self, node) -> None:
        node.stop()
        self.nodes.remove(node)

    def close(self) -> None:
        for n in list(self.nodes):
            self.stop(n)


def _mixed_drive(root, hub_pkg: str, alice_pkg: str, bob_pkg: str) -> dict:
    net = _Net(root)
    try:
        hub = net.boot(hub_pkg, "Hub", notary="validating")
        alice = net.boot(alice_pkg, "Alice", hub)
        bob = net.boot(bob_pkg, "Bob", hub, scheme="secp256r1")
        net.discover()
        A, B = (_m(p, "finance") for p in (alice_pkg, bob_pkg))

        def party(viewer, name):   # a party as the viewer's package holds it
            return viewer.services.network_map_cache.node_by_name(name).legal_identity

        ids = [net.run(alice, A.CashIssueFlow(500, "USD", alice.party, party(alice, "Hub"))).id]
        ids.append(net.run(alice, A.CashPaymentFlow(200, "USD", party(alice, "Bob"))).id)
        ids.append(net.run(bob, B.CashPaymentFlow(50, "USD", party(bob, "Alice"))).id)
        coin = min(bob.vault.unconsumed_states(B.CashState),
                   key=lambda s: (s.state.data.amount.quantity, str(s.ref)))
        cf, tx = _m(bob_pkg, "flows.core_flows"), _m(bob_pkg, "core.transactions")
        cash = _m(bob_pkg, "finance.cash")

        def spend(owner):
            b = tx.TransactionBuilder(party(bob, "Hub"))
            b.add_input_state(coin)
            b.add_output_state(coin.state.data.with_owner(owner.owning_key), cash.CASH_CONTRACT)
            b.add_command(cash.CashMove(), bob.party.owning_key)
            return bob.services.sign_initial_transaction(b)

        ids.append(net.run(bob, cf.FinalityFlow(spend(party(bob, "Alice")))).id)
        fsm = bob.smm.start_flow(cf.FinalityFlow(spend(party(bob, "Hub"))))
        net.pump_until(lambda: fsm.done)
        with pytest.raises(_m(bob_pkg, "node.notary").NotaryException) as e:
            fsm.result_or_throw()
        assert e.value.error.kind == "conflict"
        nodes = (hub, alice, bob)
        fin = {n: _m(type(n).__module__.rsplit(".", 2)[0], "finance") for n in nodes}
        return {
            "ids": [str(i) for i in ids],
            "balances": {n.config.name: sum(s.state.data.amount.quantity
                                            for s in n.vault.unconsumed_states(fin[n].CashState))
                         for n in nodes},
            "consumed": sorted({str(s.ref) for n in nodes
                                for s in n.vault.consumed_states(fin[n].CashState)}),
            "commits": hub.db.query("SELECT ref_tx, ref_index, consumer, requester"
                                    " FROM notary_commits ORDER BY ref_tx, ref_index"),
        }
    finally:
        net.close()


def test_mixed_network_over_tcp_leaves_equal_ledgers(tmp_path):
    one = _mixed_drive(tmp_path / "a", "corda_tpu", "corda_tpu_torch", "corda_tpu")
    two = _mixed_drive(tmp_path / "b", "corda_tpu_torch", "corda_tpu", "corda_tpu_torch")
    assert one == two
    assert one["balances"] == {"Hub": 0, "Alice": 500, "Bob": 0}
    assert len(one["commits"]) == 3 and len(one["ids"]) == 4


@pytest.mark.parametrize("first,second", [("corda_tpu", "corda_tpu_torch"),
                                          ("corda_tpu_torch", "corda_tpu")])
def test_node_carried_across_delivers_its_journal_once(first, second, tmp_path):
    net = _Net(tmp_path)
    try:
        a = net.boot(first, "A", notary="validating")
        b = net.boot(first, "B", a, port=_free_port())
        net.discover()
        net.run(a, _m(first, "finance").CashIssueFlow(100, "USD", a.party, a.party))
        before = {"party": a.party.owning_key.data, "tls": a.tls.fingerprint,
                  "vault": sorted(str(s.ref) for s in a.vault.unconsumed_states(
                      _m(first, "finance").CashState))}
        config_b = b.config
        net.stop(b)
        for k in range(3):
            a.messaging.send("test.carry", f"frame {k}".encode(), "B")
        assert a.messaging.pending_outbound == 3
        net.stop(a)

        a2 = net.boot(second, "A", notary="validating")
        assert a2.config == _m(second, "node.config").NodeConfig(
            **{f.name: getattr(a.config, f.name) for f in dataclasses.fields(a.config)})
        after = {"party": a2.party.owning_key.data, "tls": a2.tls.fingerprint,
                 "vault": sorted(str(s.ref) for s in a2.vault.unconsumed_states(
                     _m(second, "finance").CashState))}
        assert after == before and before["vault"]
        assert a2.messaging.pending_outbound == 3
        got = []
        b2 = _m(first, "node.node").Node(
            config_b, batch_verifier=_m(first, "crypto.batch_verifier").CpuBatchVerifier())
        b2.messaging.add_handler("test.carry", lambda msg: got.append((msg.sender, msg.payload)))
        net.nodes.append(b2.start())
        net.pump_until(lambda: len(got) == 3 and a2.messaging.pending_outbound == 0)
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            for n in net.nodes:
                n.pump()
        assert got == [("A", f"frame {k}".encode()) for k in range(3)]
    finally:
        net.close()


# ---------------------------------------------------------------------------
# no fallback, D6 and the refusals


def test_default_backend_without_a_card_fails_with_the_device_error(tmp_path, monkeypatch):
    import torch

    from corda_tpu_torch.crypto import batch_verifier as bv
    from corda_tpu_torch.finance import CashIssueFlow, CashPaymentFlow
    from corda_tpu_torch.flows.api import FlowSessionException
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.node.notary import NotaryException

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend verifies on it")
    monkeypatch.setattr(bv, "_default", None)
    used = []
    verify = bv.CpuBatchVerifier.verify_batch
    monkeypatch.setattr(bv.CpuBatchVerifier, "verify_batch",
                        lambda self, reqs: used.append(len(reqs)) or verify(self, reqs))
    nodes = []

    def boot(name, **kw):
        node = Node(NodeConfig(name=name, base_dir=str(tmp_path / name), key_seed=5,
                               **kw)).start()
        nodes.append(node)
        return node

    def run(node, logic):
        fsm = node.smm.start_flow(logic)
        deadline = time.monotonic() + 60
        while not fsm.done:
            assert time.monotonic() < deadline
            for n in nodes:
                n.pump()
        return fsm

    try:
        hub = boot("Hub", notary="batching")            # the default backend: the card
        kw = dict(network_map_peer="Hub", network_map_host="127.0.0.1",
                  network_map_port=hub.messaging.listen_port,
                  network_map_fingerprint=hub.tls.fingerprint)
        alice = boot("Alice", **kw)                      # the card too
        bob = boot("Bob", verifier_backend="cpu", **kw)  # asks for the CPU
        deadline = time.monotonic() + 60
        while not all(len(n.services.network_map_cache.all_nodes()) == 3 for n in nodes):
            assert time.monotonic() < deadline
            for n in nodes:
                n.pump()
        assert hub.config.verifier_backend == alice.config.verifier_backend == "tpu"
        # Alice's first signature check raises the device error
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(alice, CashIssueFlow(100, "USD", alice.party, hub.party)).result_or_throw()
        # Bob (asked for the CPU) issues; his payment reaches the hub, whose
        # notary service checks it on the card: the device error fails
        # the notary's side, and the payment is not notarised
        run(bob, CashIssueFlow(100, "USD", bob.party, hub.party)).result_or_throw()
        with pytest.raises((NotaryException, FlowSessionException)) as e:
            run(bob, CashPaymentFlow(40, "USD", alice.party)).result_or_throw()
        assert "RuntimeError" in str(e.value) or "CUDA is not available" in str(e.value)
        notary = hub.services.notary_service
        assert notary.degraded_fallback is False
        assert notary.metrics.counter("Notary.DegradedFlushes").count == 0
        assert notary.uniqueness.committed_count == 0
        assert bv._default is None and used        # only Bob's own checks ran on the CPU
    finally:
        for n in nodes:
            n.stop()


def test_default_node_boots_without_the_unported_planes(tmp_path, caplog):
    """A default node builds the perf, device, wire and txstory planes
    (as the reference's does): no plane is left out (D6 is closed)."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node
    from corda_tpu_torch.utils import device_telemetry, perf, txstory, wire_telemetry

    caplog.set_level(logging.WARNING, logger="corda_tpu_torch.node")
    node = Node(NodeConfig(name="Solo", base_dir=str(tmp_path / "solo"))).start()
    try:
        assert node.unported_planes == ()
        assert isinstance(node.perf, perf.PerfPlane)
        assert isinstance(node.device_plane, device_telemetry.DevicePlane)
        assert isinstance(node.wire_plane, wire_telemetry.WirePlane)
        assert isinstance(node.txstory, txstory.TxStory)
        assert node.services.txstory is node.txstory and node.txstory.index is None
        # the perf plane adopted the process kernel accounting, and the
        # wire plane is the fabric's telemetry seam
        assert node.perf.kernels is perf.get_kernel_accounting()
        assert node.messaging.telemetry is node.wire_plane.fabric
        alerts = node.health.snapshot()["alerts"]
        # (the perf rules come with a batching notary, as in the reference)
        assert {"device.hbm_pressure",
                "device.fallback_active", "device.utilization_collapse",
                "wire.journal_growth", "wire.backlog", "gateway.saturated"} <= set(alerts)
        warnings = [r for r in caplog.records if r.name == "corda_tpu_torch.node"
                    and r.levelno == logging.WARNING]
        assert warnings == []
        assert node.health is not None and node.rpc_server is not None
    finally:
        node.stop()
    quiet = Node(NodeConfig(name="Quiet", base_dir=str(tmp_path / "quiet"), perf_enabled=False,
                            device_telemetry_enabled=False, wire_telemetry_enabled=False,
                            txstory_enabled=False))
    assert quiet.unported_planes == ()
    assert (quiet.perf, quiet.device_plane, quiet.wire_plane, quiet.txstory) == (None,) * 4
    assert quiet.messaging.telemetry is None
    quiet.messaging.stop()
    quiet.db.close()


def test_node_with_web_port_zero_serves_healthz(tmp_path):
    """`web_port = 0` binds the gateway on a free port before the NodeInfo
    freezes, advertises that port and serves GET /healthz once booted;
    stop() closes it."""
    import json
    import urllib.request

    from corda_tpu_torch.node.config import NodeConfig, RpcUserConfig
    from corda_tpu_torch.node.node import Node

    node = Node(NodeConfig(name="Web", base_dir=str(tmp_path / "web"), web_port=0,
                           verifier_backend="cpu",
                           rpc_users=(RpcUserConfig("u", "p", ("ALL",)),))).start()
    try:
        assert node.web is not None and node.info.web_port == node.web.port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{node.web.port}/healthz",
                                    timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["status"] in ("ok", "degraded")
    finally:
        node.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{node.web.port}/healthz", timeout=5)


def _cluster_spends(notary, n: int = 4):
    """An issue of `n` Cash states under the cluster's notary, a spend of
    each and a double spend of the first (port objects)."""
    from corda_tpu_torch.core.contracts import Amount, Issued, StateAndRef, StateRef
    from corda_tpu_torch.core.identity import Party, PartyAndReference
    from corda_tpu_torch.core.transactions import TransactionBuilder
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.finance.cash import CASH_CONTRACT, CashIssue, CashMove, CashState

    bank_kp, owner = (schemes.generate_keypair(schemes.EDDSA_ED25519_SHA512, seed=s)
                      for s in (11, 12))
    bank = Party("Bank", bank_kp.public)
    token = Issued(PartyAndReference(bank, b"\x01"), "USD")
    ib = TransactionBuilder(notary)
    for i in range(n):
        ib.add_output_state(CashState(Amount(100 + i, token), owner.public), CASH_CONTRACT)
    ib.add_command(CashIssue(1), bank.owning_key)
    issue = ib.sign_initial_transaction(bank_kp.private)
    spends = []
    for i in list(range(n)) + [0]:
        sb = TransactionBuilder()
        sb.add_input_state(StateAndRef(issue.wtx.outputs[i], StateRef(issue.id, i)))
        payee = bank if len(spends) < n else Party("Rival", owner.public)
        sb.add_output_state(CashState(Amount(100 + i, token), payee.owning_key), CASH_CONTRACT)
        sb.add_command(CashMove(), owner.public)
        spends.append(sb.sign_initial_transaction(owner.private))
    return issue, spends, Party("Alice", owner.public)


def _serve_sharded_node(prefix: str, cfg_path: str):
    import corda_tpu_torch.core.serialization as pser

    from corda_tpu_torch.testing.notary_fixture import answer_kind

    ser = _m(prefix, "core.serialization")
    node = _m(prefix, "node.node").Node(_m(prefix, "node.config").load_config(cfg_path)).start()
    try:
        assert node.xshard is not None
        assert node.services.notary_service.uniqueness is node.xshard
        assert (node.statestore is node.xshard.store) == (node.config.notary_state_store
                                                            == "commitlog")
        assert node.services.notary_service.qos is node.qos
        notary = pser.decode(ser.encode(node._cluster_identity))
        issue, spends, requester = (ser.decode(pser.encode(x))
                                    for x in _cluster_spends(notary))
        node.services.record_transactions([issue])
        svc = node.services.notary_service
        started = []
        for stx in spends:
            gen = svc.process(stx, requester)
            started.append((gen, next(gen).future))
        svc.flush()
        for _ in range(5):
            node.pump(0.02)
        answers = []
        for gen, fut in started:
            with pytest.raises(StopIteration) as stop:
                gen.send(fut.result())
            answers.append(answer_kind(stop.value.value))
        return answers, node.xshard.shards_snapshot(), "Notary.CrossShard.InFlight" in (
            node.metrics.names())
    finally:
        node.stop()


@pytest.mark.parametrize("planes", [{}, dict(notary_state_store="commitlog", qos_enabled=True)],
                         ids=["sqlite", "commitlog-qos"])
def test_sharded_cluster_node_boots_from_config_and_serves(planes, tmp_path):
    """`notary_cluster_shards = 6` in node.toml boots a batching notary
    over a DistributedUniquenessProvider (one member, every partition
    local) with the intent WAL, over sqlite or the commit-log store with
    QoS, in both packages: the spends are answered alike and
    `shards_snapshot()` is the reference node's."""
    got = {}
    for prefix in PACKAGES:
        cfgmod = _m(prefix, "node.config")
        base = tmp_path / prefix
        cfg = cfgmod.NodeConfig(name="X0", base_dir=str(base), notary="batching",
                                notary_cluster_shards=6, cluster_peers=("X0",),
                                verifier_backend="cpu", use_tls=False, notary_intent_wal=True,
                                **planes)
        base.mkdir()
        cfgmod.write_config(cfg, str(base / "node.toml"))
        got[prefix] = _serve_sharded_node(prefix, str(base / "node.toml"))
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    answers, snap, gauged = got["corda_tpu"]
    assert answers == ["ok"] * 4 + ["conflict"] and gauged
    assert snap["n_partitions"] == 6 and snap["member"] == "X0"
    assert sum(row.get("committed_depth", 0) for row in snap["partitions"]) == 4


def _qos_built(node):
    from corda_tpu_torch.node.qos import NotaryQos

    notary = node.services.notary_service
    assert isinstance(node.qos, NotaryQos) and notary.qos is node.qos
    assert node.qos.txstory is node.txstory is notary.txstory
    assert {"slo.burn_rate", "qos.shed_ratio"} <= set(node.health.snapshot()["alerts"])
    assert notary.effective_max_batch == node.qos.controller.batch


def _statestore_built(node):
    from corda_tpu_torch.node.statestore import ShardedCommitLogUniquenessProvider

    store = node.services.notary_service.uniqueness
    assert isinstance(store, ShardedCommitLogUniquenessProvider) and node.statestore is store
    assert store.stats()["backend"] == "commitlog"
    assert os.path.isdir(os.path.join(node.config.base_dir, "statestore"))


def _intent_wal_built(node):
    from corda_tpu_torch.node.persistence import NotaryIntentJournal

    journal = node.services.notary_service.intent_journal
    assert isinstance(journal, NotaryIntentJournal) and journal.unresolved_count == 0
    assert "Notary.IntentUnresolved" in node.metrics.names()


def _txstory_index_built(node):
    from corda_tpu_torch.node.persistence import TxStoryIndex

    assert isinstance(node.txstory.index, TxStoryIndex) and node.txstory.index.row_count == 0


PLANES = [
    ("qos_enabled", dict(notary="batching", qos_enabled=True), _qos_built),
    ("notary_state_store", dict(notary="batching", notary_state_store="commitlog"),
     _statestore_built),
    ("notary_intent_wal", dict(notary="batching", notary_intent_wal=True), _intent_wal_built),
    ("txstory_index", dict(txstory_index=True), _txstory_index_built),
]


@pytest.mark.parametrize("option,kw,built", PLANES, ids=[p[0] for p in PLANES])
def test_plane_option_boots_with_its_plane(option, kw, built, tmp_path):
    """Each serving-path plane option, once refused at boot, now builds
    its plane (a CPU-verifier node, so nothing reaches for a card)."""
    from corda_tpu_torch.node.config import NodeConfig
    from corda_tpu_torch.node.node import Node

    node = Node(NodeConfig(name="X", base_dir=str(tmp_path / "x"), verifier_backend="cpu",
                           **kw)).start()
    try:
        assert node.unported_planes == ()
        built(node)
        node.pump()
    finally:
        node.stop()


def test_initial_registration_stores_the_tls_chain(tmp_path):
    """`--initial-registration` against an in-process doorman over HTTP
    exits 0 with certificates/tls.pem stored; without registration_server
    it exits 1."""
    from corda_tpu_torch.node.__main__ import main
    from corda_tpu_torch.node.config import NodeConfig, write_config
    from corda_tpu_torch.node.registration import Doorman, PermissioningServer

    server = PermissioningServer(Doorman.create(auto_approve=True)).start()
    try:
        base = tmp_path / "reg"
        toml = tmp_path / "node.toml"
        write_config(NodeConfig(name="RegBank", base_dir=str(base),
                                registration_server=server.url), str(toml))
        assert main(["--config", str(toml), "--initial-registration"]) == 0
        assert b"BEGIN CERTIFICATE" in (base / "certificates" / "tls.pem").read_bytes()
        write_config(NodeConfig(name="Lone", base_dir=str(tmp_path / "lone")), str(toml))
        assert main(["--config", str(toml), "--initial-registration"]) == 1
    finally:
        server.stop()


def test_worker_process_without_cpu_exits_with_the_device_error(tmp_path):
    """`python -m corda_tpu_torch.node.verifier` builds a CudaBatchVerifier
    at start: without `--cpu` and without a card it exits non-zero with
    the device error; with `--cpu --profile-hz 19 --profile-out f` it
    serves, profiles its threads and on SIGINT writes the folded stacks
    to f and exits 0."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker verifies on it")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = [sys.executable, "-m", "corda_tpu_torch.node.verifier", "--name", "w0",
            "--node", "A", "--node-port", "1", "--db", str(tmp_path / "w0.db")]
    out = subprocess.run(base, cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    folded = tmp_path / "w0.folded"
    out = subprocess.run([sys.executable, "-c", _SIGINT_WHEN_SERVING, *base[3:], "--cpu",
                          "--profile-hz", "19", "--profile-out", str(folded)],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"profile: folded stacks -> {folded}" in out.stderr
    stacks = folded.read_text().splitlines()
    assert stacks and all(line.rsplit(" ", 1)[1].isdigit() for line in stacks)
    assert any("verifier.py:main" in line for line in stacks)


# the worker's main() with these arguments, sent SIGINT once it has
# served a few seconds (a signal landing in the imports would be a
# KeyboardInterrupt there, not a stop)
_SIGINT_WHEN_SERVING = r"""
import os, signal, sys, threading, time
imported = threading.Event()
def stop():
    imported.wait()
    time.sleep(3)
    os.kill(os.getpid(), signal.SIGINT)
threading.Thread(target=stop, daemon=True).start()
from corda_tpu_torch.node.verifier import main
imported.set()
main(sys.argv[1:])
"""
