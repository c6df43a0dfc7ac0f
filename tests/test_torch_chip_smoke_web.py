"""Rehearsals of chip_smoke.py's phase 16 (the web gateway, the remote
shell, the replacement flows and the doorman) on the CPU at a small
size, over CPU verifiers, and its checks fed wrong answers."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import _RecordingCpu  # noqa: E402


def _host_sampler(monkeypatch):
    """The card's device sampler reads the host as one cpu device here,
    as the CPU stands in for the card."""
    from corda_tpu_torch.utils import device_telemetry as dt

    monkeypatch.setattr(dt, "cuda_devices", dt.host_devices)


def test_web_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_web over a recording CpuBatchVerifier: 16a's REST
    drive with every check (balances, the explorer, every plane, the
    gateway accounting, /cluster and /tx/<id>) and its rerun over
    verifier_backend = "cpu" to an equal ledger, 16b's remote shell,
    16c's replacement flows equal to a CpuBatchVerifier run's, 16d's
    registration process, refusals and registered node all pass; and the
    phase's last check, that ed_ladder, wei_ladder_windowed and
    wei_ladder launched, refuses a run in which no kernel did."""
    import torch

    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    _host_sampler(monkeypatch)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the web phase"):
        cs.phase_web(torch.device("cpu"), "cpu rehearsal")
    out = capsys.readouterr().out
    for line in ("web (16a): TLS from", "13 flows over REST", "REST payments/s",
                 "card calls per REST payment", "the double spend refused ['NotaryException']",
                 "{'Hub': 1080, 'Alice': 610, 'Bob': 531, 'Carol': 782}",
                 "108 plane requests answered", "the same 12 transaction ids",
                 "shell (16b): remote login to Bob over TLS, a wrong password refused",
                 "(3 steps rendered done)", "list Bob's 1 states",
                 "replacement (16c): ids 5", "'unauthorised upgrade', 'FlowException'",
                 "vaults equal", "doorman (16d): --initial-registration exit 0",
                 "legal name already in use: RegBank", "issued and paid Alice"):
        assert line in out, line


class _Answers(cs._WebRig):
    """A rig whose gateways answer from a table: (node name, path) or
    path -> (status, content type, body); anything else is an empty
    JSON object."""

    def __init__(self, table=None, **counts):
        self.table = table or {}
        self.requests = dict(counts)

    def http(self, node, method, path, body=None):
        self.requests[node.config.name] = self.requests.get(node.config.name, 0) + 1
        return self.table.get((node.config.name, path),
                              self.table.get(path, (200, "application/json", "{}")))


def _node(name: str, txs=()):
    return NS(config=NS(name=name), services=NS(validated_transactions=NS(
        all=lambda: [NS(id=NS(bytes_=bytes.fromhex(t))) for t in txs])))


def test_web_checks_refuse_wrong_answers(monkeypatch):
    """The gateway checks of 16a, and the ledger comparisons of 16a and
    16c, each refuse one wrong answer: a plane answering 404, /metrics
    without a metric, a gateway that accounts a request more than was
    made or fewer (after the settle wait), an explorer missing a recorded
    transaction, a stale peer in /cluster, a story not found, and card
    ledgers that differ from the CPU's."""
    hub, alice = _node("Hub"), _node("Alice")
    text = (200, "text/plain; version=0.0.4", "# TYPE x gauge\nx 1\n")
    ok = {"/metrics": text, "/profile": (200, "text/plain", "x 1\n"),
          **{("Alice", p): (404, "application/json", "{}") for p in cs.NOTARY_PLANES}}
    assert cs._check_planes(_Answers(ok), (hub, alice), hub, "t") == 2 * (len(cs.WEB_PLANES) + 3)
    for path, answer, match in (
            ("/perf", (404, "application/json", "{}"), "web GET Hub/perf: 404"),
            (("Alice", "/qos"), (200, "application/json", "{}"), "web GET Alice/qos: 200"),
            ("/metrics", (200, "text/plain; version=0.0.4", "x 1\n"), "holds no metric")):
        with pytest.raises(RuntimeError, match=match):
            cs._check_planes(_Answers({**ok, path: answer}), (hub, alice), hub, "t")

    def wire(n):
        return {"/wire": (200, "application/json",
                          json.dumps({"gateway": {"endpoints": {"/a": {"requests": n}}}}))}

    assert cs._check_gateway_accounting(_Answers(wire(3), Hub=3), (hub,), "t") == {"Hub": 3}
    with pytest.raises(RuntimeError, match="counts 4 gateway requests, the phase made 3"):
        cs._check_gateway_accounting(_Answers(wire(4), Hub=3), (hub,), "t")
    monkeypatch.setattr(cs, "WEB_SETTLE", 0.2)
    with pytest.raises(RuntimeError, match=r"counts 2 gateway requests, the phase made \d+"):
        cs._check_gateway_accounting(_Answers(wire(2), Hub=3), (hub,), "t")

    tx = "ab" * 32
    listing = {"/api/explorer/transactions?limit=1000": (
        200, "application/json", json.dumps({"transactions": [{"full_id": tx}]}))}
    cs._check_explorer(_Answers(listing), (_node("Hub", [tx]),), [tx], "t")
    with pytest.raises(RuntimeError, match="Hub's explorer lists 1 transactions, it recorded 2"):
        cs._check_explorer(_Answers(listing), (_node("Hub", [tx, "cd" * 32]),), [tx], "t")
    with pytest.raises(RuntimeError, match="recorded by no node"):
        cs._check_explorer(_Answers(listing), (_node("Hub", [tx]),), [tx, "cd" * 32], "t")

    def peers(stale, found=True):
        return {"/cluster": (200, "application/json", json.dumps({"nodes": {
                    "Hub": {"stale": False}, "Alice": {"stale": stale}}})),
                f"/tx/{tx.upper()}": (200, "application/json",
                                      json.dumps({"found": found, "events": [1]}))}

    cs._check_peers(_Answers(peers(False)), hub, (alice,), tx, "t")
    with pytest.raises(RuntimeError, match=r"/cluster sees \[\] of the peers \['Alice'\]"):
        cs._check_peers(_Answers(peers(True)), hub, (alice,), tx, "t")
    with pytest.raises(RuntimeError, match="holds no events"):
        cs._check_peers(_Answers(peers(False, found=False)), hub, (alice,), tx, "t")

    ledger = {"ids": ["a"], "refused": [], "balances": {}, "consumed": [], "commits": []}
    with pytest.raises(RuntimeError, match=r"web \(16a\): the card nodes' commits differ"):
        cs._same_node_ledger(ledger, {**ledger, "commits": [["x"]]}, "web (16a)")
    replaced = {"ids": ["a"], "refused": [], "vaults": {}}
    cs._same_replacement(replaced, dict(replaced))
    with pytest.raises(RuntimeError, match=r"replacement \(16c\): the card's vaults differ"):
        cs._same_replacement(replaced, {**replaced, "vaults": {"Alice": []}})


def _wrong(monkeypatch, path: str, mutate):
    """Every gateway answer to `path` passed through `mutate` first."""
    real = cs._WebRig.http

    def http(self, node, method, p, body=None):
        status, ctype, text = real(self, node, method, p, body)
        if p == path:
            status, ctype, text = mutate(status, ctype, text)
        return status, ctype, text

    monkeypatch.setattr(cs._WebRig, "http", http)


@pytest.mark.parametrize("fault,match", [
    ("double-spend-signed", r"POST Alice/api/flows/FinalityFlow: 200 .* expected 400 JSON"),
    ("balance-off", "balances over the gateways"),
], ids=["double-spend-signed", "balance-off"])
def test_web_drive_refuses_a_wrong_answer(monkeypatch, tmp_path, fault, match):
    """16a over verifier_backend = "cpu" refuses a double spend the
    notary signs (here the "double spend" spends Alice's unspent change)
    and a gateway whose balance is off by one."""
    from corda_tpu_torch.finance import CashState

    _host_sampler(monkeypatch)
    if fault == "double-spend-signed":
        spend = cs._spend

        def fresh(node, coin, notary, owner):
            coin = min(node.vault.unconsumed_states(CashState),
                       key=lambda s: s.state.data.amount.quantity)
            return spend(node, coin, notary, owner)

        monkeypatch.setattr(cs, "_spend", fresh)
    else:
        def off(status, ctype, text):
            body = json.loads(text)
            return status, ctype, json.dumps({"USD": body.get("USD", 0) + 1})

        _wrong(monkeypatch, "/api/cash/balances", off)
    with pytest.raises(RuntimeError, match=match):
        cs.web_drive(str(tmp_path / "web"), "cpu")


class _Shell:
    """connect_remote's stand-in: answers from a table by command
    prefix."""

    def __init__(self, answers):
        self.answers, self.pump = answers, lambda: None

    def run_command(self, line):
        return next(a for prefix, a in self.answers if line.startswith(prefix))


def test_shell_checks_refuse_wrong_answers(monkeypatch):
    """16b refuses a wrong password that is let in, a `flow start` that
    does not complete, a `flow watch` that renders no finished step, a
    `run vault_query_by` page and a vault listing that each miss one of
    Bob's states."""
    from corda_tpu_torch.client import json_support as js
    from corda_tpu_torch.client import shell as shellmod
    from corda_tpu_torch.core.contracts import StateRef
    from corda_tpu_torch.crypto.hashes import SecureHash

    refs = [StateRef(SecureHash.sha256(b"a"), 0), StateRef(SecureHash.sha256(b"b"), 1)]
    states = [NS(ref=r) for r in refs]
    # `run vault_query_by` answers a Page's JSON: here its decode is given
    monkeypatch.setattr(js, "loads", lambda text: NS(states=states[:1] if text == "1" else states))
    bob = NS(messaging=NS(listen_port=1), tls=NS(fingerprint=b"\x00"),
             vault=NS(unconsumed_states=lambda cls: states))
    nodes = (None, None, bob, None)
    rig = NS(pump_all=lambda: None)
    good = [("peers", "error: denied"), ("flow start", "flow completed: {}"),
            ("flow watch", "✓ verifying\n✓ notarising\nflow completed: {}"),
            ("run", "{}"), ("vault", "\n".join([f"  {r}: CashState(x)" for r in refs]
                                               + ["total: 2"]))]
    for fault, match in ((None, None), ("peers", "a wrong password was answered"),
                         ("flow start", "flow start answered"),
                         ("flow watch", "flow watch answered"),
                         ("run", "run vault_query_by listed"),
                         ("vault", "vault answered")):
        answers = list(good)
        if fault == "peers":
            answers[0] = ("peers", "Hub 127.0.0.1")
        elif fault == "flow start":
            answers[1] = ("flow start", "flow failed: insufficient USD")
        elif fault == "flow watch":
            answers[2] = ("flow watch", "flow completed: {}")
        elif fault == "run":
            answers[3] = ("run", "1")
        elif fault == "vault":
            answers[4] = ("vault", f"  {refs[0]}: CashState(x)\ntotal: 1")
        monkeypatch.setattr(shellmod, "connect_remote",
                            lambda *a, _ans=answers, **kw: (_Shell(_ans), lambda: None))
        if fault is None:
            assert cs.shell_drive(rig, nodes)["shell"]["states"] == 2
        else:
            with pytest.raises(RuntimeError, match=match):
                cs.shell_drive(rig, nodes)


def test_replacement_drive_refuses_an_unregistered_upgrade(monkeypatch):
    """16c passes over CpuBatchVerifier, and refuses a run in which the
    upgrade path was never registered (the registered upgrade fails)."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    out = cs.replacement_drive(CpuBatchVerifier())
    assert len(out["ids"]) == 5 and [r[0] for r in out["refused"]] == [
        "double spend of the old state", "unauthorised upgrade"]
    from corda_tpu_torch.core import replacement

    monkeypatch.setattr(replacement, "_UPGRADES", {})
    monkeypatch.setattr(replacement, "register_upgrade", lambda *a: None)
    with pytest.raises(RuntimeError, match="registered upgrade: FlowException"):
        cs.replacement_drive(CpuBatchVerifier())


@pytest.mark.parametrize("fault,match", [
    ("lax-doorman", "a second RegBank was answered \\(0, "),
    ("no-doorman", "--initial-registration exited 1"),
], ids=["lax-doorman", "no-doorman"])
def test_doorman_drive_refuses_a_wrong_answer(monkeypatch, tmp_path, fault, match):
    """16d refuses a doorman that lets a second key register a taken
    legal name (its own duplicate-name rule disabled), and a
    registration process that fails (its doorman URL points nowhere)."""
    from corda_tpu_torch.node import registration

    if fault == "lax-doorman":
        real = registration.Doorman.submit

        def lax(self, csr_pem, email=""):
            for r in self._requests.values():
                r["name"] = ""   # every earlier request forgets its name
            return real(self, csr_pem, email)

        monkeypatch.setattr(registration.Doorman, "submit", lax)
    else:
        register = cs._register
        monkeypatch.setattr(cs, "_register", lambda root, name, url, hub: register(
            root, name, "http://127.0.0.1:9", hub))
    _host_sampler(monkeypatch)
    rig = cs._WebRig(str(tmp_path), "cpu")
    try:
        hub = rig.boot("Hub", notary="batching")
        with pytest.raises(RuntimeError, match=match):
            cs.doorman_drive(rig, (hub, hub))
    finally:
        rig.close()
