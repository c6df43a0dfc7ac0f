"""The client kit in the port (client/json_support.py, client/shell.py,
client/webserver.py, utils/progress_render.py, finance/web.py,
tools/web_explorer.py), held against the reference.

- Every case of the reference's tests/test_client.py runs on the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module); its MockNetwork, which builds
  the default device verifier, gets CpuBatchVerifier (the port's
  default is the card). Among them: the JSON round trip and its tag
  whitelist, the flow-argument parser, the shell's commands, its
  `flow watch` progress render and its error messages, the gateway's
  GET and POST routes and errors, /metrics, a CorDapp web API mounted
  at /api/cash, the SIMM demo's API at /api/simm (samples/simm_web.py),
  and the ledger explorer's routes and page.
- `json_support.dumps` of the same core objects, and `parse_flow_args`
  of the same texts, give equal strings and equal errors in both
  packages.
- One seeded MockNetwork drive through both packages' gateways (cash
  issue and payments over /api/cash and /api/flows, an overdraft, an
  unknown flow, every GET route of the node surface, the CorDapp API
  and the explorer, a 404) gives equal statuses, content types and
  bodies; and one shell command script gives equal output.

Both drives import the IRS demo and the SIMM web API in their package
first, so that the lists of registered flows and web plugins hold the
same entries whatever else the process imported.
"""

from __future__ import annotations

import importlib
import json
import urllib.error
import urllib.request

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
LEFT_OUT: dict = {}
CPU_NET = ("MockNetwork(seed=66)",
           "MockNetwork(seed=66, batch_verifier=__import__("
           "'corda_tpu.crypto.batch_verifier', fromlist=['_']).CpuBatchVerifier())")


def client_port_module():
    return port_test_module("test_client", subs=(CPU_NET,))


@pytest.mark.parametrize("name,case", port_cases("test_client", LEFT_OUT))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(client_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_client", LEFT_OUT)) == 21


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _core_values(prefix: str) -> list:
    c, ident = _m(prefix, "core.contracts"), _m(prefix, "core.identity")
    schemes, hashes = _m(prefix, "crypto.schemes"), _m(prefix, "crypto.hashes")
    cash = _m(prefix, "finance.cash")
    kp = schemes.generate_keypair(seed=1)
    p256 = schemes.generate_keypair(schemes.ECDSA_SECP256R1_SHA256, seed=2)
    party = ident.Party("Alice", kp.public)
    token = c.Issued(ident.PartyAndReference(party, b"\x01"), "USD")
    state = cash.CashState(c.Amount(500, token), p256.public)
    ref = c.StateRef(hashes.SecureHash.sha256(b"x"), 3)
    return [party, token, state, ref, [state, ref], {"k": party}, {ref: 7}, b"\x00\xff", None]


def test_json_dumps_equal_the_references():
    got = {p: [_m(p, "client.json_support").dumps(v, sort_keys=True) for v in _core_values(p)]
           for p in PACKAGES}
    assert got["corda_tpu_torch"] == got["corda_tpu"]
    assert '"@map"' in got["corda_tpu"][6] and '"@type"' in got["corda_tpu"][2]
    # each package reads the other's JSON back to its own value
    for a, b in (PACKAGES, PACKAGES[::-1]):
        js_b = _m(b, "client.json_support")
        for text in got[a][:4]:
            assert js_b.dumps(js_b.loads(text), sort_keys=True) == text


FLOW_ARG_TEXTS = (
    'quantity: 700, currency: "USD", recipient: Alice, notary: Notary',
    'amounts: [1, 2, {"x": "a,b"}], label: "say \\"hi\\", twice", on: true',
    "",
    "nothing here",
    "who: Mallory",
    'ref: {"@type": "no.such.Tag"}',
)


def _parsed(prefix: str) -> list:
    js = _m(prefix, "client.json_support")
    party, = _core_values(prefix)[:1]
    notary = _m(prefix, "core.identity").Party("Notary", party.owning_key)
    parties = {"Alice": party, "Notary": notary}
    out = []
    for text in FLOW_ARG_TEXTS:
        try:
            out.append(js.dumps(js.parse_flow_args(text, parties.get), sort_keys=True))
        except js.CallParseError as e:
            out.append(f"CallParseError: {e}")
    return out


def test_parse_flow_args_equal_the_references():
    ref, port = (_parsed(p) for p in PACKAGES)
    assert port == ref
    assert sum(r.startswith("CallParseError") for r in ref) == 3


def _mock_rig(prefix: str):
    """A seeded MockNetwork (Notary, Alice, Bob) with an RPC server on
    Alice and a client of it on its own fabric endpoint; the package's
    IRS flows and SIMM web API registered."""
    _m(prefix, "samples.simm_web")
    rpclib = _m(prefix, "node.rpc")
    net = _m(prefix, "testing.mock_network").MockNetwork(
        seed=66, batch_verifier=_m(prefix, "crypto.batch_verifier").CpuBatchVerifier())
    net.create_notary("Notary")
    alice = net.create_node("Alice")
    bob = net.create_node("Bob")
    users = rpclib.RPCUserService(rpclib.RpcUser("sh", "pw", ("ALL",)))
    rpclib.RPCServer(rpclib.CordaRPCOpsImpl(alice.services, alice.smm), alice.messaging, users)
    client = rpclib.RPCClient(net.fabric.endpoint("console"), "Alice", "sh", "pw")
    return net, client, bob


def _http(port: int, method: str, path: str, body=None) -> tuple:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def _gateway_drive(prefix: str) -> list:
    _m(prefix, "finance.web")
    _m(prefix, "tools.web_explorer")
    js = _m(prefix, "client.json_support")
    net, client, bob = _mock_rig(prefix)
    server = _m(prefix, "client.webserver").NodeWebServer(
        client, pump=lambda: net.run(), rpc_timeout=30).start()
    bob_json = js.to_jsonable(bob.party)
    calls = [
        ("POST", "/api/cash/issue",
         {"quantity": 1000, "currency": "USD", "recipient": "Alice", "notary": "Notary"}),
        ("POST", "/api/cash/pay", {"quantity": 250, "currency": "USD", "recipient": "Bob"}),
        ("POST", "/api/flows/CashPaymentFlow",
         {"quantity": 100, "currency": "USD", "recipient": bob_json}),
        ("POST", "/api/cash/pay", {"quantity": 10**6, "currency": "USD", "recipient": "Bob"}),
        ("POST", "/api/flows/NoSuchFlow", {}),
        ("POST", "/api/flows/CashPaymentFlow", {"quantity": 1, "currency": "USD",
                                                "recipient": "Bob"}),
    ] + [("GET", path, None) for path in (
        "/", "/api/status", "/api/network", "/api/notaries", "/api/vault",
        "/api/vault?contract=CashState", "/api/flows", "/api/plugins", "/api/cash/balances",
        "/api/explorer/dashboard", "/api/explorer/states", "/api/explorer/transactions",
        "/api/explorer/network", "/api/explorer/vault", "/api/explorer/machines",
        "/web/cash/index.html", "/web/explorer/", "/nowhere", "/metrics", "/healthz")]
    out = []
    try:
        for method, path, body in calls:
            status, ctype, text = _http(server.port, method, path, body)
            out.append((method, path, status, ctype, text))
        tid = json.loads(out[1][4])["tx_id"]
        out.append(("GET", "tx", *_http(server.port, "GET", f"/api/explorer/tx?id={tid}")))
    finally:
        server.stop()
    return out


def test_gateway_bodies_equal_the_references():
    ref, port = (_gateway_drive(p) for p in PACKAGES)
    assert [r[:4] for r in port] == [r[:4] for r in ref]
    for a, b in zip(ref, port):
        assert b == a, a[:2]
    statuses = [r[2] for r in ref]
    assert statuses[:6] == [200, 200, 200, 400, 400, 400] and statuses[-1] == 200
    balances = json.loads(ref[14][4])
    assert balances == {"USD": 650}, balances


SHELL_SCRIPT = (
    "help", "peers", "notaries", "time", "vault", "flow list",
    'flow start CashIssueFlow quantity: 700, currency: "USD", recipient: Alice, notary: Notary',
    "vault CashState",
    'flow start CashPaymentFlow quantity: 250, currency: "USD", recipient: Bob',
    'flow watch CashPaymentFlow quantity: 100, currency: "USD", recipient: Bob',
    'flow start CashPaymentFlow quantity: 1, currency: "XXX", recipient: Bob',
    "flow start CashIssueFlow quantity: 1",
    "run current_node_time", "run notary_identities", "vault",
    "flow start NoSuchFlow x: 1", "bogus",
)


def _shell_drive(prefix: str) -> list:
    net, client, _ = _mock_rig(prefix)
    shell = _m(prefix, "client.shell").Shell(client, pump=lambda: net.run(), timeout=30)
    return [shell.run_command(line) for line in SHELL_SCRIPT]


def test_shell_output_equals_the_references():
    ref, port = (_shell_drive(p) for p in PACKAGES)
    for line, a, b in zip(SHELL_SCRIPT, ref, port):
        assert b == a, line
    assert all("flow completed" in ref[i] for i in (6, 8, 9))
    assert "verifying" in ref[9] and "quantity=350" in ref[14] and "total: 1" in ref[14]
