"""Ledger explorer web UI: the browser-rendered counterpart of the

Port of corda_tpu/tools/web_explorer.py: the same routes and JSON,
mounted on every gateway a port node builds.
terminal explorer.

Reference: tools/explorer/ — the JavaFX/TornadoFX ledger GUI
(tools/explorer/src/main/kotlin/net/corda/explorer/Main.kt) with its
dashboard / cash / transactions / network views bound to the
client/jfx models. The framework is headless-first, so the
GUI is a zero-dependency HTML page served by the node's REST gateway
(`client/webserver.py`) that polls the same JSON the terminal explorer
renders — dashboard counts, balances, unconsumed states, verified
transactions and in-flight flows — over the node's RPC feeds.

Mounted at /api/explorer (JSON) and /web/explorer/ (the page):
  GET /api/explorer/dashboard       identity, peers, notaries, balance
                                    + count summary
  GET /api/explorer/states          unconsumed states with contract tag
  GET /api/explorer/transactions    verified transaction summaries
                                    (?limit=N, newest last)
  GET /api/explorer/tx?id=<hex>     one transaction in full: resolved
                                    inputs, outputs, commands+signers,
                                    signatures, and the tear-off
                                    structure (component groups with
                                    the notary-revealed flags) — the
                                    reference explorer's
                                    TransactionViewer.kt detail pane
  GET /api/explorer/network         every mapped node: address,
                                    services, notary role/cluster,
                                    liveness from the map's last
                                    sighting (Network.kt analogue)
  GET /api/explorer/vault           fungible positions by
                                    (product, issuer) + every state
                                    with its full source tx id for
                                    drill-in (CashViewer.kt analogue)
  GET /api/explorer/machines        in-flight flow state machines

The page also carries the reference explorer's "new transaction"
action (views/cordapps/cash NewTransaction.kt): cash issue and pay
forms posting to the finance CorDapp's /api/cash routes. Writes ride
the gateway's RPC login, so the node's RPCUserService permission check
(StartFlow.<flow>) gates them exactly like any RPC client.

Usage: import this module (registers the plugin) before starting the
gateway — `corda_tpu_torch.node` does it for every node with a webserver
port, the same way CorDapp web APIs mount:

    import corda_tpu_torch.tools.web_explorer  # registers /api/explorer
    NodeWebServer(client, ...).start()
    # browse http://host:port/web/explorer/
"""

from __future__ import annotations

from ..client import json_support as js
from ..client.webserver import WebApiPlugin, register_web_api
from ..node.vault_query import VaultQueryCriteria


def _vault_states(ctx):
    page = ctx.wait(ctx.client.vault_query_by(VaultQueryCriteria()))
    return page.states


def _amount_product(amount) -> str:
    token = amount.token
    # Issued tokens carry the product inside; bare tokens are products
    product = getattr(token, "product", token)
    return str(product)


def _dashboard(ctx, query, body):
    me = ctx.wait(ctx.client.node_identity()).legal_identity
    infos = ctx.wait(ctx.client.network_map_snapshot())
    notaries = [p.name for p in ctx.wait(ctx.client.notary_identities())]
    states = _vault_states(ctx)
    # count-only RPC: the dashboard polls every refresh and must not
    # copy the whole transaction store over the wire to report len()
    tx_count = ctx.wait(ctx.client.verified_transactions_count())
    machines = ctx.wait(ctx.client.state_machines_snapshot())
    flows = ctx.wait(ctx.client.registered_flows())
    balances: dict[str, int] = {}
    for sar in states:
        amount = getattr(sar.state.data, "amount", None)
        if amount is not None and hasattr(amount, "quantity"):
            product = _amount_product(amount)
            balances[product] = (
                balances.get(product, 0) + int(amount.quantity)
            )
    return 200, {
        "me": me.name,
        "peers": [
            {
                "name": info.legal_identity.name,
                "services": list(info.advertised_services),
                "address": getattr(info, "address", None),
            }
            for info in sorted(infos, key=lambda i: i.legal_identity.name)
        ],
        "notaries": sorted(notaries),
        "balances": balances,
        "states": len(states),
        "transactions": tx_count,
        "flows_in_flight": len(machines),
        "registered_flows": sorted(flows),
    }


def _states(ctx, query, body):
    states = _vault_states(ctx)
    return 200, {
        "states": [
            {
                "ref": f"{sar.ref.txhash.prefix_chars()}:{sar.ref.index}",
                "contract": sar.state.contract,
                "notary": sar.state.notary.name,
                "data": js.to_jsonable(sar.state.data),
            }
            for sar in states
        ]
    }


def _transactions(ctx, query, body):
    try:
        limit = max(0, int(query.get("limit", ["50"])[0]))
    except (TypeError, ValueError):
        limit = 50
    txs = ctx.wait(ctx.client.verified_transactions_snapshot())
    return 200, {
        "total": len(txs),
        # NB txs[-0:] would be the WHOLE list — limit=0 means none
        "transactions": [
            {
                "id": stx.id.prefix_chars(12),
                "full_id": stx.id.bytes_.hex(),
                "inputs": len(stx.wtx.inputs),
                "outputs": len(stx.wtx.outputs),
                "commands": [
                    type(c.value).__name__ for c in stx.wtx.commands
                ],
                "notary": stx.wtx.notary.name if stx.wtx.notary else None,
                "signatures": len(stx.sigs),
            }
            for stx in (txs[-limit:] if limit else [])
        ],
    }


def _tx_detail(ctx, query, body):
    """One transaction in full — the reference explorer's
    TransactionViewer detail pane (TransactionViewer.kt: inputs
    resolved to their source outputs, outputs, commands with signers,
    signatures) plus the Merkle tear-off structure: each component
    group's size and whether a non-validating notary's tear-off
    reveals it (FilteredTransaction; notary completeness checks in
    node/notary.py)."""
    from ..core.transactions import (
        G_ATTACHMENTS, G_COMMANDS, G_INPUTS, G_NOTARY, G_OUTPUTS,
        G_TIMEWINDOW,
    )
    from ..crypto.hashes import SecureHash

    tx_hex = (query.get("id", [""])[0] or "").strip()
    try:
        tx_id = SecureHash(bytes.fromhex(tx_hex))
    except (ValueError, TypeError):
        return 400, {"error": "id must be the full 64-hex-char tx id"}
    stx = ctx.wait(ctx.client.transaction_by_id(tx_id))
    if stx is None:
        return 404, {"error": f"no verified transaction {tx_hex}"}
    wtx = stx.wtx
    # one fetch per DISTINCT source tx (coin selection routinely spends
    # several outputs of one issue/change tx; each RPC is a blocking
    # round trip on a remote gateway)
    sources = {
        h: ctx.wait(ctx.client.transaction_by_id(h))
        for h in {ref.txhash for ref in wtx.inputs}
    }
    inputs = []
    for ref in wtx.inputs:
        src = sources[ref.txhash]
        state = None
        if src is not None and ref.index < len(src.wtx.outputs):
            ts = src.wtx.outputs[ref.index]
            state = {
                "contract": ts.contract,
                "data": js.to_jsonable(ts.data),
            }
        inputs.append(
            {
                "ref": f"{ref.txhash.bytes_.hex()}:{ref.index}",
                "state": state,   # None when the source tx is unknown
            }
        )
    groups = (
        (G_INPUTS, "inputs", len(wtx.inputs)),
        (G_OUTPUTS, "outputs", len(wtx.outputs)),
        (G_COMMANDS, "commands", len(wtx.commands)),
        (G_ATTACHMENTS, "attachments", len(wtx.attachments)),
        (G_NOTARY, "notary", 1 if wtx.notary else 0),
        (G_TIMEWINDOW, "time_window", 1 if wtx.time_window else 0),
    )
    revealed = {G_INPUTS, G_NOTARY, G_TIMEWINDOW}
    return 200, {
        "id": stx.id.bytes_.hex(),
        "notary": wtx.notary.name if wtx.notary else None,
        "time_window": js.to_jsonable(wtx.time_window),
        "inputs": inputs,
        "outputs": [
            {
                "index": i,
                "contract": ts.contract,
                "notary": ts.notary.name if ts.notary else None,
                "data": js.to_jsonable(ts.data),
            }
            for i, ts in enumerate(wtx.outputs)
        ],
        "commands": [
            {
                "command": type(c.value).__name__,
                "value": js.to_jsonable(c.value),
                "signers": [js.to_jsonable(k) for k in c.signers],
            }
            for c in wtx.commands
        ],
        "attachments": [a.bytes_.hex() for a in wtx.attachments],
        "signatures": [js.to_jsonable(s) for s in stx.sigs],
        # the Merkle tear-off shape: id = root over these groups; a
        # non-validating notary sees only the `revealed` ones
        "tear_off": [
            {
                "group": name,
                "components": count,
                "revealed_to_nonvalidating_notary": g in revealed,
            }
            for g, name, count in groups
        ],
    }


def _network(ctx, query, body):
    """The network view (reference explorer's Network.kt map pane,
    terminal-first): every node from the network-map feed with its
    address, advertised services, notary role, cluster membership and
    liveness (age since the map last saw it)."""
    from ..node.services import SERVICE_NOTARY_VALIDATING

    infos = ctx.wait(ctx.client.network_map_snapshot())
    last_seen = ctx.wait(ctx.client.network_map_last_seen())
    now = ctx.wait(ctx.client.current_node_time())
    notary_names = {
        p.name for p in ctx.wait(ctx.client.notary_identities())
    }
    nodes = []
    for info in sorted(infos, key=lambda i: i.legal_identity.name):
        name = info.legal_identity.name
        services = list(info.advertised_services)
        cluster = (
            info.cluster_identity.name
            if info.cluster_identity is not None
            else None
        )
        seen = last_seen.get(name)
        nodes.append(
            {
                "name": name,
                "address": getattr(info, "address", None),
                "services": services,
                "notary": (
                    name in notary_names
                    or cluster in notary_names
                    or any(s.startswith("corda.notary") for s in services)
                ),
                "validating_notary": (
                    SERVICE_NOTARY_VALIDATING in services
                ),
                "cluster": cluster,
                "last_seen_micros": seen,
                "last_seen_age_s": (
                    round((now - seen) / 1e6, 1) if seen is not None else None
                ),
            }
        )
    return 200, {"now_micros": now, "nodes": nodes}


def _vault(ctx, query, body):
    """The vault position view (reference explorer's CashViewer.kt):
    fungible positions aggregated by (product, issuer) plus every
    unconsumed state with its FULL source tx id, so the page can drill
    straight into the transaction detail pane."""
    states = _vault_states(ctx)
    positions: dict[tuple[str, str], dict] = {}
    rows = []
    for sar in states:
        data = sar.state.data
        amount = getattr(data, "amount", None)
        issuer = None
        quantity = None
        product = None
        if amount is not None and hasattr(amount, "quantity"):
            quantity = int(amount.quantity)
            product = _amount_product(amount)
            issuer_ref = getattr(amount.token, "issuer", None)
            issuer = (
                issuer_ref.party.name if issuer_ref is not None else None
            )
            key = (product, issuer or "-")
            pos = positions.setdefault(
                key,
                {
                    "product": product,
                    "issuer": issuer or "-",
                    "states": 0,
                    "total": 0,
                },
            )
            pos["states"] += 1
            pos["total"] += quantity
        rows.append(
            {
                "tx_id": sar.ref.txhash.bytes_.hex(),   # drill-in key
                "index": sar.ref.index,
                "contract": sar.state.contract,
                "product": product,
                "issuer": issuer,
                "quantity": quantity,
                "notary": sar.state.notary.name if sar.state.notary else None,
            }
        )
    return 200, {
        "positions": sorted(
            positions.values(), key=lambda p: (p["product"], p["issuer"])
        ),
        "states": rows,
    }


def _machines(ctx, query, body):
    machines = ctx.wait(ctx.client.state_machines_snapshot())
    return 200, {
        "machines": [
            {"flow_id": m.flow_id.hex(), "flow": m.flow_tag}
            for m in machines
        ]
    }


_PAGE = b"""<!doctype html>
<meta charset="utf-8">
<title>corda_tpu explorer</title>
<style>
  body { font-family: ui-monospace, Menlo, Consolas, monospace;
         margin: 2rem; max-width: 72rem; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: .25rem .75rem .25rem 0;
           border-bottom: 1px solid #ddd; font-size: .85rem; }
  #err { color: #a00; }
</style>
<h1>ledger explorer &mdash; <span id="me">&hellip;</span></h1>
<p id="err"></p>
<h2>summary</h2>
<table id="summary"></table>
<h2>balances</h2>
<table id="balances"></table>
<h2>network</h2>
<table id="network"></table>
<h2>vault positions</h2>
<table id="positions"></table>
<h2>cash actions</h2>
<p>
  <label>quantity <input id="act-qty" size="8" value="100"></label>
  <label>currency <input id="act-ccy" size="4" value="USD"></label>
  <label>recipient <input id="act-to" size="12"></label>
  <label>notary (issue) <input id="act-notary" size="12"></label>
  <button onclick="cashAction('issue')">issue</button>
  <button onclick="cashAction('pay')">pay</button>
  <span id="act-out"></span>
</p>
<h2>unconsumed states (click a ref for its source transaction)</h2>
<table id="states"></table>
<h2>transactions (newest last; click an id for detail)</h2>
<table id="txs"></table>
<h2>transaction detail</h2>
<p><input id="txid" size="66" placeholder="full 64-hex tx id">
   <button onclick="showTx(q('txid').value)">show</button></p>
<pre id="txdetail"></pre>
<h2>flows in flight</h2>
<table id="machines"></table>
<script>
const q = id => document.getElementById(id);
// every cell renders through esc(): contract tags, peer names and
// flow tags are counterparty-supplied ledger data; unescaped
// innerHTML would hand a peer stored XSS in the operator's browser
const esc = s => String(s).replace(/[&<>"']/g, ch => (
  {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[ch]));
const row = cells => "<tr>" +
  cells.map(c => "<td>" + esc(c) + "</td>").join("") + "</tr>";
const head = cells => "<tr>" +
  cells.map(c => "<th>" + esc(c) + "</th>").join("") + "</tr>";
async function showTx(id) {
  // hex-only id: a non-hex value is rejected server-side with a 400
  const r = await fetch("/api/explorer/tx?id=" + encodeURIComponent(id));
  // textContent, not innerHTML: detail JSON embeds ledger data
  q("txdetail").textContent = JSON.stringify(await r.json(), null, 2);
  q("txid").value = id;
}
async function cashAction(kind) {
  const body = {
    quantity: Number(q("act-qty").value),
    currency: q("act-ccy").value,
    recipient: q("act-to").value,
  };
  if (kind === "issue") body.notary = q("act-notary").value;
  q("act-out").textContent = "...";
  const r = await fetch("/api/cash/" + kind, {
    method: "POST",
    headers: {"Content-Type": "application/json"},
    body: JSON.stringify(body),
  });
  const out = await r.json();
  q("act-out").textContent =
    r.ok ? "tx " + out.tx_id.slice(0, 12) : "failed: " + out.error;
  refresh();
}
async function refresh() {
  try {
    const dash = await (await fetch("/api/explorer/dashboard")).json();
    q("me").textContent = dash.me;
    q("summary").innerHTML =
      row(["unconsumed states", dash.states]) +
      row(["verified transactions", dash.transactions]) +
      row(["flows in flight", dash.flows_in_flight]) +
      row(["registered flows", dash.registered_flows.join(", ")]);
    q("balances").innerHTML = Object.keys(dash.balances).sort().map(
      p => row([p, dash.balances[p].toLocaleString()])).join("")
      || row(["(empty vault)", ""]);
    const net = await (await fetch("/api/explorer/network")).json();
    q("network").innerHTML = head(
      ["peer", "address", "notary", "cluster", "services", "last seen"]) +
      net.nodes.map(p => row([
        p.name, p.address || "-",
        p.notary ? (p.validating_notary ? "validating" : "yes") : "-",
        p.cluster || "-", p.services.join(","),
        p.last_seen_age_s == null ? "-" : p.last_seen_age_s + "s ago",
      ])).join("");
    const vault = await (await fetch("/api/explorer/vault")).json();
    q("positions").innerHTML = head(
      ["product", "issuer", "states", "total"]) +
      (vault.positions.map(p => row(
        [p.product, p.issuer, p.states, p.total.toLocaleString()]
      )).join("") || row(["(no fungible positions)", "", "", ""]));
    q("states").innerHTML = head(
      ["ref", "contract", "product", "quantity", "notary"]) +
      vault.states.map(s => "<tr><td><a href=\\"#txid\\" onclick=\\"" +
        "showTx('" + esc(s.tx_id) + "')\\">" + esc(s.tx_id.slice(0, 12)) +
        ":" + esc(s.index) + "</a></td>" +
        [s.contract, s.product || "-", s.quantity == null ? "-" :
         s.quantity.toLocaleString(), s.notary || "-"].map(
          c => "<td>" + esc(c) + "</td>").join("") + "</tr>").join("");
    const tx = await (await fetch(
      "/api/explorer/transactions?limit=20")).json();
    q("txs").innerHTML = head(
      ["id", "in", "out", "commands", "notary", "sigs"]) +
      tx.transactions.map(t => "<tr><td><a href=\\"#txid\\" onclick=\\"" +
        "showTx('" + esc(t.full_id) + "')\\">" + esc(t.id) + "</a></td>" +
        [t.inputs, t.outputs, t.commands.join(","), t.notary || "-",
         t.signatures].map(c => "<td>" + esc(c) + "</td>").join("") +
        "</tr>").join("");
    const sm = await (await fetch("/api/explorer/machines")).json();
    q("machines").innerHTML = sm.machines.map(
      m => row([m.flow_id.slice(0, 12), m.flow])).join("")
      || row(["(none)", ""]);
    q("err").textContent = "";
  } catch (e) { q("err").textContent = "refresh failed: " + e; }
}
refresh();
setInterval(refresh, 2000);
</script>
"""

EXPLORER_WEB = WebApiPlugin(
    prefix="explorer",
    routes=(
        ("GET", "dashboard", _dashboard),
        ("GET", "states", _states),
        ("GET", "transactions", _transactions),
        ("GET", "tx", _tx_detail),
        ("GET", "network", _network),
        ("GET", "vault", _vault),
        ("GET", "machines", _machines),
    ),
    # both spellings: /web/explorer/ and /web/explorer/index.html
    static=(("", "text/html", _PAGE), ("index.html", "text/html", _PAGE)),
)

register_web_api(EXPLORER_WEB)
