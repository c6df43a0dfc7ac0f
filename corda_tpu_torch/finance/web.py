"""Finance CorDapp web API (reference: each CorDapp's

Port of corda_tpu/finance/web.py. The flows it starts are named by
the reference's tags, which the port's RPC resolves to its own classes.
WebServerPluginRegistry REST surface mounted by NodeWebServer.kt:
171-173 — e.g. bank-of-corda's BankOfCordaWebApi).

Mounted at /api/cash:
  GET  /api/cash/balances            {currency: total} of unconsumed cash
  POST /api/cash/issue               {"quantity", "currency", "recipient",
                                      "notary"} -> issue via CashIssueFlow
  POST /api/cash/pay                 {"quantity", "currency", "recipient"}
                                     -> spend via CashPaymentFlow
Static demo page at /web/cash/index.html. Both writes start flows over
the gateway's RPC login, so RPCUserService's StartFlow.<flow>
permission check applies exactly as for any RPC client.
"""

from __future__ import annotations

from ..client.webserver import WebApiPlugin, register_web_api
from ..node.vault_query import VaultQueryCriteria
from .cash import CashState


def _balances(ctx, query, body):
    page = ctx.wait(
        ctx.client.vault_query_by(
            VaultQueryCriteria(contract_state_types=(CashState,))
        )
    )
    totals: dict[str, int] = {}
    for sar in page.states:
        amount = sar.state.data.amount
        key = str(amount.token.product)
        totals[key] = totals.get(key, 0) + amount.quantity
    return 200, totals


def _issue(ctx, query, body):
    if not isinstance(body, dict):
        return 400, {"error": "JSON object body required"}
    try:
        quantity = int(body["quantity"])
        currency = str(body["currency"])
        recipient = str(body["recipient"])
        notary = str(body["notary"])
    except (KeyError, TypeError, ValueError) as e:
        return 400, {"error": f"bad issue request: {e}"}
    if quantity <= 0:
        return 400, {"error": "quantity must be positive"}
    parties = _parties(ctx)
    if recipient not in parties or notary not in parties:
        return 400, {"error": "unknown recipient or notary party"}
    handle = ctx.wait(
        ctx.client.start_flow(
            "corda_tpu.finance.cash.CashIssueFlow",
            quantity=quantity,
            currency=currency,
            recipient=parties[recipient],
            notary=parties[notary],
        )
    )
    stx = ctx.wait(handle.result)
    return 200, {"tx_id": stx.id.bytes_.hex()}


def _parties(ctx) -> dict:
    parties = {}
    for info in ctx.wait(ctx.client.network_map_snapshot()):
        parties[info.legal_identity.name] = info.legal_identity
    for p in ctx.wait(ctx.client.notary_identities()):
        parties.setdefault(p.name, p)
    return parties


def _pay(ctx, query, body):
    if not isinstance(body, dict):
        return 400, {"error": "JSON object body required"}
    try:
        quantity = int(body["quantity"])
        currency = str(body["currency"])
        recipient = str(body["recipient"])
    except (KeyError, TypeError, ValueError) as e:
        return 400, {"error": f"bad pay request: {e}"}
    if quantity <= 0:
        # a negative quantity would build a change output exceeding the
        # inputs (an opaque contract-violation 500); zero, a pointless
        # self-move — reject both at the edge
        return 400, {"error": "quantity must be positive"}
    parties = _parties(ctx)
    if recipient not in parties:
        return 400, {"error": "unknown recipient party"}
    handle = ctx.wait(
        ctx.client.start_flow(
            "corda_tpu.finance.cash.CashPaymentFlow",
            quantity=quantity,
            currency=currency,
            recipient=parties[recipient],
        )
    )
    stx = ctx.wait(handle.result)
    return 200, {"tx_id": stx.id.bytes_.hex()}


_INDEX = b"""<!doctype html>
<title>corda_tpu cash</title>
<h1>Cash CorDapp</h1>
<p>GET <a href="/api/cash/balances">/api/cash/balances</a> |
POST /api/cash/issue</p>
"""

CASH_WEB_API = WebApiPlugin(
    prefix="cash",
    routes=(
        ("GET", "balances", _balances),
        ("POST", "issue", _issue),
        ("POST", "pay", _pay),
    ),
    static=(("index.html", "text/html", _INDEX),),
)

register_web_api(CASH_WEB_API)
