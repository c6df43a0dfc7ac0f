"""SIMM valuation demo web API (reference: the simm-valuation-demo's
REST surface, samples/simm-valuation-demo/src/main/kotlin/net/corda/
vega/api/PortfolioApi.kt — whoami :252, {party}/trades :119,
portfolio/summary :198, portfolio/valuations :181,
portfolio/valuations/calculate :275 — served to a TS frontend by the
reference webserver; here the same surface mounts on the terminal-first
NodeWebServer gateway).

Port of corda_tpu/samples/simm_web.py, on the port's
client/webserver.py. The calculate route starts the reference's flow
tag, which the port's RPC resolves to its own DealInstigatorFlow.

Mounted at /api/simm:
  GET  /api/simm/whoami                 own identity + known peers
  GET  /api/simm/trades                 swap / swaption / FX forward /
                                        CDS / equity option / commodity
                                        forward trade summaries
  GET  /api/simm/portfolio/summary      counts and notional aggregates
  GET  /api/simm/portfolio/margin       SIMM breakdown (delta/vega/
                                        curvature/fx/equity/commodity/
                                        credit_q/total, psi cross-class
                                        aggregate) priced off the
                                        shared demo market;
                                        ?t=<micros> sets the valuation
                                        time
  GET  /api/simm/portfolio/valuations   recorded on-ledger valuations
  POST /api/simm/portfolio/valuations/calculate
        {"counterparty", "valuation_micros"?} -> price, agree and
        record the margin with the counterparty (both sign)
"""

from __future__ import annotations

from ..client.webserver import WebApiPlugin, register_web_api
from ..node.vault_query import VaultQueryCriteria
from .irs_demo import InterestRateSwapState
from .simm_demo import (
    SIMM_CONTRACT,
    CdsState,
    CommodityForwardState,
    EquityOptionState,
    FxForwardState,
    PortfolioValuationState,
    SwaptionState,
)


def _states(ctx, cls):
    page = ctx.wait(
        ctx.client.vault_query_by(
            VaultQueryCriteria(contract_state_types=(cls,))
        )
    )
    return [sar.state.data for sar in page.states]


def _whoami(ctx, query, body):
    me = ctx.wait(ctx.client.node_identity()).legal_identity
    peers = [
        info.legal_identity.name
        for info in ctx.wait(ctx.client.network_map_snapshot())
    ]
    return 200, {"me": me.name, "peers": sorted(peers)}


def _trades(ctx, query, body):
    swaps = [
        {
            "type": "swap",
            "fixed_payer": s.fixed_payer.name,
            "floating_payer": s.floating_payer.name,
            "notional": s.notional,
            "fixed_rate_bps": s.fixed_rate_bps,
            "index": s.index_name,
            "fixings": len(s.fixings),
        }
        for s in _states(ctx, InterestRateSwapState)
    ]
    swaptions = [
        {
            "type": "swaption",
            "buyer": o.buyer.name,
            "seller": o.seller.name,
            "notional": o.notional,
            "strike_bps": o.strike_bps,
            "tenor_years": o.tenor_years,
            "payer": o.is_payer,
            "index": o.index_name,
        }
        for o in _states(ctx, SwaptionState)
    ]
    forwards = [
        {
            "type": "fx_forward",
            "buyer": f.buyer.name,
            "seller": f.seller.name,
            "notional_fgn": f.notional_fgn,
            "strike_milli": f.strike_milli,
            "foreign_ccy": f.foreign_ccy,
        }
        for f in _states(ctx, FxForwardState)
    ]
    cds = [
        {
            "type": "cds",
            "buyer": c.buyer.name,
            "seller": c.seller.name,
            "notional": c.notional,
            "spread_bps": c.spread_bps,
            "issuer": c.issuer,
        }
        for c in _states(ctx, CdsState)
    ]
    options = [
        {
            "type": "equity_option",
            "buyer": o.buyer.name,
            "seller": o.seller.name,
            "n_shares": o.n_shares,
            "strike_cents": o.strike_cents,
            "name": o.name,
            "call": o.is_call,
        }
        for o in _states(ctx, EquityOptionState)
    ]
    commodities = [
        {
            "type": "commodity_forward",
            "buyer": m.buyer.name,
            "seller": m.seller.name,
            "units": m.units,
            "strike_cents": m.strike_cents,
            "name": m.name,
        }
        for m in _states(ctx, CommodityForwardState)
    ]
    return 200, {
        "trades": swaps + swaptions + forwards + cds + options + commodities
    }


def _summary(ctx, query, body):
    swaps = _states(ctx, InterestRateSwapState)
    swaptions = _states(ctx, SwaptionState)
    forwards = _states(ctx, FxForwardState)
    cds = _states(ctx, CdsState)
    options = _states(ctx, EquityOptionState)
    commodities = _states(ctx, CommodityForwardState)
    return 200, {
        "swaps": len(swaps),
        "swaptions": len(swaptions),
        "fx_forwards": len(forwards),
        "cds": len(cds),
        "equity_options": len(options),
        "commodity_forwards": len(commodities),
        "swap_notional": sum(s.notional for s in swaps),
        "swaption_notional": sum(o.notional for o in swaptions),
        "fx_forward_notional": sum(f.notional_fgn for f in forwards),
        "cds_notional": sum(c.notional for c in cds),
    }


def _parse_t(query) -> int:
    try:
        return int(query.get("t", ["0"])[0])
    except (TypeError, ValueError):
        return 0


def _book(ctx):
    """One vault sweep of every priced trade family (keyed by the
    simm_demo.TRADE_FAMILIES registry)."""
    from .simm_demo import TRADE_FAMILIES

    return {
        family: _states(ctx, cls) for family, cls in TRADE_FAMILIES.items()
    }


def _margin(ctx, query, body):
    from .simm_demo import portfolio_ladders_book
    from . import simm

    now = _parse_t(query)
    book = _book(ctx)
    s = portfolio_ladders_book(book, now)
    parts = simm.simm_breakdown(
        s.delta, s.vega, s.fx,
        equity=s.equity, commodity=s.commodity, credit_q=s.credit_q,
        equity_vega=s.equity_vega, equity_cvr=s.equity_cvr,
    )
    # the total IS the psi cross-class aggregate (simm.simm_im's
    # definition) — one pricing pass, no second computation to drift
    # from the parts
    return 200, {
        "delta": round(parts["delta"], 2),
        "vega": round(parts["vega"], 2),
        "curvature": round(parts["curvature"], 2),
        "fx": round(parts["fx"], 2),
        "equity": round(parts["equity"], 2),
        "equity_vega": round(parts["equity_vega"], 2),
        "equity_curvature": round(parts["equity_curvature"], 2),
        "commodity": round(parts["commodity"], 2),
        "credit_q": round(parts["credit_q"], 2),
        "margin": int(round(parts["total"])),
        "trades": sum(len(v) for v in book.values()),
    }


def _valuations(ctx, query, body):
    vals = [
        {
            "party_a": v.party_a.name,
            "party_b": v.party_b.name,
            "valuation_micros": v.valuation_micros,
            "portfolio_size": v.portfolio_size,
            "margin": v.margin,
        }
        for v in _states(ctx, PortfolioValuationState)
    ]
    return 200, {"valuations": vals}


def _calculate(ctx, query, body):
    from .simm_demo import initial_margin_book

    if not isinstance(body, dict):
        return 400, {"error": "JSON object body required"}
    counterparty = body.get("counterparty")
    if not isinstance(counterparty, str):
        return 400, {"error": "counterparty (party name) required"}
    raw_t = body.get("valuation_micros", 0)
    if not isinstance(raw_t, int) or isinstance(raw_t, bool):
        return 400, {"error": "valuation_micros must be an integer"}
    now = raw_t
    parties = {
        info.legal_identity.name: info.legal_identity
        for info in ctx.wait(ctx.client.network_map_snapshot())
    }
    if counterparty not in parties:
        return 400, {"error": f"unknown counterparty {counterparty!r}"}
    notaries = ctx.wait(ctx.client.notary_identities())
    if not notaries:
        return 400, {"error": "no notary on the network"}
    me = ctx.wait(ctx.client.node_identity()).legal_identity
    book = _book(ctx)
    margin = initial_margin_book(book, now)
    valuation = PortfolioValuationState(
        me, parties[counterparty], now,
        sum(len(v) for v in book.values()), margin,
    )
    handle = ctx.wait(
        ctx.client.start_flow(
            "corda_tpu.finance.trade_flows.DealInstigatorFlow",
            other=parties[counterparty],
            deal_state=valuation,
            contract=SIMM_CONTRACT,
            notary=notaries[0],
        )
    )
    stx = ctx.wait(handle.result)
    return 200, {"tx_id": stx.id.bytes_.hex(), "margin": margin}


_INDEX = b"""<!doctype html>
<title>corda_tpu simm-valuation-demo</title>
<h1>SIMM portfolio valuation</h1>
<p>GET <a href="/api/simm/portfolio/summary">summary</a> |
<a href="/api/simm/portfolio/margin">margin</a> |
<a href="/api/simm/portfolio/valuations">valuations</a> |
<a href="/api/simm/trades">trades</a> |
POST /api/simm/portfolio/valuations/calculate</p>
"""

SIMM_WEB_API = WebApiPlugin(
    prefix="simm",
    routes=(
        ("GET", "whoami", _whoami),
        ("GET", "trades", _trades),
        ("GET", "portfolio/summary", _summary),
        ("GET", "portfolio/margin", _margin),
        ("GET", "portfolio/valuations", _valuations),
        ("POST", "portfolio/valuations/calculate", _calculate),
    ),
    static=(("index.html", "text/html", _INDEX),),
)

register_web_api(SIMM_WEB_API)
