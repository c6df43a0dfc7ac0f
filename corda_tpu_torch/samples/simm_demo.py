"""simm-valuation-demo: portfolio margin valuation agreed bilaterally.

Reference: samples/simm-valuation-demo/ — two parties value their
shared IRS portfolio under the ISDA SIMM (OpenGamma prices the trades
and produces bucketed delta/vega sensitivities there), then AGREE the
valuation on ledger. Here pricing comes from
`samples/pricing.py` (zero curve + Black-76, bump-and-revalue
ladders on the SIMM vertices) and the margin from
`samples/simm.py` — delta, vega AND curvature layers with
openly parameterised weights (ISDA's exact tables are versioned/
licensed). Both sides compute independently and must agree bit-for-bit
before the mutually-signed valuation records.

Port of corda_tpu/samples/simm_demo.py. `run` takes `batch_verifier=`:
the port's MockNetwork verifies on the card by default, where the
reference's verifies on the CPU. Contract and wire tags are the
reference's strings, so transaction ids equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import register_contract, require_that
from ..core.identity import Party
from .irs_demo import InterestRateSwapState

SIMM_CONTRACT = "corda_tpu.samples.PortfolioValuation"
SWAPTION_CONTRACT = "corda_tpu.samples.Swaption"
FX_FORWARD_CONTRACT = "corda_tpu.samples.FxForward"
CDS_CONTRACT = "corda_tpu.samples.CreditDefaultSwap"
EQUITY_OPTION_CONTRACT = "corda_tpu.samples.EquityOption"
COMMODITY_FORWARD_CONTRACT = "corda_tpu.samples.CommodityForward"

_YEAR_MICROS = 365.25 * 24 * 3600 * 1e6

# the demo's domestic IR bucket: swaps/swaptions key their ladders by
# index family (index_name.split("-")[0]) and every demo trade quotes
# the LIBOR family, which prices off the shared domestic curve
DOMESTIC_BUCKET = "LIBOR"


@ser.serializable
@dataclass(frozen=True)
class SwaptionState:
    """A European payer/receiver swaption between two parties — the
    portfolio's vega carrier (an IRS alone has no vol exposure, so the
    reference demo's vega sensitivities come from optionality like
    this)."""

    buyer: Party
    seller: Party
    notional: int
    strike_bps: int
    expiry_micros: int
    tenor_years: int
    index_name: str
    is_payer: bool = True

    @property
    def participants(self):
        return (self.buyer, self.seller)


class Swaption:
    def verify(self, ltx) -> None:
        outs = ltx.outputs_of_type(SwaptionState)
        require_that("one swaption output", len(outs) == 1)
        o = outs[0]
        require_that("positive notional", o.notional > 0)
        require_that("positive strike", o.strike_bps > 0)
        require_that("tenor at least a year", o.tenor_years >= 1)


register_contract(SWAPTION_CONTRACT, Swaption())


@ser.serializable
@dataclass(frozen=True)
class FxForwardState:
    """A deliverable FX forward: at maturity the buyer receives
    `notional_fgn` units of `foreign_ccy` against paying
    `notional_fgn * strike_milli / 1000` in the valuation currency.
    The portfolio's FX-risk-class carrier (an IRS book alone has no
    spot exposure, so the SIMM FX margin would be degenerate without
    cross-currency trades)."""

    buyer: Party
    seller: Party
    notional_fgn: int
    strike_milli: int          # domestic per foreign, in 1/1000ths
    maturity_micros: int
    foreign_ccy: str

    @property
    def participants(self):
        return (self.buyer, self.seller)


class FxForward:
    def verify(self, ltx) -> None:
        from . import pricing

        outs = ltx.outputs_of_type(FxForwardState)
        require_that("one forward output", len(outs) == 1)
        o = outs[0]
        require_that("positive foreign notional", o.notional_fgn > 0)
        require_that("positive strike", o.strike_milli > 0)
        require_that(
            "a known demo currency",
            o.foreign_ccy in pricing.DEMO_FX_SPOTS,
        )


register_contract(FX_FORWARD_CONTRACT, FxForward())


@ser.serializable
@dataclass(frozen=True)
class CdsState:
    """Single-name CDS: `buyer` pays `spread_bps` annually on
    `notional` for protection on `issuer` until maturity — the
    portfolio's CreditQ carrier (CS01 ladders on the five SIMM credit
    vertices price off the issuer's demo credit curve)."""

    buyer: Party
    seller: Party
    notional: int
    spread_bps: int
    maturity_micros: int
    issuer: str

    @property
    def participants(self):
        return (self.buyer, self.seller)


class CreditDefaultSwap:
    def verify(self, ltx) -> None:
        from . import pricing

        outs = ltx.outputs_of_type(CdsState)
        require_that("one cds output", len(outs) == 1)
        o = outs[0]
        require_that("positive notional", o.notional > 0)
        require_that("positive spread", o.spread_bps > 0)
        require_that(
            "a known reference issuer",
            o.issuer in pricing.DEMO_CREDIT_CURVES,
        )


register_contract(CDS_CONTRACT, CreditDefaultSwap())


@ser.serializable
@dataclass(frozen=True)
class EquityOptionState:
    """European equity option on `n_shares` of `name` — the Equity
    risk-class carrier (a rates book has no equity spot exposure)."""

    buyer: Party
    seller: Party
    n_shares: int
    strike_cents: int
    expiry_micros: int
    name: str
    is_call: bool = True

    @property
    def participants(self):
        return (self.buyer, self.seller)


class EquityOption:
    def verify(self, ltx) -> None:
        from . import pricing

        outs = ltx.outputs_of_type(EquityOptionState)
        require_that("one option output", len(outs) == 1)
        o = outs[0]
        require_that("positive share count", o.n_shares > 0)
        require_that("positive strike", o.strike_cents > 0)
        require_that(
            "a known equity name", o.name in pricing.DEMO_EQUITY_MARKET
        )


register_contract(EQUITY_OPTION_CONTRACT, EquityOption())


@ser.serializable
@dataclass(frozen=True)
class CommodityForwardState:
    """Deliverable commodity forward: buyer takes `units` of `name` at
    `strike_cents` per unit at maturity — the Commodity risk-class
    carrier."""

    buyer: Party
    seller: Party
    units: int
    strike_cents: int
    maturity_micros: int
    name: str

    @property
    def participants(self):
        return (self.buyer, self.seller)


class CommodityForward:
    def verify(self, ltx) -> None:
        from . import pricing

        outs = ltx.outputs_of_type(CommodityForwardState)
        require_that("one forward output", len(outs) == 1)
        o = outs[0]
        require_that("positive units", o.units > 0)
        require_that("positive strike", o.strike_cents > 0)
        require_that(
            "a known commodity", o.name in pricing.DEMO_COMMODITY_MARKET
        )


register_contract(COMMODITY_FORWARD_CONTRACT, CommodityForward())


@dataclass
class PortfolioSensitivities:
    """Every SIMM input family one pricing pass produces: IR delta /
    vega ladders and FX spot deltas keyed by currency, plus the
    bucketed equity / commodity spot deltas and per-issuer CreditQ
    CS01 ladders the round-3 carriers contribute."""

    delta: dict
    vega: dict
    fx: dict
    equity: dict
    commodity: dict
    credit_q: dict
    equity_vega: dict
    equity_cvr: dict


def portfolio_ladders(
    swaps: list[InterestRateSwapState],
    now_micros: int = 0,
    swaptions: list[SwaptionState] = (),
    market=None,
    fx_forwards: list[FxForwardState] = (),
    cds: list[CdsState] = (),
    equity_options: list[EquityOptionState] = (),
    commodity_forwards: list[CommodityForwardState] = (),
) -> PortfolioSensitivities:
    """Price the mixed portfolio into every SIMM sensitivity family
    off the shared market curves: per-trade bump-and-revalue IR delta
    ladders (swaps, swaptions, both legs of FX forwards, and the
    discounting legs of CDS / equity options / commodity forwards),
    swaption vega ladders, FX spot sensitivities, bucketed equity and
    commodity spot deltas, and per-issuer CreditQ CS01 ladders. The
    ONE pricing pass every margin consumer (demo, web API) shares."""
    from . import pricing, simm

    curve, vols = market if market is not None else pricing.demo_market()
    delta: dict = {}
    vega: dict = {}
    fx: dict = {}
    equity: dict = {}
    commodity: dict = {}
    credit_q: dict = {}
    equity_vega: dict = {}
    equity_cvr: dict = {}

    def add(buckets, ccy, ladder):
        buckets[ccy] = buckets.get(ccy, 0) + ladder

    def add_name(classed, bucket, name, value):
        classed.setdefault(bucket, {})
        classed[bucket][name] = classed[bucket].get(name, 0) + value

    for s in swaps:
        last = max(s.fixing_dates) if s.fixing_dates else now_micros
        years = max((last - now_micros) / _YEAR_MICROS, 0.0)
        ccy = s.index_name.split("-")[0]   # index family as the bucket
        add(
            delta, ccy,
            pricing.swap_delta_ladder(
                s.notional, s.fixed_rate_bps, years, curve
            ),
        )
    for o in swaptions:
        expiry = max((o.expiry_micros - now_micros) / _YEAR_MICROS, 0.0)
        ccy = o.index_name.split("-")[0]
        add(
            delta, ccy,
            pricing.swaption_delta_ladder(
                o.notional, o.strike_bps, expiry, o.tenor_years,
                curve, vols, o.is_payer,
            ),
        )
        add(
            vega, ccy,
            pricing.swaption_vega_ladder(
                o.notional, o.strike_bps, expiry, o.tenor_years,
                curve, vols, o.is_payer,
            ),
        )
    # foreign curves derive from the CALLER's domestic curve (basis
    # spread), built once per currency — a scenario-bumped market
    # moves both legs of every forward consistently
    fgn_curves: dict = {}
    for f in fx_forwards:
        years = max((f.maturity_micros - now_micros) / _YEAR_MICROS, 0.0)
        fgn_curve = fgn_curves.get(f.foreign_ccy)
        if fgn_curve is None:
            fgn_curve = fgn_curves[f.foreign_ccy] = (
                pricing.demo_foreign_curve(f.foreign_ccy, curve)
            )
        spot = pricing.DEMO_FX_SPOTS[f.foreign_ccy]
        strike = f.strike_milli / 1000.0
        add(
            fx, f.foreign_ccy,
            pricing.fx_forward_spot_delta(
                f.notional_fgn, strike, years, curve, fgn_curve, spot
            ),
        )
        dom_ladder, fgn_ladder = pricing.fx_forward_rate_ladders(
            f.notional_fgn, strike, years, curve, fgn_curve, spot
        )
        # the forward's domestic pay leg prices off the SAME curve as
        # the swaps/swaptions, so its delta must land in the same
        # bucket (DOMESTIC_BUCKET) to net intra-bucket — a separate
        # "USD" bucket would correlate identical-curve risk at the
        # 0.32 cross-bucket gamma instead of netting it
        add(delta, DOMESTIC_BUCKET, dom_ladder)
        add(delta, f.foreign_ccy, fgn_ladder)
    for c in cds:
        years = max((c.maturity_micros - now_micros) / _YEAR_MICROS, 0.0)
        bucket, credit_curve = pricing.DEMO_CREDIT_CURVES[c.issuer]
        add_name(
            credit_q, bucket, c.issuer,
            pricing.cds_cs01_ladder(
                c.notional, c.spread_bps, years, curve, credit_curve
            ),
        )
        add(
            delta, DOMESTIC_BUCKET,
            pricing.cds_rate_ladder(
                c.notional, c.spread_bps, years, curve, credit_curve
            ),
        )
    for e in equity_options:
        expiry = max((e.expiry_micros - now_micros) / _YEAR_MICROS, 0.0)
        bucket, spot, vol = pricing.DEMO_EQUITY_MARKET[e.name]
        strike = e.strike_cents / 100.0
        add_name(
            equity, bucket, e.name,
            pricing.equity_spot_delta(
                e.n_shares, strike, expiry, curve, spot, vol, e.is_call
            ),
        )
        ev = pricing.equity_vega(
            e.n_shares, strike, expiry, curve, spot, vol, e.is_call
        )
        add_name(equity_vega, bucket, e.name, ev)
        add_name(
            equity_cvr, bucket, e.name,
            simm.scaling_function(expiry) * ev,
        )
        add(
            delta, DOMESTIC_BUCKET,
            pricing.equity_option_rate_ladder(
                e.n_shares, strike, expiry, curve, spot, vol, e.is_call
            ),
        )
    for m in commodity_forwards:
        years = max((m.maturity_micros - now_micros) / _YEAR_MICROS, 0.0)
        bucket, spot, carry = pricing.DEMO_COMMODITY_MARKET[m.name]
        strike = m.strike_cents / 100.0
        add_name(
            commodity, bucket, m.name,
            pricing.commodity_spot_delta(
                m.units, strike, years, curve, spot, carry
            ),
        )
        add(
            delta, DOMESTIC_BUCKET,
            pricing.commodity_forward_rate_ladder(
                m.units, strike, years, curve, spot, carry
            ),
        )
    return PortfolioSensitivities(
        delta, vega, fx, equity, commodity, credit_q, equity_vega,
        equity_cvr,
    )


# the one registry of priced trade families: portfolio_ladders kwarg
# name -> state class. Every book enumerator (demo gather, web API
# vault sweep) iterates THIS mapping, so adding a seventh family is one
# entry + one pricing branch — not synchronized edits across call sites
TRADE_FAMILIES: dict[str, type] = {
    "swaps": InterestRateSwapState,
    "swaptions": SwaptionState,
    "fx_forwards": FxForwardState,
    "cds": CdsState,
    "equity_options": EquityOptionState,
    "commodity_forwards": CommodityForwardState,
}


def portfolio_ladders_book(
    book: dict, now_micros: int = 0, market=None
) -> PortfolioSensitivities:
    """`portfolio_ladders` over a {family_name: [states]} book keyed by
    `TRADE_FAMILIES` (unknown families raise — a misfiled family must
    not silently drop from the margin)."""
    unknown = set(book) - set(TRADE_FAMILIES)
    if unknown:
        raise ValueError(f"unknown trade families: {sorted(unknown)}")
    swaps = book.get("swaps", [])
    kwargs = {
        f: book[f] for f in TRADE_FAMILIES
        if f != "swaps" and f in book
    }
    return portfolio_ladders(swaps, now_micros, market=market, **kwargs)


def initial_margin_book(
    book: dict, now_micros: int = 0, market=None
) -> int:
    """SIMM margin for a {family_name: [states]} book: the priced
    sensitivities feed the IR (delta + vega + curvature), FX, Equity,
    Commodity and CreditQ risk classes of `simm.simm_im`,
    psi-aggregated across classes. Deterministic: both parties run the
    same fixed float64 op order and agree bit-for-bit."""
    from . import simm

    s = portfolio_ladders_book(book, now_micros, market)
    return simm.simm_im(
        s.delta, s.vega, s.fx,
        equity=s.equity, commodity=s.commodity, credit_q=s.credit_q,
        equity_vega=s.equity_vega, equity_cvr=s.equity_cvr,
    )


def initial_margin(
    swaps: list[InterestRateSwapState],
    now_micros: int = 0,
    swaptions: list[SwaptionState] = (),
    market=None,
    fx_forwards: list[FxForwardState] = (),
    cds: list[CdsState] = (),
    equity_options: list[EquityOptionState] = (),
    commodity_forwards: list[CommodityForwardState] = (),
) -> int:
    """`initial_margin_book` with one positional/keyword argument per
    family (the demo-facing spelling)."""
    return initial_margin_book(
        {
            "swaps": swaps,
            "swaptions": swaptions,
            "fx_forwards": fx_forwards,
            "cds": cds,
            "equity_options": equity_options,
            "commodity_forwards": commodity_forwards,
        },
        now_micros,
        market,
    )


@ser.serializable
@dataclass(frozen=True)
class PortfolioValuationState:
    """The agreed margin for the portfolio between two parties at a
    valuation time."""

    party_a: Party
    party_b: Party
    valuation_micros: int
    portfolio_size: int
    margin: int

    @property
    def participants(self):
        return (self.party_a, self.party_b)

    def agreement_command(self):
        return AgreeValuation()


@ser.serializable
@dataclass(frozen=True)
class AgreeValuation:
    pass


class PortfolioValuation:
    def verify(self, ltx) -> None:
        outs = ltx.outputs_of_type(PortfolioValuationState)
        require_that("one valuation output", len(outs) == 1)
        cmds = ltx.commands_of_type(AgreeValuation)
        require_that("an agreement command", len(cmds) == 1)
        signers = set(cmds[0].signers)
        v = outs[0]
        require_that("margin is non-negative", v.margin >= 0)
        for p in v.participants:
            require_that(
                "both parties signed the valuation", p.owning_key in signers
            )


register_contract(SIMM_CONTRACT, PortfolioValuation())


def run(
    seed: int = 42, n_swaps: int = 3, n_swaptions: int = 2,
    n_fx_forwards: int = 2, n_cds: int = 2, n_equity_options: int = 2,
    n_commodity_forwards: int = 2, batch_verifier=None,
):
    """Build a mixed IRS + swaption + FX-forward + CDS + equity-option
    + commodity-forward portfolio, have both sides price it off the
    shared demo market and value it under SIMM across all the exposed
    risk classes (IR delta + vega + curvature, FX, CreditQ, Equity,
    Commodity; psi cross-class aggregation), agree the margin on
    ledger. Returns the recorded valuation state. `batch_verifier`:
    the MockNetwork's verifier; None verifies on the card
    (`CudaBatchVerifier()`), `CpuBatchVerifier()` runs without one."""
    from ..finance.trade_flows import DealInstigatorFlow
    from ..samples.irs_demo import StartSwapFlow
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary", validating=True)
    a = net.create_node("PartyA")
    b = net.create_node("PartyB")
    oracle = net.create_node("Oracle")

    now = net.clock.now_micros()
    for i in range(n_swaps):
        swap = InterestRateSwapState(
            fixed_payer=a.party,
            floating_payer=b.party,
            oracle=oracle.party,
            notional=1_000_000 * (i + 1),
            fixed_rate_bps=400 + 25 * i,
            index_name="LIBOR-3M",
            # fixings out at (i+1) years: gives the portfolio real
            # PV01 mass on the SIMM tenor ladder
            fixing_dates=(now + (i + 1) * 31_557_600 * 10**6,),
        )
        fsm = a.start_flow(StartSwapFlow(swap, notary.party))
        net.run()
        fsm.result_or_throw()
    for i in range(n_swaptions):
        swaption = SwaptionState(
            buyer=a.party,
            seller=b.party,
            notional=2_000_000 * (i + 1),
            strike_bps=300 + 50 * i,
            expiry_micros=now + (i + 2) * 31_557_600 * 10**6,
            tenor_years=5,
            index_name="LIBOR-3M",
        )
        fsm = a.start_flow(
            DealInstigatorFlow(b.party, swaption, SWAPTION_CONTRACT, notary.party)
        )
        net.run()
        fsm.result_or_throw()
    fx_ccys = ("EUR", "GBP")
    for i in range(n_fx_forwards):
        fwd = FxForwardState(
            buyer=a.party,
            seller=b.party,
            notional_fgn=3_000_000 * (i + 1),
            strike_milli=1_100 + 120 * i,
            maturity_micros=now + (i + 1) * 31_557_600 * 10**6,
            foreign_ccy=fx_ccys[i % len(fx_ccys)],
        )
        fsm = a.start_flow(
            DealInstigatorFlow(b.party, fwd, FX_FORWARD_CONTRACT, notary.party)
        )
        net.run()
        fsm.result_or_throw()
    from . import pricing as _pricing

    issuers = tuple(sorted(_pricing.DEMO_CREDIT_CURVES))
    for i in range(n_cds):
        swap_cds = CdsState(
            buyer=a.party,
            seller=b.party,
            notional=5_000_000 * (i + 1),
            spread_bps=80 + 20 * i,
            maturity_micros=now + (i + 3) * 31_557_600 * 10**6,
            issuer=issuers[i % len(issuers)],
        )
        fsm = a.start_flow(
            DealInstigatorFlow(b.party, swap_cds, CDS_CONTRACT, notary.party)
        )
        net.run()
        fsm.result_or_throw()
    eq_names = tuple(sorted(_pricing.DEMO_EQUITY_MARKET))
    for i in range(n_equity_options):
        name = eq_names[i % len(eq_names)]
        _, spot, _ = _pricing.DEMO_EQUITY_MARKET[name]
        opt = EquityOptionState(
            buyer=a.party,
            seller=b.party,
            n_shares=10_000 * (i + 1),
            strike_cents=int(spot * 100 * (0.95 + 0.1 * i)),
            expiry_micros=now + (i + 1) * 31_557_600 * 10**6,
            name=name,
            is_call=(i % 2 == 0),
        )
        fsm = a.start_flow(
            DealInstigatorFlow(
                b.party, opt, EQUITY_OPTION_CONTRACT, notary.party
            )
        )
        net.run()
        fsm.result_or_throw()
    cm_names = tuple(sorted(_pricing.DEMO_COMMODITY_MARKET))
    for i in range(n_commodity_forwards):
        name = cm_names[i % len(cm_names)]
        _, spot, _ = _pricing.DEMO_COMMODITY_MARKET[name]
        cfwd = CommodityForwardState(
            buyer=a.party,
            seller=b.party,
            units=20_000 * (i + 1),
            strike_cents=int(spot * 100 * (0.98 + 0.05 * i)),
            maturity_micros=now + (i + 1) * 31_557_600 * 10**6,
            name=name,
        )
        fsm = a.start_flow(
            DealInstigatorFlow(
                b.party, cfwd, COMMODITY_FORWARD_CONTRACT, notary.party
            )
        )
        net.run()
        fsm.result_or_throw()

    # both sides independently price + value their view of the shared
    # portfolio against the shared market data
    def gather(node):
        return {
            family: [
                s.state.data for s in node.vault.unconsumed_states(cls)
            ]
            for family, cls in TRADE_FAMILIES.items()
        }

    book_a = gather(a)
    book_b = gather(b)
    margin_a = initial_margin_book(book_a, now)
    margin_b = initial_margin_book(book_b, now)
    assert margin_a == margin_b, "valuations must agree before signing"

    valuation = PortfolioValuationState(
        a.party, b.party, now,
        sum(len(v) for v in book_a.values()), margin_a,
    )
    fsm = a.start_flow(
        DealInstigatorFlow(b.party, valuation, SIMM_CONTRACT, notary.party)
    )
    net.run()
    fsm.result_or_throw()
    recorded = b.vault.unconsumed_states(PortfolioValuationState)
    assert len(recorded) == 1
    return recorded[0].state.data


def main():
    v = run()
    print(
        f"portfolio of {v.portfolio_size} trades valued: margin {v.margin}"
    )


if __name__ == "__main__":
    main()
