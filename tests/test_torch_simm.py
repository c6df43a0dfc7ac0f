"""The SIMM analytics (samples/simm.py, samples/pricing.py) and the SIMM
valuation demo (samples/simm_demo.py) in the port, held against the
reference.

- The reference's SIMM and pricing cases of tests/test_samples.py
  (test_torch_samples_irs.SIMM_CASES) run on the port with its imports
  read as corda_tpu_torch, each simm_demo.run over CpuBatchVerifier and
  estimate_margins_batch on the CPU (the slow full-book case stays slow).
  tests/test_client.py's test_simm_web_api runs on the port in
  tests/test_torch_client.py.
- simm_demo.run at one trade per family over CpuBatchVerifier leaves the
  reference's transaction ids and a valuation that encodes to the
  reference's bytes (the margin bit-equal).
- Seeded books of every trade family priced by each package's
  portfolio_ladders_book give bit-equal ladders, and from them every
  class margin, simm_breakdown and simm_im are bit-equal (float.hex).
- estimate_margins_batch(device="cpu") is float32 and within rtol 1e-5
  of the reference's jnp version and within 1e-4 of float64
  bucket_margins, on seeded portfolios (chip_smoke.seeded_ladders).
"""

from __future__ import annotations

import importlib
import random
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_samples import _run  # noqa: E402
from test_torch_samples_irs import SIMM_CASES, samples_port_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
ONE_PER_FAMILY = cs.SIMM_DEPTH


@pytest.mark.parametrize("name,case", [p for p in port_cases("test_samples", {})
                                       if p.values[1] in SIMM_CASES])
def test_reference_simm_case_on_the_port(name, case, tmp_path):
    run_port_case(samples_port_module(), case, tmp_path)


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def test_simm_demo_equals_the_reference():
    (ref, ref_ids) = _run("corda_tpu", "simm_demo", "run", **ONE_PER_FAMILY)
    (port, ids) = _run("corda_tpu_torch", "simm_demo", "run", **ONE_PER_FAMILY)
    assert port.portfolio_size == 6 and port.margin == ref.margin > 0
    assert _m("corda_tpu_torch", "core.serialization").encode(port) == _m(
        "corda_tpu", "core.serialization").encode(ref)
    assert ids == ref_ids and len(ids) == 7


def _book(prefix: str, seed: int, n: int = 3) -> dict:
    """A seeded book of `n` trades per family, built as simm_demo.run
    builds its trades, with drawn notionals, strikes and dates."""
    demo, pricing = _m(prefix, "samples.simm_demo"), _m(prefix, "samples.pricing")
    ident, schemes = _m(prefix, "core.identity"), _m(prefix, "crypto.schemes")
    a, b, o = (ident.Party(name, schemes.generate_keypair(seed=s).public)
               for name, s in (("PartyA", 11), ("PartyB", 12), ("Oracle", 13)))
    rng = random.Random(seed)
    year = 31_557_600 * 10**6

    def when():
        return rng.randint(1, 25) * year // 4

    book = {family: [] for family in demo.TRADE_FAMILIES}
    for i in range(n):
        book["swaps"].append(demo.InterestRateSwapState(
            a, b, o, rng.randint(1, 50) * 1_000_000, rng.randint(100, 700), "LIBOR-3M",
            (when(),)))
        book["swaptions"].append(demo.SwaptionState(
            buyer=a, seller=b, notional=rng.randint(1, 20) * 1_000_000,
            strike_bps=rng.randint(100, 600), expiry_micros=when(),
            tenor_years=rng.choice((2, 5, 10)), index_name="LIBOR-3M"))
        book["fx_forwards"].append(demo.FxForwardState(
            buyer=a, seller=b, notional_fgn=rng.randint(1, 9) * 1_000_000,
            strike_milli=rng.randint(900, 1_500), maturity_micros=when(),
            foreign_ccy=rng.choice(("EUR", "GBP"))))
        book["cds"].append(demo.CdsState(
            buyer=a, seller=b, notional=rng.randint(1, 9) * 1_000_000,
            spread_bps=rng.randint(40, 200), maturity_micros=when(),
            issuer=rng.choice(sorted(pricing.DEMO_CREDIT_CURVES))))
        name = rng.choice(sorted(pricing.DEMO_EQUITY_MARKET))
        spot = pricing.DEMO_EQUITY_MARKET[name][1]
        book["equity_options"].append(demo.EquityOptionState(
            buyer=a, seller=b, n_shares=rng.randint(1, 50) * 1_000,
            strike_cents=int(spot * 100 * rng.uniform(0.8, 1.2)), expiry_micros=when(),
            name=name, is_call=rng.random() < 0.5))
        name = rng.choice(sorted(pricing.DEMO_COMMODITY_MARKET))
        spot = pricing.DEMO_COMMODITY_MARKET[name][1]
        book["commodity_forwards"].append(demo.CommodityForwardState(
            buyer=a, seller=b, units=rng.randint(1, 50) * 1_000,
            strike_cents=int(spot * 100 * rng.uniform(0.9, 1.1)), maturity_micros=when(),
            name=name))
    return book


def _exact(value):
    """A value with every float as its hex form and every array as its
    dtype, shape and bytes: equal only if bit-equal."""
    if isinstance(value, dict):
        return {k: _exact(v) for k, v in sorted(value.items())}
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, (tuple, list)):
        return [_exact(v) for v in value]
    if isinstance(value, (float, np.floating)):
        return float(value).hex()
    return value


def _margins(prefix: str, seed: int) -> dict:
    """Every margin the consensus path computes, from the ladders of a
    seeded book priced by `prefix`'s portfolio_ladders_book."""
    simm, demo = _m(prefix, "samples.simm"), _m(prefix, "samples.simm_demo")
    s = demo.portfolio_ladders_book(_book(prefix, seed), now_micros=0)
    delta = np.stack([s.delta[c] for c in sorted(s.delta)])
    vega = np.stack([s.vega[c] for c in sorted(s.vega)])
    classes = dict(equity=s.equity, commodity=s.commodity, credit_q=s.credit_q,
                   equity_vega=s.equity_vega, equity_cvr=s.equity_cvr)
    out = {"ladders": {k: getattr(s, k) for k in ("delta", "vega", "fx", *classes)},
           "bucket_margins": simm.bucket_margins(delta),
           "vega_bucket_margins": simm.vega_bucket_margins(vega),
           "aggregate_margin": simm.aggregate_margin(*simm.bucket_margins(delta)),
           "curvature_margin": simm.curvature_margin(simm.curvature_ladders(vega)),
           "fx_margin": simm.fx_margin(s.fx),
           "equity_margin": simm.equity_margin(s.equity),
           "equity_vega_margin": simm.equity_vega_margin(s.equity_vega),
           "equity_curvature_margin": simm.equity_curvature_margin(s.equity_cvr),
           "commodity_margin": simm.commodity_margin(s.commodity),
           "credit_q_margin": simm.credit_q_margin(s.credit_q),
           "credit_nonq_margin": simm.credit_nonq_margin(s.credit_q),
           "simm_breakdown": simm.simm_breakdown(s.delta, s.vega, s.fx, **classes),
           "simm_im": simm.simm_im(s.delta, s.vega, s.fx, **classes),
           "initial_margin_book": demo.initial_margin_book(_book(prefix, seed), 0)}
    out["product_margin"] = simm.product_margin({"IR": out["aggregate_margin"],
                                                 "FX": out["fx_margin"],
                                                 "Equity": out["equity_margin"]})
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_margins_bit_equal_the_reference(seed):
    ref, port = (_margins(p, seed) for p in PACKAGES)
    assert set(port) == set(ref)
    for key in ref:
        assert _exact(port[key]) == _exact(ref[key]), key
    assert ref["simm_im"] == ref["initial_margin_book"] > 0
    assert all(v > 0 for k, v in ref["simm_breakdown"].items() if k != "credit_nonq")


def test_estimate_margins_batch_on_the_cpu_against_the_reference():
    from corda_tpu.samples import simm as rsimm
    from corda_tpu_torch.samples import simm

    lad = cs.seeded_ladders(4096, 5)
    est = simm.estimate_margins_batch(lad, device="cpu")
    ref = rsimm.estimate_margins_batch(lad)
    k, _ = simm.bucket_margins(lad)
    assert est.dtype == np.float32 and est.shape == (4096,)
    np.testing.assert_allclose(est, ref, rtol=1e-5, atol=0)
    assert float(np.max(np.abs(est - k) / k)) <= 1e-4
    assert simm.estimate_margins_batch(lad[:1], device="cpu")[0] == est[0]
    # the default device is the card: without one it raises, it never falls back
    import torch

    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            simm.estimate_margins_batch(lad)
