"""The IRS demo (samples/irs_demo.py) with its rate oracle, the network
simulation (samples/simulation.py), Commodity (finance/commodity.py),
the universal contracts (experimental/universal.py) and the audit
service (node/audit.py) in the port, held against the reference.

- Every case of the reference's tests/test_samples.py but its SIMM and
  pricing cases (SIMM_CASES, held in tests/test_torch_simm.py) runs on
  the port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module): the IRS demo's scheduled
  fixings, the oracle's refusals, the simulation's trace and the other
  demos' arcs. Each demo's `run`, and the MockNetwork the oracle case
  builds, gets a CpuBatchVerifier (the port's default is the card).
  Every case of tests/test_universal.py and tests/test_clauses.py (the
  clause combinators and Commodity's issue, move and exit), and
  tests/test_aux.py's test_audit_services, run the same way.
- irs_demo.run and run_irs_simulation over CpuBatchVerifier leave the
  same transaction ids as the reference's on the same seed, the same
  final swap (equal encodings) and the same trace, line for line.
- A swap's scheduled activity names the reference's FixingFlow tag, and
  client/common.find_flow_class resolves the IRS flows to the
  reference's tags, which resolve to the port's classes.
- Commodity and universal states encode to the reference's bytes, and
  the contracts are registered under the reference's names.
"""

from __future__ import annotations

import importlib

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402
from test_torch_samples import _run  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
# the reference's SIMM and pricing cases: tests/test_torch_simm.py runs them
SIMM_CASES = frozenset({
    "test_simm_demo", "test_simm_vega_curvature_layers", "test_simm_fx_class_and_psi_aggregation",
    "test_fx_forward_pricing", "test_fx_forward_domestic_delta_nets_with_swaps",
    "test_pricing_curve_sensitivities", "test_simm_calculator_properties",
    "test_simm_demo_portfolio_margin_positive", "test_simm_equity_commodity_classes",
    "test_simm_credit_classes", "test_simm_six_class_aggregation_and_carrier_pricing",
    "test_simm_demo_six_class_arc", "test_simm_equity_vega_curvature",
})
# every demo run and MockNetwork of tests/test_samples.py over `_CPU()`
# (CpuBatchVerifier, set on the module), and the analytics on the CPU
SAMPLES_SUBS = (
    ("irs_demo.run(", "irs_demo.run(batch_verifier=_CPU(), "),
    ("simm_demo.run(", "simm_demo.run(batch_verifier=_CPU(), "),
    ("run_irs_simulation()", "run_irs_simulation(batch_verifier=_CPU())"),
    ("MockNetwork(seed=50)", "MockNetwork(seed=50, batch_verifier=_CPU())"),
    ("trader_demo.run()", "trader_demo.run(batch_verifier=_CPU())"),
    ("bank_of_corda_demo.run()", "bank_of_corda_demo.run(batch_verifier=_CPU())"),
    ("attachment_demo.run()", "attachment_demo.run(batch_verifier=_CPU())"),
    (", n_txs=3)", ", n_txs=3, batch_verifier=_CPU())"),
    ("run_via_rpc(face=50_000, price=46_000)",
     "run_via_rpc(face=50_000, price=46_000, batch_verifier=_CPU())"),
    ("estimate_margins_batch(lad[None, :])", "estimate_margins_batch(lad[None, :], device='cpu')"),
)


def samples_port_module():
    """tests/test_samples.py on the port, every demo over CpuBatchVerifier."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    return port_test_module("test_samples", subs=SAMPLES_SUBS, _CPU=CpuBatchVerifier)


def _cases(name: str, keep=lambda case: True) -> list:
    return [p for p in port_cases(name, {}) if keep(p.values[1])]


@pytest.mark.parametrize("name,case", _cases("test_samples", lambda c: c not in SIMM_CASES))
def test_reference_sample_on_the_port(name, case, tmp_path):
    run_port_case(samples_port_module(), case, tmp_path)


@pytest.mark.parametrize("name,case", _cases("test_universal") + _cases("test_clauses") + _cases(
    "test_aux", lambda c: c == "test_audit_services"))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(port_test_module(name), case, tmp_path)


def test_case_count():
    samples = vars(importlib.import_module("tests.test_samples"))
    assert SIMM_CASES <= set(samples)
    assert len(_cases("test_samples", lambda c: c not in SIMM_CASES)) == 10
    assert [len(_cases(n)) for n in ("test_universal", "test_clauses")] == [12, 14]


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def test_irs_demo_equals_the_reference():
    (ref, ref_ids) = _run("corda_tpu", "irs_demo", "run", n_fixings=3)
    (port, ids) = _run("corda_tpu_torch", "irs_demo", "run", n_fixings=3)
    assert [f.rate_bps for f in port.fixings] == [500, 507, 514] and port.next_fixing_date() is None
    assert _m("corda_tpu_torch", "core.serialization").encode(port) == _m(
        "corda_tpu", "core.serialization").encode(ref)
    assert ids == ref_ids and len(ids) == 4


def test_simulation_trace_equals_the_reference():
    (ref, ref_ids) = _run("corda_tpu", "simulation", "run_irs_simulation", seed=7)
    (port, ids) = _run("corda_tpu_torch", "simulation", "run_irs_simulation", seed=7)
    assert port.trace() == ref.trace() and len(ref.trace()) > 20
    assert [(e.kind, e.node, e.detail) for e in port.events] == [
        (e.kind, e.node, e.detail) for e in ref.events]
    assert ids == ref_ids and len(ids) == 3


def _swap(prefix: str):
    irs, schemes = _m(prefix, "samples.irs_demo"), _m(prefix, "crypto.schemes")
    ident = _m(prefix, "core.identity")
    a, b, o = (ident.Party(n, schemes.generate_keypair(seed=s).public)
               for n, s in (("BankA", 1), ("BankB", 2), ("RateOracle", 3)))
    return irs.InterestRateSwapState(a, b, o, 10_000_000, 450, "LIBOR-3M", (5, 9))


def test_scheduled_fixing_names_the_reference_flow():
    from corda_tpu_torch.flows.api import class_from_tag
    from corda_tpu_torch.samples.irs_demo import FixingFlow

    acts = {}
    for prefix in PACKAGES:
        c, h = _m(prefix, "core.contracts"), _m(prefix, "crypto.hashes")
        swap = _swap(prefix)
        acts[prefix] = swap.next_scheduled_activity(c.StateRef(h.SecureHash.sha256(b"s"), 0))
        fixed = swap.with_fixing(_m(prefix, "samples.irs_demo").RateFix(
            _m(prefix, "samples.irs_demo").FixOf("LIBOR-3M", 5), 501))
        assert fixed.next_fixing_date() == 9
    ref, port = acts["corda_tpu"], acts["corda_tpu_torch"]
    assert port.flow_tag == ref.flow_tag == "corda_tpu.samples.irs_demo.FixingFlow"
    assert port.scheduled_at == ref.scheduled_at == 5
    assert class_from_tag(port.flow_tag) is FixingFlow
    assert _m("corda_tpu_torch", "core.serialization").encode(_swap("corda_tpu_torch")) == _m(
        "corda_tpu", "core.serialization").encode(_swap("corda_tpu"))


IRS_FLOWS = ("FixingFlow", "StartSwapFlow", "OracleQueryFlow", "OracleSignFlow",
             "OracleQueryHandler", "OracleSignHandler")


def test_find_flow_class_resolves_the_irs_flows():
    from corda_tpu.client import common as ref
    from corda_tpu_torch.client import common as port
    from corda_tpu_torch.flows.api import class_from_tag

    for name in IRS_FLOWS:
        tag = f"corda_tpu.samples.irs_demo.{name}"
        assert port.find_flow_class(name) == ref.find_flow_class(name) == tag
        assert class_from_tag(tag).__module__ == "corda_tpu_torch.samples.irs_demo"
    with pytest.raises(port.FlowLookupError):
        port.find_flow_class("InterestRateSwapState")


def _commodity_and_universal(prefix: str) -> list:
    com, uni = _m(prefix, "finance.commodity"), _m(prefix, "experimental.universal")
    c, ident, schemes = (_m(prefix, n) for n in ("core.contracts", "core.identity",
                                                 "crypto.schemes"))
    acme, bank = (ident.Party(n, schemes.generate_keypair(seed=s).public)
                  for n, s in (("ACME", 401), ("HighStreetBank", 402)))
    fcoj = c.Amount(250, com.commodity_token(acme, "FCOJ"))
    bond = uni.actions(
        uni.action("execute", uni.time_after(1_900_000_000_000_000), bank,
                   uni.obligation(uni.const(1_000_000) * uni.observable("LIBOR", "3M"),
                                  "USD", acme, bank)),
        uni.action("cancel", uni.const(True), (acme, bank), uni.zero))
    def coupon(start, end, nxt):
        return uni.actions(uni.action(f"pay-{start}", uni.time_after(end), bank, uni.all_of(
            uni.obligation(uni.const(50), "USD", acme, bank), nxt)))

    return [com.CommodityState(fcoj, bank.owning_key), com.CommodityMove(),
            com.CommodityExit(fcoj), uni.UniversalState((acme, bank), bond), bond,
            uni.roll_out(0, 30, 10, coupon)]


def test_commodity_and_universal_encode_as_the_reference():
    ref, port = (_commodity_and_universal(p) for p in PACKAGES)
    rser, pser = (_m(p, "core.serialization") for p in PACKAGES)
    for a, b in zip(ref, port):
        assert pser.encode(b) == rser.encode(a) == pser.encode_py(b), type(a).__name__
        assert pser.decode(rser.encode(a)) == b
    contracts = _m("corda_tpu_torch", "core.contracts")
    for module, name in (("finance.commodity", "COMMODITY_CONTRACT"),
                         ("experimental.universal", "UNIVERSAL_CONTRACT"),
                         ("samples.irs_demo", "IRS_CONTRACT")):
        tag = getattr(_m("corda_tpu_torch", module), name)
        assert tag == getattr(_m("corda_tpu", module), name) and tag.startswith("corda_tpu.")
        assert contracts.contract_by_name(tag) is not None
    from corda_tpu_torch.finance import Commodity, CommodityState  # the package exports them
    assert contracts.contract_by_name(_m("corda_tpu_torch", "finance.commodity")
                                      .COMMODITY_CONTRACT) is Commodity
    assert isinstance(port[0], CommodityState)
