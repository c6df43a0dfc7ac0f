"""The state replacement flows (flows/replacement.py) in the port, held
against the reference.

- Every case of the reference's tests/test_replacement.py runs on the
  port with its imports read as corda_tpu_torch
  (test_torch_health.port_test_module); its MockNetwork, which builds
  the default device verifier, gets CpuBatchVerifier (the port's
  default is the card). Among them: a notary change moving a state
  and the state then spent under the new notary, a change to the same
  notary refused, the old state's double spend refused by the old
  notary, a registered contract upgrade, an unauthorised one refused,
  the replacement rules' command, threshold and notary checks, and
  those rules in a process that never imports the flows layer.
- One seeded drive (an issue, its notary change, a payment under the
  new notary, a double spend of the old state, a second issue and its
  contract upgrade) gives equal transaction ids, refusals and vaults in
  both packages. The upgrade's target contract is named alike in both
  (the reference module's own name would read as corda_tpu_torch on
  the port).
"""

from __future__ import annotations

import importlib
import sys

import pytest

pytest.importorskip("torch")

from test_torch_fabric import port_cases, run_port_case  # noqa: E402
from test_torch_health import port_test_module  # noqa: E402

PACKAGES = ("corda_tpu", "corda_tpu_torch")
CPU_NET = ("MockNetwork(seed=88)",
           "MockNetwork(seed=88, batch_verifier=__import__("
           "'corda_tpu.crypto.batch_verifier', fromlist=['_']).CpuBatchVerifier())")
V2_CONTRACT = "tests.replacement.CashV2"


def reference_module():
    """tests/test_replacement.py, imported once: it registers CashStateV2
    with the reference's codec, so the module pytest collected (as
    `test_replacement`) and `tests.test_replacement` must be one."""
    mod = sys.modules.get("test_replacement") or importlib.import_module("tests.test_replacement")
    sys.modules.setdefault("test_replacement", mod)
    sys.modules.setdefault("tests.test_replacement", mod)
    return mod


reference_module()


def replacement_port_module():
    return port_test_module("test_replacement", subs=(CPU_NET,))


@pytest.mark.parametrize("name,case", port_cases("test_replacement", {}))
def test_reference_case_on_the_port(name, case, tmp_path):
    run_port_case(replacement_port_module(), case, tmp_path)


def test_case_count():
    assert len(port_cases("test_replacement", {})) == 9


def _m(prefix: str, name: str):
    return importlib.import_module(f"{prefix}.{name}")


def _replacement_drive(prefix: str) -> list:
    tests = reference_module() if prefix == "corda_tpu" else replacement_port_module()
    contracts, cash = _m(prefix, "core.contracts"), _m(prefix, "finance.cash")
    flows, tx = _m(prefix, "flows.replacement"), _m(prefix, "core.transactions")
    contracts.register_contract(V2_CONTRACT, tests.CashV2())
    flows.register_upgrade(cash.CASH_CONTRACT, V2_CONTRACT,
                           lambda old: tests.CashStateV2(old.amount, old.owner))
    net = _m(prefix, "testing.mock_network").MockNetwork(
        seed=88, batch_verifier=_m(prefix, "crypto.batch_verifier").CpuBatchVerifier())
    n1 = net.create_notary("NotaryOne", validating=True)
    n2 = net.create_notary("NotaryTwo")
    alice, bob = net.create_node("Alice"), net.create_node("Bob")

    def run(flow):
        fsm = alice.start_flow(flow)
        net.run()
        try:
            return str(fsm.result_or_throw().id)
        except Exception as e:
            return f"{type(e).__name__}: {e}"

    out = [str(alice.run_flow(cash.CashIssueFlow(1_000, "USD", alice.party, n1.party)).id)]
    coin = alice.vault.unconsumed_states(cash.CashState)[0]
    out.append(run(flows.NotaryChangeFlow(coin, n2.party)))
    out.append(run(cash.CashPaymentFlow(400, "USD", bob.party)))
    b = tx.TransactionBuilder()
    b.add_input_state(coin)
    b.add_output_state(coin.state.data.with_owner(bob.party.owning_key), cash.CASH_CONTRACT)
    b.add_command(cash.CashMove(), alice.party.owning_key)
    out.append(run(_m(prefix, "flows.core_flows").FinalityFlow(
        alice.services.sign_initial_transaction(b))))
    out.append(str(alice.run_flow(cash.CashIssueFlow(500, "USD", alice.party, n1.party)).id))
    coin = next(s for s in alice.vault.unconsumed_states(cash.CashState)
                if s.state.data.amount.quantity == 500)
    out.append(run(flows.ContractUpgradeFlow(coin, V2_CONTRACT)))
    for node in (alice, bob):
        for cls in (cash.CashState, tests.CashStateV2):
            out.append(sorted((str(s.ref), s.state.notary.name, s.state.contract,
                               s.state.data.amount.quantity)
                              for s in node.vault.unconsumed_states(cls)))
    return out


def test_replacement_drive_equals_the_references():
    ref, port = (_replacement_drive(p) for p in PACKAGES)
    assert port == ref
    assert "conflict" in ref[3] and not any("Error" in r or "Exception" in r
                                            for r in ref[:3] + ref[4:6])
    assert [q for *_, q in ref[7]] == [500]
