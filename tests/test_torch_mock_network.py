"""One seeded drive through MockNetwork in both packages, compared byte
for byte.

The same drive — issue, pay, a transitive payment that resolves a
backchain, a payment checkpointed after one delivered frame, a double
spend, an insufficient balance, an exit, swapped identities, a DvP trade
of commercial paper against Cash, a two-signer deal through
CollectSignaturesFlow and an issuance request — runs on the reference's
MockNetwork and on the port's, each over its CpuBatchVerifier, with
ed25519 nodes (signing is deterministic, so every signature compares)
and a simple, a validating or a batching notary. Required equal:
- every fabric frame in send order (sender, target, topic, unique id,
  payload bytes), with the first differing frame reported;
- every node's checkpoint records after the first frame of a payment;
- each step's transaction id and signatures, or its exception class and
  notary error kind;
- every node's balances.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import pytest

pytest.importorskip("torch")

PACKAGES = ("corda_tpu", "corda_tpu_torch")
DEAL_CONTRACT = "test.TwoPartyDeal"
_DEALS: dict = {}


class _AcceptAll:
    def verify(self, ltx) -> None:
        pass


def _package(prefix: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    return SimpleNamespace(
        mock=m("testing.mock_network"), bv=m("crypto.batch_verifier"),
        cash=m("finance.cash"), cf=m("flows.core_flows"), cp=m("finance.commercial_paper"),
        contracts=m("core.contracts"), identity=m("core.identity"), ser=m("core.serialization"),
        sm=m("flows.statemachine"), tf=m("finance.trade_flows"), tx=m("core.transactions"),
    )


def _deal_class(P, prefix: str):
    """A two-party deal state registered in one package's codec (the
    same wire tag and fields in both)."""
    if prefix not in _DEALS:
        @P.ser.serializable
        @dataclass(frozen=True)
        class TwoPartyDealState:
            party_a: Any
            party_b: Any
            notional: int

            @property
            def participants(self):
                return (self.party_a, self.party_b)

        P.contracts.register_contract(DEAL_CONTRACT, _AcceptAll())
        _DEALS[prefix] = TwoPartyDealState
    return _DEALS[prefix]


def _wire_name(cls) -> str:
    name = f"{cls.__module__}.{cls.__qualname__}"
    return name.replace("corda_tpu_torch.", "corda_tpu.", 1)


def _summary(P, result):
    if isinstance(result, P.tx.SignedTransaction):
        return [str(result.id), [s.signature.hex() for s in result.sigs]]
    if isinstance(result, dict):     # SwapIdentitiesFlow: party -> anonymous party
        return sorted((p.name, P.ser.encode(a).hex()) for p, a in result.items())
    return repr(result)


def drive(prefix: str, notary_kind: str) -> dict:
    P = _package(prefix)
    net = P.mock.MockNetwork(seed=23, batch_verifier=P.bv.CpuBatchVerifier())
    frames = []
    enqueue = net.fabric._enqueue

    def recording(msg, target):
        frames.append((msg.sender, target, msg.topic, msg.unique_id, msg.payload))
        enqueue(msg, target)

    net.fabric._enqueue = recording
    notary = net.create_notary("Notary", validating=notary_kind == "validating",
                               batching=notary_kind == "batching")
    bank, alice, bob, carol = (net.create_node(n) for n in ("Bank", "Alice", "Bob", "Carol"))
    usd = P.contracts.Issued(P.identity.PartyAndReference(bank.party, b"\x01"), "USD")
    steps = []

    def step(label, node, logic):
        try:
            result = node.run_flow(logic)
        except Exception as e:   # noqa: BLE001 - the failure is the step's outcome
            steps.append([label, "error", _wire_name(type(e)),
                          getattr(getattr(e, "error", None), "kind", None)])
            return None
        steps.append([label, "ok", _summary(P, result)])
        return result

    step("issue", bank, P.cash.CashIssueFlow(1000, "USD", alice.party, notary.party))
    step("pay", alice, P.cash.CashPaymentFlow(400, "USD", bob.party))
    step("pay on (backchain)", bob, P.cash.CashPaymentFlow(150, "USD", carol.party))

    fsm = carol.start_flow(P.cash.CashPaymentFlow(50, "USD", bank.party))
    net.fabric.pump(1)
    checkpoints = sorted((n.name, fid.hex(), rec) for n in net.nodes
                         for fid, rec in n.services.checkpoint_storage.all())
    net.run()
    steps.append(["checkpointed pay", "ok", _summary(P, fsm.result_or_throw())])

    coin, = alice.vault.unconsumed_states(P.cash.CashState)

    def spend_to(party):
        b = P.tx.TransactionBuilder(notary.party)
        b.add_input_state(coin)
        b.add_output_state(coin.state.data.with_owner(party.owning_key), P.cash.CASH_CONTRACT)
        b.add_command(P.cash.CashMove(), alice.party.owning_key)
        return alice.services.sign_initial_transaction(b)

    step("spend", alice, P.cf.FinalityFlow(spend_to(bob.party)))
    step("double spend", alice, P.cf.FinalityFlow(spend_to(carol.party)))
    step("insufficient", carol, P.cash.CashPaymentFlow(10_000, "USD", bank.party))
    step("issue to self", bank, P.cash.CashIssueFlow(100, "USD", bank.party, notary.party))
    step("exit", bank, P.cash.CashExitFlow(40, "USD"))
    step("swap identities", alice, P.cf.SwapIdentitiesFlow(bob.party))

    paper = P.tx.TransactionBuilder(notary.party)
    paper.set_time_window(P.contracts.TimeWindow(until_time=net.clock.now_micros() + 1_000_000))
    P.cp.generate_issue(paper, P.identity.PartyAndReference(bob.party, b"\x01"),
                        P.contracts.Amount(10_000, usd), net.clock.now_micros() + 10**9)
    step("issue paper", bob, P.cf.FinalityFlow(bob.services.sign_initial_transaction(paper)))
    paper_sar, = bob.vault.unconsumed_states(P.cp.CommercialPaperState)
    step("DvP", bob, P.tf.SellerFlow(carol.party, paper_sar, P.contracts.Amount(60, usd)))
    deal = _deal_class(P, prefix)(alice.party, bob.party, 1_000_000)
    step("deal", alice, P.tf.DealInstigatorFlow(bob.party, deal, DEAL_CONTRACT, notary.party))
    step("issuance request", alice, P.tf.IssuanceRequesterFlow(bank.party, 500, "CHF"))

    balances = {}
    for n in net.nodes:
        for s in n.vault.unconsumed_states(P.cash.CashState):
            key = (n.name, s.state.data.amount.token.product)
            balances[key] = balances.get(key, 0) + s.state.data.amount.quantity
    papers = {n.name: len(n.vault.unconsumed_states(P.cp.CommercialPaperState))
              for n in net.nodes}
    return {"frames": frames, "checkpoints": checkpoints, "steps": steps,
            "balances": balances, "papers": papers}


@pytest.mark.parametrize("notary_kind", ["simple", "validating", "batching"])
def test_drive_equals_the_reference(notary_kind):
    ref, port = (drive(prefix, notary_kind) for prefix in PACKAGES)
    for i, (a, b) in enumerate(zip(ref["frames"], port["frames"])):
        assert a == b, f"frame {i} differs: reference {a[:4]}, port {b[:4]}"
    assert len(ref["frames"]) == len(port["frames"]) > 50
    assert port["checkpoints"] and port["checkpoints"] == ref["checkpoints"]
    assert port["steps"] == ref["steps"]
    assert port["balances"] == ref["balances"]
    assert port["papers"] == ref["papers"]
    outcomes = {label: rest for label, *rest in port["steps"]}
    assert outcomes["double spend"] == ["error", "corda_tpu.node.notary.NotaryException",
                                        "conflict"]
    assert outcomes["insufficient"] == ["error", "corda_tpu.flows.api.FlowException", None]
    assert all(rest[0] == "ok" for label, rest in outcomes.items()
               if label not in ("double spend", "insufficient"))
    assert port["balances"] == {
        ("Alice", "CHF"): 500, ("Bank", "USD"): 110, ("Bob", "USD"): 910, ("Carol", "USD"): 40}
    assert port["papers"]["Carol"] == 1
