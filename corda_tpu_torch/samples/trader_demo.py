"""trader-demo: cash-vs-commercial-paper DvP between two banks.

Reference: samples/trader-demo/ — Bank B self-issues commercial paper,
Bank A gets cash from the bank-of-corda issuer, then they trade
atomically through `TwoPartyTradeFlow` via a validating notary.

Port of corda_tpu/samples/trader_demo.py. `run` and `run_via_rpc`
take `batch_verifier=`: the port's MockNetwork verifies on the card by
default, where the reference's verifies on the CPU.
"""

from __future__ import annotations

from ..core.contracts import Amount, Issued, TimeWindow
from ..core.identity import PartyAndReference
from ..core.transactions import TransactionBuilder
from ..finance.cash import CashState
from ..finance.commercial_paper import CommercialPaperState, generate_issue
from ..finance.trade_flows import IssuanceRequesterFlow, SellerFlow
from ..flows.core_flows import FinalityFlow


def run(seed: int = 42, face: int = 100_000, price: int = 92_000,
        batch_verifier=None):
    """The demo arc on a MockNetwork; returns (buyer_paper, seller_cash).
    `batch_verifier`: the MockNetwork's verifier; None verifies on the
    card (`CudaBatchVerifier()`), `CpuBatchVerifier()` runs without one."""
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary", validating=True)
    bank = net.create_node("BankOfCorda")
    seller = net.create_node("BankA")    # sells paper
    buyer = net.create_node("BankB")     # pays cash

    # 1. buyer funds itself from the central issuer
    buyer.run_flow(IssuanceRequesterFlow(bank.party, price + 8_000, "USD"))
    bank_usd = Issued(PartyAndReference(bank.party, b"\x01"), "USD")

    # 2. seller self-issues paper maturing in 30 days
    now = net.clock.now_micros()
    builder = TransactionBuilder(notary.party)
    builder.set_time_window(TimeWindow(until_time=now + 60_000_000))
    generate_issue(
        builder,
        PartyAndReference(seller.party, b"\x01"),
        Amount(face, bank_usd),
        now + 30 * 24 * 3600 * 1_000_000,
    )
    seller.run_flow(
        FinalityFlow(seller.services.sign_initial_transaction(builder))
    )
    paper = seller.vault.unconsumed_states(CommercialPaperState)[0]

    # 3. the trade
    fsm = seller.start_flow(
        SellerFlow(buyer.party, paper, Amount(price, bank_usd))
    )
    net.run()
    fsm.result_or_throw()

    buyer_paper = buyer.vault.unconsumed_states(CommercialPaperState)
    seller_cash = sum(
        s.state.data.amount.quantity
        for s in seller.vault.unconsumed_states(CashState)
    )
    return buyer_paper, seller_cash


def run_via_rpc(seed: int = 42, face: int = 100_000, price: int = 92_000,
                batch_verifier=None):
    """The demo arc with the buyer's funding, the trade itself, and
    every report query driven over CordaRPCOps (the
    TraderDemoClientApi.runBuyer/runSeller shape from
    samples/trader-demo/). The seller's one-off paper self-issue stays
    in-process — it is demo fixture setup, not part of the client
    pattern. Returns a report dict assembled from RPC vault queries."""
    from ..client.common import wait_rpc
    from ..node import rpc as rpclib
    from ..node.vault_query import VaultQueryCriteria
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary", validating=True)
    bank = net.create_node("BankOfCorda")
    seller = net.create_node("BankA")
    buyer = net.create_node("BankB")

    users = rpclib.RPCUserService(rpclib.RpcUser("demo", "demo", ("ALL",)))
    for node in (seller, buyer):
        rpclib.RPCServer(
            rpclib.CordaRPCOpsImpl(node.services, node.smm),
            node.messaging,
            users,
        )

    def client(node_name: str) -> rpclib.RPCClient:
        return rpclib.RPCClient(
            net.fabric.endpoint(f"{node_name}-console"),
            node_name,
            "demo",
            "demo",
        )

    def wait(fut):
        return wait_rpc(fut, lambda: net.run(), 60.0)

    buyer_rpc = client("BankB")
    seller_rpc = client("BankA")

    # buyer: request issuance from the bank (runBuyer)
    handle = wait(
        buyer_rpc.start_flow(
            "corda_tpu.finance.trade_flows.IssuanceRequesterFlow",
            issuer=bank.party,
            quantity=price + 8_000,
            currency="USD",
        )
    )
    wait(handle.result)

    # seller: self-issue paper, then offer it (runSeller)
    bank_usd = Issued(PartyAndReference(bank.party, b"\x01"), "USD")
    now = net.clock.now_micros()
    builder = TransactionBuilder(notary.party)
    builder.set_time_window(TimeWindow(until_time=now + 60_000_000))
    generate_issue(
        builder,
        PartyAndReference(seller.party, b"\x01"),
        Amount(face, bank_usd),
        now + 30 * 24 * 3600 * 1_000_000,
    )
    seller.run_flow(
        FinalityFlow(seller.services.sign_initial_transaction(builder))
    )
    paper = seller.vault.unconsumed_states(CommercialPaperState)[0]
    handle = wait(
        seller_rpc.start_flow(
            SellerFlow,
            buyer=buyer.party,
            asset=paper,
            price=Amount(price, bank_usd),
        )
    )
    wait(handle.result)

    # the report comes from RPC vault queries, not node internals
    def holdings(rpc, cls):
        page = wait(
            rpc.vault_query_by(VaultQueryCriteria(contract_state_types=(cls,)))
        )
        return page.states

    return {
        "buyer_paper": len(holdings(buyer_rpc, CommercialPaperState)),
        "seller_cash": sum(
            s.state.data.amount.quantity
            for s in holdings(seller_rpc, CashState)
        ),
        "buyer_cash": sum(
            s.state.data.amount.quantity
            for s in holdings(buyer_rpc, CashState)
        ),
    }


def main():
    paper, cash = run()
    print(f"in-process: buyer holds {len(paper)} paper, seller has {cash}")
    report = run_via_rpc()
    print(
        "via RPC:    buyer holds "
        f"{report['buyer_paper']} paper + {report['buyer_cash']} change, "
        f"seller has {report['seller_cash']}"
    )


if __name__ == "__main__":
    main()
