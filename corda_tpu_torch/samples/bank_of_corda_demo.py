"""bank-of-corda-demo: an issuer node serving issuance requests.

Reference: samples/bank-of-corda-demo/ — a bank node issues cash to
requesting parties on demand through `IssuerFlow`, with an issuance
policy; clients drive it via RPC.

Port of corda_tpu/samples/bank_of_corda_demo.py. `run` takes
`batch_verifier=`: the port's MockNetwork verifies on the card by
default, where the reference's verifies on the CPU.
"""

from __future__ import annotations

from ..finance.cash import CashState
from ..finance.trade_flows import IssuanceRequesterFlow


def run(seed: int = 42, requests=((7_000, "USD"), (3_000, "GBP")),
        batch_verifier=None):
    """Big Corporation asks the Bank of Corda for money; the bank's
    policy caps single issuances. Returns the requester's balances.
    `batch_verifier`: the MockNetwork's verifier; None verifies on the
    card (`CudaBatchVerifier()`), `CpuBatchVerifier()` runs without one."""
    from ..flows.api import FlowException
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    net.create_notary("Notary")
    bank = net.create_node("BankOfCorda")
    big_corp = net.create_node("BigCorporation")

    def policy(req, requester):
        if req.quantity > 1_000_000:
            raise ValueError("single issuance cap is 1,000,000")

    bank.services.issuance_policy = policy

    for quantity, currency in requests:
        fsm = big_corp.start_flow(
            IssuanceRequesterFlow(bank.party, quantity, currency)
        )
        net.run()
        fsm.result_or_throw()

    # over-cap request refused
    fsm = big_corp.start_flow(
        IssuanceRequesterFlow(bank.party, 2_000_000, "USD")
    )
    net.run()
    refused = False
    try:
        fsm.result_or_throw()
    except FlowException:
        refused = True

    balances: dict[str, int] = {}
    for s in big_corp.vault.unconsumed_states(CashState):
        cur = s.state.data.amount.token.product
        balances[cur] = balances.get(cur, 0) + s.state.data.amount.quantity
    return balances, refused


def main():
    balances, refused = run()
    print(f"issued balances: {balances}; over-cap refused: {refused}")


if __name__ == "__main__":
    main()
