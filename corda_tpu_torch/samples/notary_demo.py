"""notary-demo: fire N transactions through a chosen notary flavour.

Reference: samples/notary-demo/ — `Notarise.kt` drives N transactions
through `DummyIssueAndMove` against a Single, Raft, or BFT notary
cluster and prints which member(s) signed each one.

Port of corda_tpu/samples/notary_demo.py. `run` takes
`batch_verifier=`: the port's MockNetwork verifies on the card by
default, where the reference's verifies on the CPU.
"""

from __future__ import annotations

import time

from ..crypto.composite import leaves_of
from ..finance.cash import CashIssueFlow, CashPaymentFlow


def run(flavour: str = "single", n_txs: int = 10, seed: int = 42,
        batch_verifier=None):
    """Issue-and-move n_txs through the selected notary flavour on a
    MockNetwork. Returns (signer names per tx, elapsed seconds).
    `batch_verifier`: the MockNetwork's verifier; None verifies on the
    card (`CudaBatchVerifier()`), `CpuBatchVerifier()` runs without one."""
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    if flavour == "single":
        notary_party = net.create_notary("Notary").party
        members = []
    elif flavour == "batching":
        notary_party = net.create_notary("Notary", batching=True).party
        members = []
    elif flavour == "raft":
        notary_party, members = net.create_raft_notary_cluster(3)
        net.elect(members)
    elif flavour == "bft":
        notary_party, members = net.create_bft_notary_cluster(4)
    else:
        raise ValueError(f"unknown notary flavour {flavour!r}")

    alice = net.create_node("Counterparty")
    bob = net.create_node("Requestor")

    def settle(fsm, rounds=600):
        for _ in range(rounds):
            net.run()
            if fsm.done:
                return
            net.clock.advance(100_000)
        raise AssertionError("notarisation did not settle")

    # one vault state per planned payment so concurrent flows can each
    # soft-lock a distinct coin (distinct nonces: identical issuances
    # would collapse into one deterministic tx id)
    for i in range(n_txs):
        fsm = bob.start_flow(
            CashIssueFlow(100, "USD", bob.party, notary_party, nonce=i)
        )
        settle(fsm)
        fsm.result_or_throw()

    notary_leaves = set(leaves_of(notary_party.owning_key))
    signers_per_tx = []
    t0 = time.perf_counter()
    if flavour == "batching":
        # the point of the batching notary: N requests in flight at
        # once share SPI dispatches (one per quiescent pump round)
        fsms = [
            bob.start_flow(CashPaymentFlow(100, "USD", alice.party))
            for _ in range(n_txs)
        ]
        for fsm in fsms:
            settle(fsm)
        stxs = [fsm.result_or_throw() for fsm in fsms]
    else:
        stxs = []
        for i in range(n_txs):
            fsm = bob.start_flow(CashPaymentFlow(100, "USD", alice.party))
            settle(fsm)
            stxs.append(fsm.result_or_throw())
    elapsed = time.perf_counter() - t0
    for stx in stxs:
        signers_per_tx.append(
            [s.by for s in stx.sigs if s.by in notary_leaves]
        )
    assert all(signers_per_tx), "every tx must carry notary signature(s)"
    return signers_per_tx, elapsed


def main():
    for flavour in ("single", "batching", "raft", "bft"):
        signers, elapsed = run(flavour, n_txs=5)
        per_tx = [len(s) for s in signers]
        print(
            f"{flavour:>8}: 5 txs notarised in {elapsed:.2f}s "
            f"({5 / elapsed:.1f} tx/s), signatures per tx: {per_tx}"
        )


if __name__ == "__main__":
    main()
