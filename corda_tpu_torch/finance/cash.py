"""Cash: fungible issued currency — the canonical contract.

Port of corda_tpu/finance/cash.py: the state, the commands and the
contract (reference: finance/src/main/kotlin/net/corda/contracts/asset/
Cash.kt) and the flows CashIssueFlow, CashPaymentFlow and CashExitFlow
with their shared spend builder `generate_spend` (finance/.../flows/).
CASH_CONTRACT is a wire name carried inside every transaction, so it
stays the reference's string byte for byte.

The contract groups states by issued token (issuer+currency) and
checks conservation per group — pure integer arithmetic on Amount.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import (
    Amount,
    Issued,
    register_contract,
)
from ..core.identity import Party, PartyAndReference
from ..core.transactions import TransactionBuilder
from ..crypto.composite import AnyKey
from ..flows.api import FlowException, FlowLogic, initiating_flow
from ..flows.core_flows import FinalityFlow
from ..node.services import InsufficientBalanceError
from .asset import OnLedgerAsset

CASH_CONTRACT = "corda_tpu.finance.Cash"


@ser.serializable
@dataclass(frozen=True)
class CashState:
    """An amount of issued currency owned by a key
    (Cash.State: finance/.../asset/Cash.kt)."""

    amount: Amount              # token is an Issued(issuer_ref, currency)
    owner: AnyKey

    @property
    def participants(self):
        return (self.owner,)

    def with_owner(self, new_owner: AnyKey) -> "CashState":
        return CashState(self.amount, new_owner)

    @property
    def issuer(self) -> Party:
        return self.amount.token.issuer.party


# commands


@ser.serializable
@dataclass(frozen=True)
class CashIssue:
    nonce: int = 0


@ser.serializable
@dataclass(frozen=True)
class CashMove:
    pass


@ser.serializable
@dataclass(frozen=True)
class CashExit:
    amount: Amount


# The contract: the canonical OnLedgerAsset clause stack (Cash.kt's
# clause-based verify — issue/move/exit dispatched per issued-token
# group; see finance/asset.py for the clauses).
Cash = OnLedgerAsset(CashState, CashIssue, CashMove, CashExit)

register_contract(CASH_CONTRACT, Cash)


# ---------------------------------------------------------------------------
# flows


@initiating_flow
class CashIssueFlow(FlowLogic):
    """Issue cash to a recipient (finance/.../flows/CashIssueFlow.kt).
    Issuance has no inputs, so no notarisation round-trip is needed —
    FinalityFlow records + broadcasts."""

    def __init__(
        self,
        quantity: int,
        currency: str,
        recipient: Party,
        notary: Party,
        issuer_ref: bytes = b"\x01",
        nonce: int = 0,
    ):
        self.quantity = quantity
        self.currency = currency
        self.recipient = recipient
        self.notary = notary
        self.issuer_ref = issuer_ref
        self.nonce = nonce

    def call(self):
        us = self.our_identity
        token = Issued(PartyAndReference(us, self.issuer_ref), self.currency)
        state = CashState(
            Amount(self.quantity, token), self.recipient.owning_key
        )
        builder = TransactionBuilder(self.notary)
        builder.add_output_state(state, CASH_CONTRACT)
        builder.add_command(CashIssue(self.nonce), us.owning_key)
        stx = self.services.sign_initial_transaction(builder)
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


@initiating_flow
class CashPaymentFlow(FlowLogic):
    """Pay cash to a recipient: coin-select, move, change back to us
    (finance/.../flows/CashPaymentFlow.kt)."""

    def __init__(self, quantity: int, currency: str, recipient: Party):
        self.quantity = quantity
        self.currency = currency
        self.recipient = recipient

    def call(self):
        builder, _ = yield from generate_spend(
            self, self.quantity, self.currency, self.recipient.owning_key
        )
        stx = self.services.sign_initial_transaction(builder)
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


@initiating_flow
class CashExitFlow(FlowLogic):
    """Redeem (destroy) our cash back to the issuer
    (finance/.../flows/CashExitFlow.kt). Only the issuer runs this over
    states it issued and owns."""

    def __init__(self, quantity: int, currency: str, issuer_ref: bytes = b"\x01"):
        self.quantity = quantity
        self.currency = currency
        self.issuer_ref = issuer_ref

    def call(self):
        us = self.our_identity
        token = Issued(PartyAndReference(us, self.issuer_ref), self.currency)
        lock_id = self.lock_id   # flow-scoped: auto-released on flow end
        coins = yield from self.record(
            lambda: self.services.vault.unconsumed_states_for_spending(
                self.quantity,
                lock_id,
                cls=CashState,
                predicate=lambda ts: ts.data.amount.token == token,
            )
        )
        self.services.vault.soft_lock([sar.ref for sar in coins], lock_id)
        total = sum(sar.state.data.amount.quantity for sar in coins)
        builder = TransactionBuilder()
        for sar in coins:
            builder.add_input_state(sar)
        change = total - self.quantity
        if change > 0:
            builder.add_output_state(
                CashState(Amount(change, token), us.owning_key),
                CASH_CONTRACT,
            )
        builder.add_command(
            CashExit(Amount(self.quantity, token)), us.owning_key
        )
        stx = self.services.sign_initial_transaction(builder)
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


def generate_spend(flow: FlowLogic, quantity: int, currency: str, to_key):
    """Shared spend builder (Cash.generateSpend, Cash.kt): greedy coin
    selection over every issuer's tokens in `currency`, outputs to
    `to_key` grouped per token + change to us. Generator (journals the
    soft-lock id)."""
    services = flow.services
    us = flow.our_identity
    lock_id = flow.lock_id   # flow-scoped: auto-released on flow end
    # The selection is journaled: on checkpoint replay the recorded
    # coins are reused verbatim (never re-selected against a vault that
    # may have changed), so the rebuilt tx id matches the journaled
    # notary conversation. Locks are then re-asserted for this run.
    try:
        coins = yield from flow.record(
            lambda: services.vault.unconsumed_states_for_spending(
                quantity,
                lock_id,
                cls=CashState,
                predicate=lambda ts: ts.data.amount.token.product == currency,
            )
        )
    except InsufficientBalanceError as e:
        raise FlowException(
            f"insufficient {currency}: short {e.shortfall}"
        ) from e
    services.vault.soft_lock([sar.ref for sar in coins], lock_id)
    builder = TransactionBuilder()
    by_token: dict = {}
    for sar in coins:
        builder.add_input_state(sar)
        t = sar.state.data.amount.token
        by_token[t] = by_token.get(t, 0) + sar.state.data.amount.quantity
    remaining = quantity
    for token in sorted(by_token, key=lambda t: ser.encode(t)):
        available = by_token[token]
        pay = min(available, remaining)
        if pay > 0:
            builder.add_output_state(
                CashState(Amount(pay, token), to_key), CASH_CONTRACT
            )
        change = available - pay
        if change > 0:
            builder.add_output_state(
                CashState(Amount(change, token), us.owning_key),
                CASH_CONTRACT,
            )
        remaining -= pay
    builder.add_command(CashMove(), us.owning_key)
    return builder, coins
