"""Trading flows: DvP trade, generic deal onboarding, issuer requests.

Port of corda_tpu/finance/trade_flows.py: Cash against the port's
CommercialPaper, with the seller's signature collected in the trade and
CollectSignaturesFlow for deals.

Reference: finance/src/main/kotlin/net/corda/flows/ —
`TwoPartyTradeFlow` (Seller `:54` / Buyer `:110`: atomic
asset-for-cash, the trader-demo's engine), `TwoPartyDealFlow`
(Instigator/Acceptor onboarding a mutually-signed deal state), and
`IssuerFlow` (IssuanceRequester asking a bank to issue cash to it —
bank-of-corda's engine).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core import serialization as ser
from ..core.contracts import Amount, StateAndRef
from ..core.identity import Party
from ..core.transactions import SignedTransaction, TransactionBuilder
from ..crypto.tx_signature import TransactionSignature
from ..flows.api import (
    FlowException,
    FlowLogic,
    initiated_by,
    initiating_flow,
)
from ..flows.core_flows import (
    CollectSignaturesFlow,
    FinalityFlow,
    ResolveTransactionsFlow,
)
from .cash import CashIssueFlow, CashState, generate_spend
from .commercial_paper import CPMove


# ---------------------------------------------------------------------------
# TwoPartyTradeFlow — DvP


@ser.serializable
@dataclass(frozen=True)
class SellerTradeInfo:
    """The seller's opening offer (TwoPartyTradeFlow.SellerTradeInfo):
    the asset on offer and the price asked for it."""

    asset: StateAndRef
    price: Amount                    # of Issued currency
    seller_owner_key: Any


@initiating_flow
class SellerFlow(FlowLogic):
    """TwoPartyTradeFlow.Seller (:54): offer the asset, receive the
    buyer's draft DvP transaction, check it honours the offer, sign it,
    and wait for the notarised result to hit our ledger."""

    def __init__(self, buyer: Party, asset: StateAndRef, price: Amount):
        self.buyer = buyer
        self.asset = asset
        self.price = price

    def call(self):
        yield from self.step("offering asset")
        offer = SellerTradeInfo(
            self.asset, self.price, self.our_identity.owning_key
        )
        stx = yield from self.send_and_receive(
            self.buyer, offer, SignedTransaction
        )
        yield from self.step("verifying draft")
        self._check_draft(stx)
        yield from self.step("signing")
        key = self.services.key_management.our_first_key_for(
            [self.asset.state.data.owner]
        )
        if key is None:
            raise FlowException("we do not own the offered asset")
        sig = self.services.key_management.sign(stx.id, key)
        yield from self.send(self.buyer, sig)
        yield from self.step("awaiting ledger commit")
        final = yield from self.wait_for_ledger_commit(stx.id)
        return final

    def _check_draft(self, stx: SignedTransaction) -> None:
        """The buyer's draft is untrusted: it must consume our asset,
        pay us (at least) the asking price, and touch NOTHING ELSE of
        ours (Seller.checkProposal) — our signature covers every input,
        so a draft sneaking a second seller-owned state into another
        group would move it for free."""
        wtx = stx.wtx
        if self.asset.ref not in wtx.inputs:
            raise FlowException("draft does not consume the offered asset")
        for ref in wtx.inputs:
            if ref == self.asset.ref:
                continue
            if self.services.vault.state_and_ref(ref) is not None:
                raise FlowException(
                    f"draft consumes our state {ref} beyond the offer"
                )
        us = self.our_identity.owning_key
        paid = sum(
            t.data.amount.quantity
            for t in wtx.outputs
            if isinstance(t.data, CashState)
            and t.data.owner == us
            and t.data.amount.token == self.price.token
        )
        if paid < self.price.quantity:
            raise FlowException(
                f"draft pays {paid}, asking price is {self.price.quantity}"
            )


@initiated_by(SellerFlow)
class BuyerFlow(FlowLogic):
    """TwoPartyTradeFlow.Buyer (:110): receive the offer, build the
    DvP transaction (their asset to us, our cash to them), collect the
    seller's signature, notarise, broadcast."""

    # nodes may install a hook to vet offers: services.trade_approval
    def __init__(self, seller: Party):
        self.seller = seller

    def call(self):
        offer = yield from self.receive(self.seller, SellerTradeInfo)
        yield from self.step("resolving offered asset")
        # pull the asset's backchain from the seller and check the offer
        # is honest: the claimed StateAndRef must be a real unspent
        # output of a valid transaction (Buyer's "check the asset is
        # what the seller claims" step)
        yield from self.sub_flow(
            ResolveTransactionsFlow([offer.asset.ref.txhash], self.seller)
        )
        recorded = self.services.validated_transactions.get(
            offer.asset.ref.txhash
        )
        if (
            recorded is None
            or offer.asset.ref.index >= len(recorded.wtx.outputs)
            or recorded.wtx.outputs[offer.asset.ref.index] != offer.asset.state
        ):
            raise FlowException("offered asset does not match its chain")
        approval = getattr(self.services, "trade_approval", None)
        if approval is not None:
            approval(offer, self.seller)   # raises to refuse
        yield from self.step("building DvP transaction")
        builder, _coins = yield from generate_spend(
            self,
            offer.price.quantity,
            offer.price.token.product,
            offer.seller_owner_key,
        )
        builder.add_input_state(offer.asset)
        builder.add_output_state(
            offer.asset.state.data.with_owner(self.our_identity.owning_key),
            offer.asset.state.contract,
        )
        builder.add_command(CPMove(), offer.asset.state.data.owner)
        stx = self.services.sign_initial_transaction(builder)
        yield from self.step("collecting seller signature")
        sig = yield from self.send_and_receive(
            self.seller, stx, TransactionSignature
        )
        sig.verify(stx.id)
        stx = stx.with_additional_signature(sig)
        yield from self.step("finalising")
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


# ---------------------------------------------------------------------------
# TwoPartyDealFlow — mutually-signed deal onboarding


@initiating_flow
class DealInstigatorFlow(FlowLogic):
    """TwoPartyDealFlow.Instigator: propose a deal state that both
    parties must sign; collect signatures; finalise."""

    def __init__(self, other: Party, deal_state: Any, contract: str, notary: Party):
        self.other = other
        self.deal_state = deal_state
        self.contract = contract
        self.notary = notary

    def call(self):
        builder = TransactionBuilder(self.notary)
        builder.add_output_state(self.deal_state, self.contract)
        command = getattr(self.deal_state, "agreement_command", None)
        signers = [
            getattr(p, "owning_key", p)
            for p in self.deal_state.participants
        ]
        builder.add_command(
            command() if callable(command) else DealAgree(), *signers
        )
        stx = self.services.sign_initial_transaction(builder)
        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


@ser.serializable
@dataclass(frozen=True)
class DealAgree:
    """Default agreement command for deal states."""


# ---------------------------------------------------------------------------
# IssuerFlow — ask a bank to issue cash to us


@ser.serializable
@dataclass(frozen=True)
class IssuanceRequest:
    quantity: int
    currency: str


@ser.serializable
@dataclass(frozen=True)
class IssuanceResult:
    tx_id: Any                      # SecureHash of the issuance tx
    error: Optional[str] = None


@initiating_flow
class IssuanceRequesterFlow(FlowLogic):
    """IssuerFlow.IssuanceRequester: ask `issuer` to issue
    quantity/currency to us; wait until the issuance lands on our
    ledger (bank-of-corda's client path)."""

    def __init__(self, issuer: Party, quantity: int, currency: str):
        self.issuer = issuer
        self.quantity = quantity
        self.currency = currency

    def call(self):
        result = yield from self.send_and_receive(
            self.issuer,
            IssuanceRequest(self.quantity, self.currency),
            IssuanceResult,
        )
        if result.error is not None:
            raise FlowException(f"issuer refused: {result.error}")
        stx = yield from self.wait_for_ledger_commit(result.tx_id)
        return stx


@initiated_by(IssuanceRequesterFlow)
class IssuerHandlerFlow(FlowLogic):
    """IssuerFlow.Issuer: vet the request (nodes may install
    services.issuance_policy), run CashIssueFlow to the requester, and
    reply with the transaction id."""

    def __init__(self, requester: Party):
        self.requester = requester

    def call(self):
        req = yield from self.receive(self.requester, IssuanceRequest)
        policy = getattr(self.services, "issuance_policy", None)
        if policy is not None:
            try:
                policy(req, self.requester)
            except Exception as e:
                yield from self.send(
                    self.requester, IssuanceResult(None, str(e))
                )
                return None
        notaries = self.services.network_map_cache.notary_identities()
        if not notaries:
            yield from self.send(
                self.requester, IssuanceResult(None, "no notary available")
            )
            return None
        stx = yield from self.sub_flow(
            CashIssueFlow(
                req.quantity, req.currency, self.requester, notaries[0]
            )
        )
        yield from self.send(self.requester, IssuanceResult(stx.id))
        return stx.id
