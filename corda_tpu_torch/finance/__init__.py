"""Financial contracts and flows of the port (port of corda_tpu/finance):
the OnLedgerAsset base, Cash with its issue, payment and exit flows,
CommercialPaper, Obligation and the trading flows. The reference's
Commodity and its MappedSchemas are not ported."""

from .asset import OnLedgerAsset
from .cash import (
    Cash,
    CashExitFlow,
    CashIssueFlow,
    CashPaymentFlow,
    CashState,
)
from .commercial_paper import (
    CommercialPaper,
    CommercialPaperState,
)
from .obligation import (
    Obligation,
    ObligationState,
)
from .trade_flows import (
    BuyerFlow,
    DealInstigatorFlow,
    IssuanceRequesterFlow,
    IssuerHandlerFlow,
    SellerFlow,
)

__all__ = [
    "OnLedgerAsset",
    "Cash",
    "CashExitFlow",
    "CashIssueFlow",
    "CashPaymentFlow",
    "CashState",
    "CommercialPaper",
    "CommercialPaperState",
    "Obligation",
    "ObligationState",
    "BuyerFlow",
    "DealInstigatorFlow",
    "IssuanceRequesterFlow",
    "IssuerHandlerFlow",
    "SellerFlow",
]
