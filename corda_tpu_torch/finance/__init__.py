"""Financial contracts and flows of the port (port of corda_tpu/finance):
the OnLedgerAsset base, Cash with its issue, payment and exit flows,
Commodity, CommercialPaper, Obligation, the trading flows and the Cash
and CommercialPaper MappedSchemas (registered on import, as the
reference registers them)."""

from .asset import OnLedgerAsset
from .cash import (
    Cash,
    CashExitFlow,
    CashIssueFlow,
    CashPaymentFlow,
    CashState,
)
from .commodity import (
    Commodity,
    CommodityState,
)
from .commercial_paper import (
    CommercialPaper,
    CommercialPaperState,
)
from .obligation import (
    Obligation,
    ObligationState,
)
from . import schemas as _schemas  # noqa: F401 - registers MappedSchemas
from .trade_flows import (
    BuyerFlow,
    DealInstigatorFlow,
    IssuanceRequesterFlow,
    IssuerHandlerFlow,
    SellerFlow,
)

__all__ = [
    "OnLedgerAsset",
    "Commodity",
    "CommodityState",
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
