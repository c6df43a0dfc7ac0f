"""CommodityContract: fungible physical commodities on ledger.

Reference: finance/.../contracts/asset/CommodityContract.kt — the
second OnLedgerAsset instantiation after Cash (same issue/move/exit
clause stack over `Issued(commodity-code)` tokens, e.g. "FCOJ").

Port of corda_tpu/finance/commodity.py; the contract name and the wire
tags are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import Amount, Issued, register_contract
from ..core.identity import Party, PartyAndReference
from ..crypto.composite import AnyKey
from .asset import OnLedgerAsset

COMMODITY_CONTRACT = "corda_tpu.finance.Commodity"


@ser.serializable
@dataclass(frozen=True)
class CommodityState:
    """An amount of an issued commodity owned by a key
    (CommodityContract.State)."""

    amount: Amount              # token is Issued(issuer_ref, commodity_code)
    owner: AnyKey

    @property
    def participants(self):
        return (self.owner,)

    def with_owner(self, new_owner: AnyKey) -> "CommodityState":
        return CommodityState(self.amount, new_owner)

    @property
    def issuer(self) -> Party:
        return self.amount.token.issuer.party


@ser.serializable
@dataclass(frozen=True)
class CommodityIssue:
    nonce: int = 0


@ser.serializable
@dataclass(frozen=True)
class CommodityMove:
    pass


@ser.serializable
@dataclass(frozen=True)
class CommodityExit:
    amount: Amount


Commodity = OnLedgerAsset(
    CommodityState, CommodityIssue, CommodityMove, CommodityExit
)

register_contract(COMMODITY_CONTRACT, Commodity)


def commodity_token(
    issuer: Party, code: str, ref: bytes = b"\x01"
) -> Issued:
    return Issued(PartyAndReference(issuer, ref), code)
