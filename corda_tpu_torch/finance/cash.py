"""Cash: fungible issued currency — the canonical contract.

Port of corda_tpu/finance/cash.py: the state, the commands and the
contract (reference: finance/src/main/kotlin/net/corda/contracts/asset/
Cash.kt). The flows (CashIssueFlow, CashPaymentFlow, CashExitFlow) are
not ported yet. CASH_CONTRACT is a wire name carried inside every
transaction, so it stays the reference's string byte for byte.

The contract groups states by issued token (issuer+currency) and
checks conservation per group — pure integer arithmetic on Amount.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import (
    Amount,
    register_contract,
)
from ..core.identity import Party
from ..crypto.composite import AnyKey
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
