"""CommercialPaper: issued debt redeemable for cash at maturity.

Port of corda_tpu/finance/commercial_paper.py: the same states, commands, rules
and messages, and the same wire names, so a transaction under it has
the same id in both packages (the attachment sandbox serves this module
to contract code that imports corda_tpu.finance.commercial_paper).

Reference: finance/src/main/kotlin/net/corda/contracts/
CommercialPaper.kt — State(issuance, owner, faceValue, maturityDate),
commands Issue/Move/Redeem, clause-stack verification flattened here:
issue needs the issuer's signature and a future maturity; move conserves
the paper and needs the owner's signature; redeem needs maturity
reached, the paper destroyed, and cash of at least face value paid to
the paper's owner in the same transaction (the DvP atom the trader-demo
trades on).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core import serialization as ser
from ..core.contracts import (
    Amount,
    ContractViolation,
    register_contract,
    require_that,
)
from ..core.identity import PartyAndReference
from ..core.transactions import LedgerTransaction, TransactionBuilder
from ..crypto.composite import AnyKey
from .asset import signed_by as _signed_by
from .cash import CashState

CP_CONTRACT = "corda_tpu.finance.CommercialPaper"


@ser.serializable
@dataclass(frozen=True)
class CommercialPaperState:
    """One paper: `issuance` identifies the issuer (and its reference),
    `face_value` is what the owner may redeem at `maturity_micros`."""

    issuance: PartyAndReference
    owner: AnyKey
    face_value: Amount              # token: Issued(issuer_ref, currency)
    maturity_micros: int

    @property
    def participants(self):
        return (self.owner,)

    def with_owner(self, new_owner: AnyKey) -> "CommercialPaperState":
        return CommercialPaperState(
            self.issuance, new_owner, self.face_value, self.maturity_micros
        )

    def without_owner_key(self):
        """Group key: everything but the owner (CommercialPaper.kt
        withoutOwner)."""
        return (self.issuance, self.face_value, self.maturity_micros)


@ser.serializable
@dataclass(frozen=True)
class CPIssue:
    nonce: int = 0


@ser.serializable
@dataclass(frozen=True)
class CPMove:
    pass


@ser.serializable
@dataclass(frozen=True)
class CPRedeem:
    pass


class CommercialPaper:
    def verify(self, ltx: LedgerTransaction) -> None:
        groups = ltx.group_states(
            CommercialPaperState, lambda s: s.without_owner_key()
        )
        cmds = [
            c for c in ltx.commands
            if isinstance(c.value, (CPIssue, CPMove, CPRedeem))
        ]
        require_that("a CommercialPaper command is present", len(cmds) == 1)
        cmd = cmds[0]
        tw = ltx.time_window
        # redemption cash is accounted GLOBALLY per (owner, token): the
        # same cash output must not satisfy two papers (double-count)
        redeem_required: dict = {}
        for group in groups:
            issuance, face_value, maturity = group.key
            if isinstance(cmd.value, CPIssue):
                require_that("no paper inputs when issuing", not group.inputs)
                require_that(
                    "one paper output per issue group",
                    len(group.outputs) == 1,
                )
                require_that(
                    "face value is positive", face_value.quantity > 0
                )
                require_that(
                    "issue has a time window", tw is not None
                )
                require_that(
                    "maturity is in the future",
                    tw.until_time is not None
                    and maturity > tw.until_time,
                )
                require_that(
                    "issue is signed by the issuer",
                    _signed_by(issuance.party.owning_key, set(cmd.signers)),
                )
            elif isinstance(cmd.value, CPMove):
                require_that(
                    "move consumes exactly one paper", len(group.inputs) == 1
                )
                require_that(
                    "move produces exactly one paper", len(group.outputs) == 1
                )
                inp, out = group.inputs[0], group.outputs[0]
                require_that(
                    "the paper itself is unchanged",
                    inp.without_owner_key() == out.without_owner_key(),
                )
                require_that(
                    "move is signed by the current owner",
                    _signed_by(inp.owner, set(cmd.signers)),
                )
            else:   # CPRedeem
                require_that(
                    "redeem consumes the paper", len(group.inputs) >= 1
                )
                require_that(
                    "redeemed paper is destroyed", not group.outputs
                )
                require_that("redeem has a time window", tw is not None)
                require_that(
                    "paper has matured",
                    tw.from_time is not None and tw.from_time >= maturity,
                )
                for inp in group.inputs:
                    key = (inp.owner, face_value.token)
                    redeem_required[key] = (
                        redeem_required.get(key, 0) + face_value.quantity
                    )
                    require_that(
                        "redeem is signed by the owner",
                        _signed_by(inp.owner, set(cmd.signers)),
                    )
        for (owner, token), required in redeem_required.items():
            received = sum(
                s.amount.quantity
                for s in ltx.outputs_of_type(CashState)
                if s.owner == owner and s.amount.token == token
            )
            require_that(
                "owner receives the face value of every redeemed paper",
                received >= required,
            )


register_contract(CP_CONTRACT, CommercialPaper())


# -- builder helpers (CommercialPaper.kt generateIssue/Move/Redeem) ----------


def generate_issue(
    builder: TransactionBuilder,
    issuance: PartyAndReference,
    face_value: Amount,
    maturity_micros: int,
) -> TransactionBuilder:
    paper = CommercialPaperState(
        issuance, issuance.party.owning_key, face_value, maturity_micros
    )
    builder.add_output_state(paper, CP_CONTRACT)
    builder.add_command(CPIssue(), issuance.party.owning_key)
    return builder


def generate_move(builder: TransactionBuilder, paper_sar, new_owner: AnyKey):
    builder.add_input_state(paper_sar)
    builder.add_output_state(
        paper_sar.state.data.with_owner(new_owner), CP_CONTRACT
    )
    builder.add_command(CPMove(), paper_sar.state.data.owner)
    return builder
