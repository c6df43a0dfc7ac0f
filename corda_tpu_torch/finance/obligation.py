"""Obligation: an IOU of issued currency between two parties.

Port of corda_tpu/finance/obligation.py: the same states, commands, rules
and messages, and the same wire names, so a transaction under it has
the same id in both packages (the attachment sandbox serves this module
to contract code that imports corda_tpu.finance.obligation).

Reference: finance/src/main/kotlin/net/corda/contracts/asset/
Obligation.kt — State(obligor, template terms, quantity, beneficiary)
with a NORMAL/DEFAULTED lifecycle; commands Issue, Move, Settle.Cash,
Net, SetLifecycle, Exit. The big clause stack flattens to per-group
checks: issuance signed by the obligor; moves conserve the claim and
need the beneficiary; settlement destroys obligation value against
cash actually paid to the beneficiary in the same transaction;
bilateral netting cancels opposing claims; lifecycle changes past the
due date let the beneficiary mark default.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import Amount, register_contract, require_that
from ..core.identity import Party
from ..core.transactions import LedgerTransaction, TransactionBuilder
from ..crypto.composite import AnyKey
from .asset import signed_by as _signed_by
from .cash import CashState

OBLIGATION_CONTRACT = "corda_tpu.finance.Obligation"

NORMAL = "NORMAL"
DEFAULTED = "DEFAULTED"


@ser.serializable
@dataclass(frozen=True)
class ObligationState:
    """`obligor` owes `amount` to `beneficiary`, due at `due_micros`."""

    obligor: Party
    beneficiary: AnyKey
    amount: Amount                  # token: Issued(...)
    due_micros: int
    lifecycle: str = NORMAL

    @property
    def participants(self):
        return (self.obligor.owning_key, self.beneficiary)

    def terms_key(self):
        """Group key: the obligation 'terms' (Obligation.kt Terms)."""
        return (self.obligor, self.amount.token, self.due_micros)

    def with_quantity(self, quantity: int) -> "ObligationState":
        return ObligationState(
            self.obligor,
            self.beneficiary,
            Amount(quantity, self.amount.token),
            self.due_micros,
            self.lifecycle,
        )


@ser.serializable
@dataclass(frozen=True)
class ObligationIssue:
    nonce: int = 0


@ser.serializable
@dataclass(frozen=True)
class ObligationMove:
    pass


@ser.serializable
@dataclass(frozen=True)
class ObligationSettle:
    amount: Amount


@ser.serializable
@dataclass(frozen=True)
class ObligationNet:
    pass


@ser.serializable
@dataclass(frozen=True)
class ObligationSetLifecycle:
    lifecycle: str


class Obligation:
    def verify(self, ltx: LedgerTransaction) -> None:
        cmds = [
            c for c in ltx.commands
            if isinstance(
                c.value,
                (
                    ObligationIssue,
                    ObligationMove,
                    ObligationSettle,
                    ObligationNet,
                    ObligationSetLifecycle,
                ),
            )
        ]
        require_that("an Obligation command is present", len(cmds) == 1)
        cmd = cmds[0]
        signers = set(cmd.signers)

        if isinstance(cmd.value, ObligationNet):
            self._verify_net(ltx, signers)
            return

        groups = ltx.group_states(ObligationState, lambda s: s.terms_key())
        # settlement cash is accounted GLOBALLY per (beneficiary, token):
        # one cash output must not satisfy two settle groups (same
        # double-count class as CP redemption)
        settle_required: dict = {}
        for group in groups:
            obligor, token, due = group.key
            in_sum = sum(s.amount.quantity for s in group.inputs)
            out_sum = sum(s.amount.quantity for s in group.outputs)
            require_that(
                "obligation amounts are positive",
                all(s.amount.quantity > 0 for s in group.outputs),
            )
            if isinstance(cmd.value, ObligationIssue):
                require_that("issue creates value", out_sum > in_sum)
                require_that(
                    "issue is signed by the obligor",
                    _signed_by(obligor.owning_key, signers),
                )
            elif isinstance(cmd.value, ObligationMove):
                require_that(
                    "move conserves the claim", in_sum == out_sum and in_sum > 0
                )
                for s in group.inputs:
                    require_that(
                        "move is signed by the beneficiary",
                        _signed_by(s.beneficiary, signers),
                    )
            elif isinstance(cmd.value, ObligationSettle):
                settled = cmd.value.amount
                require_that(
                    "settlement token matches the obligation",
                    settled.token == token,
                )
                require_that(
                    "settlement destroys obligation value",
                    in_sum - out_sum == settled.quantity
                    and settled.quantity > 0,
                )
                # the obligor settles unilaterally, so the residual must
                # be EXACTLY the input claim minus cash actually paid:
                # same beneficiary, same lifecycle — anything else would
                # let the obligor reassign or default the remainder
                # without the beneficiary's signature
                beneficiaries = {s.beneficiary for s in group.inputs}
                require_that(
                    "settle covers one beneficiary's obligations",
                    len(beneficiaries) == 1,
                )
                lifecycles = {s.lifecycle for s in group.inputs}
                require_that(
                    "settle covers one lifecycle's obligations",
                    len(lifecycles) == 1,
                )
                (beneficiary,) = beneficiaries
                (lifecycle,) = lifecycles
                for s in group.outputs:
                    require_that(
                        "residual keeps the input beneficiary",
                        s.beneficiary == beneficiary,
                    )
                    require_that(
                        "residual keeps the input lifecycle",
                        s.lifecycle == lifecycle,
                    )
                key = (beneficiary, token)
                settle_required[key] = (
                    settle_required.get(key, 0) + settled.quantity
                )
                require_that(
                    "settle is signed by the obligor",
                    _signed_by(obligor.owning_key, signers),
                )
            elif isinstance(cmd.value, ObligationSetLifecycle):
                require_that(
                    "lifecycle change conserves the claim",
                    in_sum == out_sum and len(group.inputs) == len(group.outputs),
                )
                target = cmd.value.lifecycle
                require_that(
                    "lifecycle is NORMAL or DEFAULTED",
                    target in (NORMAL, DEFAULTED),
                )
                for s_in, s_out in zip(
                    sorted(group.inputs, key=lambda s: ser.encode(s.amount)),
                    sorted(group.outputs, key=lambda s: ser.encode(s.amount)),
                ):
                    require_that(
                        "only the lifecycle changes",
                        s_out == ObligationState(
                            s_in.obligor,
                            s_in.beneficiary,
                            s_in.amount,
                            s_in.due_micros,
                            target,
                        ),
                    )
                if target == DEFAULTED:
                    tw = ltx.time_window
                    require_that(
                        "default needs a time window past the due date",
                        tw is not None
                        and tw.from_time is not None
                        and tw.from_time >= due,
                    )
                    for s in group.inputs:
                        require_that(
                            "default is declared by the beneficiary",
                            _signed_by(s.beneficiary, signers),
                        )
                else:
                    require_that(
                        "reset to NORMAL is agreed by the obligor",
                        _signed_by(obligor.owning_key, signers),
                    )
        for (beneficiary, token), required in settle_required.items():
            paid = sum(
                c.amount.quantity
                for c in ltx.outputs_of_type(CashState)
                if c.owner == beneficiary and c.amount.token == token
            )
            require_that(
                "beneficiary is paid the settled amount in cash",
                paid >= required,
            )

    @staticmethod
    def _verify_net(ltx: LedgerTransaction, signers) -> None:
        """Bilateral netting: opposing obligations in one token cancel;
        the residual claim survives (Obligation.kt Commands.Net)."""
        ins = ltx.inputs_of_type(ObligationState)
        outs = ltx.outputs_of_type(ObligationState)
        require_that("netting consumes obligations", len(ins) >= 2)
        # balances: (obligor key fp, beneficiary fp) net positions per token
        def key_of(k):
            return k.fingerprint() if hasattr(k, "fingerprint") else bytes(k)

        balance: dict = {}
        for s in ins:
            a = key_of(s.obligor.owning_key)
            b = key_of(s.beneficiary)
            balance[(s.amount.token, a, b)] = (
                balance.get((s.amount.token, a, b), 0) + s.amount.quantity
            )
            require_that(
                "netting is signed by every beneficiary",
                _signed_by(s.beneficiary, signers),
            )
            require_that(
                "netting is signed by every obligor",
                _signed_by(s.obligor.owning_key, signers),
            )
        # cancel opposing positions
        net: dict = {}
        for (token, a, b), qty in balance.items():
            opposite = balance.get((token, b, a), 0)
            net[(token, a, b)] = max(0, qty - opposite)
        out_positions: dict = {}
        for s in outs:
            a = key_of(s.obligor.owning_key)
            b = key_of(s.beneficiary)
            out_positions[(s.amount.token, a, b)] = (
                out_positions.get((s.amount.token, a, b), 0)
                + s.amount.quantity
            )
        require_that(
            "outputs equal the net positions",
            out_positions == {k: v for k, v in net.items() if v > 0},
        )


register_contract(OBLIGATION_CONTRACT, Obligation())


# -- builder helpers ---------------------------------------------------------


def generate_issue(
    builder: TransactionBuilder,
    obligor: Party,
    beneficiary: AnyKey,
    amount: Amount,
    due_micros: int,
) -> TransactionBuilder:
    builder.add_output_state(
        ObligationState(obligor, beneficiary, amount, due_micros),
        OBLIGATION_CONTRACT,
    )
    builder.add_command(ObligationIssue(), obligor.owning_key)
    return builder
