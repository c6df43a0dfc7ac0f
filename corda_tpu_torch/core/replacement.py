"""Replacement-transaction rules: notary change + contract upgrade.

Port of corda_tpu/core/replacement.py; an upgrade's conversion shipped
only as an attachment (the reference's core/sandbox.py) is not ported:
such an upgrade is not authorised here. Reference:
`NotaryChangeWireTransaction`/`NotaryChangeLedgerTransaction`
(core/.../transactions/NotaryChangeTransactions.kt) and the
contract-upgrade ledger rules behind `ContractUpgradeFlow` — special transaction
types verified WITHOUT running state contracts (a notary change must
not be constrained by business rules, and contracts cannot anticipate
their own replacement).

This lives in CORE (not the flows layer) because every verifier — the
in-process service, the notary, and the OUT-OF-PROCESS worker pool —
must apply the same rules: LedgerTransaction.verify dispatches here,
so any process that can decode a LedgerTransaction also verifies
replacements correctly. Upgrade authorisation is process-local
by design (`register_upgrade` in a cordapp module, which workers import
like any contract module — the reference's per-node Authorise step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import serialization as ser
from .contracts import require_that
from .identity import Party


@ser.serializable
@dataclass(frozen=True)
class NotaryChangeCommand:
    new_notary: Party


@ser.serializable
@dataclass(frozen=True)
class ContractUpgradeCommand:
    old_contract: str
    new_contract: str


# -- the upgrade registry (authorizeUpgrade's role) --------------------------

_UPGRADES: dict[tuple[str, str], Callable] = {}


def register_upgrade(
    old_contract: str, new_contract: str, convert: Callable
) -> None:
    """Authorise an upgrade path in THIS process: states under
    `old_contract` may be replaced by `convert(old_data)` under
    `new_contract`. Every verifying process (nodes AND verifier
    workers) must have registered the same path or the upgrade
    transaction fails verification — the reference's per-node
    `ContractUpgradeFlow.Authorise` discipline. Put the
    register_upgrade call in the cordapp module next to the contracts
    so it loads wherever they do."""
    _UPGRADES[(old_contract, new_contract)] = convert


def registered_upgrade(old_contract: str, new_contract: str):
    return _UPGRADES.get((old_contract, new_contract))


# -- verification (runs INSTEAD of contracts) --------------------------------


def _signed_by_participants(state_data, signers: set) -> None:
    from ..crypto.composite import is_fulfilled_by

    for p in state_data.participants:
        key = getattr(p, "owning_key", p)
        require_that(
            "every participant signed the replacement (composite keys "
            "to their threshold)",
            is_fulfilled_by(key, signers),
        )


def _verify_notary_change(ltx, cmd) -> None:
    """NotaryChangeLedgerTransaction.verify: outputs are identical
    states re-pointed at the new notary; every participant signed."""
    new_notary = cmd.value.new_notary
    require_that(
        "notary change moves at least one state", len(ltx.inputs) >= 1
    )
    require_that(
        "inputs and outputs pair up", len(ltx.inputs) == len(ltx.outputs)
    )
    signers = set(cmd.signers)
    for sar, out in zip(ltx.inputs, ltx.outputs):
        require_that(
            "state data is unchanged", out.data == sar.state.data
        )
        require_that(
            "contract is unchanged", out.contract == sar.state.contract
        )
        require_that(
            "output notary is the new notary", out.notary == new_notary
        )
        require_that(
            "old and new notary differ", sar.state.notary != new_notary
        )
        # the OLD notary must notarise the change — it is the one whose
        # uniqueness map consumes the input. A tx notarised by the new
        # notary would leave the input spendable at the old one: a
        # cross-notary double spend.
        require_that(
            "the transaction is notarised by the inputs' current notary",
            ltx.notary == sar.state.notary,
        )
        _signed_by_participants(sar.state.data, signers)


def _verify_contract_upgrade(ltx, cmd) -> None:
    """Outputs are the registered conversion of the inputs, under the
    new contract, authorised in THIS process and signed by every
    participant."""
    from .transactions import TransactionVerificationError

    old_c, new_c = cmd.value.old_contract, cmd.value.new_contract
    convert = registered_upgrade(old_c, new_c)
    if convert is None:
        raise TransactionVerificationError(
            f"upgrade {old_c} -> {new_c} is not authorised on this node"
        )
    require_that("upgrade moves at least one state", len(ltx.inputs) >= 1)
    require_that(
        "inputs and outputs pair up", len(ltx.inputs) == len(ltx.outputs)
    )
    signers = set(cmd.signers)
    for sar, out in zip(ltx.inputs, ltx.outputs):
        require_that(
            "input runs the old contract", sar.state.contract == old_c
        )
        require_that("output runs the new contract", out.contract == new_c)
        require_that(
            "output is the registered conversion of the input",
            out.data == convert(sar.state.data),
        )
        require_that("notary is unchanged", out.notary == sar.state.notary)
        require_that(
            "the transaction is notarised by the inputs' notary",
            ltx.notary == sar.state.notary,
        )
        _signed_by_participants(sar.state.data, signers)


_REPLACEMENT_COMMANDS = (NotaryChangeCommand, ContractUpgradeCommand)


def has_replacement_command(commands) -> bool:
    """True when any command value is a replacement command. Works on
    wire Commands and resolved CommandWithParties alike (both expose
    .value) — the notary's object-less fast sweep uses this to route
    replacement transactions to the full LedgerTransaction path
    without resolving first."""
    for c in commands:
        if isinstance(c.value, _REPLACEMENT_COMMANDS):
            return True
    return False


def replacement_verifier(ltx):
    """Dispatch hook (installed by core/__init__): a tx carrying exactly
    one replacement command is verified by the replacement rules;
    mixing replacement commands with anything else is rejected.

    The no-replacement early-out is the notary flush hot path (every
    ordinary transaction passes through here once per contract verify):
    no list is built and nothing is imported unless a replacement
    command is actually present."""
    for c in ltx.commands:
        if isinstance(c.value, _REPLACEMENT_COMMANDS):
            break
    else:
        return None   # ordinary transaction: run contracts
    from .transactions import TransactionVerificationError

    special = [
        c
        for c in ltx.commands
        if isinstance(c.value, _REPLACEMENT_COMMANDS)
    ]
    if len(special) != 1 or len(ltx.commands) != 1:
        raise TransactionVerificationError(
            "a replacement transaction carries exactly one command"
        )
    cmd = special[0]
    if isinstance(cmd.value, NotaryChangeCommand):
        return lambda: _verify_notary_change(ltx, cmd)
    return lambda: _verify_contract_upgrade(ltx, cmd)
