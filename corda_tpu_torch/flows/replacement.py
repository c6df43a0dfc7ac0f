"""State replacement flows: notary change + contract upgrade.

Port of corda_tpu/flows/replacement.py, over the port's
core/replacement.py. Its flows' tags are the reference's
(`corda_tpu.flows.replacement.NotaryChangeFlow`).

Reference: `AbstractStateReplacementFlow` (propose/verify/sign across
every participant, 213 LoC), `NotaryChangeFlow`, `ContractUpgradeFlow`.
The TRANSACTION rules (and the special verification dispatch that runs
them instead of state contracts) live in `corda_tpu_torch.core.replacement`
so every verifying process — including out-of-process workers that
never import the flows layer — applies them identically; this module
holds only the multi-party protocol.
"""

from __future__ import annotations

from ..core.contracts import StateAndRef
from ..core.identity import Party
from ..core.replacement import (
    ContractUpgradeCommand,
    NotaryChangeCommand,
    register_upgrade,
    registered_upgrade,
)
from ..core.transactions import TransactionBuilder
from .api import FlowException, FlowLogic, initiating_flow
from .core_flows import CollectSignaturesFlow, FinalityFlow

__all__ = [
    "AbstractStateReplacementFlow",
    "ContractUpgradeCommand",
    "ContractUpgradeFlow",
    "NotaryChangeCommand",
    "NotaryChangeFlow",
    "register_upgrade",
    "registered_upgrade",
]


def _participant_keys(state_data) -> set:
    keys = set()
    for p in state_data.participants:
        keys.add(getattr(p, "owning_key", p))
    return keys


class AbstractStateReplacementFlow(FlowLogic):
    """Shared propose/sign/notarise skeleton (AbstractStateReplacement-
    Flow.kt): build the replacement tx, collect every participant's
    signature, notarise with the OLD notary, broadcast."""

    def __init__(self, state_and_ref: StateAndRef):
        self.state_and_ref = state_and_ref

    def _build(self) -> TransactionBuilder:   # subclass hook
        raise NotImplementedError

    def call(self):
        builder = self._build()
        stx = self.services.sign_initial_transaction(builder)
        stx = yield from self.sub_flow(CollectSignaturesFlow(stx))
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


@initiating_flow
class NotaryChangeFlow(AbstractStateReplacementFlow):
    """Move one state to a new notary (NotaryChangeFlow.kt)."""

    def __init__(self, state_and_ref: StateAndRef, new_notary: Party):
        super().__init__(state_and_ref)
        self.new_notary = new_notary

    def _build(self) -> TransactionBuilder:
        sar = self.state_and_ref
        if sar.state.notary == self.new_notary:
            raise FlowException("state already uses that notary")
        builder = TransactionBuilder()
        builder.add_input_state(sar)
        builder.add_output_state(
            sar.state.data, sar.state.contract, notary=self.new_notary
        )
        builder.add_command(
            NotaryChangeCommand(self.new_notary),
            *sorted(
                _participant_keys(sar.state.data),
                key=lambda k: k.fingerprint(),
            ),
        )
        return builder


@initiating_flow
class ContractUpgradeFlow(AbstractStateReplacementFlow):
    """Upgrade one state to a new contract (ContractUpgradeFlow.kt).
    The upgrade path must be register_upgrade()d in every process that
    will verify the transaction."""

    def __init__(self, state_and_ref: StateAndRef, new_contract: str):
        super().__init__(state_and_ref)
        self.new_contract = new_contract

    def _build(self) -> TransactionBuilder:
        sar = self.state_and_ref
        old_contract = sar.state.contract
        convert = registered_upgrade(old_contract, self.new_contract)
        if convert is None:
            raise FlowException(
                f"upgrade {old_contract} -> {self.new_contract} is not "
                f"authorised on this node"
            )
        builder = TransactionBuilder()
        builder.add_input_state(sar)
        builder.add_output_state(
            convert(sar.state.data), self.new_contract
        )
        builder.add_command(
            ContractUpgradeCommand(old_contract, self.new_contract),
            *sorted(
                _participant_keys(sar.state.data),
                key=lambda k: k.fingerprint(),
            ),
        )
        return builder
