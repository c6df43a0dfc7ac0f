"""attachment-demo: a transaction referencing an attachment blob.

Reference: samples/attachment-demo/ — the sender uploads a jar to its
attachment store, builds a transaction referencing it by hash, and the
recipient (who has never seen the blob) fetches it during resolution
(FetchAttachmentsFlow) and checks the content hash.

Port of corda_tpu/samples/attachment_demo.py. The contract registers
under the reference's wire name, so a transaction of either package
names the same contract. `run` takes `batch_verifier=`: the port's
MockNetwork verifies on the card by default, where the reference's
verifies on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core import serialization as ser
from ..core.contracts import register_contract
from ..core.identity import Party
from ..core.transactions import TransactionBuilder
from ..crypto.hashes import SecureHash
from ..flows.api import FlowLogic, initiating_flow
from ..flows.core_flows import FinalityFlow

ATTACHMENT_CONTRACT = "corda_tpu.samples.AttachmentDemo"


@ser.serializable
@dataclass(frozen=True)
class AttachmentDemoState:
    """Records that `att_id` was shared with the participants."""

    sender: Party
    recipient: Party
    att_id: SecureHash

    @property
    def participants(self):
        return (self.sender, self.recipient)


@ser.serializable
@dataclass(frozen=True)
class ShareAttachment:
    pass


class AttachmentDemoContract:
    def verify(self, ltx) -> None:
        from ..core.contracts import require_that

        outs = ltx.outputs_of_type(AttachmentDemoState)
        require_that("one demo state output", len(outs) == 1)
        require_that(
            "the referenced attachment rides the transaction",
            any(a.id == outs[0].att_id for a in ltx.attachments),
        )


register_contract(ATTACHMENT_CONTRACT, AttachmentDemoContract())


@initiating_flow
class ShareAttachmentFlow(FlowLogic):
    def __init__(self, recipient: Party, att_id: SecureHash, notary: Party):
        self.recipient = recipient
        self.att_id = att_id
        self.notary = notary

    def call(self):
        builder = TransactionBuilder(self.notary)
        builder.add_output_state(
            AttachmentDemoState(self.our_identity, self.recipient, self.att_id),
            ATTACHMENT_CONTRACT,
        )
        builder.add_command(ShareAttachment(), self.our_identity.owning_key)
        builder.add_attachment(self.att_id)
        stx = self.services.sign_initial_transaction(builder)
        result = yield from self.sub_flow(FinalityFlow(stx))
        return result


def run(seed: int = 42, payload: bytes = b"PK\x03\x04 demo jar bytes " * 100,
        batch_verifier=None):
    """Sender uploads + shares; recipient ends up with the blob it
    never had. Returns (att_id, recipient_blob).
    `batch_verifier`: the MockNetwork's verifier; None verifies on the
    card (`CudaBatchVerifier()`), `CpuBatchVerifier()` runs without one."""
    from ..testing.mock_network import MockNetwork

    net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
    notary = net.create_notary("Notary")
    sender = net.create_node("Sender")
    recipient = net.create_node("Recipient")

    att_id = sender.services.attachments.import_attachment(payload)
    assert att_id not in recipient.services.attachments

    fsm = sender.start_flow(
        ShareAttachmentFlow(recipient.party, att_id, notary.party)
    )
    net.run()
    fsm.result_or_throw()

    att = recipient.services.attachments.open_attachment(att_id)
    assert att is not None, "recipient did not fetch the attachment"
    assert SecureHash.sha256(att.data) == att_id
    return att_id, att.data


def main():
    att_id, data = run()
    print(f"attachment {att_id} delivered: {len(data)} bytes")


if __name__ == "__main__":
    main()
