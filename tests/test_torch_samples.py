"""The demos (samples/) and the client plumbing (client/common.py) in the
port, held against the reference.

Each demo runs in both packages over CpuBatchVerifier (the port's
`batch_verifier=`; the reference's MockNetwork verifies on the CPU by
default) with the same seed: notary_demo's single, Raft, BFT and batching
flavours (3 transactions each), trader_demo's `run` and `run_via_rpc`,
bank_of_corda_demo and attachment_demo. Required equal: every
transaction id any node recorded (chip_smoke.recorded_networks), the
notary signer keys per transaction and the demo's result. `find_flow_class`
gives the reference's tags for the flows of every ported search package,
refuses a class that is not a flow, resolves the replacement flows
(flows/replacement.py) to the reference's tags, and skips the package
the port does not hold (samples/irs_demo.py).
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _run(prefix: str, demo: str, fn: str, *args, **kw):
    """(result, recorded transaction ids) of `prefix`'s samples.<demo>.<fn>
    over CpuBatchVerifier."""
    mod = importlib.import_module(f"{prefix}.samples.{demo}")
    if prefix == "corda_tpu_torch":
        from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

        kw["batch_verifier"] = CpuBatchVerifier()
    with cs.recorded_networks(importlib.import_module(f"{prefix}.testing.mock_network")) as rec:
        out = getattr(mod, fn)(*args, **kw)
    return out, rec.ids()


def _keys(signers) -> list:
    return [[(k.scheme_id, bytes(k.data)) for k in keys] for keys in signers]


@pytest.mark.parametrize("flavour, per_tx", [("single", 1), ("raft", 1), ("bft", 2),
                                             ("batching", 1)])
def test_notary_demo_equals_the_reference(flavour, per_tx):
    (ref, _), ref_ids = _run("corda_tpu", "notary_demo", "run", flavour, n_txs=3)
    (port, _), port_ids = _run("corda_tpu_torch", "notary_demo", "run", flavour, n_txs=3)
    assert len(port) == 3 and all(len(s) >= per_tx for s in port)
    assert _keys(port) == _keys(ref)
    assert port_ids == ref_ids and len(port_ids) >= 6


def test_trader_demo_equals_the_reference():
    (ref_paper, ref_cash), ref_ids = _run("corda_tpu", "trader_demo", "run")
    (paper, cash), ids = _run("corda_tpu_torch", "trader_demo", "run")
    assert (len(paper), cash) == (1, 92_000) == (len(ref_paper), ref_cash)
    assert [str(s.ref) for s in paper] == [str(s.ref) for s in ref_paper]
    assert ids == ref_ids


def test_trader_demo_via_rpc_equals_the_reference():
    ref, ref_ids = _run("corda_tpu", "trader_demo", "run_via_rpc", face=50_000, price=46_000)
    port, ids = _run("corda_tpu_torch", "trader_demo", "run_via_rpc", face=50_000, price=46_000)
    assert port == ref == {"buyer_paper": 1, "seller_cash": 46_000, "buyer_cash": 8_000}
    assert ids == ref_ids


def test_bank_of_corda_demo_equals_the_reference():
    ref, ref_ids = _run("corda_tpu", "bank_of_corda_demo", "run")
    port, ids = _run("corda_tpu_torch", "bank_of_corda_demo", "run")
    assert port == ref == ({"USD": 7_000, "GBP": 3_000}, True)
    assert ids == ref_ids


def test_attachment_demo_equals_the_reference():
    from corda_tpu_torch.core.contracts import contract_by_name
    from corda_tpu_torch.samples.attachment_demo import ATTACHMENT_CONTRACT, AttachmentDemoContract

    (ref_id, ref_data), ref_ids = _run("corda_tpu", "attachment_demo", "run")
    (att_id, data), ids = _run("corda_tpu_torch", "attachment_demo", "run")
    assert (str(att_id), data) == (str(ref_id), ref_data) and len(data) > 1000
    assert ids == ref_ids
    assert ATTACHMENT_CONTRACT == "corda_tpu.samples.AttachmentDemo"
    assert isinstance(contract_by_name(ATTACHMENT_CONTRACT), AttachmentDemoContract)


FLOWS = ("CashIssueFlow", "CashPaymentFlow", "CashExitFlow", "SellerFlow", "BuyerFlow",
         "IssuanceRequesterFlow", "FinalityFlow", "NotaryFlow", "ShareAttachmentFlow",
         "PingFlow", "NoOpFlow")


def test_find_flow_class_gives_the_reference_tags():
    from corda_tpu.client import common as ref
    from corda_tpu_torch.client import common as port
    from corda_tpu_torch.flows.api import class_from_tag

    assert port.FLOW_SEARCH_PACKAGES == ref.FLOW_SEARCH_PACKAGES
    for name in FLOWS:
        tag = port.find_flow_class(name)
        assert tag == ref.find_flow_class(name) and tag.startswith("corda_tpu.")
        assert class_from_tag(tag).__module__.startswith("corda_tpu_torch.")
    assert port.find_flow_class("corda_tpu.x.Y") == "corda_tpu.x.Y"
    for name in ("CashState", "NoSuchFlow"):
        with pytest.raises(port.FlowLookupError):
            port.find_flow_class(name)
        with pytest.raises(ref.FlowLookupError):
            ref.find_flow_class(name)
    # the replacement flows resolve to the reference's tags
    for name in ("NotaryChangeFlow", "ContractUpgradeFlow"):
        tag = f"corda_tpu.flows.replacement.{name}"
        assert port.find_flow_class(name) == ref.find_flow_class(name) == tag
        assert class_from_tag(tag).__module__ == "corda_tpu_torch.flows.replacement"


def test_wait_rpc_pumps_until_resolved():
    from corda_tpu_torch.client.common import wait_rpc

    class Fut:
        done, pumps = False, 0

        def get(self):
            return "answer"

    fut = Fut()

    def pump():
        fut.pumps += 1
        fut.done = fut.pumps == 3

    assert wait_rpc(fut, pump, 5.0) == "answer" and fut.pumps == 3
    with pytest.raises(TimeoutError):
        wait_rpc(Fut(), lambda: None, 0.05)
