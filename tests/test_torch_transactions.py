"""Transactions, Cash and the grouped contract sweep of the port against
the reference, on the same seeded keys:

* a TransactionBuilder run on both sides gives equal transaction ids and
  equal ed25519 signature bytes (ed25519 signing is deterministic);
* p256 rows get equal verdicts (the reference signs with OpenSSL's
  random nonce, so p256 signatures are compared by verdict), on the
  port's CPU reference and through CudaBatchVerifier's device path on
  the CPU (the kernels' plain versions);
* `convert` turns the reference's serialized bytes into port objects
  with equal ids;
* the grouped contract sweep (`ServiceHub.resolve_verify_batch`, the
  object-less asset sweep) and the per-transaction clause stack decide
  valid, unbalanced and unsigned Cash transactions alike, with the
  reference's messages.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

import corda_tpu.core.serialization as rser  # noqa: E402
import corda_tpu.crypto.batch_verifier as rbv  # noqa: E402
import corda_tpu.node.services as rsvc  # noqa: E402
import corda_tpu_torch.core.serialization as pser  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.node.services as psvc  # noqa: E402
from corda_tpu_torch import convert  # noqa: E402

from test_torch_notary import one_torch_thread  # noqa: E402,F401  (autouse)
from test_torch_serialization import PORT, REF  # noqa: E402


def _ledger(ns, svc, p256_spender: bool):
    """An issue of three Cash states and, over them, a valid move, an
    unbalanced one, one the owner did not sign, a valid exit and an
    exit the issuer did not sign: (hub with the issue recorded, issue,
    [spends])."""
    ed = ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=21)
    owner = ns.generate_keypair(
        ns.ECDSA_SECP256R1_SHA256 if p256_spender else ns.EDDSA_ED25519_SHA512, seed=22)
    notary_kp = ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=23)
    bank = ns.Party("Bank", ed.public)
    notary = ns.Party("Notary", notary_kp.public)
    token = ns.Issued(ns.PartyAndReference(bank, b"\x01"), "USD")

    ib = ns.TransactionBuilder(notary)
    for q in (100, 50, 25):
        ib.add_output_state(ns.CashState(ns.Amount(q, token), owner.public), ns.CASH_CONTRACT)
    ib.add_command(ns.CashIssue(3), bank.owning_key)
    issue = ib.sign_initial_transaction(ed.private)

    def spend(idx, outs, signers, cmd=None):
        b = ns.TransactionBuilder()
        for i in idx:
            b.add_input_state(ns.StateAndRef(issue.wtx.outputs[i], ns.StateRef(issue.id, i)))
        for q, key in outs:
            b.add_output_state(ns.CashState(ns.Amount(q, token), key), ns.CASH_CONTRACT)
        b.add_command(cmd if cmd is not None else ns.CashMove(), *[k.public for k in signers])
        return b.sign_initial_transaction(*[k.private for k in signers])

    spends = [
        spend([0], [(60, ed.public), (40, owner.public)], [owner]),      # valid
        spend([0, 1], [(149, ed.public)], [owner]),                      # unbalanced
        spend([1], [(50, ed.public)], [ed]),                             # owner did not sign
        spend([2], [(5, owner.public)], [owner, ed],
              ns.CashExit(ns.Amount(20, token))),                        # exit of 20
        spend([2], [(5, owner.public)], [owner],
              ns.CashExit(ns.Amount(20, token))),                        # exit, issuer missing
    ]
    hub = svc.ServiceHub(
        svc.NodeInfo("Notary", notary), svc.KeyManagementService(notary_kp),
        svc.IdentityService(bank, notary), batch_verifier=None,
    )
    hub.record_transactions([issue])
    return hub, issue, spends


@pytest.mark.parametrize("p256_spender", [False, True])
def test_builder_gives_equal_ids_and_ed25519_signatures(p256_spender):
    _, r_issue, r_spends = _ledger(REF, rsvc, p256_spender)
    _, p_issue, p_spends = _ledger(PORT, psvc, p256_spender)
    for r, p in zip([r_issue] + r_spends, [p_issue] + p_spends):
        assert p.id.bytes_ == r.id.bytes_
        assert pser.encode(p.wtx) == rser.encode(r.wtx)
        for rs, ps in zip(r.sigs, p.sigs):
            assert ps.by.data == rs.by.data
            if ps.by.scheme_id == PORT.EDDSA_ED25519_SHA512:
                assert ps.signature == rs.signature


def test_signature_verdicts_equal_on_both_sides():
    """Every signature of both sides' transactions, one tampered copy of
    each: the port's CPU reference, its device path (plain versions) and
    the reference's CPU reference agree row by row."""
    rows = []
    for ns, svc in ((REF, rsvc), (PORT, psvc)):
        for p256 in (False, True):
            _, issue, spends = _ledger(ns, svc, p256)
            for stx in [issue] + spends:
                for req in stx.signature_requests():
                    for tamper in (False, True):
                        sig = req.signature[:-1] + bytes([req.signature[-1] ^ tamper])
                        rows.append((req.key.scheme_id, req.key.data, sig, req.message))
    r_reqs = [rbv.VerificationRequest(REF.PublicKey(s, k), sig, m) for s, k, sig, m in rows]
    p_reqs = [pbv.VerificationRequest(PORT.PublicKey(s, k), sig, m) for s, k, sig, m in rows]
    want = rbv.CpuBatchVerifier().verify_batch(r_reqs)
    assert want == [i % 2 == 0 for i in range(len(rows))]
    assert pbv.CpuBatchVerifier().verify_batch(p_reqs) == want
    device = pbv.CudaBatchVerifier(batch_sizes=(32,), device="cpu")
    assert device.verify_batch(p_reqs) == want


def test_convert_reference_bytes_to_port_objects():
    _, issue, spends = _ledger(REF, rsvc, True)
    for r in [issue] + spends:
        data = rser.encode(r)
        p = convert.signed_transaction_from_reference(data)
        assert isinstance(p, PORT.SignedTransaction)
        assert p.id.bytes_ == r.id.bytes_
        assert pser.encode(p) == data
        assert [q.message for q in p.signature_requests()] == [
            q.message for q in r.signature_requests()]
    with pytest.raises(pser.SerializationError):
        convert.signed_transaction_from_reference(rser.encode(issue.wtx))


def _errors(hub, spends, batched: bool) -> list:
    """One outcome per spend: None or (exception class name, message)."""
    if batched:
        errs, deferred = hub.resolve_verify_batch(spends)
        assert deferred == {}
    else:
        errs = []
        for stx in spends:
            try:
                hub.resolve_transaction(stx.wtx).verify()
                errs.append(None)
            except Exception as e:   # noqa: BLE001 - the outcome under test
                errs.append(e)
    return [None if e is None else (type(e).__name__, str(e)) for e in errs]


def test_grouped_sweep_matches_per_transaction_path_and_reference():
    r_hub, _, r_spends = _ledger(REF, rsvc, True)
    p_hub, _, p_spends = _ledger(PORT, psvc, True)
    want = _errors(r_hub, r_spends, batched=True)
    assert want == _errors(r_hub, r_spends, batched=False)
    assert want[0] is None and want[3] is None
    assert [w[0] for w in want if w] == ["ContractViolation"] * 3
    assert _errors(p_hub, p_spends, batched=True) == want
    assert _errors(p_hub, p_spends, batched=False) == want
    # the grouped LedgerTransaction sweep (the path transactions with
    # attachments or replacement commands take) decides alike
    from corda_tpu_torch.core.batch_verify import verify_ledger_batch

    ltxs = [p_hub.resolve_transaction(s.wtx) for s in p_spends]
    got = [None if e is None else (type(e).__name__, str(e)) for e in verify_ledger_batch(ltxs)]
    assert got == want


def test_signature_checks_default_to_the_card():
    """SignedTransaction's checks go to default_verifier(), a
    CudaBatchVerifier on the card: here a CPU verifier must be passed
    (or set as the default)."""
    _, issue, _ = _ledger(PORT, psvc, False)
    issue.check_signatures_are_valid(pbv.CpuBatchVerifier())
    saved = pbv._default
    try:
        pbv.set_default_verifier(None)
        import torch

        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                issue.check_signatures_are_valid()
        pbv.set_default_verifier(pbv.CpuBatchVerifier())
        issue.check_signatures_are_valid()
    finally:
        pbv.set_default_verifier(saved)


def _attachment_spend(ns, svc, sandbox, split, attach: bool):
    """A Cash spend whose outputs run under an attachment-only contract
    (notary_fixture.MAGIC_SOURCE: no output above 50), with the
    attachment recorded on the hub and listed on the transaction, or
    neither: (hub, spend)."""
    from corda_tpu_torch.testing.notary_fixture import MAGIC_CONTRACT, MAGIC_SOURCE

    hub, issue, _ = _ledger(ns, svc, False)
    owner = ns.generate_keypair(ns.EDDSA_ED25519_SHA512, seed=22)
    att = sandbox.make_contract_attachment(MAGIC_CONTRACT, "MagicContract", MAGIC_SOURCE)
    b = ns.TransactionBuilder()
    b.add_input_state(ns.StateAndRef(issue.wtx.outputs[0], ns.StateRef(issue.id, 0)))
    token = issue.wtx.outputs[0].data.amount.token
    for q in split:
        b.add_output_state(ns.CashState(ns.Amount(q, token), owner.public), MAGIC_CONTRACT)
    b.add_command(ns.CashMove(), owner.public)
    if attach:
        hub.attachments.import_attachment(att.data)
        b.add_attachment(att.id)
    return hub, b.sign_initial_transaction(owner.private)


@pytest.mark.parametrize("split, attach", [((50, 50), True), ((60, 40), True), ((50, 50), False)],
                         ids=["satisfied", "broken", "no-attachment"])
def test_attachment_contract_verifies_or_fails_with_the_reference_message(split, attach):
    """A contract no process registered, carried only by the
    transaction's attachment: the port loads it into its sandbox and the
    transaction verifies, or fails with the reference's exception class
    and message (the contract's own violation; an unknown contract when
    no attachment carries it). The grouped sweep defers such a
    transaction until its signatures are known, on both sides; the same
    attachment bytes give the same transaction id."""
    import corda_tpu.core.sandbox as rsandbox
    import corda_tpu_torch.core.sandbox as psandbox

    outcomes, ids = [], []
    for ns, svc, sandbox in ((REF, rsvc, rsandbox), (PORT, psvc, psandbox)):
        hub, stx = _attachment_spend(ns, svc, sandbox, split, attach)
        ids.append(stx.id.bytes_)
        errs, deferred = hub.resolve_verify_batch([stx])
        assert errs == [None] and list(deferred) == [0]
        got = []
        for ltx in (deferred[0], hub.resolve_transaction(stx.wtx)):
            try:
                ltx.verify()
                got.append(None)
            except Exception as e:   # noqa: BLE001 - the outcome under test
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1]
        outcomes.append(got[0])
    assert ids[0] == ids[1]
    assert outcomes[0] == outcomes[1]
    if split == (50, 50) and attach:
        assert outcomes[1] is None
    elif attach:
        assert outcomes[1] == ("ContractViolation", "magic output exceeds its cap of 50")
    else:
        assert outcomes[1][0] == "ContractViolation" and "no attachment carries it" in outcomes[1][1]
