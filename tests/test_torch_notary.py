"""The port's batching notary against the reference's, on one seeded
fixture (`corda_tpu_torch.testing.notary_fixture`: single-input Cash
spends with ok, flipped-signature, double-spend and wrong-notary
labels, ed25519 and p256 signers). The reference sees only the port's
serialized bytes of it.

The reference notary verifies on its CpuBatchVerifier; the port's on
`CudaBatchVerifier(device="cpu", batch_sizes=(16,))` (the device path
with the kernels' plain versions). Per transaction the answer kind must
be equal (and equal the label), notary signatures byte-equal (ed25519
notary key, same flush order, same Merkle root), conflicts equal, and
the committed uniqueness maps equal — on the streamed (`chunks()`) and
the join path. This file holds shards = 1 and the degraded mode;
test_torch_notary_shards.py holds shards = 4.
"""

from __future__ import annotations

from functools import lru_cache

import pytest

pytest.importorskip("torch")

import corda_tpu.core.serialization as rser  # noqa: E402
import corda_tpu.crypto.batch_verifier as rbv  # noqa: E402
import corda_tpu.crypto.schemes as rschemes  # noqa: E402
import corda_tpu.finance.cash  # noqa: E402,F401  (wire classes)
import corda_tpu.node.notary as rnot  # noqa: E402
import corda_tpu.node.services as rsvc  # noqa: E402
import corda_tpu_torch.core.serialization as pser  # noqa: E402
import corda_tpu_torch.crypto.batch_verifier as pbv  # noqa: E402
import corda_tpu_torch.node.notary as pnot  # noqa: E402
import torch  # noqa: E402
from corda_tpu_torch.crypto.cuda_ec import DeviceFaultError  # noqa: E402
from corda_tpu_torch.testing.notary_fixture import (  # noqa: E402
    answer_kind,
    build_fixture,
    notary_hub,
)

N_SPENDS = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of torch ops on 16-row tensors:
    one intra-op thread is faster there, and leaves the other test
    workers their cores."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@lru_cache(maxsize=None)
def fixture():
    return build_fixture(N_SPENDS, seed=5, outputs_per_issue=8, bad_every=8,
                         wrong_notary_every=16, owners_per_scheme=4, workers=1)


class JoinOnly(pbv.BatchSignatureVerifier):
    """The port's device path without verify_batch_async: the notary
    then joins the whole batch's result (the join path)."""

    def __init__(self, inner):
        self.inner = inner

    def verify_batch(self, requests):
        return self.inner.verify_batch(requests)


class StreamedCpu(rbv.BatchSignatureVerifier):
    """The reference's CPU verifier behind a streamed handle: the
    reference notary then takes its streaming tail."""

    def verify_batch(self, requests):
        return rbv.CpuBatchVerifier().verify_batch(requests)

    def verify_batch_async(self, requests):
        return rbv.PendingVerification(self.verify_batch(requests), [], streamed=True)


def port_device(streamed: bool):
    v = pbv.CudaBatchVerifier(batch_sizes=(16,), device="cpu")
    return v if streamed else JoinOnly(v)


def _reference_hub(fx, verifier):
    """The reference's notary hub, from the port fixture's bytes."""
    def dec(obj):
        return rser.decode(pser.encode(obj))

    kp = rschemes.keypair_from_private(fx.notary_key.private.scheme_id,
                                       fx.notary_key.private.data)
    parties = dec([fx.notary, fx.other_notary, fx.bank, fx.requester])
    hub = rsvc.ServiceHub(rsvc.NodeInfo("Notary", parties[0]),
                          rsvc.KeyManagementService(kp),
                          rsvc.IdentityService(*parties), batch_verifier=verifier)
    hub.record_transactions([dec(s) for s in fx.issues])
    return hub, [dec(s) for s in fx.spends], parties[3]


def _drive(svc, spends, requester) -> list:
    """Every spend through the notary's `process` generator (the service
    flow's entry) and one flush: an answer per spend."""
    started = []
    for stx in spends:
        gen = svc.process(stx, requester)
        try:
            started.append((gen, next(gen).future))
        except StopIteration as stop:
            started.append(stop.value)
    svc.flush()
    out = []
    for entry in started:
        if isinstance(entry, tuple):
            gen, fut = entry
            with pytest.raises(StopIteration) as stop:
                gen.send(fut.result())
            entry = stop.value.value
        out.append(entry)
    return out


def run_reference(verifier, shards: int, spends=None, **kw):
    fx = fixture()
    hub, r_spends, requester = _reference_hub(fx, verifier)
    uniq = (rnot.ShardedUniquenessProvider(shards) if shards > 1
            else rnot.InMemoryUniquenessProvider())
    svc = rnot.BatchingNotaryService(hub, uniq, max_batch=10**6, shards=shards,
                                     shard_queue_depth=10**6, **kw)
    chosen = r_spends if spends is None else [r_spends[i] for i in spends]
    return svc, _drive(svc, chosen, requester)


def run_port(verifier, shards: int, spends=None, **kw):
    fx = fixture()
    uniq = (pnot.ShardedUniquenessProvider(shards) if shards > 1
            else pnot.InMemoryUniquenessProvider())
    svc = pnot.BatchingNotaryService(notary_hub(fx, verifier), uniq, max_batch=10**6,
                                     shards=shards, shard_queue_depth=10**6, **kw)
    chosen = fx.spends if spends is None else [fx.spends[i] for i in spends]
    started = pnot.run_process([svc.process(s, fx.requester) for s in chosen])
    svc.flush()
    return svc, pnot.finish_process(started)


def assert_same_answers(r_svc, r_ans, p_svc, p_ans, labels):
    """Equal kinds (and equal to the labels), byte-equal notary
    signatures and proofs, equal conflicts, equal committed maps."""
    assert [answer_kind(a) for a in p_ans] == labels
    assert [answer_kind(a) for a in r_ans] == labels
    for r, p in zip(r_ans, p_ans):
        if answer_kind(p) == "ok":
            assert p.signature == r.signature
            assert p.by.data == r.by.data
            assert pser.encode(p.partial_merkle) == rser.encode(r.partial_merkle)
        elif answer_kind(p) == "conflict":
            assert {k: v.bytes_ for k, v in p.conflict.items()} == {
                k: v.bytes_ for k, v in r.conflict.items()}
    assert {pser.encode(k): v.bytes_ for k, v in p_svc.uniqueness.committed.items()} == {
        rser.encode(k): v.bytes_ for k, v in r_svc.uniqueness.committed.items()}


def check_against_reference(shards: int, streamed: bool):
    fx = fixture()
    r_svc, r_ans = run_reference(StreamedCpu() if streamed else rbv.CpuBatchVerifier(), shards)
    p_svc, p_ans = run_port(port_device(streamed), shards)
    assert_same_answers(r_svc, r_ans, p_svc, p_ans, fx.labels)
    # the first spend of each double-spend pair won, against the later one
    for i, label in enumerate(fx.labels):
        if label == "conflict":
            (ref, winner), = p_ans[i].conflict.items()
            assert winner == fx.spends[i - 1].id
            assert ref == str(fx.spends[i].wtx.inputs[0])
    ok = [a for a in p_ans if answer_kind(a) == "ok"]
    assert len(p_svc.uniqueness.committed) == len(ok)
    for stx, a in zip(fx.spends, p_ans):
        if answer_kind(a) == "ok":
            assert a.is_valid(stx.id)   # schemes.verify_one over its proof
    assert not p_svc.degraded and p_svc.metrics.counter("Notary.DegradedFlushes").count == 0
    return p_svc


def test_fixture_labels():
    fx = fixture()
    assert len(fx.spends) == N_SPENDS and set(fx.labels) == {
        "ok", "invalid-signature", "conflict", "wrong-notary"}
    signers = {(lab, s.sigs[0].by.scheme_id) for lab, s in zip(fx.labels, fx.spends)}
    assert ("invalid-signature", 3) in signers and ("invalid-signature", 4) in signers
    # spend i's signer holds a p256 key where i % 4 == 3, but a conflict
    # is signed by the owner of the input it shares with spend i - 1
    p256 = [s.sigs[0].by.scheme_id == 3 for s in fx.spends]
    owner = [i - (lab == "conflict") for i, lab in enumerate(fx.labels)]
    assert p256 == [j % 4 == 3 for j in owner]


@pytest.mark.parametrize("streamed", [True, False], ids=["streamed", "join"])
def test_notary_matches_reference_one_shard(streamed):
    svc = check_against_reference(1, streamed)
    assert svc.batches_dispatched == 1
    assert set(svc.phase_seconds or {}) <= {
        "stage", "dispatch", "resolve_verify", "link_wait", "validate", "commit",
        "stream_commit", "sign_scatter"}


SMALL = [0, 1, 3, 4]   # ed25519 and p256 signers, all "ok"


def test_degraded_mode_matches_reference():
    """Two verifier failures at the dispatch: the flush is served by the
    CPU reference (same answers), counted and flagged, as in the
    reference; the next flush's dispatch is the recovery probe. The
    port allows the fallback for a CPU-device verifier only."""
    fx = fixture()
    r_inj = rbv.DispatchFaultInjector(rbv.CpuBatchVerifier())
    p_inj = pbv.DispatchFaultInjector(port_device(streamed=True))
    r_inj.arm(2)
    p_inj.arm(2)
    r_svc, r_ans = run_reference(r_inj, 1)
    p_svc, p_ans = run_port(p_inj, 1, degraded_fallback=True)
    assert_same_answers(r_svc, r_ans, p_svc, p_ans, fx.labels)
    for svc in (r_svc, p_svc):
        assert svc.degraded
        assert svc.metrics.counter("Notary.DegradedFlushes").count == 1
        assert "DeviceFaultError" in svc.degraded_evidence["error"]
    # recovery: the next flush reaches the device and re-arms it
    p_svc.uniqueness = pnot.InMemoryUniquenessProvider()
    started = pnot.run_process([p_svc.process(fx.spends[i], fx.requester) for i in SMALL])
    p_svc.flush()
    assert [answer_kind(a) for a in pnot.finish_process(started)] == ["ok"] * len(SMALL)
    assert not p_svc.degraded
    assert "recovered_at_micros" in p_svc.degraded_evidence
    assert p_svc.metrics.counter("Notary.DegradedFlushes").count == 1


def test_one_device_failure_is_retried_on_the_device():
    r_inj = rbv.DispatchFaultInjector(rbv.CpuBatchVerifier())
    p_inj = pbv.DispatchFaultInjector(port_device(streamed=True))
    r_inj.arm(1)
    p_inj.arm(1)
    r_svc, r_ans = run_reference(r_inj, 1, spends=SMALL)
    p_svc, p_ans = run_port(p_inj, 1, spends=SMALL, degraded_fallback=True)
    assert_same_answers(r_svc, r_ans, p_svc, p_ans, ["ok"] * len(SMALL))
    assert not p_svc.degraded and not r_svc.degraded
    assert p_inj.faults_raised == r_inj.faults_raised == 1


def test_no_fallback_answers_verification_unavailable():
    """degraded_fallback=False (the port's default): the dispatch fault
    is re-raised to the flush, which answers every queued request
    `verification-unavailable` (the wrong-notary ones were answered at
    intake), as the reference."""
    fx = fixture()
    r_inj = rbv.DispatchFaultInjector(rbv.CpuBatchVerifier())
    p_inj = pbv.DispatchFaultInjector(port_device(streamed=True))
    r_inj.arm(1)
    p_inj.arm(1, exc_factory=lambda: DeviceFaultError("card lost"))
    _, r_ans = run_reference(r_inj, 1, degraded_fallback=False)
    p_svc, p_ans = run_port(p_inj, 1)
    want = ["wrong-notary" if lab == "wrong-notary" else "verification-unavailable"
            for lab in fx.labels]
    assert [answer_kind(a) for a in r_ans] == want
    assert [answer_kind(a) for a in p_ans] == want
    assert "card lost" in next(a.message for a in p_ans if a.kind != "wrong-notary")
    assert not p_svc.degraded and p_svc.uniqueness.committed == {}


def test_optional_planes_raise():
    """The QoS plane, the intent journal and per-shard verifiers are
    not ported: the notary takes no argument for them, so passing one
    is refused rather than ignored. A request's `deadline` is accepted,
    as the flows pass it, and ignored, as the reference ignores it
    without a QoS plane: the answer is the one without it."""
    fx = fixture()
    hub = notary_hub(fx, pbv.CpuBatchVerifier())
    for kw in ({"qos": object()}, {"intent_journal": object()},
               {"shard_verifiers": [pbv.CpuBatchVerifier()]}):
        with pytest.raises(TypeError):
            pnot.BatchingNotaryService(hub, **kw)
    answers = []
    for deadline in ({}, {"deadline": 1}):
        svc = pnot.BatchingNotaryService(hub)
        started = pnot.run_process([svc.process(fx.spends[0], fx.requester, **deadline)])
        svc.flush()
        answers.append(pnot.finish_process(started))
    assert answer_kind(answers[0][0]) == "ok" and answers[0] == answers[1]


class OnCard(pbv.BatchSignatureVerifier):
    """Stands for a verifier on the card (only its device is read)."""

    device = torch.device("cuda", 0)


@pytest.mark.parametrize("verifier", [OnCard(), pbv.DispatchFaultInjector(OnCard()), None],
                         ids=["on-card", "wrapped", "hub-default"])
def test_cpu_fallback_refused_with_a_card_verifier(verifier):
    """The degraded mode's CPU fallback would move a flush off the
    card: the notary refuses it at construction for a verifier on the
    card, wrapped or not, and for the hub's default (on the card)."""
    hub = notary_hub(fixture(), verifier)
    with pytest.raises(ValueError, match="on the card"):
        pnot.BatchingNotaryService(hub, degraded_fallback=True)
    assert not pnot.BatchingNotaryService(hub).degraded_fallback


def test_submit_and_tick():
    """submit() queues without the flow seam (no intake notary check);
    tick() flushes, or holds while a batching deadline runs."""
    fx = fixture()
    hub = notary_hub(fx, pbv.CpuBatchVerifier())
    svc = pnot.BatchingNotaryService(hub, max_wait_micros=10**12)
    futs = [svc.submit(fx.spends[i], fx.requester) for i in SMALL]
    assert svc.tick() == 0 and svc.backlog() == len(SMALL)   # held
    svc.max_wait_micros = 0
    assert svc.tick() == len(SMALL) and svc.backlog() == 0
    assert [answer_kind(f.result()) for f in futs] == ["ok"] * len(SMALL)


@lru_cache(maxsize=None)
def _rsa_key():
    from corda_tpu_torch.crypto import schemes

    return schemes.generate_keypair(schemes.RSA_SHA256)


def _with_extra_signature(spends, i, sig):
    out = list(spends)
    out[i] = out[i].with_additional_signature(sig)
    return out


@pytest.mark.parametrize("signed", [False, True], ids=["dummy-rsa", "real-rsa"])
@pytest.mark.parametrize("streamed", [True, False], ids=["streamed", "join"])
def test_rsa_row_is_verified_on_the_host_with_its_batchmates_in_one_dispatch(streamed, signed):
    """A spend carrying an added RSA signature: no kernel verifies RSA in
    either package, so the card's verifier checks the row on the host in
    the same dispatch as its batchmates' device rows. A dummy RSA row is
    answered `invalid-signature` and a real RSA signature over the id
    `ok` — the reference notary's answers on the same bytes, with
    byte-equal notary signatures and committed maps; one dispatch, no
    degraded flush."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.tx_signature import SignatureMetadata, TransactionSignature, sign_tx_id

    fx = fixture()
    spends = [fx.spends[i] for i in SMALL]
    if signed:
        sig = sign_tx_id(_rsa_key().private, spends[1].id)
    else:
        sig = TransactionSignature(b"\x01", schemes.PublicKey(schemes.RSA_SHA256, b"rsa"),
                                   SignatureMetadata(1, schemes.RSA_SHA256))
    spends = _with_extra_signature(spends, 1, sig)
    labels = ["ok", "ok" if signed else "invalid-signature", "ok", "ok"]
    svc = pnot.BatchingNotaryService(notary_hub(fx, port_device(streamed)))
    started = pnot.run_process([svc.process(s, fx.requester) for s in spends])
    svc.flush()
    answers = pnot.finish_process(started)
    hub, _, requester = _reference_hub(fx, StreamedCpu() if streamed else rbv.CpuBatchVerifier())
    r_svc = rnot.BatchingNotaryService(hub, rnot.InMemoryUniquenessProvider())
    r_answers = _drive(r_svc, [rser.decode(pser.encode(s)) for s in spends], requester)
    assert_same_answers(r_svc, r_answers, svc, answers, labels)
    assert svc.batches_dispatched == 1 and not svc.degraded and not svc.quarantined
    assert svc.metrics.counter("Notary.DegradedFlushes").count == 0
    assert (spends[1].wtx.inputs[0] in svc.uniqueness.committed) == signed


def test_row_of_a_scheme_no_path_verifies_is_answered_at_intake():
    """A signature row under a COMPOSITE key, which no path verifies in
    either package: the port answers that transaction `unsupported-scheme`
    at intake and signs its batchmates in one dispatch. The reference's
    verifier raises for the whole batch instead, and its degraded mode
    (on by default) quarantines the transaction as poison (ROADMAP
    Queue 3, D4)."""
    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.tx_signature import SignatureMetadata, TransactionSignature

    fx = fixture()
    comp = TransactionSignature(b"\x01", schemes.PublicKey(schemes.COMPOSITE_KEY, b"c"),
                                SignatureMetadata(1, schemes.COMPOSITE_KEY))
    spends = _with_extra_signature([fx.spends[i] for i in SMALL], 1, comp)
    svc = pnot.BatchingNotaryService(notary_hub(fx, port_device(True)))
    started = pnot.run_process([svc.process(s, fx.requester) for s in spends])
    svc.flush()
    answers = pnot.finish_process(started)
    assert [answer_kind(a) for a in answers] == ["ok", "unsupported-scheme", "ok", "ok"]
    assert "COMPOSITE" in answers[1].message
    assert svc.batches_dispatched == 1 and not svc.degraded and not svc.quarantined
    hub, _, requester = _reference_hub(fx, StreamedCpu())
    r_svc = rnot.BatchingNotaryService(hub, rnot.InMemoryUniquenessProvider())
    r_answers = _drive(r_svc, [rser.decode(pser.encode(s)) for s in spends], requester)
    assert [answer_kind(a) for a in r_answers] == ["ok", "poison-quarantined", "ok", "ok"]


class PoisonCpu(pbv.BatchSignatureVerifier):
    """A CPU reference that crashes on any batch holding `signature`:
    a deterministic poison row."""

    def __init__(self, signature: bytes):
        self.signature = signature

    def verify_batch(self, requests):
        if any(r.signature == self.signature for r in requests):
            raise RuntimeError("poison row")
        return pbv.CpuBatchVerifier().verify_batch(requests)


def test_poison_transaction_is_quarantined_in_degraded_mode():
    """Degraded mode on a CPU-device verifier: the device path fails
    twice, and the CPU reference crashes on one transaction's rows. The
    flush bisects, quarantines that transaction as poison and answers
    its batchmates."""
    fx = fixture()
    spends = [fx.spends[i] for i in SMALL]
    inj = pbv.DispatchFaultInjector(port_device(streamed=True))
    inj.arm(2)
    svc = pnot.BatchingNotaryService(notary_hub(fx, inj), degraded_fallback=True)
    svc._cpu_reference = PoisonCpu(spends[2].sigs[0].signature)
    started = pnot.run_process([svc.process(s, fx.requester) for s in spends])
    svc.flush()
    kinds = [answer_kind(a) for a in pnot.finish_process(started)]
    assert kinds == ["ok", "ok", "poison-quarantined", "ok"]
    assert svc.degraded and svc.quarantined == [spends[2].id]
    assert svc.metrics.counter("Notary.Quarantined").count == 1


def _answers_without_flush(svc, requests) -> list:
    """Drive per-request notaries (simple, validating): each process
    generator waits on an already-resolved commit future, whose value is
    sent (or whose exception is thrown) back in, as the flow state
    machine does."""
    out = []
    for args in requests:
        gen = svc.process(*args)
        try:
            fut = next(gen).future
        except StopIteration as stop:
            out.append(stop.value)
            continue
        with pytest.raises(StopIteration) as stop:
            try:
                value = fut.result()
            except Exception as e:   # noqa: BLE001 - handed to the flow
                gen.throw(e)
            else:
                gen.send(value)
        out.append(stop.value.value)
    return out


def test_simple_and_validating_notaries_match_reference():
    """The per-request flavours on the CPU reference verifiers: the
    validating notary checks signatures and contracts, the simple one a
    Merkle tear-off of inputs, notary and time window; both answer as
    the reference's, with byte-equal notary signatures."""
    from corda_tpu.core.contracts import StateRef as RStateRef
    from corda_tpu.core.identity import Party as RParty
    from corda_tpu_torch.core.contracts import StateRef
    from corda_tpu_torch.core.identity import Party

    fx = fixture()
    picks = [0, 2, 3, 6, 7, 15]   # ok, invalid, ok (p256), ok, conflict, wrong notary
    want = [fx.labels[i] for i in picks]
    r_hub, r_spends, r_req = _reference_hub(fx, rbv.CpuBatchVerifier())
    p_hub = notary_hub(fx, pbv.CpuBatchVerifier())
    r_val = rnot.ValidatingNotaryService(r_hub)
    p_val = pnot.ValidatingNotaryService(p_hub)
    r_ans = _answers_without_flush(r_val, [(r_spends[i], r_req) for i in picks])
    p_ans = _answers_without_flush(p_val, [(fx.spends[i], fx.requester) for i in picks])
    assert [answer_kind(a) for a in p_ans] == [answer_kind(a) for a in r_ans] == want
    for r, p in zip(r_ans, p_ans):
        if answer_kind(p) == "ok":
            assert p.signature == r.signature and p.partial_merkle is None

    def tear_off(stx, classes):
        return stx.wtx.build_filtered_transaction(lambda c: isinstance(c, classes))

    r_simple = rnot.SimpleNotaryService(r_hub)
    p_simple = pnot.SimpleNotaryService(p_hub)
    r_ans = _answers_without_flush(
        r_simple, [(tear_off(r_spends[i], (RStateRef, RParty)), r_req) for i in picks])
    p_ans = _answers_without_flush(
        p_simple, [(tear_off(fx.spends[i], (StateRef, Party)), fx.requester) for i in picks])
    # a non-validating notary sees no signatures: the flipped one commits
    kinds = [answer_kind(a) for a in p_ans]
    assert kinds == [answer_kind(a) for a in r_ans]
    assert kinds == ["ok", "ok", "ok", "ok", "conflict", "wrong-notary"]
    hidden = p_simple.process(tear_off(fx.spends[0], (Party,)), fx.requester)
    with pytest.raises(StopIteration) as stop:
        next(hidden)
    assert stop.value.value.kind == "incomplete-tearoff"


def test_tracer_records_each_request_with_the_flush_phases():
    """With an enabled tracer every notarisation is a root span, ended
    when answered, with the flush's phase intervals as child spans."""
    from corda_tpu_torch.utils import tracing

    fx = fixture()
    tracer = tracing.Tracer(enabled=True)
    saved = tracing.get_tracer()
    tracing.set_tracer(tracer)
    try:
        svc = pnot.BatchingNotaryService(notary_hub(fx, pbv.CpuBatchVerifier()))
        started = pnot.run_process([svc.process(fx.spends[i], fx.requester) for i in SMALL])
        svc.flush()
        assert [answer_kind(a) for a in pnot.finish_process(started)] == ["ok"] * len(SMALL)
    finally:
        tracing.set_tracer(saved)
    assert len(tracer.completed) == len(SMALL)
    for spans in tracer.completed:
        root = spans[0]
        assert root.name == "notarise.request" and root.parent_id is None
        # the join path's phases (the CPU verifier has no streamed handle)
        assert [s.name for s in spans[1:]] == [
            "notary.stage", "notary.dispatch", "notary.resolve_verify", "notary.link_wait",
            "notary.validate", "notary.commit", "notary.sign_scatter"]
        assert all(s.parent_id == root.span_id and s.attributes["batch"] == len(SMALL)
                   for s in spans[1:])
    assert tracing.get_tracer() is saved


class _PerTxProvider(pnot.InMemoryUniquenessProvider):
    """A provider whose commits resolve per transaction (as a
    distributed one's do): the batching notary commits through
    commit_async futures and joins the verify result."""

    batch_synchronous = False


def test_per_transaction_commit_path_matches_labels():
    fx = fixture()
    svc = pnot.BatchingNotaryService(notary_hub(fx, pbv.CpuBatchVerifier()), _PerTxProvider())
    started = pnot.run_process([svc.process(s, fx.requester) for s in fx.spends])
    svc.flush()
    answers = pnot.finish_process(started)
    assert [answer_kind(a) for a in answers] == fx.labels
    assert svc.requests_batched == sum(lab != "wrong-notary" for lab in fx.labels)
    with pytest.raises(ValueError, match="batch_synchronous"):
        pnot.BatchingNotaryService(notary_hub(fx, pbv.CpuBatchVerifier()), _PerTxProvider(),
                                   shards=2)


def test_time_window_checker_matches_reference():
    from corda_tpu.core.contracts import TimeWindow as RTW
    from corda_tpu_torch.core.contracts import TimeWindow as PTW
    from corda_tpu_torch.node.services import TestClock

    now, tol = 1_700_000_000_000_000, 30_000_000
    r = rnot.TimeWindowChecker(rsvc.TestClock(now), tol)
    p = pnot.TimeWindowChecker(TestClock(now), tol)
    for lo, hi in [(None, now), (None, now + tol), (None, now + tol + 1), (now + tol, None),
                   (now + tol + 1, None), (now - 10**9, now - tol), (now, now + 1)]:
        assert p.is_valid(PTW(lo, hi)) == r.is_valid(RTW(lo, hi)), (lo, hi)
    assert p.is_valid(None) and r.is_valid(None)
