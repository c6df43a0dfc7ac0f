"""The port's pipelined wire ingest (node/ingest.py), its ring seam in the
fabric, the notary's ring drain and the verifier worker's ingest path,
held against the reference.

The fixture is `corda_tpu_torch.testing.notary_fixture` at 16 spends
(ok, flipped-signature, double-spend and wrong-notary labels, ed25519
and p256 signers); the reference sees only the port's bytes of it. The
port's IngestPipeline must give the reference's ids, staged requests
and verdicts slot by slot, for a malformed and a re-seen frame too,
cold and cache-warm; shedding, the ring seam and the worker's drain
must answer as the reference's do.
"""

from __future__ import annotations

import importlib
import threading
import time
from functools import lru_cache
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from corda_tpu_torch.testing.notary_fixture import (  # noqa: E402
    answer_kind,
    build_fixture,
    notary_hub,
)

PACKAGES = ("corda_tpu", "corda_tpu_torch")


def _package(prefix: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    return SimpleNamespace(
        prefix=prefix, ser=m("core.serialization"), bv=m("crypto.batch_verifier"),
        ingest=m("node.ingest"), msg=m("node.messaging"), ver=m("node.verifier"),
        notary=m("node.notary"), qos=m("node.qos"), cash=m("finance.cash"),
        services=m("node.services"), schemes=m("crypto.schemes"),
    )


@lru_cache(maxsize=None)
def fixture():
    return build_fixture(16, seed=5, outputs_per_issue=8, bad_every=8,
                         wrong_notary_every=16, owners_per_scheme=4, workers=1)


@lru_cache(maxsize=None)
def blobs() -> tuple:
    """The spends' wire bytes, a truncated frame mid-batch, and a re-seen
    frame at the end."""
    T = _package("corda_tpu_torch")
    good = [T.ser.encode(s) for s in fixture().spends]
    return tuple(good[:5] + [good[5][:-5]] + good[5:] + [good[0]])


def _hub(P, verifier):
    """The notary hub of the fixture in package P (the reference's from
    the port's bytes)."""
    fx = fixture()
    if P.prefix == "corda_tpu_torch":
        return notary_hub(fx, verifier), list(fx.spends), fx.requester
    T = _package("corda_tpu_torch")

    def dec(obj):
        return P.ser.decode(T.ser.encode(obj))

    kp = P.schemes.keypair_from_private(fx.notary_key.private.scheme_id,
                                        fx.notary_key.private.data)
    parties = dec([fx.notary, fx.other_notary, fx.bank, fx.requester])
    hub = P.services.ServiceHub(P.services.NodeInfo("Notary", parties[0]),
                                P.services.KeyManagementService(kp),
                                P.services.IdentityService(*parties), batch_verifier=verifier)
    hub.record_transactions([dec(s) for s in fx.issues])
    return hub, [dec(s) for s in fx.spends], parties[3]


def _slots(P, entries) -> list:
    """Per slot: the error class, or the id, the staged requests and
    their CPU verdicts."""
    out = []
    for e in entries:
        if e.error is not None:
            out.append(("error", type(e.error).__name__, e.stx is None))
            continue
        reqs = [(r.key.scheme_id, r.key.data.hex(), r.signature.hex(), r.message.hex())
                for r in e.requests]
        out.append(("ok", str(e.tx_id), reqs, P.bv.CpuBatchVerifier().verify_batch(e.requests)))
    return out


def _ingest_twice(prefix: str):
    P = _package(prefix)
    pipe = P.ingest.IngestPipeline(shards=2)
    passes = [_slots(P, pipe.ingest(list(blobs()))) for _ in ("cold", "cache-warm")]
    hits = pipe.frame_hits
    pipe.close()
    return passes, hits


def test_pipeline_ids_staging_and_verdicts_equal_the_reference():
    ref, port = (_ingest_twice(p) for p in PACKAGES)
    assert port == ref
    (cold, warm), hits = port
    assert cold == warm and hits == len(blobs()) - 1   # the warm pass: all but the bad frame
    assert cold[5] == ("error", "SerializationError", True)
    fx = fixture()
    for i, label in enumerate(fx.labels):
        slot = cold[i if i < 5 else i + 1]
        assert slot[1] == str(fx.spends[i].id)
        assert all(slot[3]) == (label != "invalid-signature")


def test_install_tx_ids_matches_property_walk():
    """The batched Merkle-id stage installs the ids of the per-tx walk,
    with and without caches, warm too."""
    T = _package("corda_tpu_torch")
    good = [T.ser.encode(s) for s in fixture().spends]
    want = [T.ser.decode(b).wtx.id for b in good]
    wtxs = [T.ser.decode(b).wtx for b in good]
    T.ingest.install_tx_ids(wtxs, None, None)
    assert [w.id for w in wtxs] == want
    leaf, root = T.ingest.DigestCache(1024), T.ingest.DigestCache(1024)
    for _ in range(2):
        wtxs = [T.ser.decode(b).wtx for b in good]
        T.ingest.install_tx_ids(wtxs, leaf, root)
        assert [w.__dict__["_id_cache"] for w in wtxs] == want
    assert len(root) == len(set(want))


def test_staging_is_memoised_not_restaged():
    T = _package("corda_tpu_torch")
    pipe = T.ingest.IngestPipeline()
    entry = pipe.ingest([blobs()[0]])[0]
    assert entry.requests and entry.stx.signature_requests() is entry.requests
    pipe.close()


def test_pipeline_traces_every_frame():
    """With a tracer on, each frame gets a root span carrying its wire
    bytes and id, with decode / merkle_id / stage children; a malformed
    frame's root carries its error and only a decode child; a re-seen
    frame (the second pass) is marked a frame-cache hit and has no
    children."""
    T = _package("corda_tpu_torch")
    from corda_tpu_torch.utils.tracing import Tracer

    tracer = Tracer(enabled=True, keep=64)
    pipe = T.ingest.IngestPipeline(shards=1, tracer=tracer)
    b = list(blobs())
    entries = pipe.ingest(b) + pipe.ingest(b)
    pipe.close()
    traces = {t[0].trace_id: t for t in tracer.completed}
    assert len(traces) == 2 * len(b)
    hits = 0
    for blob, e in zip(b + b, entries):
        root, *children = traces[e.span.trace_id]
        assert root.name == "notarise.frame" and root.attributes["wire_bytes"] == len(blob)
        names = [c.name for c in children]
        if e.error is not None:
            assert "error" in root.attributes and names == ["ingest.decode"]
        elif root.attributes.get("frame_cache_hit"):
            assert names == [] and root.attributes["tx_id"] == str(e.tx_id)
            hits += 1
        else:
            assert root.attributes["tx_id"] == str(e.tx_id)
            assert names == ["ingest.decode", "ingest.merkle_id", "ingest.stage"]
            assert all(c.parent_id == root.span_id for c in children)
    assert hits == len(b) - 1 == pipe.frame_hits


def test_digest_cache_bounded_as_the_reference():
    caches = [_package(p).ingest.DigestCache(capacity=16) for p in PACKAGES]
    for i in range(100):
        for c in caches:
            c.put(bytes([i]) * 4, i)
    assert len(caches[1]) <= 16
    assert caches[0]._map == caches[1]._map


def test_ring_put_blocks_until_consumer_drains():
    T = _package("corda_tpu_torch")
    ring = T.ingest.IngestRing(depth=1)
    assert ring.put(["batch-0"], timeout=1)
    done = threading.Event()

    def producer():
        ring.put(["batch-1"], timeout=5)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.05)
    assert not done.is_set(), "a full ring must block the producer"
    assert ring.take(timeout=1) == ["batch-0"]
    t.join(5)
    assert done.is_set() and ring.take(timeout=1) == ["batch-1"]
    assert ring.high_water == 1
    ring.close()
    assert not ring.put(["late"], timeout=1)


@pytest.mark.parametrize("prefix", PACKAGES)
def test_ring_seam_parks_on_full_and_retries(prefix):
    P = _package(prefix)
    from corda_tpu_torch.utils.metrics import MetricRegistry

    imn = P.msg.InMemoryMessagingNetwork()
    rx, tx = imn.endpoint("rx"), imn.endpoint("tx")
    ring = P.ingest.IngestRing(depth=2)
    metrics = MetricRegistry()
    rx.add_ring("ingest.topic", ring, metrics=metrics)
    for i in range(5):
        tx.send("ingest.topic", b"frame-%d" % i, "rx")
    imn.run()
    assert len(ring) == 2 and rx.parked_count("ingest.topic") == 3
    assert metrics.get("Ingest.ingest.topic.Parked").value() == 3
    assert [m.payload for m in ring.drain()] == [b"frame-0", b"frame-1"]
    assert rx.retry_parked("ingest.topic") == 2
    assert [m.payload for m in ring.drain()] == [b"frame-2", b"frame-3"]
    rx.retry_parked("ingest.topic")
    assert [m.payload for m in ring.drain()] == [b"frame-4"]
    assert rx.parked_count("ingest.topic") == 0


@pytest.mark.parametrize("prefix", PACKAGES)
def test_ring_seam_redelivery_of_parked_frame_stays_exactly_once(prefix):
    """A frame parked while the ring was full and then redelivered
    (at-least-once upstream) is taken once: the parked copy is dropped
    at retry_parked, and later copies are deduped."""
    P = _package(prefix)
    rx = P.msg.InMemoryMessagingNetwork().endpoint("rx")
    ring = P.ingest.IngestRing(depth=1)
    rx.add_ring("ingest.topic", ring)
    m0 = P.msg.Message("ingest.topic", b"frame-0", "tx", 1)
    m1 = P.msg.Message("ingest.topic", b"frame-1", "tx", 2)
    rx._deliver(m0)                 # fills the ring
    rx._deliver(m1)                 # full -> parked, not marked seen
    assert ring.drain()[0].payload == b"frame-0"
    rx._deliver(m1)                 # the redelivery: room now
    assert [m.payload for m in ring.drain()] == [b"frame-1"]
    assert rx.retry_parked("ingest.topic") == 0
    assert ring.drain() == []
    rx._deliver(m1)
    assert ring.drain() == []


def _shed(prefix: str) -> list:
    P = _package(prefix)
    pipe = P.ingest.IngestPipeline(shards=1)
    b = list(blobs())[:4]
    deadlines = [None, 1_000, 2_000, 5_000]
    entries = pipe.ingest(b, deadlines=deadlines, now_micros=2_000)
    out = [(type(e.error).__name__ if e.error else None, str(e.error) if e.error else None,
            e.deadline, None if e.tx_id is None else str(e.tx_id)) for e in entries]
    assert pipe.frame_hits == 0
    pipe.close()
    return out


def test_predecode_shedding_equals_the_reference():
    """Expired deadlines (inclusive: a deadline equal to now sheds) give
    DeadlineExpired in their slots before any decode; live ones ride
    out on the entry."""
    ref, port = (_shed(p) for p in PACKAGES)
    assert port == ref
    assert [s[0] for s in port] == [None, "DeadlineExpired", "DeadlineExpired", None]
    assert port[1][1] == "deadline 1000 expired 1000 us before processing"
    assert port[3][2] == 5_000 and port[1][3] is None


def _notary(P, hub, shards: int):
    uniq = (P.notary.ShardedUniquenessProvider(shards) if shards > 1
            else P.notary.InMemoryUniquenessProvider())
    return P.notary.BatchingNotaryService(hub, uniq, shards=shards)


def _ring_answers(prefix: str, shards: int) -> dict:
    """The wire bytes of the spends naming this notary fed through
    package P's IngestPipeline into its notary's ring, one flush; the
    answers by spend index. The ring path checks no notary, so a spend
    naming another notary is left to `process`."""
    P = _package(prefix)
    flow_future = importlib.import_module(f"{prefix}.flows.api").FlowFuture
    hub, spends, requester = _hub(P, P.bv.CpuBatchVerifier())
    svc = _notary(P, hub, shards)
    mine = [i for i, s in enumerate(spends) if s.wtx.notary == svc.identity]
    pipe = P.ingest.IngestPipeline(ring_depth=1)
    svc.attach_ingest(pipe.ring)
    futs, errors = [], []

    def wrap(entries):
        batch = []
        for e in entries:
            if e.error is not None:
                errors.append(e.error)
                continue
            fut = flow_future()
            futs.append(fut)
            batch.append(P.notary._PendingNotarisation(e.stx, requester, fut))
        return batch

    T = _package("corda_tpu_torch")
    wire = [T.ser.encode(fixture().spends[i]) for i in mine]
    feeder = pipe.feed([wire[:6], wire[6:11], wire[11:]], wrap=wrap)
    while feeder.is_alive() or len(pipe.ring):
        svc.tick()                  # the ring is 1 deep: ticks release the feeder
        feeder.join(0.01)
    svc.flush()
    assert svc.metrics.get("Ingest.notary.RingHighWater").value() == 1
    pipe.close()
    assert errors == [] and len(futs) == len(mine)
    return {i: (answer_kind(f.result()), P.ser.encode(getattr(f.result(), "conflict", None)))
            for i, f in zip(mine, futs)}


@pytest.mark.parametrize("shards", [1, 4])
def test_notary_ring_drain_answers_as_the_process_path(shards):
    """The port's notary fed from its ingest ring answers as the
    reference's ring-fed notary does on the same wire bytes, and as the
    port's `process` path does: the same kinds (each its label) and
    conflicts. The spends it is not fed are exactly those naming another
    notary, which `process` answers wrong-notary."""
    T = _package("corda_tpu_torch")
    hub, spends, requester = _hub(T, T.bv.CpuBatchVerifier())
    svc = _notary(T, hub, shards)
    started = T.notary.run_process([svc.process(s, requester) for s in spends])
    svc.flush()
    processed = [(answer_kind(a), T.ser.encode(getattr(a, "conflict", None)))
                 for a in T.notary.finish_process(started)]
    ref, port = (_ring_answers(p, shards) for p in PACKAGES)
    assert port == ref
    assert port == {i: processed[i] for i in port}
    labels = fixture().labels
    assert [k for k, _ in processed] == labels
    assert [labels[i] for i in range(len(labels)) if i not in port] == ["wrong-notary"]
    assert {labels[i] for i in port} == {"ok", "invalid-signature", "conflict"}


def _worker_drain(prefix: str) -> dict:
    """The fixture's spends through a verifier worker with the request
    ingest pipeline: every request (with a contract-only one) lands in
    the ring, one drain answers all; a malformed frame is then dropped
    in its slot."""
    P = _package(prefix)
    hub, spends, _ = _hub(P, P.bv.CpuBatchVerifier())
    ltxs = [s.to_ledger_transaction(hub) for s in spends]
    imn = P.msg.InMemoryMessagingNetwork()
    node_ep, worker_ep = imn.endpoint("nodeA"), imn.endpoint("w1")
    frames = []
    enqueue = imn._enqueue
    imn._enqueue = lambda msg, target: (frames.append((msg.topic, target, msg.payload)),
                                        enqueue(msg, target))
    svc = P.ver.OutOfProcessTransactionVerifierService(node_ep)
    worker = P.ver.VerifierWorker(worker_ep, "nodeA", batch_verifier=P.bv.CpuBatchVerifier(),
                                  batch_window=10**9,
                                  ingest=P.ver.request_ingest_pipeline(shards=1))
    imn.run()
    futs = [svc.verify(ltx, stx) for ltx, stx in zip(ltxs, spends)]
    futs.append(svc.verify(ltxs[0]))            # contract-only
    imn.run()
    assert len(worker._ring) == len(futs)       # every frame went to the ring
    assert worker.drain() == len(futs)
    imn.run()
    answers = []
    for f in futs:
        assert f.done
        try:
            f.result()
            answers.append("ok")
        except Exception as e:   # noqa: BLE001 - the failure is the answer
            answers.append(f"{type(e).__name__}: {e}")
    node_ep.send(P.msg.TOPIC_VERIFIER_REQ, b"\x07garbage", "w1")
    imn.run()
    assert worker.drain() == 0
    h = worker.metrics.histogram("Verifier.BatchSize")
    return {"answers": answers, "frames": frames,
            "verified": worker.metrics.meter("Verifier.Verified").count,
            "failed": worker.metrics.meter("Verifier.Failed").count,
            "batch": (h.count, h.max)}


def test_worker_drains_prestaged_requests_as_the_reference():
    ref, port = (_worker_drain(p) for p in PACKAGES)
    assert port == ref
    labels = fixture().labels
    assert port["answers"][-1] == "ok"          # the contract-only request
    for a, label in zip(port["answers"], labels):
        assert a.startswith("VerificationFailedError: InvalidSignature") == \
            (label == "invalid-signature"), (a, label)
    assert port["failed"] == labels.count("invalid-signature") + 1   # + the malformed frame
    assert port["batch"] == (1, len(labels))


def test_worker_prestaged_requests_are_the_pipelines():
    """The worker's drain dispatches the very request lists the
    pipeline staged at ingest (no re-staging)."""
    T = _package("corda_tpu_torch")
    hub, spends, _ = _hub(T, T.bv.CpuBatchVerifier())
    seen = []

    class Recording(T.bv.CpuBatchVerifier):
        def verify_batch(self, requests):
            seen.append(list(requests))
            return super().verify_batch(requests)

    imn = T.msg.InMemoryMessagingNetwork()
    svc = T.ver.OutOfProcessTransactionVerifierService(imn.endpoint("nodeA"))
    pipe = T.ver.request_ingest_pipeline(shards=1)
    staged = []
    real = pipe._finish

    def finish(started, end_spans=True):
        entries = real(started, end_spans)
        staged.extend(r for e in entries for r in e.requests)
        return entries

    pipe._finish = finish
    worker = T.ver.VerifierWorker(imn.endpoint("w1"), "nodeA", batch_verifier=Recording(),
                                  batch_window=10**9, ingest=pipe)
    imn.run()
    for stx in spends[:4]:
        svc.verify(stx.to_ledger_transaction(hub), stx)
    imn.run()
    worker.drain()
    assert len(seen) == 1 and len(staged) == 4
    assert all(a is b for a, b in zip(seen[0], staged))
    assert pipe.stage_seconds["decode"] > 0 and worker.drain_seconds[-1]["requests"] == 4
