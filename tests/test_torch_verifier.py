"""The out-of-process verifier pool in both packages, held against the
reference.

Every case of the reference's tests/test_verifier.py (offload, buffering
until a worker attaches, an invalid signature, round robin, one dispatch
per batched drain, a malformed transaction, worker churn, a lost answer,
the buffer drained exactly once, the signature gate before contract
execution, failures delivered before sends) and the typed timeout of
`wait` run on the same seeded MockNetwork in each package over
CpuBatchVerifier. Required equal between the packages: every frame on
the verifier topics (sender, target, topic, payload bytes: requests,
responses, WorkerReady), every answer (its exception class and message),
and the pool's and workers' metrics (success and failure counts,
Verified, Failed, BatchSize, Redispatched, WorkersLost). One case runs
the port's worker on CudaBatchVerifier(device="cpu"); the port's worker
with a failing card dispatch answers VerifierDispatchError for every
request and never verifies on the host, and with no verifier it raises
where there is no card.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

PACKAGES = ("corda_tpu", "corda_tpu_torch")


def _package(prefix: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{prefix}.{name}")

    return SimpleNamespace(
        prefix=prefix, mock=m("testing.mock_network"), bv=m("crypto.batch_verifier"),
        cash=m("finance.cash"), contracts=m("core.contracts"), ser=m("core.serialization"),
        tx=m("core.transactions"), msg=m("node.messaging"), ver=m("node.verifier"),
        services=m("node.services"), repl=m("core.replacement"),
    )


def _answer(fut) -> str:
    if not fut.done:
        return "pending"
    try:
        fut.result()
    except Exception as e:   # noqa: BLE001 - the failure is the answer
        return f"{type(e).__name__}: {e}"
    return "ok"


class Rig:
    """One seeded MockNetwork (seed 11, CpuBatchVerifier) with an issued
    Cash transaction of Alice's, its resolved ledger transaction, and a
    recorder of every frame on the verifier topics."""

    def __init__(self, P, faults: bool = False):
        self.P = P
        self.faults = P.msg.FabricFaults() if faults else None
        self.net = P.mock.MockNetwork(seed=11, faults=self.faults,
                                      batch_verifier=P.bv.CpuBatchVerifier())
        self.frames: list = []
        enqueue = self.net.fabric._enqueue

        def recording(msg, target):
            if msg.topic.startswith("verifier."):
                self.frames.append((msg.sender, target, msg.topic, msg.payload))
            enqueue(msg, target)

        self.net.fabric._enqueue = recording
        self.notary = self.net.create_notary()
        self.alice = self.net.create_node("Alice")
        self.stx = self.alice.run_flow(
            P.cash.CashIssueFlow(1000, "USD", self.alice.party, self.notary.party))
        self.ltx = self.alice.services.resolve_transaction(self.stx.wtx)

    def pool(self, **kw):
        return self.P.ver.OutOfProcessTransactionVerifierService(self.alice.messaging, **kw)

    def worker(self, name, **kw):
        kw.setdefault("batch_verifier", self.P.bv.CpuBatchVerifier())
        return self.P.ver.VerifierWorker(self.net.fabric.endpoint(name), "Alice", **kw)

    def forged(self):
        """The issue transaction with a signature over ANOTHER id."""
        notary = self.alice.services.network_map_cache.notary_identities()[0]
        other = self.alice.run_flow(self.P.cash.CashIssueFlow(5, "EUR", self.alice.party, notary))
        wrong = self.alice.services.key_management.sign(other.id, self.alice.party.owning_key)
        return self.P.tx.SignedTransaction(self.stx.wtx, (wrong,))

    def kill(self, name):
        self.faults.kill(name)
        self.net.fabric.endpoint(name).running = False

    def run(self):
        self.net.fabric.run()


def _pool_metrics(svc) -> dict:
    m = svc.metrics
    return {
        "success": m.meter("TransactionVerifierService.Verification.Success").count,
        "failure": m.meter("TransactionVerifierService.Verification.Failure").count,
        "redispatched": m.meter("Verifier.Redispatched").count,
        "workers_lost": m.meter("Verifier.WorkersLost").count,
        "workers": svc.worker_count, "in_flight": svc.in_flight, "buffered": svc.buffered,
    }


def _worker_metrics(w) -> dict:
    h = w.metrics.histogram("Verifier.BatchSize")
    return {"verified": w.metrics.meter("Verifier.Verified").count,
            "failed": w.metrics.meter("Verifier.Failed").count,
            "batch_count": h.count, "batch_max": h.max}


def _outcome(rig, svc, futs, workers) -> dict:
    return {"answers": [_answer(f) for f in futs], "pool": _pool_metrics(svc),
            "workers": [_worker_metrics(w) for w in workers], "frames": rig.frames}


# ---------------------------------------------------------------------------
# the cases: each runs in one package and asserts what the reference's
# test asserts; its outcome is compared across the packages


def case_offload_roundtrip(P):
    rig = Rig(P)
    svc = rig.pool()
    w = rig.worker("worker-1")
    rig.run()
    assert svc.worker_count == 1
    fut = svc.verify(rig.ltx, rig.stx)
    assert not fut.done
    rig.run()
    assert _answer(fut) == "ok" and svc.in_flight == 0
    assert "TransactionVerifierService_Verification_Success_total 1" in svc.metrics.to_prometheus()
    return _outcome(rig, svc, [fut], [w])


def case_buffer_until_worker_attaches(P):
    rig = Rig(P)
    svc = rig.pool()
    fut = svc.verify(rig.ltx, rig.stx)
    rig.run()
    assert not fut.done and svc.buffered == 1
    w = rig.worker("worker-1")
    rig.run()
    assert _answer(fut) == "ok"
    return _outcome(rig, svc, [fut], [w])


def case_invalid_signature(P):
    rig = Rig(P)
    forged = rig.forged()
    svc = rig.pool()
    w = rig.worker("worker-1")
    rig.run()
    fut = svc.verify(rig.ltx, forged)
    rig.run()
    assert _answer(fut).startswith("VerificationFailedError: InvalidSignature: invalid signature")
    return _outcome(rig, svc, [fut], [w])


def case_round_robin(P):
    rig = Rig(P)
    svc = rig.pool()
    ws = [rig.worker("worker-1"), rig.worker("worker-2")]
    rig.run()
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(6)]
    rig.run()
    assert [_answer(f) for f in futs] == ["ok"] * 6
    assert [w.metrics.meter("Verifier.Verified").count for w in ws] == [3, 3]
    return _outcome(rig, svc, futs, ws)


def case_batched_drain(P, worker_verifier=None):
    rig = Rig(P)
    svc = rig.pool()
    kw = {"batch_verifier": worker_verifier} if worker_verifier is not None else {}
    w = rig.worker("worker-1", batch_window=100, **kw)
    rig.run()
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(5)]
    rig.run()
    assert not any(f.done for f in futs)
    assert w.drain() == 5
    rig.run()
    assert [_answer(f) for f in futs] == ["ok"] * 5
    h = w.metrics.histogram("Verifier.BatchSize")
    assert h.count == 1 and h.max == 5 * len(rig.stx.sigs)
    return _outcome(rig, svc, futs, [w])


def case_malformed_transaction(P):
    rig = Rig(P)
    ltx = rig.ltx
    notary2 = rig.alice.services.network_map_cache.notary_identities()[0]
    cmd = type(ltx.commands[0])(ltx.commands[0].signers, (), P.repl.NotaryChangeCommand(notary2))
    bad_ltx = type(ltx)(ltx.inputs, ltx.outputs, ltx.commands + (cmd,), ltx.attachments,
                        ltx.notary, ltx.time_window, ltx.id)
    svc = rig.pool()
    w = rig.worker("worker-1", batch_window=100)
    rig.run()
    good, bad = svc.verify(ltx, rig.stx), svc.verify(bad_ltx, rig.stx)
    rig.run()
    assert not good.done
    assert w.drain() == 2
    rig.run()
    assert _answer(good) == "ok" and _answer(bad).startswith("VerificationFailedError: ")
    return _outcome(rig, svc, [good, bad], [w])


def _churn_pool(rig, **policy):
    P = rig.P
    base = dict(lease_micros=100_000, request_timeout_micros=100_000_000,
                backoff_base_micros=50_000, backoff_cap_micros=200_000, max_attempts=4)
    base.update(policy)
    return rig.pool(clock=rig.net.clock, policy=P.ver.RedispatchPolicy(**base))


def case_worker_killed_mid_batch(P):
    rig = Rig(P, faults=True)
    svc = _churn_pool(rig)
    clock = rig.net.clock
    w1 = rig.worker("worker-1", clock=clock, heartbeat_micros=50_000)
    w2 = rig.worker("worker-2", clock=clock, heartbeat_micros=50_000)
    rig.run()
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(4)]   # RR: 2 per worker
    rig.kill("worker-1")
    rig.run()
    w2.drain()
    rig.run()
    assert sum(f.done for f in futs) == 2
    clock.advance(150_000)
    w2.drain()             # the survivor's heartbeat
    rig.run()
    svc.tick()             # lease expiry: worker-1 detaches
    assert svc.worker_count == 1
    clock.advance(80_000)
    svc.tick()             # redispatch to the survivor
    assert svc.metrics.meter("Verifier.Redispatched").count == 2
    rig.run()
    w2.drain()
    rig.run()
    assert [_answer(f) for f in futs] == ["ok"] * 4 and svc.in_flight == 0
    return _outcome(rig, svc, futs, [w1, w2])


def case_stale_incarnation_rejected(P):
    rig = Rig(P, faults=True)
    svc = _churn_pool(rig)
    clock = rig.net.clock
    w1 = rig.worker("worker-1", clock=clock, heartbeat_micros=50_000, batch_window=100)
    w2 = rig.worker("worker-2", clock=clock, heartbeat_micros=50_000)
    rig.run()
    assert svc.incarnation_of("worker-1") == 1
    fut = svc.verify(rig.ltx, rig.stx)     # RR -> worker-1
    rig.run()
    w1.drain()                             # computes + sends the answer...
    rig.kill("worker-1")                   # ...and dies before it delivers
    clock.advance(150_000)
    w2.drain()
    rig.run()
    svc.tick()
    assert svc.worker_count == 1
    clock.advance(80_000)
    svc.tick()                             # re-dispatch to worker-2, attempt 1
    rig.faults.revive("worker-1")
    rig.net.fabric.endpoint("worker-1").running = True
    w1._send_ready()
    rig.run()                              # the stale answer (attempt 0) is rejected
    assert svc.incarnation_of("worker-1") == 2
    w2.drain()
    rig.run()
    assert _answer(fut) == "ok"
    assert svc.metrics.meter("TransactionVerifierService.Verification.Success").count == 1
    return _outcome(rig, svc, [fut], [w1, w2])


def case_lost_answer_redispatched(P):
    rig = Rig(P, faults=True)
    svc = _churn_pool(rig, lease_micros=10_000_000, attempt_timeout_micros=200_000)
    clock = rig.net.clock
    w1 = rig.worker("worker-1", clock=clock, heartbeat_micros=50_000)
    w2 = rig.worker("worker-2", clock=clock, heartbeat_micros=50_000)
    rig.run()
    rig.faults.drop_link("worker-1", "Alice", 1.0, symmetric=False)
    fut = svc.verify(rig.ltx, rig.stx)     # RR -> worker-1; its answer is dropped
    rig.run()
    assert not fut.done
    clock.advance(250_000)                 # past the attempt deadline only
    w1.drain()
    rig.faults.drop_link("worker-1", "Alice", 0.0)
    svc.tick()
    assert svc.metrics.meter("Verifier.Redispatched").count == 1
    rig.run()
    w2.drain()
    rig.run()
    assert _answer(fut) == "ok" and svc.worker_count == 2
    assert svc.metrics.meter("Verifier.WorkersLost").count == 0
    return _outcome(rig, svc, [fut], [w1, w2])


def case_straggler_hedged_first_answer_wins(P):
    """A nonce held past the hedge threshold by its worker is duplicated
    onto the other worker at the same attempt; the hedge's answer
    resolves it and the straggler's late answer is dropped."""
    rig = Rig(P)
    clock = rig.net.clock
    svc = rig.pool(clock=clock, policy=P.ver.RedispatchPolicy(
        hedge_quantile=0.5, hedge_min_micros=50_000, lease_micros=60_000_000))
    w1 = rig.worker("worker-1", clock=clock, batch_window=100)   # holds its request
    w2 = rig.worker("worker-2", clock=clock)
    rig.run()
    fut = svc.verify(rig.ltx, rig.stx)     # RR -> worker-1
    rig.run()
    svc.tick()                             # below the threshold: no hedge
    assert svc.metrics.meter("Verifier.Hedged").count == 0
    clock.advance(60_000)
    svc.tick()                             # straggler: hedged onto worker-2
    assert svc.metrics.meter("Verifier.Hedged").count == 1
    rig.run()
    assert _answer(fut) == "ok" and svc.in_flight == 0
    assert w1.drain() == 1                 # the straggler answers late
    rig.run()
    assert svc.metrics.meter("TransactionVerifierService.Verification.Success").count == 1
    return _outcome(rig, svc, [fut], [w1, w2])


def case_two_workers_drain_buffer_once(P):
    rig = Rig(P)
    svc = rig.pool(clock=rig.net.clock)
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(4)]
    rig.run()
    assert svc.buffered == 4
    ws = [rig.worker("worker-1", clock=rig.net.clock), rig.worker("worker-2", clock=rig.net.clock)]
    rig.run()
    assert svc.buffered == 0 and [_answer(f) for f in futs] == ["ok"] * 4
    assert sum(w.metrics.meter("Verifier.Verified").count for w in ws) == 4
    return _outcome(rig, svc, futs, ws)


def case_signature_gates_contract(P):
    ran = []

    class Spy:
        def verify(self, ltx) -> None:
            ran.append(ltx.id)

    P.contracts.register_contract("test.verifier.Spy", Spy())
    rig = Rig(P)
    ltx = rig.ltx
    spy_ltx = type(ltx)((), tuple(type(ts)(ts.data, "test.verifier.Spy", ts.notary)
                                  for ts in ltx.outputs),
                        ltx.commands, (), ltx.notary, None, ltx.id)
    forged = rig.forged()
    svc = rig.pool()
    w = rig.worker("worker-1")
    rig.run()
    fut = svc.verify(spy_ltx, forged)
    rig.run()
    assert _answer(fut).startswith("VerificationFailedError: InvalidSignature")
    assert ran == []
    ok = svc.verify(spy_ltx, rig.stx)      # signed: the contract runs
    rig.run()
    assert _answer(ok) == "ok" and ran == [ltx.id]
    return _outcome(rig, svc, [fut, ok], [w])


def case_tick_failures_before_sends(P):
    rig = Rig(P)
    clock = P.services.TestClock()
    svc = rig.pool(clock=clock, policy=P.ver.RedispatchPolicy(
        request_timeout_micros=1_000_000, attempt_timeout_micros=500_000,
        lease_micros=60_000_000))
    w = rig.worker("worker-1")
    rig.run()
    fut_a = svc.verify(rig.ltx, rig.stx)
    clock.advance(600_000)
    fut_b = svc.verify(rig.ltx, rig.stx)
    clock.advance(600_000)

    class Broken:
        def __init__(self, inner):
            self._inner = inner

        def send(self, *a, **kw):
            raise RuntimeError("journal full")

        def __getattr__(self, name):
            return getattr(self._inner, name)

    svc._messaging = Broken(svc._messaging)
    with pytest.raises(RuntimeError, match="journal full"):
        svc.tick()
    assert _answer(fut_a).startswith("VerificationTimeoutError: verification of nonce 1")
    assert not fut_b.done
    return _outcome(rig, svc, [fut_a, fut_b], [w])


def case_wait_typed_timeout(P):
    rig = Rig(P)
    svc = rig.pool()
    fut = svc.verify(rig.ltx, rig.stx)     # no worker attached: buffered
    with pytest.raises(P.ver.VerificationTimeoutError) as e:
        svc.wait(fut, timeout=0.05)
    assert e.value.worker is None and e.value.elapsed_micros >= 50_000
    assert "nonce 1" in str(e.value)
    return {"nonce": e.value.nonce, "worker": e.value.worker, "pool": _pool_metrics(svc),
            "frames": rig.frames}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_equals_the_reference(case):
    ref, port = (CASES[case](_package(prefix)) for prefix in PACKAGES)
    frames = port.pop("frames")
    assert frames == ref.pop("frames")
    assert frames or case == "wait_typed_timeout"   # that one never attaches a worker
    assert port == ref


def test_wire_frames_byte_equal():
    """A request, a response and a WorkerReady built in the port encode
    to the reference's bytes, and the reference decodes them back to
    equal values."""
    R, T = (_package(p) for p in PACKAGES)
    rig = Rig(T)
    req = T.ver.TxVerificationRequest(7, rig.ltx, "Alice", rig.stx, 2)
    wire = T.ser.encode(req)
    back = R.ser.decode(wire)
    assert type(back).__module__ == "corda_tpu.node.verifier"
    assert (back.nonce, back.response_address, back.attempt) == (7, "Alice", 2)
    assert str(back.ltx.id) == str(rig.ltx.id) and str(back.stx.id) == str(rig.stx.id)
    assert R.ser.encode(back) == wire
    assert T.ser.decode(wire) == req
    for port_obj, ref_obj in (
        (T.ver.TxVerificationResponse(7, "InvalidSignature: x", 1),
         R.ver.TxVerificationResponse(7, "InvalidSignature: x", 1)),
        (T.ver.TxVerificationResponse(8), R.ver.TxVerificationResponse(8)),
        (T.ver.WorkerReady("worker-1", "10.0.0.1", 9000),
         R.ver.WorkerReady("worker-1", "10.0.0.1", 9000)),
    ):
        assert T.ser.encode(port_obj) == R.ser.encode(ref_obj)
        assert R.ser.decode(T.ser.encode(port_obj)) == ref_obj


@pytest.fixture
def one_thread():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_batched_drain_on_the_device_path_equals_the_reference(one_thread):
    """The port's worker over CudaBatchVerifier(device="cpu",
    batch_sizes=(16,)) — the card's path with the kernels' plain
    versions — answers the batched drain as the reference's worker over
    its CpuBatchVerifier: the same frames, answers and metrics."""
    R, T = (_package(p) for p in PACKAGES)
    ref = case_batched_drain(R)
    port = case_batched_drain(T, T.bv.CudaBatchVerifier(device="cpu", batch_sizes=(16,)))
    assert port.pop("frames") == ref.pop("frames")
    assert port == ref


@pytest.mark.parametrize("prefix", PACKAGES)
def test_failed_dispatch_answers_every_request_and_never_falls_back(prefix):
    """A worker whose dispatch raises answers every queued request
    `VerifierDispatchError: DeviceFaultError: ...` and verifies nothing
    on the host; the next drain, with the fault spent, verifies. The
    answers are equal in both packages."""
    P = _package(prefix)
    rig = Rig(P)
    calls = []

    class Counting(P.bv.CpuBatchVerifier):
        def verify_batch(self, requests):
            calls.append(len(requests))
            return super().verify_batch(requests)

    injector = P.bv.DispatchFaultInjector(Counting())
    injector.arm(1)
    svc = rig.pool()
    w = rig.worker("worker-1", batch_verifier=injector, batch_window=100)
    rig.run()
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(3)]
    rig.run()
    assert w.drain() == 3
    rig.run()
    want = "VerificationFailedError: VerifierDispatchError: DeviceFaultError: " \
           "injected device fault (dispatch seam)"
    assert [_answer(f) for f in futs] == [want] * 3
    assert calls == [] and injector.faults_raised == 1
    assert _worker_metrics(w) == {"verified": 0, "failed": 3, "batch_count": 1,
                                  "batch_max": 3 * len(rig.stx.sigs)}
    again = svc.verify(rig.ltx, rig.stx)
    rig.run()
    w.drain()
    rig.run()
    assert _answer(again) == "ok" and calls == [len(rig.stx.sigs)]


def test_port_worker_on_a_failing_card_path_does_not_fall_back(one_thread):
    """The same with the port's CudaBatchVerifier (device="cpu") behind
    the injector: a failed dispatch is answered, never re-verified on
    the host; the drain after it runs on the device path."""
    T = _package("corda_tpu_torch")
    rig = Rig(T)
    card = T.bv.CudaBatchVerifier(device="cpu", batch_sizes=(16,))
    injector = T.bv.DispatchFaultInjector(card)
    injector.arm(1)
    svc = rig.pool()
    w = rig.worker("worker-1", batch_verifier=injector, batch_window=100)
    rig.run()
    futs = [svc.verify(rig.ltx, rig.stx) for _ in range(2)]
    rig.run()
    w.drain()
    rig.run()
    assert all(_answer(f).startswith("VerificationFailedError: VerifierDispatchError: "
                                     "DeviceFaultError") for f in futs)
    again = svc.verify(rig.ltx, rig.stx)
    rig.run()
    w.drain()
    rig.run()
    assert _answer(again) == "ok"


def test_worker_without_a_verifier_needs_the_card(monkeypatch):
    """VerifierWorker(...) with no batch_verifier takes default_verifier(),
    a CudaBatchVerifier on "cuda": it raises where there is no card."""
    import torch

    T = _package("corda_tpu_torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default verifier builds")
    monkeypatch.setattr(T.bv, "_default", None)
    net = T.msg.InMemoryMessagingNetwork()
    with pytest.raises(Exception, match="(?i)cuda"):
        T.ver.VerifierWorker(net.endpoint("worker-1"), "Alice")
    assert T.bv._default is None


def test_pool_lock_holds_under_concurrent_verify_attach_and_answers():
    """The service lock under contention: 8 threads call verify() while
    workers attach and tick() runs, with a short switch interval; then 4
    threads deliver every answer (each twice: at-least-once). Every
    nonce is unique, dispatched exactly once (buffered ones on attach),
    and every future resolves exactly once."""
    import sys
    import threading

    T = _package("corda_tpu_torch")
    rig = Rig(T)

    class Fabric:
        my_address = "Alice"

        def __init__(self):
            self.sent = []
            self.handlers = {}

        def send(self, topic, payload, target, **kw):
            self.sent.append((topic, payload, target))

        def add_handler(self, topic, handler):
            self.handlers[topic] = handler

    fabric = Fabric()
    svc = T.ver.OutOfProcessTransactionVerifierService(fabric)
    per_thread, threads_n = 150, 8
    futs: list = []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client():
            mine = [svc.verify(rig.ltx, rig.stx) for _ in range(per_thread)]
            futs.extend(mine)

        def attacher():
            for k in range(3):
                msg = T.msg.Message(T.ver.TOPIC_READY, T.ser.encode(T.ver.WorkerReady(f"w{k}")),
                                    f"w{k}", k)
                svc._on_ready(msg)
                svc.tick()

        threads = [threading.Thread(target=client) for _ in range(threads_n)]
        threads.append(threading.Thread(target=attacher))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        n = per_thread * threads_n
        assert sorted(f.nonce for f in futs) == list(range(1, n + 1))
        reqs = [(T.ser.decode(p), target) for topic, p, target in fabric.sent
                if topic == T.msg.TOPIC_VERIFIER_REQ]
        assert sorted(r.nonce for r, _ in reqs) == list(range(1, n + 1))
        assert svc.buffered == 0 and svc.in_flight == n

        answers = [T.msg.Message(T.msg.TOPIC_VERIFIER_RES,
                                 T.ser.encode(T.ver.TxVerificationResponse(r.nonce, None, r.attempt)),
                                 target, r.nonce) for r, target in reqs] * 2

        def responder(part):
            for msg in part:
                svc._on_response(msg)

        threads = [threading.Thread(target=responder, args=(answers[k::4],)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert all(f.done for f in futs) and svc.in_flight == 0
    assert svc.metrics.meter("TransactionVerifierService.Verification.Success").count == n
