"""Out-of-process transaction verification — the offload seam.

Port of corda_tpu/node/verifier.py: the wire API
(`TxVerificationRequest`, `TxVerificationResponse`, `WorkerReady`), the
node-side pool `OutOfProcessTransactionVerifierService` (leases,
redispatch with backoff and jitter, hedging, stale-incarnation
rejection, store-and-forward buffer, round robin, metrics),
`request_ingest_pipeline` and the worker `VerifierWorker`. Classes keep
the reference's names, field order and serialization tags, so request,
response and ready frames are byte-equal across the two packages.

Reference architecture (SURVEY §2.6): `TransactionVerifierService` SPI
(core/.../node/services/TransactionVerifierService.kt:9-15) with an
out-of-process implementation that keeps a nonce→future handle map and
ships serialized transactions onto a `verifier.requests` queue
(node/.../transactions/OutOfProcessTransactionVerifierService.kt:19-73,
node-api/.../VerifierApi.kt:10-59); standalone workers attach to the
broker, consume requests, verify, and reply to a per-node response
queue (verifier/src/main/kotlin/net/corda/verifier/Verifier.kt:38-111).
Workers scale horizontally — the queue load-balances across however
many are attached.

Batch-first: the worker is where the card lives, so a request may also
carry the `SignedTransaction`, and the worker drains ALL signature
checks across every request in its queue into ONE
`BatchSignatureVerifier.verify_batch` call — a CudaBatchVerifier
dispatch by default. Store-and-forward: requests sent before any worker
attaches are buffered and flushed on the first `verifier.ready`.

Over the TCP fabric (node/fabric.py) the pool takes `register_peer=`
and `allowed_workers=` and the worker `advertised_address=`, as the
reference's do; the worker's `health=` registers its drain heartbeat,
its `perf=` its verified-request rate (utils/perf.py), and the pool's
`watch_health` its degraded-pool rule. `main()` is the standalone
worker process (`python -m corda_tpu_torch.node.verifier`), on a
CudaBatchVerifier unless `--cpu` asks for CpuBatchVerifier, with a
perf plane and, with `--profile-hz`, its sampling profiler.

The pool's `txstory` stamps every dispatch, redispatch, hedge, answer
and failure on the request's lifecycle story (utils/txstory.py). A
ring-fed worker's ring depth is `INGEST_WINDOW`.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Optional

from ..core import serialization as ser
from ..core.batch_verify import verify_ledger_batch
from ..core.transactions import LedgerTransaction, SignedTransaction
from ..crypto.batch_verifier import BatchSignatureVerifier, default_verifier
from ..utils import locks
from ..utils.metrics import MetricRegistry
from . import messaging as msglib
from .ingest import IngestPipeline, IngestRing
from .qos import DeadlineExpired
from .services import TransactionVerifierService, _Future

TOPIC_READY = "verifier.ready"
INGEST_WINDOW = 8192        # frames a ring-fed worker's ring holds


# ---------------------------------------------------------------------------
# wire API (reference: node-api/.../VerifierApi.kt:10-59)


@ser.serializable
@dataclass(frozen=True)
class TxVerificationRequest:
    """One transaction to verify.

    `ltx` is the resolved transaction (contract execution input); when
    `stx` is present the worker additionally batch-verifies its attached
    signatures on the card — the widening of the reference seam (which
    ships only the LedgerTransaction).

    `attempt` is the node-side dispatch incarnation of this nonce: a
    re-dispatch after a worker loss or timeout bumps it, the worker
    echoes it back, and the answer path only accepts the CURRENT
    incarnation — the at-least-once dedupe that lets the node safely
    re-send in-flight work to a survivor."""

    nonce: int
    ltx: LedgerTransaction
    response_address: str
    stx: Optional[SignedTransaction] = None
    attempt: int = 0


@ser.serializable
@dataclass(frozen=True)
class TxVerificationResponse:
    """Worker's reply: error is None on success, else `Type: message`
    (reference ships the serialized Throwable). `attempt` echoes the
    request's dispatch incarnation so a stale answer (computed by a
    worker the nonce was already re-dispatched away from) is rejected
    instead of racing the live one."""

    nonce: int
    error: Optional[str] = None
    attempt: int = 0


@ser.serializable
@dataclass(frozen=True)
class WorkerReady:
    """Worker attach announcement (the Artemis analogue is the broker
    seeing a consumer on `verifier.requests`; the point-to-point fabric
    makes attachment an explicit message). A TCP fabric's worker
    advertises its listen address; in-memory fabrics leave host/port
    empty."""

    worker: str
    host: str = ""
    port: int = 0


# ---------------------------------------------------------------------------
# node side


class VerificationFailedError(Exception):
    """Worker reported the transaction invalid."""


class VerificationTimeoutError(Exception):
    """The nonce's answer never arrived inside its deadline. Names the
    nonce, the worker it was last bound to and the elapsed time."""

    def __init__(self, nonce: int, worker: Optional[str], elapsed_micros: int):
        self.nonce = nonce
        self.worker = worker
        self.elapsed_micros = elapsed_micros
        super().__init__(
            f"verification of nonce {nonce} timed out after "
            f"{elapsed_micros / 1e6:.3f}s (last bound to worker "
            f"{worker or '<none attached>'})"
        )


class WorkerLostError(Exception):
    """Every dispatch attempt for this nonce died with its worker: the
    pool lost the workers faster than redispatch could recover."""

    def __init__(self, nonce: int, workers: list, attempts: int):
        self.nonce = nonce
        self.workers = list(workers)
        self.attempts = attempts
        super().__init__(
            f"nonce {nonce} lost {attempts} dispatch attempt(s) to dead "
            f"workers {self.workers}"
        )


@dataclass(frozen=True)
class RedispatchPolicy:
    """Self-healing knobs for the out-of-process pool.

    `lease_micros` — a worker from which no frame (a `WorkerReady` or
    an answer) has arrived within this window is considered dead and
    detached (its in-flight nonces re-dispatch to survivors).
    `attempt_timeout_micros` — one dispatch's answer deadline: past it
    the nonce re-dispatches (the bound worker may be alive but its
    answer lost, or it restarted within its lease), bumping the attempt
    so the late original answer is rejected. `request_timeout_micros`
    — the OVERALL per-nonce deadline; past it the future fails with a
    typed error instead of hanging. Redispatch after a worker LOSS waits a capped exponential
    backoff with +/- `backoff_jitter` (seeded, deterministic) so a
    flapping pool is not hammered in lockstep. `hedge_quantile` > 0
    additionally duplicates straggler nonces (older than that quantile
    of the observed duration histogram, floored at
    `hedge_min_micros`) onto a second worker — first valid answer
    wins."""

    lease_micros: int = 10_000_000
    attempt_timeout_micros: int = 5_000_000
    request_timeout_micros: int = 30_000_000
    backoff_base_micros: int = 100_000
    backoff_cap_micros: int = 2_000_000
    backoff_jitter: float = 0.25
    max_attempts: int = 4
    hedge_quantile: float = 0.0
    hedge_min_micros: int = 50_000


class _PendingVerify:
    """One in-flight nonce: its future, the full request (kept so a
    worker loss can re-dispatch it), the worker+attempt binding the
    answer path authenticates against, and the retry/hedge state the
    tick loop walks."""

    __slots__ = (
        "req", "fut", "t0", "enqueued_micros", "dispatched_micros",
        "worker", "attempt", "dispatches", "retry_at_micros",
        "hedged_to", "lost_workers",
    )

    def __init__(self, req, fut, t0: float, now_micros: int):
        self.req = req
        self.fut = fut
        self.t0 = t0
        self.enqueued_micros = now_micros
        self.dispatched_micros: Optional[int] = None
        self.worker: Optional[str] = None
        self.attempt = 0
        self.dispatches = 0
        self.retry_at_micros: Optional[int] = None
        self.hedged_to: Optional[str] = None
        self.lost_workers: list[str] = []


class OutOfProcessTransactionVerifierService(TransactionVerifierService):
    """Nonce→future handle map over the message fabric, self-healing.

    Reference: OutOfProcessTransactionVerifierService.kt:19-73 — same
    metric set: duration timer, success/failure meters, in-flight gauge
    (:34-46). Futures complete on the node's message pump thread when
    the matching response arrives.

    Workers hold LEASES renewed by periodic `WorkerReady` heartbeats;
    `tick()` — driven by the node pump — detaches lease-expired workers
    and re-dispatches their in-flight nonces to survivors with capped
    exponential backoff + jitter, answers are deduped by nonce→attempt
    binding (a stale incarnation's answer is rejected), stragglers can
    be hedged onto a second worker, and a nonce that exhausts its
    deadline fails with a typed VerificationTimeoutError /
    WorkerLostError instead of stranding.

    Threading model: the response/ready handlers may fire on a fabric's
    receive thread while `wait()` drives `tick()` from whichever thread
    owns the future. A single service lock therefore guards ALL pool
    state (`_pending`, `_workers`, `_leases`, `_buffer`, `_rr`,
    `_nonce`); the lock spans pure bookkeeping only — fabric sends and
    future resolutions (whose done-callbacks run arbitrary code) are
    collected under the lock and performed AFTER it is released, so no
    send happens under the service lock and no callback can re-enter
    it.
    """

    def __init__(
        self,
        messaging: msglib.MessagingService,
        metrics: Optional[MetricRegistry] = None,
        register_peer=None,   # Callable[[str, host, port], None] for TCP fabrics
        allowed_workers: Optional[set[str]] = None,
        clock=None,           # node clock for lease/timeout judgement;
        #                       None = wall micros. Rigs on a TestClock
        #                       MUST pass it.
        policy: Optional[RedispatchPolicy] = None,
    ):
        self._messaging = messaging
        self._register_peer = register_peer
        # only these authenticated peer names may join the pool; None
        # admits any authenticated peer (dev mode)
        self._allowed_workers = allowed_workers
        self._clock = clock
        self.policy = policy or RedispatchPolicy()
        self._rng = random.Random(0xFA17)   # jitter: seeded, deterministic
        # guards the pool state below; never held across a fabric
        # send, a register_peer callback or a future resolution
        self._lock = locks.make_lock(
            "OutOfProcessTransactionVerifierService._lock"
        )
        self._pending: dict[int, _PendingVerify] = {}
        self._workers: list[str] = []              # attach order (RR)
        self._leases: dict[str, int] = {}          # worker -> last-ready us
        self._incarnations: dict[str, int] = {}    # worker -> attach count
        self._rr = 0
        self._buffer: list[_PendingVerify] = []    # store-and-forward
        self._nonce = 0
        self._last_lost_micros: Optional[int] = None
        self.metrics = metrics or MetricRegistry()
        self._duration = self.metrics.timer(
            "TransactionVerifierService.Verification.Duration"
        )
        self._success = self.metrics.meter(
            "TransactionVerifierService.Verification.Success"
        )
        self._failure = self.metrics.meter(
            "TransactionVerifierService.Verification.Failure"
        )
        self._redispatched = self.metrics.meter("Verifier.Redispatched")
        self._hedged_meter = self.metrics.meter("Verifier.Hedged")
        self._workers_lost = self.metrics.meter("Verifier.WorkersLost")
        self.metrics.gauge(
            "TransactionVerifierService.VerificationsInFlight",
            lambda: len(self._pending),
        )
        # the pool state as gauges next to the duration histogram: is
        # the pool draining, buffering, or starved?
        self.metrics.gauge("Verifier.InFlight", lambda: len(self._pending))
        self.metrics.gauge("Verifier.Buffered", lambda: len(self._buffer))
        self.metrics.gauge("Verifier.Workers", lambda: len(self._workers))
        # transaction lifecycle ledger (utils/txstory.py): wired by
        # node.py / rigs; every dispatch / redispatch / hedge / answer
        # stamps a per-attempt event keyed by the transaction id
        self.txstory = None
        messaging.add_handler(msglib.TOPIC_VERIFIER_RES, self._on_response)
        messaging.add_handler(TOPIC_READY, self._on_ready)

    def _story_tx(self, entry: "_PendingVerify") -> Optional[str]:
        ltx = getattr(entry.req, "ltx", None)
        tid = getattr(ltx, "id", None)
        return str(tid) if tid is not None else None

    def _now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    # -- SPI ---------------------------------------------------------------

    def verify(
        self, ltx: LedgerTransaction, stx: Optional[SignedTransaction] = None
    ) -> _Future:
        """Ship `ltx` (and optionally the signature batch) to a worker.
        The returned future completes when the response message is
        pumped."""
        fut = _Future()
        with self._lock:
            self._nonce += 1
            nonce = self._nonce
            fut.nonce = nonce   # wait() names it in its typed timeout
            req = TxVerificationRequest(
                nonce, ltx, self._messaging.my_address, stx
            )
            entry = _PendingVerify(
                req, fut, time.perf_counter(), self._now_micros()
            )
            self._pending[nonce] = entry
            send = self._dispatch_locked(entry)
        self._send_all((send,) if send else ())
        return fut

    def wait(self, fut: _Future, timeout: float = 30.0) -> None:
        """Pump the fabric until `fut` completes, then raise/return its
        outcome. ONLY for callers that own the pump (tools, tests) —
        never from inside a flow handler, which already runs on the
        pump thread.

        Pump-less fabrics (the response handler fires on another
        thread) park on the future's condition variable with the
        remaining deadline. On deadline the wait raises a typed
        VerificationTimeoutError naming the nonce, its bound worker and
        the elapsed time."""
        pump = getattr(self._messaging, "pump", None)
        t_start = time.monotonic()
        deadline = t_start + timeout
        while not fut.done:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if pump is not None:
                pump(block=True, timeout=min(0.1, remaining))
                self.tick()
            else:
                fut.wait(remaining)
        if not fut.done:
            nonce = getattr(fut, "nonce", -1)
            entry = self._pending.get(nonce)
            raise VerificationTimeoutError(
                nonce,
                entry.worker if entry is not None else None,
                int((time.monotonic() - t_start) * 1e6),
            )
        fut.result()

    @property
    def worker_count(self) -> int:
        return len(self._workers)

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    @property
    def buffered(self) -> int:
        return len(self._buffer)

    def incarnation_of(self, worker: str) -> int:
        """How many times `worker` has attached (0 = never seen)."""
        return self._incarnations.get(worker, 0)

    # -- self-healing ------------------------------------------------------

    def tick(self, now: Optional[int] = None) -> None:
        """One self-healing pass, driven by the node pump (or a test
        clock): expire worker leases (detaching the dead and
        re-dispatching their in-flight nonces), time out / retry
        pending nonces, and hedge stragglers. Bookkeeping happens
        under the service lock; the collected sends and failure
        resolutions run after it releases."""
        if now is None:
            now = self._now_micros()
        pol = self.policy
        sends: list[tuple] = []
        failures: list[tuple] = []   # (future, typed exception)
        # the hedge threshold reads the duration histogram's own lock —
        # taken before the service lock, never under it
        hedge_after = self._hedge_after_micros()
        with self._lock:
            # 1 — lease expiry: a worker silent past its lease is dead
            for worker in [
                w for w in self._workers
                if now - self._leases.get(w, now) > pol.lease_micros
            ]:
                self._detach_worker_locked(worker, now)
            # 2 — per-nonce deadlines, retries, hedging
            for nonce, entry in list(self._pending.items()):
                elapsed = now - entry.enqueued_micros
                if elapsed > pol.request_timeout_micros:
                    failures.append(self._fail_locked(nonce, entry, elapsed))
                    continue
                if entry.worker is None:
                    # unbound (its worker died, or it never had one):
                    # retry once the backoff passes and a worker exists
                    if (
                        self._workers
                        and (
                            entry.retry_at_micros is None
                            or now >= entry.retry_at_micros
                        )
                    ):
                        self._retry_or_fail_locked(
                            nonce, entry, elapsed,
                            entry.lost_workers, sends, failures,
                        )
                    continue
                if (
                    pol.attempt_timeout_micros
                    and entry.dispatched_micros is not None
                    and now - entry.dispatched_micros
                    > pol.attempt_timeout_micros
                ):
                    # the bound worker is (or looks) alive but this
                    # attempt's answer never came — lost frame, or a
                    # same-name restart inside the lease. Re-dispatch
                    # NOW (prefer a different worker); the attempt bump
                    # rejects the original answer if it limps in later.
                    self._retry_or_fail_locked(
                        nonce, entry, elapsed,
                        entry.lost_workers + [entry.worker],
                        sends, failures,
                    )
                    continue
                if (
                    hedge_after is not None
                    and entry.hedged_to is None
                    and len(self._workers) > 1
                    and entry.dispatched_micros is not None
                    and now - entry.dispatched_micros >= hedge_after
                ):
                    send = self._hedge_locked(entry)
                    if send:
                        sends.append(send)
        # failures FIRST: _fail_locked already removed these nonces
        # from _pending, so if a fabric send raised before resolution
        # the futures could never complete — typed-error delivery must
        # not depend on the sends succeeding
        for fut, exc in failures:
            fut.set_exception(exc)
        self._send_all(sends)

    def _retry_or_fail_locked(
        self, nonce, entry, elapsed, exclude, sends, failures
    ) -> None:
        """Re-dispatch one unbound / attempt-timed-out nonce — or fail
        it once its attempts are spent — collecting the send or the
        typed failure for the caller to perform after the lock
        releases."""
        if entry.dispatches >= self.policy.max_attempts:
            failures.append(self._fail_locked(nonce, entry, elapsed))
            return
        self._redispatched.mark()
        send = self._dispatch_locked(entry, exclude=exclude)
        if send:
            sends.append(send)

    def _hedge_after_micros(self) -> Optional[int]:
        pol = self.policy
        if pol.hedge_quantile <= 0:
            return None
        q = 0.0
        hist = self._duration.histogram
        if hist.count:
            q = float(hist.quantile(pol.hedge_quantile)) * 1e6
        return max(int(q), pol.hedge_min_micros)

    def _hedge_locked(self, entry: _PendingVerify) -> Optional[tuple]:
        """Duplicate a straggler onto a different worker, SAME attempt:
        either copy's answer is valid, the first one wins, the other is
        deduped by the nonce having left the pending map. Returns the
        send for the caller to perform outside the lock."""
        others = [w for w in self._workers if w != entry.worker]
        if not others:
            return None
        worker = others[self._rr % len(others)]
        self._rr += 1
        entry.hedged_to = worker
        self._hedged_meter.mark()
        if self.txstory is not None:
            tid = self._story_tx(entry)
            if tid is not None:
                self.txstory.record(
                    tid, "verify.hedge",
                    attempt=entry.attempt, worker=worker,
                    nonce=entry.req.nonce,
                )
        return (msglib.TOPIC_VERIFIER_REQ, entry.req, worker)

    def _detach_worker_locked(self, worker: str, now: int) -> None:
        self._workers.remove(worker)
        self._leases.pop(worker, None)
        self._workers_lost.mark()
        self._last_lost_micros = now
        pol = self.policy
        for entry in self._pending.values():
            touched = entry.worker == worker
            if entry.hedged_to == worker:
                entry.hedged_to = None
            if not touched:
                continue
            entry.worker = None
            entry.lost_workers.append(worker)
            retries = len(entry.lost_workers)
            backoff = min(
                pol.backoff_cap_micros,
                pol.backoff_base_micros * (1 << (retries - 1)),
            )
            jitter = 1.0 + pol.backoff_jitter * (2 * self._rng.random() - 1)
            entry.retry_at_micros = now + int(backoff * jitter)

    def _fail_locked(
        self, nonce: int, entry: _PendingVerify, elapsed: int
    ) -> tuple:
        """Remove a dead nonce under the lock; the caller resolves the
        returned (future, exception) AFTER releasing it — set_exception
        runs done-callbacks, which must never fire under the service
        lock."""
        del self._pending[nonce]
        if entry in self._buffer:
            self._buffer.remove(entry)
        self._failure.mark()
        if entry.lost_workers and entry.worker is None:
            exc: Exception = WorkerLostError(
                nonce, entry.lost_workers, entry.dispatches
            )
        else:
            exc = VerificationTimeoutError(nonce, entry.worker, elapsed)
        if self.txstory is not None:
            tid = self._story_tx(entry)
            if tid is not None:
                self.txstory.record(
                    tid, "verify.failed",
                    attempt=entry.attempt, nonce=nonce,
                    error=type(exc).__name__,
                )
        return entry.fut, exc

    def watch_health(self, monitor) -> None:
        """Register the `verifier.pool_degraded` rule on a
        HealthMonitor (utils/health.py): fires while work is waiting
        with NO live worker, or within one lease window of a worker
        loss."""
        from ..utils.health import AlertRule

        def check(now: int):
            starved = (
                not self._workers
                and (self._pending or self._buffer)
            )
            healing = (
                self._last_lost_micros is not None
                and now - self._last_lost_micros <= self.policy.lease_micros
            )
            return bool(starved or healing), {
                "workers": len(self._workers),
                "in_flight": len(self._pending),
                "buffered": len(self._buffer),
                "workers_lost": self._workers_lost.count,
                "redispatched": self._redispatched.count,
            }

        monitor.add_rule(
            AlertRule(
                "verifier.pool_degraded", check,
                for_micros=0, clear_for_micros=0,
            )
        )

    # -- internals ---------------------------------------------------------

    def _dispatch_locked(
        self, entry: _PendingVerify, exclude: Optional[list] = None
    ) -> Optional[tuple]:
        """Bind (or buffer) one entry under the service lock; returns
        the (topic, request, target) send for the caller to encode and
        perform after release, or None when the entry was buffered."""
        if not self._workers:
            if entry not in self._buffer:
                self._buffer.append(entry)   # store-and-forward
            return None
        candidates = (
            [w for w in self._workers if w not in exclude] if exclude else []
        ) or self._workers
        worker = candidates[self._rr % len(candidates)]
        self._rr += 1
        redispatch = entry.dispatches > 0
        if redispatch:
            # a RE-dispatch is a new incarnation of the nonce: bump the
            # attempt so the previous worker's late answer is rejected
            entry.attempt += 1
            entry.req = replace(entry.req, attempt=entry.attempt)
        entry.worker = worker
        entry.hedged_to = None
        entry.dispatches += 1
        entry.dispatched_micros = self._now_micros()
        entry.retry_at_micros = None
        if self.txstory is not None:
            # per-attempt lifecycle events (memory-only append — safe
            # under the service lock): the story shows every worker
            # this nonce ever visited and why
            tid = self._story_tx(entry)
            if tid is not None:
                if redispatch:
                    self.txstory.record(
                        tid, "verify.redispatch",
                        attempt=entry.attempt, worker=worker,
                        nonce=entry.req.nonce,
                    )
                else:
                    self.txstory.record(
                        tid, "verify.dispatch",
                        attempt=entry.attempt, worker=worker,
                        nonce=entry.req.nonce,
                    )
        # the request REFERENCE is captured under the lock (the frozen
        # dataclass is only ever replaced, never mutated), so encoding
        # happens after release
        return (msglib.TOPIC_VERIFIER_REQ, entry.req, worker)

    def _send_all(self, sends) -> None:
        for topic, req, target in sends:
            self._messaging.send(topic, ser.encode(req), target)

    def _on_ready(self, msg: msglib.Message) -> None:
        ready = ser.decode(msg.payload)
        # The advertised worker name MUST be the fabric-authenticated
        # sender: a peer can only attach as itself.
        if ready.worker != msg.sender:
            return
        if (
            self._allowed_workers is not None
            and ready.worker not in self._allowed_workers
        ):
            return
        if ready.host and self._register_peer is not None:
            # every announcement refreshes the dial-back address (a
            # worker restarted on a new port within its lease), outside
            # the service lock and before the worker joins _workers, so
            # no nonce binds to a peer the fabric cannot resolve yet
            self._register_peer(ready.worker, ready.host, ready.port)
        now = self._now_micros()
        sends: list[tuple] = []
        with self._lock:
            self._leases[ready.worker] = now   # heartbeat = lease renewal
            if ready.worker not in self._workers:
                self._workers.append(ready.worker)
                self._incarnations[ready.worker] = (
                    self._incarnations.get(ready.worker, 0) + 1
                )
                # fresh capacity: flush the store-and-forward buffer,
                # then give any orphaned in-flight nonce (its worker
                # died while the pool was empty) a home without
                # waiting for the next tick
                buffered, self._buffer = self._buffer, []
                for entry in buffered:
                    send = self._dispatch_locked(entry)
                    if send:
                        sends.append(send)
                for entry in self._pending.values():
                    if entry.worker is None and entry not in self._buffer:
                        if entry.dispatches:
                            self._redispatched.mark()
                        send = self._dispatch_locked(
                            entry, exclude=entry.lost_workers
                        )
                        if send:
                            sends.append(send)
        self._send_all(sends)

    def _on_response(self, msg: msglib.Message) -> None:
        res: TxVerificationResponse = ser.decode(msg.payload)
        now = self._now_micros()
        with self._lock:
            # any frame of an attached worker proves it alive: under a
            # burst its WorkerReady waits behind its answers, so an answer
            # renews the lease too. A detached worker stays detached
            # until it re-announces (only _on_ready attaches).
            if msg.sender in self._workers:
                self._leases[msg.sender] = now
            entry = self._pending.get(res.nonce)
            if entry is None:
                return   # duplicate / already answered (at-least-once)
            if res.attempt != entry.attempt:
                return   # stale incarnation: re-dispatched since
            if msg.sender not in (entry.worker, entry.hedged_to):
                return   # only the bound (or hedge) worker may answer
            del self._pending[res.nonce]
        # resolution outside the lock: set_result/set_exception run
        # done-callbacks
        self._duration.update(time.perf_counter() - entry.t0)
        if self.txstory is not None:
            tid = self._story_tx(entry)
            if tid is not None:
                self.txstory.record(
                    tid, "verify.done",
                    attempt=entry.attempt, worker=msg.sender,
                    nonce=res.nonce, ok=res.error is None,
                )
        if res.error is None:
            self._success.mark()
            entry.fut.set_result()
        else:
            self._failure.mark()
            entry.fut.set_exception(VerificationFailedError(res.error))


# ---------------------------------------------------------------------------
# worker side


def request_ingest_pipeline(**kw) -> IngestPipeline:
    """An IngestPipeline configured for TxVerificationRequest frames:
    the envelope decodes in the pool, and the batched Merkle-id /
    staging stages run on the carried SignedTransaction (None for
    contract-only requests)."""
    return IngestPipeline(extract=lambda req: req.stx, **kw)


class VerifierWorker:
    """Standalone verification worker (reference: Verifier.kt:38-111).

    Handles `verifier.requests`: rebuilds nothing (the request is fully
    resolved), batch-verifies every attached signature across ALL queued
    requests in one `verify_batch` dispatch, runs contract verification,
    and replies per-request. With `batch_window=0` each message is
    processed as it is pumped; a positive window lets the fabric deliver
    several requests first so one dispatch covers them all.

    With no `batch_verifier` the worker takes `default_verifier()`, a
    CudaBatchVerifier on the card, which raises where there is none. A
    dispatch that raises answers every queued request
    `VerifierDispatchError: ...`; nothing is verified again on the host.

    With an `ingest` pipeline (node/ingest.py) attached, request frames
    route through the fabric's ring seam (messaging.add_ring) into the
    sharded decode pool; each round's transaction ids come from the
    batched Merkle-id stage, and `drain` consumes the PRE-STAGED
    signature requests the pipeline memoised at decode time. A
    malformed frame is dropped and metered (Verifier.Failed) in its
    slot; the rest of the round proceeds.

    `drain_seconds` keeps, per non-empty drain (the last 256), its
    requests, signature rows and host seconds: decode (the handler's
    per-frame decodes since the last drain, or the ingest pipeline's
    pass), dispatch (the `verify_batch` call), contract (the signature
    gate and the contract sweep) and answer (encoding and sending the
    responses).
    """

    def __init__(
        self,
        messaging: msglib.MessagingService,
        node_address: str,
        batch_verifier: Optional[BatchSignatureVerifier] = None,
        metrics: Optional[MetricRegistry] = None,
        batch_window: int = 0,
        advertised_address: Optional[tuple[str, int]] = None,
        ingest: Optional[IngestPipeline] = None,
        heartbeat_micros: int = 2_000_000,   # WorkerReady re-announce
        #                            cadence (lease renewal on the node
        #                            side); 0 disables heartbeats
        clock=None,                # node-clock source for deadline expiry;
        #                            None = wall clock; simulated-time rigs
        #                            MUST pass the TestClock that minted
        #                            their deadlines
        health=None,               # Optional[utils.health.HealthMonitor]:
        #                            a `verifier.drain` heartbeat the drain
        #                            beats (progress = requests answered,
        #                            queue depth = ring + handler backlog)
        perf=None,                 # Optional[utils.perf.PerfPlane]: the
        #                            worker's verified-request counter
        #                            becomes an in-process rate history
        #                            key, and an ingest pipeline built
        #                            with no plane reports its stage
        #                            seconds there
    ):
        self._messaging = messaging
        self._verifier = batch_verifier or default_verifier()
        self._clock = clock
        self._batch_window = batch_window
        self._queue: list[TxVerificationRequest] = []
        # handler-fed frames awaiting the ingest pipeline, as
        # (payload, trace header, deadline header)
        self._raw: list[tuple[bytes, Optional[tuple], Optional[int]]] = []
        self._decode_s = 0.0      # handler decodes since the last drain
        self.drain_seconds: deque = deque(maxlen=256)
        self.metrics = metrics or MetricRegistry()
        self._verified = self.metrics.meter("Verifier.Verified")
        self._failed = self.metrics.meter("Verifier.Failed")
        # deadline-expired frames dropped pre-decode (sheds are not
        # failures: the sender stopped wanting the answer)
        self._shed = self.metrics.meter("Verifier.Shed")
        self._batch_sizes = self.metrics.histogram("Verifier.BatchSize")
        self._ingest = ingest
        self._ring = None
        if ingest is not None:
            try:
                ring = IngestRing(depth=INGEST_WINDOW)
                # ring depth / high-water / parked gauges on this
                # worker's registry (messaging.register_ring_gauges)
                messaging.add_ring(
                    msglib.TOPIC_VERIFIER_REQ, ring, metrics=self.metrics
                )
                self._ring = ring
            except NotImplementedError:
                # fabric has no ring seam: the handler path below still
                # feeds the pipeline via self._raw
                pass
        if perf is not None:
            perf.watch_rate(
                "verifier_worker_verified_per_sec",
                lambda: self._verified.count,
            )
            if ingest is not None and getattr(ingest, "perf", None) is None:
                ingest.perf = perf
        self._heartbeat = None
        if health is not None:
            self._heartbeat = health.heartbeat(
                "verifier.drain",
                queue_depth=lambda: len(self._queue)
                + len(self._raw)
                + (len(self._ring) if self._ring is not None else 0),
            )
            if self._ring is not None:
                parked = getattr(self._messaging, "parked_count", None)
                health.watch_ring(
                    msglib.TOPIC_VERIFIER_REQ,
                    lambda: len(self._ring),
                    self._ring.depth,
                    parked_fn=(
                        (lambda: parked(msglib.TOPIC_VERIFIER_REQ))
                        if parked is not None else None
                    ),
                )
        messaging.add_handler(msglib.TOPIC_VERIFIER_REQ, self._on_request)
        # announce attachment so buffered requests flush to us. The
        # SAME announcement doubles as the lease heartbeat: the pump
        # loop re-sends it every `heartbeat_micros` (maybe_heartbeat).
        self._node_address = node_address
        self._advertised = advertised_address or ("", 0)
        self._heartbeat_micros = heartbeat_micros
        self._last_ready_micros = self._now_micros()
        self._send_ready()

    def _now_micros(self) -> int:
        if self._clock is not None:
            return self._clock.now_micros()
        return time.time_ns() // 1_000

    def _send_ready(self) -> None:
        self._messaging.send(
            TOPIC_READY,
            ser.encode(WorkerReady(self._messaging.my_address, *self._advertised)),
            self._node_address,
        )

    def maybe_heartbeat(self, now: Optional[int] = None) -> bool:
        """Re-announce WorkerReady when the heartbeat cadence is due
        (lease renewal). Called from the drain/pump loop; returns True
        when a heartbeat was sent."""
        if not self._heartbeat_micros:
            return False
        if now is None:
            now = self._now_micros()
        if now - self._last_ready_micros < self._heartbeat_micros:
            return False
        self._last_ready_micros = now
        self._send_ready()
        return True

    def _on_request(self, msg: msglib.Message) -> None:
        if self._ingest is not None:
            self._raw.append((msg.payload, msg.trace, msg.deadline))
            if len(self._raw) > self._batch_window:
                self.drain()
            return
        t0 = time.perf_counter()
        self._queue.append(ser.decode(msg.payload))
        self._decode_s += time.perf_counter() - t0
        if len(self._queue) > self._batch_window:
            self.drain()

    def _pull_ingested(self) -> None:
        """Move every waiting frame through the ingest pipeline into
        the request queue: ring frames first (fabric fast path), then
        handler-fed raw payloads. Each frame's trace header rides into
        the pipeline, and its deadline header too, so an expired
        request sheds PRE-DECODE."""
        payloads: list[bytes] = []
        traces: list = []
        deadlines: list = []
        if self._ring is not None:
            for m in self._ring.drain():
                payloads.append(m.payload)
                traces.append(m.trace)
                deadlines.append(m.deadline)
            # frames parked while the ring was full re-enter it for the
            # next drain — the backpressure release valve
            retry = getattr(self._messaging, "retry_parked", None)
            if retry is not None:
                retry(msglib.TOPIC_VERIFIER_REQ)
        for payload, trace, deadline in self._raw:
            payloads.append(payload)
            traces.append(trace)
            deadlines.append(deadline)
        self._raw = []
        if not payloads:
            return
        t0 = time.perf_counter()
        for e in self._ingest.ingest(
            payloads,
            trace_parents=traces,
            deadlines=deadlines,
            now_micros=(
                self._clock.now_micros() if self._clock is not None else None
            ),
        ):
            if isinstance(e.error, DeadlineExpired):
                self._shed.mark()     # shed, not failed
                continue
            if e.error is not None:
                self._failed.mark()   # malformed frame: its slot only
                continue
            self._queue.append(e.obj)
        self._decode_s += time.perf_counter() - t0

    def drain(self) -> int:
        """Process every queued request; one signature-batch dispatch
        covers all of them. Returns how many were processed."""
        self.maybe_heartbeat()
        if self._ingest is not None:
            self._pull_ingested()
        pending, self._queue = self._queue, []
        if not pending:
            if self._heartbeat is not None:
                self._heartbeat.beat()
            return 0
        t0 = time.perf_counter()
        sig_reqs, spans = [], []
        for req in pending:
            if req.stx is not None:
                rs = req.stx.signature_requests()
                spans.append((len(sig_reqs), len(rs)))
                sig_reqs.extend(rs)
            else:
                spans.append((0, 0))
        self._batch_sizes.update(len(sig_reqs))
        batch_error: Optional[str] = None
        sig_ok: list[bool] = []
        try:
            sig_ok = self._verifier.verify_batch(sig_reqs) if sig_reqs else []
        except Exception as e:
            # a failed batch dispatch (device lost, kernel error) must
            # still answer every queued request — silence would leave
            # all node-side futures hanging forever. No host fallback.
            batch_error = f"VerifierDispatchError: {type(e).__name__}: {e}"
        t1 = time.perf_counter()
        # the signature gate runs FIRST: a request with invalid
        # signatures must not reach contract execution at all — the
        # contract phase can run attachment-carried sandboxed code
        sig_errs: list[Optional[Exception]] = []
        for req, (off, n) in zip(pending, spans):
            err: Optional[Exception] = None
            if batch_error is None and req.stx is not None:
                try:
                    req.stx.raise_on_invalid(sig_ok[off : off + n])
                except Exception as e:  # noqa: BLE001 - reported per req
                    err = e
            sig_errs.append(err)
        # contract phase: grouped-by-contract across the sig-valid
        # requests (core/batch_verify.py), guarded: pending is already
        # detached from self._queue, so an escaping exception would
        # strand every node-side future
        contract_errs: list[Optional[Exception]] = [None] * len(pending)
        live = [
            i for i, e in enumerate(sig_errs)
            if batch_error is None and e is None
        ]
        if live:
            try:
                batch = verify_ledger_batch([pending[i].ltx for i in live])
                for i, cerr in zip(live, batch):
                    contract_errs[i] = cerr
            except Exception as e:  # noqa: BLE001 - answer, don't strand
                for i in live:
                    contract_errs[i] = e
        t2 = time.perf_counter()
        for req, serr, cerr in zip(pending, sig_errs, contract_errs):
            error = batch_error
            if error is None:
                e = serr or cerr
                if e is not None:
                    error = f"{type(e).__name__}: {e}"
            if error is None:
                self._verified.mark()
            else:
                self._failed.mark()
            self._messaging.send(
                msglib.TOPIC_VERIFIER_RES,
                ser.encode(TxVerificationResponse(req.nonce, error, req.attempt)),
                req.response_address,
            )
        t3 = time.perf_counter()
        self.drain_seconds.append({
            "requests": len(pending), "rows": len(sig_reqs),
            "decode": self._decode_s, "dispatch": t1 - t0,
            "contract": t2 - t1, "answer": t3 - t2,
        })
        self._decode_s = 0.0
        if self._heartbeat is not None:
            self._heartbeat.beat(progress=len(pending))
        return len(pending)


# ---------------------------------------------------------------------------
# standalone worker process (reference: Verifier.main, Verifier.kt:50-88)


def main(argv: Optional[list[str]] = None) -> None:
    """`python -m corda_tpu_torch.node.verifier --name w1 --node nodeA
    --node-host 127.0.0.1 --node-port 10001 --db /tmp/w1.db`

    Connects a fabric endpoint to the requesting node, announces
    readiness, and pumps until SIGINT. The verifier is built at start: a
    CudaBatchVerifier on the card, which raises where there is none, or
    CpuBatchVerifier with `--cpu`. The worker attributes itself on a
    perf plane (kernel accounting, drain-rate history) and, with
    `--profile-hz`, profiles its threads continuously; the folded
    stacks land in `--profile-out` (default `<db>.folded`) on exit. On
    exit the worker prints one line to stderr: the requests it answered
    and its drains.
    """
    import argparse
    import importlib
    import sys

    from ..crypto import schemes
    from ..crypto.batch_verifier import CpuBatchVerifier, CudaBatchVerifier
    from ..utils.health import HealthMonitor
    from ..utils.perf import PerfPlane, PerfPolicy
    from .cordapp import port_module_name
    from .fabric import FabricEndpoint, PeerAddress
    from .persistence import NodeDatabase

    p = argparse.ArgumentParser(description="out-of-process verifier worker")
    p.add_argument("--name", required=True)
    p.add_argument("--node", required=True, help="requesting node's name")
    p.add_argument("--node-host", default="127.0.0.1")
    p.add_argument("--node-port", type=int, required=True)
    p.add_argument("--db", required=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--cpu", action="store_true", help="use the CPU reference verifier"
    )
    p.add_argument("--batch-window", type=int, default=0)
    p.add_argument(
        "--ingest-shards",
        type=int,
        default=0,
        help="enable the pipelined wire-ingest path with this many "
        "decode shards (0 = per-message decode, the default)",
    )
    p.add_argument(
        "--profile-hz",
        type=float,
        default=0.0,
        help="continuous sampling-profiler rate over this worker's "
        "threads (utils/perf.py; 0 = off). Folded stacks are written "
        "to --profile-out on shutdown",
    )
    p.add_argument(
        "--profile-out",
        default="",
        help="where the folded collapsed stacks land on shutdown "
        "(flamegraph.pl format; default <db>.folded)",
    )
    p.add_argument(
        "--app",
        action="append",
        default=[],
        help="contract module(s) to import so their states/commands are "
        "codec-registered (the reference's names, `corda_tpu.` read as "
        "`corda_tpu_torch.`)",
    )
    args = p.parse_args(argv)

    for mod in args.app or ["corda_tpu.finance"]:
        importlib.import_module(port_module_name(mod))

    verifier = CpuBatchVerifier() if args.cpu else CudaBatchVerifier()
    keypair = schemes.generate_keypair(
        seed=args.seed if args.seed is not None else 1
    )
    db = NodeDatabase(args.db)
    node_addr = PeerAddress(args.node_host, args.node_port, None)
    ep = FabricEndpoint(
        args.name,
        keypair,
        db,
        resolve=lambda peer: node_addr if peer == args.node else None,
    )
    ep.start()
    ingest = (
        request_ingest_pipeline(shards=args.ingest_shards)
        if args.ingest_shards
        else None
    )
    # the drain heartbeat (and the ring rule) live on a HealthMonitor
    # ticked by the pump loop, so a wedged drain shows in-process
    health = HealthMonitor()
    # the worker attributes itself too: kernel first-call-vs-execute
    # accounting (its verifier records into the plane's process
    # default), drain-rate history, and with --profile-hz continuous
    # folded-stack profiling of the pump and decode-pool threads
    perf = PerfPlane(policy=PerfPolicy(profile_hz=args.profile_hz or 19.0))
    health.watch_perf(perf)
    if args.profile_hz:
        perf.profiler.start()
    worker = VerifierWorker(
        ep,
        args.node,
        batch_verifier=verifier,
        batch_window=args.batch_window,
        advertised_address=("127.0.0.1", ep.listen_port),
        ingest=ingest,
        health=health,
        perf=perf,
    )
    try:
        while True:
            ep.pump(block=True, timeout=1.0)
            worker.drain()
            health.tick()
            perf.tick()
    except KeyboardInterrupt:
        pass
    finally:
        perf.profiler.stop()
        if args.profile_hz and perf.profiler.samples:
            # the worker has no web gateway to serve the profile from:
            # the capture lands in a file
            out_path = args.profile_out or (args.db + ".folded")
            try:
                with open(out_path, "w") as f:
                    f.write(perf.profiler.collapsed() + "\n")
                print(f"profile: folded stacks -> {out_path}",
                      file=sys.stderr)
            except OSError as e:
                print(f"profile: could not write {out_path}: {e}",
                      file=sys.stderr)
        m = worker.metrics
        answered = m.meter("Verifier.Verified").count + m.meter("Verifier.Failed").count
        drains = m.histogram("Verifier.BatchSize").count
        print(f"verifier worker {args.name}: {answered} requests answered in {drains} "
              f"drains ({answered / max(drains, 1):.1f} requests per drain)",
              file=sys.stderr, flush=True)
        ep.stop()
        db.close()


if __name__ == "__main__":
    main()
