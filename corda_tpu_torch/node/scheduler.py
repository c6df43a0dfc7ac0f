"""Scheduler service: time-triggered flows from SchedulableState outputs.

Port of corda_tpu/node/scheduler.py, on the vault's `updates`
observers. A scheduled activity names its flow by the reference's class
tag (`corda_tpu.testing.flows.HeartbeatFlow`); it resolves in this
package (flows.api.class_from_tag).

Reference: `NodeSchedulerService` (node/.../services/events/
NodeSchedulerService.kt:43) watches vault outputs implementing
`SchedulableState` (core/.../contracts/Structures.kt), wakes at the
earliest `nextScheduledActivity`, and launches the requested flow via a
`FlowLogicRef`; `ScheduledActivityObserver` (node/.../services/events/
ScheduledActivityObserver.kt) feeds it from vault update streams.

Design differences from the reference (deliberate, TPU-host idiomatic):
- The schedule is *derived state*: it is rebuilt from the vault's
  unconsumed states at startup instead of persisted separately, so a
  crash can never leave the schedule out of sync with the ledger (the
  reference persists a requery table and replays it).
- The core is deterministic and pump-driven (`tick()`), matching the
  MockNetwork Ring-3 testing model; the real node wraps it in a
  background thread (`start()`/`stop()`).
"""

from __future__ import annotations

import heapq
import logging
import threading
from typing import Callable, Optional

from ..core.contracts import ScheduledActivity, SchedulableState, StateRef
from ..flows.api import class_from_tag
from ..utils import locks

log = logging.getLogger("corda_tpu_torch.scheduler")


def flow_from_ref(flow_tag: str, flow_args: tuple):
    """Instantiate a flow from its class tag + constructor args.

    The FlowLogicRef discipline (core/.../flows/FlowLogicRef.kt): a
    scheduled activity names a flow *class* and fully-serializable
    constructor arguments; we re-run the constructor, we never pickle
    live flow objects into states.
    """
    try:
        cls = class_from_tag(flow_tag)
    except ImportError:
        raise ValueError(f"cannot import scheduled flow {flow_tag!r}")
    return cls(*flow_args)


class NodeSchedulerService:
    """Watches the vault for SchedulableStates and launches their flows
    when due.

    `flow_starter(logic)` is the SMM's start_flow (the reference invokes
    via `ServiceHubInternal.startFlow` with `FlowInitiator.Scheduled`).

    Delivery is AT-LEAST-ONCE: a crash between flow start and state
    consumption re-fires the activity on restart (rebuild_from_vault
    sees the state unconsumed), and the reference has the same window.
    Scheduled flows must therefore re-check their trigger state on
    entry (see HeartbeatFlow's state_and_ref guard); a racing duplicate
    is ultimately stopped by the notary's double-spend check.
    """

    RETRY_BACKOFF_MICROS = 5_000_000

    def __init__(
        self,
        services,
        flow_starter: Callable[[object], object],
        *,
        flow_factory: Callable[[str, tuple], object] = flow_from_ref,
    ):
        self._services = services
        self._flow_starter = flow_starter
        self._flow_factory = flow_factory
        self._lock = locks.make_rlock("NodeSchedulerService._lock")
        self._scheduled: dict[StateRef, ScheduledActivity] = {}
        # min-heap of (scheduled_at, seq, ref); stale entries are lazily
        # discarded against _scheduled (the reference recomputes earliest
        # on every mutation; a heap keeps tick() O(due · log n))
        self._heap: list[tuple[int, int, StateRef]] = []
        self._seq = 0
        self._unsubscribe: Optional[Callable[[], None]] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._stop_evt = threading.Event()
        vault = services.vault
        vault.updates.append(self._on_vault_update)
        self._unsubscribe = lambda: (
            vault.updates.remove(self._on_vault_update)
            if self._on_vault_update in vault.updates
            else None
        )
        self.rebuild_from_vault()

    # -- schedule maintenance ----------------------------------------------

    def rebuild_from_vault(self) -> None:
        """Derive the full schedule from unconsumed vault states (crash
        recovery: the vault IS the persistent schedule)."""
        with self._lock:
            self._scheduled.clear()
            self._heap.clear()
            for sar in self._services.vault.unconsumed_states():
                self._consider(sar.ref, sar.state.data)

    def _consider(self, ref: StateRef, state) -> None:
        if not isinstance(state, SchedulableState):
            return
        try:
            activity = state.next_scheduled_activity(ref)
        except Exception:
            log.exception("next_scheduled_activity failed for %s", ref)
            return
        if activity is None:
            return
        with self._lock:
            self._scheduled[ref] = activity
            self._seq += 1
            heapq.heappush(self._heap, (activity.scheduled_at, self._seq, ref))

    def _on_vault_update(self, update) -> None:
        with self._lock:
            for sar in update.consumed:
                self._scheduled.pop(sar.ref, None)
        for sar in update.produced:
            self._consider(sar.ref, sar.state.data)
        # a new earliest activity must wake the sleeper early
        if self._thread is not None:
            self._stop_evt.set()

    # -- querying -----------------------------------------------------------

    def next_wakeup_micros(self) -> Optional[int]:
        """Earliest pending activity time, or None when idle."""
        return self._peek_next()

    def pending_count(self) -> int:
        return len(self._scheduled)

    # -- execution ----------------------------------------------------------

    def tick(self) -> int:
        """Launch every activity due at the current clock. Returns the
        number of flows started. Deterministic: ties launch in
        scheduling order. A flow that cannot be constructed or started
        stays scheduled and retries after RETRY_BACKOFF_MICROS (the
        state is still unconsumed — dropping it would silently desync
        the schedule from the vault)."""
        now = self._services.clock.now_micros()
        started = 0
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > now:
                    return started
                at, _, ref = heapq.heappop(self._heap)
                activity = self._scheduled.get(ref)
                if activity is None or activity.scheduled_at != at:
                    continue  # consumed or rescheduled since queueing
            try:
                logic = self._flow_factory(
                    activity.flow_tag, activity.flow_args
                )
                self._flow_starter(logic)
            except Exception:
                log.exception(
                    "scheduled flow %s failed to launch; retrying in %dus",
                    activity.flow_tag,
                    self.RETRY_BACKOFF_MICROS,
                )
                retry = ScheduledActivity(
                    activity.flow_tag,
                    activity.flow_args,
                    now + self.RETRY_BACKOFF_MICROS,
                )
                with self._lock:
                    # only re-arm if the state wasn't consumed meanwhile
                    if self._scheduled.get(ref) is activity:
                        self._scheduled[ref] = retry
                        self._seq += 1
                        heapq.heappush(
                            self._heap, (retry.scheduled_at, self._seq, ref)
                        )
                continue
            with self._lock:
                if self._scheduled.get(ref) is activity:
                    del self._scheduled[ref]
            started += 1

    # -- background driver (real node) --------------------------------------

    def start(self, poll_micros: int = 200_000) -> None:
        """Run tick() on a background thread, sleeping until the next
        activity (or poll_micros, whichever is sooner)."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._running = True

        def loop():
            while self._running:
                self.tick()
                nxt = self._peek_next()
                now = self._services.clock.now_micros()
                wait = poll_micros if nxt is None else max(0, nxt - now)
                self._stop_evt.wait(min(wait, poll_micros) / 1e6)
                self._stop_evt.clear()

        self._thread = threading.Thread(
            target=loop, name="corda-scheduler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def _peek_next(self) -> Optional[int]:
        with self._lock:
            while self._heap:
                at, _, ref = self._heap[0]
                activity = self._scheduled.get(ref)
                if activity is None or activity.scheduled_at != at:
                    heapq.heappop(self._heap)
                    continue
                return at
            return None
