"""Instrumented lock factory — the construction seam of the runtime
concurrency sanitizer (testing/sanitizer.py).

Port of corda_tpu/utils/locks.py. Every ``threading.Lock/RLock/
Condition`` constructor site of the port goes through
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition`,
passing the lock's STATIC identity — the reference's ``Class.attr`` /
``module.name`` string — so the port's runtime lock graph reads
name-for-name like the reference's.

Disarmed (the default, and the only production state) the factory
returns the raw ``threading`` primitive: zero wrapper, zero per-
acquisition overhead, nothing on the hot path but one module-global
read at CONSTRUCTION time. Armed — a monitor installed via
:func:`install_monitor`, normally by
``testing.sanitizer.ConcurrencySanitizer.arm()`` — subsequently
constructed locks are sanitized wrappers that report every
acquisition/release/wait to the monitor: per-thread held stacks,
acquisition-order edges, contention counts, hold times. Locks created
while disarmed stay raw forever (module-level singletons created at
import time are therefore never instrumented).

The monitor protocol (duck-typed; see ConcurrencySanitizer):

    check_blocking_acquire(lock)      before a BLOCKING acquire —
                                      the self-deadlock trap
    on_acquired(lock, wait_ns, contended)
    on_release(lock)                  just before the real release
    on_wait_release(cond) / on_wait_reacquired(cond)
                                      Condition.wait's release window

This module imports nothing of the port — it must be importable from
every leaf module (metrics, tracing, flows) without cycles.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# the process-wide monitor slot: None = disarmed (raw primitives)
_MONITOR = None


def install_monitor(monitor) -> None:
    """Arm (or, with None, disarm) the factory. Affects locks
    constructed AFTER the call; existing locks keep their nature."""
    global _MONITOR
    _MONITOR = monitor


def active_monitor():
    return _MONITOR


def make_lock(name: str):
    """A non-reentrant lock named by its static identity."""
    mon = _MONITOR
    if mon is None:
        return threading.Lock()
    return SanitizedLock(name, mon, reentrant=False)


def make_rlock(name: str):
    """A reentrant lock named by its static identity."""
    mon = _MONITOR
    if mon is None:
        return threading.RLock()
    return SanitizedLock(name, mon, reentrant=True)


def make_condition(name: str, lock=None):
    """A condition variable named by its static identity. `lock`, when
    given, may be a raw primitive or a SanitizedLock (its underlying
    primitive is shared; instrumentation stays with the wrapper that
    performs each operation)."""
    mon = _MONITOR
    if mon is None:
        return threading.Condition(lock)
    return SanitizedCondition(name, mon, lock)


class SanitizerDeadlockError(RuntimeError):
    """Raised by an armed monitor instead of letting the thread
    self-deadlock on a non-reentrant lock it already holds — the
    sanitizer's fail-fast analogue of a TSan abort."""


class SanitizedLock:
    """Lock/RLock wrapper reporting to the armed monitor.

    The contention probe is a non-blocking acquire first: success means
    the lock was free (uncontended fast path); failure counts one
    contention event and times the blocking wait."""

    __slots__ = ("name", "_monitor", "_inner", "reentrant")

    def __init__(self, name: str, monitor, reentrant: bool = False):
        self.name = name
        self._monitor = monitor
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = self._monitor
        if blocking:
            mon.check_blocking_acquire(self)
        if self._inner.acquire(False):
            mon.on_acquired(self, 0, False)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter_ns()
        got = (
            self._inner.acquire(True, timeout)
            if timeout is not None and timeout >= 0
            else self._inner.acquire(True)
        )
        if got:
            mon.on_acquired(self, time.perf_counter_ns() - t0, True)
        return got

    def release(self) -> None:
        self._monitor.on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def primitive(self):
        """The underlying threading primitive — the PHYSICAL lock.
        The monitor's self-deadlock trap compares primitives, not
        wrappers: a condition built over this lock is a different
        wrapper around the same deadlock."""
        return self._inner

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<Sanitized{kind} {self.name}>"


class SanitizedCondition:
    """Condition wrapper reporting to the armed monitor.

    ``wait()`` releases the underlying lock for its duration: the held
    stack must pop at wait entry and re-push at wake, or every span
    parked on the condition would read as a monster hold and every
    notifier's acquisition as a phantom order edge."""

    __slots__ = ("name", "_monitor", "_cond", "reentrant")

    def __init__(self, name: str, monitor, lock=None):
        self.name = name
        self._monitor = monitor
        if isinstance(lock, SanitizedLock):
            lock = lock._inner
        self._cond = threading.Condition(lock)
        # a default Condition is built over an RLock: nested
        # acquisition by the holding thread is LEGAL and must not
        # trip the self-deadlock trap — reentrancy follows the
        # underlying primitive, exactly like the raw passthrough
        self.reentrant = isinstance(
            self._cond._lock, type(threading.RLock())
        )

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        mon = self._monitor
        if blocking:
            mon.check_blocking_acquire(self)
        if self._cond.acquire(False):
            mon.on_acquired(self, 0, False)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter_ns()
        got = (
            self._cond.acquire(True, timeout)
            if timeout is not None and timeout >= 0
            else self._cond.acquire(True)
        )
        if got:
            mon.on_acquired(self, time.perf_counter_ns() - t0, True)
        return got

    def release(self) -> None:
        self._monitor.on_release(self)
        self._cond.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def primitive(self):
        """The underlying threading primitive (see
        SanitizedLock.primitive)."""
        return self._cond._lock

    def wait(self, timeout: Optional[float] = None) -> bool:
        # Condition._release_save releases EVERY re-entry level of an
        # RLock-backed condition: the monitor must close the whole
        # held entry (saved = the depth to restore at wake), or the
        # park would count into the hold span
        mon = self._monitor
        saved = mon.on_wait_release(self)
        try:
            return self._cond.wait(timeout)
        finally:
            mon.on_wait_reacquired(self, saved)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # threading.Condition.wait_for, routed through the
        # instrumented wait() so every park/wake is observed
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<SanitizedCondition {self.name}>"
