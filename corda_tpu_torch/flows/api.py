"""FlowLogic: the flow-author API.

Port of corda_tpu/flows/api.py. A flow's protocol tag travels in every
SessionInit frame and every checkpoint record, so it is the reference's
module path: `class_tag` names a class of this package by the path of
its reference counterpart (`corda_tpu.finance.cash.CashPaymentFlow`),
and `class_from_tag` maps such a tag back to this package's module of
the same path, never importing corda_tpu.

Reference: core/.../flows/FlowLogic.kt:38-264 — blocking-style `call()`
with send/receive/sendAndReceive/subFlow — plus the @InitiatingFlow /
@InitiatedBy registration annotations and ProgressTracker
(core/.../utilities/ProgressTracker.kt:35).

TPU-first design difference: the reference suspends JVM fibers with
Quasar and pickles their stacks (FlowStateMachineImpl.kt:384-392). Here
`call()` is a Python *generator*; every IO helper is used as
`yield from self.send(...)`, so suspension points are explicit in the
code and the state machine can replay a flow deterministically from its
event journal (see statemachine.py). Flows must therefore be
deterministic given (constructor state, journal) — the same discipline
the reference demands of contract code, extended to flows, and the
price of not having a fiber serializer.
"""

from __future__ import annotations

import importlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, Optional, Type

from ..core.identity import Party
from ..utils import locks


class FlowException(Exception):
    """Errors that propagate to counterparties (reference:
    core/.../flows/FlowException.kt)."""


class FlowSessionException(FlowException):
    """The counterparty's flow ended, rejected, or errored."""


class FlowTimeoutException(FlowException):
    """A timed receive expired (the sendAndReceiveWithRetry mechanism,
    FlowLogic.kt:108 — notary clients catch this and try another
    cluster member)."""


# ---------------------------------------------------------------------------
# IO requests — the only values a flow generator may yield.
# (Reference: node/.../statemachine/FlowIORequest.kt)


@dataclass(frozen=True)
class _Send:
    party: Party
    payload: Any
    logic: Any          # the FlowLogic that issued the request: a new
                        # session is opened under ITS @initiating_flow
                        # tag (sub-flows initiate their own protocols)


@dataclass(frozen=True)
class _Receive:
    party: Party
    expected: type
    logic: Any
    timeout_micros: Optional[int] = None


@dataclass(frozen=True)
class _SendAndReceive:
    party: Party
    payload: Any
    expected: type
    logic: Any
    timeout_micros: Optional[int] = None


@dataclass(frozen=True)
class _Record:
    """Journal the result of a nondeterministic host call (fresh keys,
    clock reads): runs live once, replays from the journal after."""

    fn: Callable[[], Any]


@dataclass(frozen=True)
class _WaitLedgerCommit:
    tx_id: Any


@dataclass(frozen=True)
class _WaitFuture:
    """Suspend until a FlowFuture resolves (the bridge from flows to
    async services: Raft commits, the verifier pool). The result is
    journaled, so a replayed flow returns the recorded value instead of
    re-waiting — the submission side effect must be idempotent."""

    future: "FlowFuture"


class FlowFuture:
    """Completable future resolved on the node's pump thread (services
    that finish later — Raft quorum, worker pools — hand these to
    flows; CordaFuture's role in the reference). Registration and
    resolution are lock-protected: the sharded notary's worker threads
    add done-callbacks (qos latency, span end) while the pump thread
    resolves, and an unlocked append racing the callback swap would
    silently drop the callback."""

    def __init__(self):
        self.done = False
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: list[Callable[["FlowFuture"], None]] = []
        self._lock = locks.make_lock("FlowFuture._lock")

    def set_result(self, value: Any) -> None:
        with self._lock:
            if self.done:
                return
            self.done = True
            self._value = value
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self.done:
                return
            self.done = True
            self._exc = exc
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def result(self) -> Any:
        if not self.done:
            raise RuntimeError("future not resolved")
        if self._exc is not None:
            raise self._exc
        return self._value

    def add_done_callback(self, cb: Callable[["FlowFuture"], None]) -> None:
        with self._lock:
            if not self.done:
                self._callbacks.append(cb)
                return
        cb(self)


def wait_future(future: FlowFuture):
    """`result = yield from wait_future(fut)` from inside any flow (or
    generator the flow delegates to)."""
    value = yield _WaitFuture(future)
    return value


@dataclass(frozen=True)
class _TrackStep:
    label: str


# ---------------------------------------------------------------------------
# class tags: the reference's module paths on the wire

_PORT_PREFIX = "corda_tpu_torch."
_REFERENCE_PREFIX = "corda_tpu."


def class_tag(cls) -> str:
    """`module.qualname` of a class, with this package's prefix written
    as the reference's, so frames and checkpoints equal the
    reference's bytes."""
    name = f"{cls.__module__}.{cls.__qualname__}"
    if name.startswith(_PORT_PREFIX):
        return _REFERENCE_PREFIX + name[len(_PORT_PREFIX):]
    return name


def class_from_tag(tag: str):
    """The class a tag names: a `corda_tpu.` tag resolves in this
    package's module of the same path; any other tag imports as it
    reads. Raises ImportError or AttributeError when nothing matches."""
    if tag.startswith(_REFERENCE_PREFIX):
        tag = _PORT_PREFIX + tag[len(_REFERENCE_PREFIX):]
    parts = tag.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
            break
        except ImportError:
            continue
    else:
        raise ImportError(f"cannot import {tag!r}")
    for part in parts[i:]:
        obj = getattr(obj, part)
    return obj


# ---------------------------------------------------------------------------
# registration decorators


_INITIATED_BY: dict[str, Callable[[Party], "FlowLogic"]] = {}


def initiating_flow(cls):
    """Mark a flow class as session-initiating; its tag names the
    session protocol (reference: core/.../flows/InitiatingFlow.kt)."""
    cls._initiating_tag = class_tag(cls)
    return cls


def initiating_tag_of(cls) -> str:
    tag = getattr(cls, "_initiating_tag", None)
    if tag is None:
        raise TypeError(f"{cls.__name__} is not an @initiating_flow")
    return tag


def initiated_by(initiating_cls):
    """Register the responder factory for an initiating flow
    (reference: core/.../flows/InitiatedBy.kt). The decorated class must
    take the initiating Party as its only constructor argument."""

    def wrap(cls):
        _INITIATED_BY[initiating_tag_of(initiating_cls)] = cls
        cls._initiated_by = initiating_cls
        return cls

    return wrap


def registered_initiated_flows() -> dict[str, Callable[[Party], "FlowLogic"]]:
    return dict(_INITIATED_BY)


class ProgressTracker:
    """Hierarchical progress steps streamed to observers (reference:
    core/.../utilities/ProgressTracker.kt:35; rendered by the shell and
    RPC feeds). Minimal v1: linear step list + change callbacks."""

    def __init__(self, *steps: str):
        self.steps = list(steps)
        self.current: Optional[str] = None
        self.observers: list[Callable[[str], None]] = []
        self.history: list[str] = []

    def set_step(self, label: str) -> None:
        self.current = label
        self.history.append(label)
        for cb in list(self.observers):
            cb(label)


class FlowLogic:
    """Base class for flows. Subclasses implement `call()` as a
    generator using the yield-from helpers below; plain-return call()
    is allowed for flows that do no IO."""

    progress_tracker: Optional[ProgressTracker] = None

    # injected by the state machine before the first step:
    _machine = None       # the FlowStateMachine driving this flow
    services = None       # the node's ServiceHub

    def call(self):
        raise NotImplementedError

    # -- IO helpers (use with `yield from`) ---------------------------------

    def send(self, party: Party, payload: Any):
        """Queue payload to the counterparty; does not wait for receipt
        (FlowLogic.kt:131)."""
        yield _Send(party, payload, self)

    def receive(
        self,
        party: Party,
        expected: type = object,
        timeout_micros: Optional[int] = None,
    ):
        """Wait for the next payload from the counterparty
        (FlowLogic.kt:89). The returned data is untrustworthy — the
        type is checked, the contents are the peer's claim. A timeout
        raises FlowTimeoutException (journaled, so replay re-raises)."""
        data = yield _Receive(party, expected, self, timeout_micros)
        return _checked(data, expected, party)

    def send_and_receive(
        self,
        party: Party,
        payload: Any,
        expected: type = object,
        timeout_micros: Optional[int] = None,
    ):
        """Send then wait for the reply (FlowLogic.kt:159)."""
        data = yield _SendAndReceive(
            party, payload, expected, self, timeout_micros
        )
        return _checked(data, expected, party)

    def sub_flow(self, logic: "FlowLogic"):
        """Run another flow inline, sharing this flow's sessions
        (FlowLogic.kt:211)."""
        logic._machine = self._machine
        logic.services = self.services
        result = logic.call()
        if inspect.isgenerator(result):
            result = yield from result
        return result

    def record(self, fn: Callable[[], Any]):
        """Journaled nondeterminism: `fn` runs once, live; on checkpoint
        replay its recorded result is returned instead. Use for fresh
        keys, clock reads, randomness."""
        value = yield _Record(fn)
        return value

    def wait_for_ledger_commit(self, tx_id):
        """Suspend until tx_id is in the validated-transaction store
        (FlowLogic.kt waitForLedgerCommit)."""
        stx = yield _WaitLedgerCommit(tx_id)
        return stx

    def step(self, label: str):
        """Advance the progress tracker (journald as a no-op event so
        replay stays aligned)."""
        yield _TrackStep(label)

    # -- convenience --------------------------------------------------------

    @property
    def our_identity(self) -> Party:
        return self.services.my_info.legal_identity

    @property
    def lock_id(self) -> bytes:
        """This flow's soft-lock id (= the flow id). Locks taken under
        it are released automatically when the flow ends — success OR
        failure (reference: VaultSoftLockManager's flow-lifecycle
        release)."""
        return self._machine.id

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


def _checked(data: Any, expected: type, party: Party) -> Any:
    if expected is not object and not isinstance(data, expected):
        raise FlowSessionException(
            f"{party} sent {type(data).__name__}, expected {expected.__name__}"
        )
    return data


def as_generator(result):
    """Normalise call() results: plain values become finished gens."""
    if inspect.isgenerator(result):
        return result

    def _g():
        return result
        yield  # pragma: no cover

    return _g()
