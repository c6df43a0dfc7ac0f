"""The flow seam the notary uses.

Port of the parts of corda_tpu/flows/api.py that node/notary.py needs:
the completable `FlowFuture` and `wait_future`, the generator step a
flow yields to suspend until a future resolves. FlowLogic, sessions and
the state machine are not ported yet: a caller drives a notary's
`process` generator by hand (`node/notary.py` `run_process`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..utils import locks


class FlowFuture:
    """Completable future (CordaFuture's role in the reference).
    Registration and resolution are lock-protected: the sharded notary's
    worker threads add done-callbacks while the pump thread resolves."""

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


@dataclass(frozen=True)
class _WaitFuture:
    """Suspend until a FlowFuture resolves; whoever runs the flow (the
    state machine, or node.notary.run_process) sends back its
    result."""

    future: FlowFuture


def wait_future(future: FlowFuture):
    """`result = yield from wait_future(fut)` from inside a flow (or a
    generator the flow delegates to)."""
    value = yield _WaitFuture(future)
    return value
