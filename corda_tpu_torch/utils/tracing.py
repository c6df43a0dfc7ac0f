"""Hot-path tracing: spans and the profiler annotation the notary uses.

Port of the parts of corda_tpu/utils/tracing.py that the batching
notary calls: `Tracer` with its `Span` (trace_id/span_id/parent links,
monotonic timestamps, attributes and events), the shared no-op span a
disabled tracer hands out, `get_tracer`/`set_tracer`, and `annotate`.
A trace completes when every span opened for its id has ended; the
tracer keeps the last `keep` completed traces in `completed`. The
reference's flight recorder, Chrome export and cross-node assembly wait
for Queue 1 #10.

`wire_trace` is the header a traced flow's session frames carry.

`annotate(name)` is `torch.profiler.record_function(name)`: the notary's
verify dispatch shows as a named region in a torch.profiler capture, so
host spans line up with the card's kernels.

Enable process-wide with CORDA_TPU_TRACE=1 (the default tracer is
disabled otherwise), or construct and set an explicit `Tracer`.
"""

from __future__ import annotations

import os
import random
import time
from collections import deque
from typing import Any, Optional

from . import locks


class SpanContext(tuple):
    """(trace_id, span_id) — the propagatable identity of a span."""

    __slots__ = ()

    def __new__(cls, trace_id: int, span_id: int):
        return super().__new__(cls, (int(trace_id), int(span_id)))

    @property
    def trace_id(self) -> int:
        return self[0]

    @property
    def span_id(self) -> int:
        return self[1]

    @classmethod
    def from_header(cls, header) -> Optional["SpanContext"]:
        """None-tolerant decode of a propagated header (a sequence of
        >= 2 ints, or None/malformed -> None)."""
        if header is None:
            return None
        try:
            return cls(int(header[0]), int(header[1]))
        except (TypeError, ValueError, IndexError):
            return None


class _NoopSpan:
    """The disabled-tracer span: every operation is a no-op and `bool()`
    is False, so call sites gate work with `if span:`."""

    __slots__ = ()

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attributes) -> None:
        pass

    def end(self, end_time: Optional[float] = None) -> None:
        pass

    @property
    def context(self) -> Optional[SpanContext]:
        return None

    @property
    def ended(self) -> bool:
        return True

    def __bool__(self) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed operation in a trace (time.perf_counter timestamps)."""

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "start", "end_time", "attributes", "events",
    )

    def __init__(self, tracer, name, trace_id, span_id, parent_id, start,
                 attributes=None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_time: Optional[float] = None
        self.attributes = attributes or {}
        self.events: list[tuple[float, str, dict]] = []

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes) -> None:
        self.events.append((time.perf_counter(), name, attributes))

    def end(self, end_time: Optional[float] = None) -> None:
        """Idempotent: the first end wins."""
        if self.end_time is not None:
            return
        self.end_time = end_time if end_time is not None else time.perf_counter()
        self._tracer._complete(self)

    @property
    def ended(self) -> bool:
        return self.end_time is not None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.end_time is None else self.end_time - self.start

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def __bool__(self) -> bool:
        return True


def wire_trace(parent) -> Optional[tuple]:
    """The fabric-header form of a trace context: `(trace_id, span_id,
    sent_at_us)`, `sent_at_us` the sender's time.perf_counter in
    microseconds at send time (the reference's receivers pair it with
    their arrival clock). Accepts a live Span, a SpanContext or a prior
    wire header (re-stamped for the new hop); None in, None out. The
    state machine stamps it on every frame of a traced flow."""
    if parent is None:
        return None
    ctx = parent.context if isinstance(parent, (Span, _NoopSpan)) \
        else SpanContext.from_header(parent)
    if ctx is None:
        return None
    return (ctx.trace_id, ctx.span_id, int(time.perf_counter() * 1e6))


class Tracer:
    """Span factory + per-trace assembly: a trace completes when every
    span opened for its id has ended (ref-counted, so a batch phase span
    may end after its root); `max_open_traces` bounds the in-flight
    table against spans never ended (the oldest trace is dropped)."""

    def __init__(self, enabled: bool = True, keep: int = 64,
                 max_open_traces: int = 4096):
        self.enabled = enabled
        self.completed: deque = deque(maxlen=max(1, keep))   # [Span] per trace
        self._lock = locks.make_lock("Tracer._lock")
        self._trace_salt = random.getrandbits(32) << 20
        self._span_salt = random.getrandbits(32) << 20
        self._next_trace = 0
        self._next_span = 0
        self._open: dict[int, list] = {}   # trace_id -> [spans, n_open]
        self._max_open = max(16, max_open_traces)

    def start_trace(self, name: str, parent=None, **attributes):
        """Root (or hop-continuation) span; with a propagated `parent`
        context the span joins that trace."""
        if not self.enabled:
            return NOOP_SPAN
        ctx = SpanContext.from_header(parent) if parent is not None else None
        if ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        else:
            with self._lock:
                self._next_trace += 1
                trace_id = self._trace_salt + self._next_trace
            parent_id = None
        return self._open_span(name, trace_id, parent_id, attributes)

    def start_span(self, name: str, parent, **attributes):
        """Child span under a live Span or a SpanContext (a None or
        no-op parent yields the no-op span)."""
        if not self.enabled:
            return NOOP_SPAN
        ctx = parent.context if isinstance(parent, (Span, _NoopSpan)) \
            else SpanContext.from_header(parent)
        if ctx is None:
            return NOOP_SPAN
        return self._open_span(name, ctx.trace_id, ctx.span_id, attributes)

    def span_at(self, name: str, parent, start: float, end: float, **attributes):
        """A pre-timed, completed child span: one batch phase interval
        attributed to every member's trace."""
        span = self.start_span(name, parent, **attributes)
        if span:
            span.start = start
            span.end(end)
        return span

    def _open_span(self, name, trace_id, parent_id, attributes) -> Span:
        with self._lock:
            self._next_span += 1
            span = Span(
                self, name, trace_id, self._span_salt + self._next_span,
                parent_id, time.perf_counter(),
                dict(attributes) if attributes else None,
            )
            state = self._open.get(trace_id)
            if state is None:
                if len(self._open) >= self._max_open:
                    self._open.pop(next(iter(self._open)))
                state = self._open[trace_id] = [[], 0]
            state[0].append(span)
            state[1] += 1
        return span

    def _complete(self, span: Span) -> None:
        with self._lock:
            state = self._open.get(span.trace_id)
            if state is None:
                return   # evicted from the open table
            state[1] -= 1
            if state[1] <= 0:
                del self._open[span.trace_id]
                self.completed.append(sorted(state[0], key=lambda s: s.start))


def annotate(name: str):
    """A named region in a torch.profiler capture."""
    import torch

    return torch.profiler.record_function(name)


_default_tracer: Optional[Tracer] = None
_default_lock = locks.make_lock("tracing._default_lock")


def get_tracer() -> Tracer:
    """The process-wide tracer: disabled unless CORDA_TPU_TRACE is set to
    a non-empty, non-'0' value at first use (or set_tracer installs an
    enabled one)."""
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer(
                    enabled=os.environ.get("CORDA_TPU_TRACE", "") not in ("", "0")
                )
    return _default_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    global _default_tracer
    with _default_lock:
        _default_tracer = tracer
