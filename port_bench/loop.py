"""The closed loop that drives the SPI for a window.

Each caller keeps `in_flight` calls outstanding on its own verifier: it
submits a call (`verify_batch_async`), and once `in_flight` are out it
waits for the oldest (`result()`) and then submits the next, as a
batching notary or a pool worker waits for its answers. A call is timed
from the start of its submission to the return of its last answer. A
call that completes after the window's end is drained and checked, but
not counted.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional


@dataclass
class Call:
    caller: int
    layout: int
    rows: int
    t_submit: float
    t_submitted: float
    t_done: float = 0.0
    stage_s: float = 0.0
    device_s: float = 0.0
    answers: object = None          # bytes of 0/1, or the answers as returned
    error: Optional[str] = None
    in_window: bool = False


def _pack(answers):
    """The answers as bytes where each is a bool (or 0/1), else as given."""
    try:
        return bytes(answers)
    except (TypeError, ValueError):
        return tuple(answers)


def _caller(k: int, verifier, calls: list, deadline: float, in_flight: int, span,
            out: list, first_layout: int, stride: int) -> None:
    """One caller's loop; it stops submitting at its first failed call."""
    pending = deque()
    nth = 0

    def submit() -> bool:
        nonlocal nth
        layout = (first_layout + nth * stride) % len(calls)
        nth += 1
        t0 = time.perf_counter()
        try:
            with span("bench.submit"):
                handle = verifier.verify_batch_async(calls[layout])
        except Exception as e:      # noqa: BLE001 - a failed call is counted, not fatal
            rec = Call(k, layout, len(calls[layout]), t0, time.perf_counter(),
                       error=f"{type(e).__name__}: {e}")
            out.append(rec)
            return False
        pending.append((Call(k, layout, len(calls[layout]), t0, time.perf_counter()), handle))
        return True

    def complete() -> bool:
        rec, handle = pending.popleft()
        try:
            with span("bench.result"):
                answers = handle.result()
            rec.t_done = time.perf_counter()
            rec.stage_s = float(getattr(handle, "stage_seconds", 0.0))
            rec.device_s = float(handle.device_seconds())
            rec.answers = _pack(answers)
        except Exception as e:      # noqa: BLE001
            rec.t_done = time.perf_counter()
            rec.error = f"{type(e).__name__}: {e}"
        rec.in_window = rec.t_done <= deadline
        out.append(rec)
        return rec.error is None

    ok = True
    while ok and time.perf_counter() < deadline:
        while ok and len(pending) < in_flight and time.perf_counter() < deadline:
            ok = submit()
        if pending:
            ok = complete()
    while pending:
        complete()


def run(verifiers: list, calls: list, seconds: float, in_flight: int, *,
        traced: bool = False) -> list:
    """Drive every verifier (one caller each) over the call layouts
    `calls` (lists of requests) for `seconds`; returns every Call.
    Caller k takes layouts k, k + callers, ... in turn. With `traced`,
    the window and each submission and wait are torch.profiler spans."""
    if traced:
        from torch.profiler import record_function as span
    else:
        def span(_name):
            return nullcontext()
    out: list = []
    deadline = time.perf_counter() + seconds
    with span("bench.window"):
        if len(verifiers) == 1:
            _caller(0, verifiers[0], calls, deadline, in_flight, span, out, 0, 1)
        else:
            threads = [threading.Thread(
                target=_caller, name=f"caller-{k}",
                args=(k, v, calls, deadline, in_flight, span, out, k, len(verifiers)))
                for k, v in enumerate(verifiers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    return out
