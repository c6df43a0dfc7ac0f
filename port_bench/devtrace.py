"""The traced run's reading of a torch.profiler capture.

The capture's raw events (`prof.profiler.kineto_results.events()`) are
read as they are, without the profiler's Python event tree, which takes
minutes to build for a long window. From them:

- the window: the benchmark's own `bench.window` span on the host;
- device activity: every kernel, copy and fill on the card, by name;
- busy seconds: the union of device activity inside the window;
- idle gaps: the stretches of the window with nothing on the card, each
  named after the innermost host span open at its middle (the
  benchmark's `bench.submit` and `bench.result`, and inside them the
  program's own `corda_tpu.*` spans);
- kernel seconds: the summed device time of every kernel in the capture
  (the window and the drain after it), which is the verify program's,
  since the window runs nothing else on the card.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

DEVICE_ACTIVITY = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW_SPAN = "bench.window"
TOP = 10
SPAN_DEPTH = 256        # host spans looked back through for the one open at a time


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: float                   # every kernel of the capture, summed
    kernels: int
    device_ops: list = field(default_factory=list)    # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)     # [[host span, seconds]], longest first


def short_name(name: str) -> str:
    """A kernel's name without its argument list and leading `void`."""
    name = name.split("(", 1)[0].strip()
    return name[5:] if name.startswith("void ") else name


def _union(intervals) -> tuple[float, list]:
    """(covered length, merged intervals) of [(start, end)] sorted."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _innermost(spans, starts, t: float) -> str:
    """The name of the latest-starting host span open at t, among the
    SPAN_DEPTH that start last before it (spans nest a few deep)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - SPAN_DEPTH, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return "host.other"


def _kind(evt) -> str:
    """"user_annotation" (a host span), one of DEVICE_ACTIVITY, or ""
    for anything else, by the event's device and name: on the card a
    span's mirror is a user annotation, a copy's name starts with
    Memcpy, a fill's with Memset, and the rest are kernels."""
    on_card = "CUDA" in str(evt.device_type())
    if evt.is_user_annotation():
        return "" if on_card else "user_annotation"
    if not on_card:
        return ""
    name = evt.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def summarise(events) -> TraceSummary:
    """Read a capture's raw events (seconds throughout)."""
    host_spans, device = [], []
    window = None
    annotation_names = set()
    for evt in events:
        kind = _kind(evt)
        if not kind:
            continue
        start, end = evt.start_ns() / 1e9, evt.end_ns() / 1e9
        name = evt.name()
        if kind == "user_annotation":
            annotation_names.add(name)
            if name == WINDOW_SPAN:
                window = (start, end)
            else:
                host_spans.append((start, end, name))
        else:
            device.append((start, end, name, kind))
    # a span mirrored on the card's timeline is not device work
    device = [d for d in device if d[2] not in annotation_names]
    if window is None:
        raise RuntimeError(f"the capture holds no {WINDOW_SPAN} span")
    lo, hi = window
    inside = sorted((max(s, lo), min(e, hi)) for s, e, _, _ in device if e > lo and s < hi)
    busy, merged = _union(inside)
    gaps, at = [], lo
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    host_spans.sort()
    starts = [s for s, _, _ in host_spans]
    named = sorted(((_innermost(host_spans, starts, (a + b) / 2), b - a) for a, b in gaps),
                   key=lambda g: -g[1])
    by_name: dict = {}
    kernel_s, kernels = 0.0, 0
    for s, e, name, kind in device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
        if kind == "kernel":
            kernel_s += e - s
            kernels += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=hi - lo, busy_s=busy, kernel_s=kernel_s, kernels=kernels,
        device_ops=[[k, v] for k, v in ops],
        idle_gaps=[[k, v] for k, v in named[:TOP]],
    )
