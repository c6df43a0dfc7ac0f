"""Metrics registry: counters, meters, timers, histograms, gauges.

Port of corda_tpu/utils/metrics.py. Reference: the node's dropwizard
`MetricRegistry` held by `MonitoringService`
(node/.../services/api/MonitoringService.kt:11), exported over JMX
there and as Prometheus text here.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Optional

from . import locks


def _sanitize(name: str) -> str:
    """Dotted dropwizard-style names -> prometheus metric names."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


class Counter:
    """Monotonic-or-not integer count."""

    def __init__(self):
        self._lock = locks.make_lock("Counter._lock")
        self._count = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    def dec(self, n: int = 1) -> None:
        self.inc(-n)

    @property
    def count(self) -> int:
        return self._count


class Meter:
    """Event rate: total count + exponentially-weighted 1-minute rate
    (dropwizard Meter's role; one EWMA instead of three)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = locks.make_lock("Meter._lock")
        self._clock = clock
        self._count = 0
        self._start = clock()
        self._last = self._start
        self._ewma: Optional[float] = None   # events/sec

    def mark(self, n: int = 1) -> None:
        with self._lock:
            now = self._clock()
            dt = now - self._last
            self._count += n
            if dt > 0:
                inst = n / dt
                if self._ewma is None:
                    self._ewma = inst
                else:
                    alpha = 1.0 - math.exp(-dt / 60.0)
                    self._ewma += alpha * (inst - self._ewma)
                self._last = now

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean_rate(self) -> float:
        elapsed = self._clock() - self._start
        return self._count / elapsed if elapsed > 0 else 0.0

    @property
    def one_minute_rate(self) -> float:
        """EWMA decayed to 'now' on read: with no events since the last
        mark the instantaneous rate is 0, so the average decays by
        exp(-idle/60) instead of freezing at burst level (dropwizard
        ticks its EWMA on read for the same reason)."""
        if self._ewma is None:
            return 0.0
        idle = self._clock() - self._last
        return self._ewma * math.exp(-max(idle, 0.0) / 60.0)


class Histogram:
    """Streaming distribution: count/min/max/mean + reservoir quantiles."""

    RESERVOIR = 1024

    def __init__(self):
        self._lock = locks.make_lock("Histogram._lock")
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._reservoir: list[float] = []

    def update(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)
            if len(self._reservoir) < self.RESERVOIR:
                self._reservoir.append(value)
            else:
                # deterministic-ish replacement keyed off the count
                idx = (self._count * 2654435761) % self.RESERVOIR
                self._reservoir[idx] = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def sum(self) -> float:
        """The true running sum — what the Prometheus `_sum` series
        exports. Reconstructing it as mean * count round-trips through
        a float division and drifts under load (mean is _sum/_count, so
        mean * count != _sum once the division is inexact)."""
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._reservoir:
                return 0.0
            vals = sorted(self._reservoir)
            idx = min(len(vals) - 1, int(q * len(vals)))
            return vals[idx]


class Timer:
    """Duration histogram (seconds) + throughput meter."""

    def __init__(self):
        self.histogram = Histogram()
        self.meter = Meter()

    def update(self, seconds: float) -> None:
        self.histogram.update(seconds)
        self.meter.mark()

    def time(self) -> "_TimerContext":
        return _TimerContext(self)

    @property
    def count(self) -> int:
        return self.histogram.count


class _TimerContext:
    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.update(time.perf_counter() - self._t0)
        return False


class MetricRegistry:
    """Named metric registry (reference: com.codahale MetricRegistry)."""

    def __init__(self):
        self._lock = locks.make_lock("MetricRegistry._lock")
        self._metrics: dict[str, Any] = {}

    def _get_or_create(self, name: str, cls, factory=None):
        m = self._metrics.get(name)
        if m is None:
            # construct OUTSIDE the lock: `factory` is arbitrary user
            # code (dynamic dispatch the static blocking pass cannot
            # see through, and the runtime sanitizer measured on the
            # pump-hot registry lock) — a losing race wastes one
            # short-lived object, which is cheaper than serializing
            # every registration behind a caller-supplied constructor
            fresh = (factory or cls)()
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = fresh
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(f"{name} already registered as {type(m)}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get_or_create(name, Meter)

    def timer(self, name: str) -> Timer:
        return self._get_or_create(name, Timer)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def gauge(self, name: str, fn: Callable[[], float]) -> None:
        # the error counter exists before the lock is taken (counter()
        # acquires it too — the registry lock is not reentrant)
        errors = self.counter(GAUGE_ERRORS)
        with self._lock:
            self._metrics[name] = _Gauge(fn, name=name, errors=errors)

    def get(self, name: str) -> Any:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- export -------------------------------------------------------------

    def to_prometheus(self) -> str:
        """Render every metric in Prometheus text exposition format."""
        lines: list[str] = []
        for name in self.names():
            m = self._metrics[name]
            p = _sanitize(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {p} counter")
                lines.append(f"{p} {m.count}")
            elif isinstance(m, _Gauge):
                lines.append(f"# TYPE {p} gauge")
                lines.append(f"{p} {m.value()}")
            elif isinstance(m, Meter):
                lines.append(f"# TYPE {p}_total counter")
                lines.append(f"{p}_total {m.count}")
                lines.append(f"# TYPE {p}_rate_1m gauge")
                lines.append(f"{p}_rate_1m {m.one_minute_rate:.6f}")
            elif isinstance(m, Histogram):
                lines.extend(_histo_lines(p, m))
            elif isinstance(m, Timer):
                lines.append(f"# TYPE {p}_total counter")
                lines.append(f"{p}_total {m.count}")
                lines.extend(_histo_lines(p + "_seconds", m.histogram))
        return "\n".join(lines) + "\n"


def _histo_lines(p: str, h: Histogram) -> list[str]:
    return [
        f"# TYPE {p} summary",
        f'{p}{{quantile="0.5"}} {h.quantile(0.5):.9f}',
        f'{p}{{quantile="0.95"}} {h.quantile(0.95):.9f}',
        f'{p}{{quantile="0.99"}} {h.quantile(0.99):.9f}',
        f"{p}_sum {h.sum:.9f}",
        f"{p}_count {h.count}",
    ]


# a gauge whose fn raises still renders (NaN), but the failure is no
# longer silent: this counter moves on /metrics and the FIRST failure
# per gauge logs with the exception — a dashboard of quiet NaNs
# otherwise looks exactly like "nothing to report", forever
GAUGE_ERRORS = "Metrics.GaugeErrors"


class _Gauge:
    def __init__(
        self,
        fn: Callable[[], float],
        name: str = "",
        errors: Optional[Counter] = None,
    ):
        self._fn = fn
        self._name = name
        self._errors = errors
        self._logged = False

    def value(self) -> float:
        try:
            return float(self._fn())
        except Exception as e:
            if self._errors is not None:
                self._errors.inc()
            if not self._logged:
                self._logged = True   # first failure only: no log storm
                import logging

                logging.getLogger("corda_tpu_torch.metrics").warning(
                    "gauge %s failed (returning NaN): %r",
                    self._name or "<unnamed>", e,
                )
            return float("nan")
