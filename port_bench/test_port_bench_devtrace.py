"""The trace reader on made-up events, classified as the profiler's raw
events are: by device and name."""

from __future__ import annotations

import pytest

from port_bench import devtrace


class Event:
    def __init__(self, name, start_us, end_us, where, annotation=False):
        self._n, self._s, self._e = name, start_us, end_us
        self._where, self._ann = where, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def end_ns(self):
        return int(self._e * 1000)

    def device_type(self):
        return "DeviceType.CUDA" if self._where == "card" else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann


def events():
    return [
        Event("bench.window", 0, 1000, "host", True),
        Event("bench.submit", 0, 300, "host", True),
        Event("bench.result", 600, 1000, "host", True),
        Event("bench.submit", 0, 300, "card", True),
        Event("cudaLaunchKernel", 100, 110, "host"),
        Event("Memcpy HtoD (Pinned -> Device)", 100, 150, "card"),
        Event("void wei_ladder_windowed_kernel(int const*)", 150, 550, "card"),
        Event("ecdsa_epilogue_kernel(int*)", 540, 560, "card"),
        Event("wei_ladder_windowed_kernel(int const*)", 1000, 1200, "card"),
    ]


def test_busy_idle_gaps_and_kernel_time():
    t = devtrace.summarise(events())
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(460e-6)          # 100..560, the window's part
    assert t.kernel_s == pytest.approx(620e-6)        # every kernel of the capture
    assert t.kernels == 3
    assert t.device_ops[0] == ["wei_ladder_windowed_kernel", pytest.approx(600e-6)]
    assert t.idle_gaps[0] == ["bench.result", pytest.approx(440e-6)]
    assert t.idle_gaps[1] == ["bench.submit", pytest.approx(100e-6)]


def test_a_capture_without_the_window_span_is_refused():
    with pytest.raises(RuntimeError, match="bench.window"):
        devtrace.summarise(events()[1:])
