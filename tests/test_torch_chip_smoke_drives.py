"""Rehearsals of chip_smoke.py's phases 12 (the load test, the demos and
the fuzzer) and 13 (the perf, device and wire planes) on the CPU at a
small size, and their checks fed wrong answers or readings."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import (  # noqa: E402,F401 - one_thread is a fixture
    SMALL_FIXTURE, _counted_plain_versions, one_thread)


def test_drives_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_drives end to end on the CPU at small depth: (a)
    the load test through four `verifier_backend = "cpu"` node processes,
    8 commands with both restarts and 5 empty flows, no command failed and
    the model the reference's for the seed; (b) the notary demo, batching
    (2 payments) and single (1), and (d) the trader demo, on MockNetwork's
    default verifier made CpuBatchVerifier; (c) the 30-tx corpus cut to 6
    and a 20-tx ledger's mutation through the card's path on the CPU
    (CudaBatchVerifier(device="cpu"), counted plain versions), every
    verdict its label. Every check and print of the phase runs; the three
    kernels of the path launch in (c)."""
    import torch
    from test_torch_loadtest import SOAK, command_stream

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.testing import mock_network

    monkeypatch.setattr(cs, "LOAD_COUNT", 8)
    monkeypatch.setattr(cs, "LOAD_EMPTY", 5)
    monkeypatch.setattr(cs, "DEMO_TXS", (("batching", 2), ("single", 1)))
    monkeypatch.setattr(cs, "FUZZ_CORPUS", (13, 6))
    monkeypatch.setattr(cs, "FUZZ_SCALE", (17, 20))
    monkeypatch.setattr(cs, "FUZZ_SAMPLE", 8)
    monkeypatch.setattr(mock_network, "CudaBatchVerifier", CpuBatchVerifier)
    _counted_plain_versions(monkeypatch)
    load, real = {}, cs.load_drive
    monkeypatch.setattr(cs, "load_drive", lambda root: load.update(
        real(root, "cpu", check_contexts=False)) or load)
    launches = cs.phase_drives(torch.device("cpu"), "cpu rehearsal")
    assert all(launches[k] > 0 for k in ("ed_ladder", "wei_ladder_windowed", "wei_ladder"))
    r = load["result"]
    assert (r.submitted, r.failed, r.reconciled) == (8, 0, True)
    want = command_stream("corda_tpu", cs.LOAD_SEED, ("Alice", "Bob", "Carol"), 8, SOAK)
    assert r.expected == load["totals"] == want["expected"]
    assert [n for n, _ in load["restarts"]] == [want["victims"][0], "Hub"]
    assert set(load["boot_s"]) == {"Hub", "Alice", "Bob", "Carol"}
    assert all(v > 0 for v in load["p50_s"].values()) and load["max_s"] >= load["p50_s"]["all"]
    assert load["empty"]["count"] == 5 and load["contexts"] == (0, None)
    out = capsys.readouterr().out
    for line in ("load test (12a): nodes booted", "notary demo batching (12b): 2 payments",
                 "notary demo single (12b): 1 payments", "every verdict its label",
                 "trader demo (12d): buyer 1 paper, seller 92000", "drives (ph. 12) launches"):
        assert line in out, line


def test_drive_checks_raise_on_a_wrong_answer(monkeypatch):
    """Each phase-12 check refuses a wrong answer: a verifier that accepts
    every row (12c), a notary demo whose transaction carries two notary
    signatures or whose card run differs from the CPU run (12b), a
    trader demo with no paper delivered (12d)."""
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu_torch.samples import notary_demo, trader_demo

    monkeypatch.setattr(cs, "FUZZ_CORPUS", (13, 4))
    monkeypatch.setattr(cs, "FUZZ_SCALE", (17, 4))
    monkeypatch.setattr(cs, "FUZZ_SAMPLE", 4)

    class AcceptsAll:
        def verify_batch(self, requests):
            return [True] * len(requests)

    with pytest.raises(RuntimeError, match="30-tx corpus against its labels"):
        cs.fuzz_drive(AcceptsAll(), CpuBatchVerifier())
    monkeypatch.setattr(cs, "DEMO_TXS", (("single", 1),))
    run = notary_demo.run
    monkeypatch.setattr(notary_demo, "run", lambda *a, **kw: (
        lambda out: ([s * 2 for s in out[0]], out[1]))(run(*a, **kw)))
    with pytest.raises(RuntimeError, match="notary signatures per transaction"):
        cs.notary_demo_drive(CpuBatchVerifier())
    calls = []

    def seeded(*a, **kw):
        calls.append(1)
        return run(*a, **{**kw, "seed": kw["seed"] + len(calls)})

    monkeypatch.setattr(notary_demo, "run", seeded)
    with pytest.raises(RuntimeError, match="differ from the CpuBatchVerifier run"):
        cs.notary_demo_drive(CpuBatchVerifier())
    monkeypatch.setattr(trader_demo, "run", lambda **kw: ([], 92_000))
    with pytest.raises(RuntimeError, match="buyer paper 0"):
        cs.trader_drive(CpuBatchVerifier())



def _fake_window(verifier, reqs, planes):
    """13b's profiler window without a card: the chunk verified as on the
    card, into ledgers of its own, with fixed figures in the keys the
    phase prints."""
    with cs._private_ledgers():
        verdicts = verifier.verify_batch(reqs)
    return {"rows": len(reqs), "verdicts": verdicts, "window_ms": 400.0,
            "capture_s": 0.4, "stop_s": 0.1, "read_s": 0.1,
            "kernels": 3, "kernel_ms": 2.0, "ladder_ms": 1.5, "ladder_share": 0.75,
            "ends_ms": 0.4, "busy_share": 0.005, "plane_busy_fraction": 0.9}


def test_telemetry_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_telemetry at 16 spends on the CPU: the card's path
    on the CPU (CudaBatchVerifier(device="cpu"), counted plain versions),
    a device plane with no device (the CPU node's sampler), one on/off
    pair, the profiler window stood in for (its verdicts still held to
    the flush's), and the profiled worker process on `--cpu`. Every other
    check and print of 13a-13d runs: one compile per key then executes
    only with 0 retraces, the device-0 ledger's dispatches (the two
    flushes and the window's chunk) and requests, the named constraint,
    every answer its label, the worker's exit 0 and its folded stacks."""
    import torch

    from corda_tpu_torch.testing.notary_fixture import build_fixture
    from corda_tpu_torch.utils import device_telemetry as dlib
    from corda_tpu_torch.utils import perf as plib

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    monkeypatch.setattr(cs, "TELEMETRY_PAIRS", 1)
    monkeypatch.setattr(cs, "TELEMETRY_WORKER", 8)
    monkeypatch.setattr(cs, "profile_window", _fake_window)
    kernels, devices = plib.get_kernel_accounting(), dlib.get_device_accounting()
    fx = build_fixture(16, **SMALL_FIXTURE)
    out = cs.phase_telemetry(torch.device("cpu"), "cpu rehearsal", fx,
                             sampler=dlib.DeviceSampler(lambda: []), cpu_worker=True)
    # the phase put the process ledgers back
    assert plib.get_kernel_accounting() is kernels and dlib.get_device_accounting() is devices
    assert out["launches"]["ed_ladder"] > 0 and out["launches"]["wei_ladder_windowed"] > 0
    assert out["capacity"] in ("host_pump", "device_compute", "transfer", "commit_plane")
    assert out["worker"]["stacks"] > 0 and out["worker"]["samples"] > 0
    printed = capsys.readouterr().out
    for line in ("telemetry (13a) first pass: 16 spends in",
                 "telemetry (13a) warm pass (13c's first planes-on flush): 16 spends",
                 "retraces 0", '"executes": 1', "telemetry (13a) device ledger cuda:0",
                 "telemetry (13a) capacity: binding", "telemetry (13a) wire (in-memory fabric, "
                 'both endpoints): {"frames_in": 32, "frames_out": 32',
                 "telemetry (13b) profiler window over one warm", "the device plane's busy "
                 "fraction (launch wall) for the same window 0.9000",
                 "telemetry (13c) planes on vs off, 1 interleaved pairs",
                 "min-of-walls overhead", "telemetry (13d) profiled worker (--profile-hz 19)",
                 "8 requests answered", "SIGINT exit 0", "telemetry (ph. 13) launches"):
        assert line in printed, line


def test_telemetry_checks_raise_on_a_wrong_reading(monkeypatch, one_thread):
    """13a refuses a verifier whose keys recompile after mark_warm (a
    retrace); 13b's window arithmetic: the busy share is the union of the
    kernel intervals, and a capture without device time is refused."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier
    from corda_tpu_torch.testing.notary_fixture import build_fixture
    from corda_tpu_torch.utils import device_telemetry as dlib

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "CHUNK", 16)
    monkeypatch.setattr(cs, "NOTARY_SAMPLE", 8)
    real = cs._recording_verifier

    def forgetful(batch_sizes, device):
        v = real(batch_sizes, device)
        inner = v.verify_batch_async

        def cold(requests):
            v._warm_shapes.clear()      # every call a first call: retraces
            return inner(requests)

        v.verify_batch_async = cold
        return v

    monkeypatch.setattr(cs, "_recording_verifier", forgetful)
    monkeypatch.setattr(cs, "profile_window", _fake_window)
    fx = build_fixture(8, **SMALL_FIXTURE)
    with pytest.raises(RuntimeError, match="after mark_warm the keys recompiled"):
        cs.phase_telemetry(torch.device("cpu"), "cpu", fx,
                           sampler=dlib.DeviceSampler(lambda: []), cpu_worker=True)
    assert isinstance(cs._recording_verifier((4,), "cpu"), CudaBatchVerifier)

    from torch.autograd import DeviceType

    def evt(start, end, device_type, name="k", annotation=False):
        """A raw profiler event (µs in, ns out, as kineto gives them)."""
        return SimpleNamespace(start_ns=lambda: start * 1000, end_ns=lambda: end * 1000,
                               device_type=lambda: device_type, name=lambda: name,
                               is_user_annotation=lambda: annotation)

    events = [evt(0, 100, DeviceType.CPU), evt(10, 30, DeviceType.CUDA, "ed_ladder_kernel"),
              evt(20, 40, DeviceType.CUDA), evt(60, 70, DeviceType.CUDA),
              evt(5, 95, DeviceType.CUDA, "corda_tpu.verify_dispatch.s4.b16", True)]
    window, kernels = cs._kernel_intervals(events)
    assert window == 100 and len(kernels) == 3     # the annotation is not device work
    assert cs._union_us(kernels) == 40     # 10-40 and 60-70
    assert cs._kernel_intervals([evt(0, 5, DeviceType.CPU)]) == (5, [])


def test_profile_window_on_the_cpu(monkeypatch):
    """13b's window on the CPU: the profiler records the CPU side only, so
    the capture is refused for holding no device time; with device
    activity stood in for, the window's own device plane reads the
    chunk's launch wall as busy (its ledger anchored before the launch),
    and the flushes' process ledgers are left as they were."""
    import torch
    from test_torch_perf import stub_kernels

    from corda_tpu_torch.crypto import schemes
    from corda_tpu_torch.crypto.batch_verifier import CudaBatchVerifier, VerificationRequest
    from corda_tpu_torch.utils import device_telemetry as dlib

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    stub_kernels(monkeypatch)
    kp = schemes.generate_keypair(schemes.EDDSA_ED25519_SHA512, seed=3)
    reqs = [VerificationRequest(kp.public, kp.private.sign(b"m"), b"m")] * 3
    verifier = CudaBatchVerifier(batch_sizes=(4,), device="cpu")
    planes = SimpleNamespace(device=SimpleNamespace(sampler=dlib.DeviceSampler(lambda: [])))
    before = dlib.get_device_accounting().snapshot()
    with pytest.raises(RuntimeError, match="no device time in the capture"):
        cs.profile_window(verifier, reqs, planes)
    monkeypatch.setattr(cs, "_kernel_intervals", lambda events: (
        1000.0, [(0.0, 10.0, "ed_ladder_kernel"), (5.0, 30.0, "k")]))
    win = cs.profile_window(verifier, reqs, planes)
    assert win["verdicts"] == [True] * 3 and win["kernels"] == 2
    assert win["busy_share"] == pytest.approx(0.03) and win["ladder_share"] == pytest.approx(10 / 35)
    assert 0 < win["plane_busy_fraction"] <= 1
    assert dlib.get_device_accounting().snapshot() == before
