"""Rehearsals of chip_smoke.py's phase 18 (the fleet soak, its fault arc
and DemoBench with the explorer) on the CPU, over CPU verifiers, and
its checks fed wrong answers."""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import _RecordingCpu  # noqa: E402


class _CardLikeCpu(_RecordingCpu):
    """The recording CPU verifier named as if it ran on the card: the
    fleet then takes the card's side of divergence D10 (no degraded
    fallback, device_fault refused)."""

    def __init__(self, *args, **kw):
        import torch

        super().__init__(*args, **kw)
        self.device = torch.device("cuda", 0)


def test_tools_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_tools with the recording verifier on the CPU (as
    if on the card) and DemoBench's nodes on verifier_backend = "cpu":
    18a reconciles and equals the CpuBatchVerifier soak's records, 18b's
    pool and accounting hold and device_fault is refused, 18c's steps
    match their expect sequence; and the phase's last check, that
    wei_ladder_windowed launched, refuses a run in which no kernel did."""
    import torch

    from corda_tpu_torch.utils import device_telemetry

    monkeypatch.setattr(cs, "_recording_verifier", _CardLikeCpu)
    monkeypatch.setattr(device_telemetry, "cuda_devices", device_telemetry.host_devices)
    monkeypatch.setattr(cs, "demobench_drive", functools.partial(
        cs.demobench_drive, backend="cpu", check_contexts=False))
    with pytest.raises(RuntimeError, match="wei_ladder_windowed was not launched in the tools"):
        cs.phase_tools(torch.device("cpu"), "cpu rehearsal")
    out = capsys.readouterr().out
    for line in ("fleet (18a): 1024 clients (", "reconciled with the SLO, the brownout and the "
                 "health story", "records equal to the CpuBatchVerifier soak's",
                 "fault arc (18b): outcomes", "on the card (D10), worker 0 lost",
                 "none unresolved", "refused (D2) for the default and recording verifier",
                 "demobench (18c): Hub, Alice and Bob up through /api/bench/add",
                 "6 simulation steps [\"issue", "the feed matching their expect sequence",
                 "equal to a vault query", "SIGTERM exits 0"):
        assert line in out, line


def test_tools_checks_refuse_wrong_answers(monkeypatch, tmp_path):
    """The phase refuses card records that differ from the CPU soak's; 18b
    refuses a fleet that does not refuse device_fault over the card; 18c's
    expectation refuses an idle step."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    fault_arc = cs.fault_arc
    monkeypatch.setattr(cs, "_recording_verifier", _CardLikeCpu)
    monkeypatch.setattr(cs, "fault_arc", lambda v: {})
    monkeypatch.setattr(cs, "_cpu_drive", lambda code, root: None)
    monkeypatch.setattr(cs, "_cpu_drive_result",
                        lambda proc, timeout, label: {"records": [[0, "C0", "x", "signed"]]})
    monkeypatch.setattr(cs, "fleet_soak", lambda v: {"records": [[0, "C0", "x", "conflict"]]})
    with pytest.raises(RuntimeError, match=r"fleet \(18a\): the card's records differ"):
        cs.phase_tools(torch.device("cpu"), "cpu rehearsal")
    with pytest.raises(RuntimeError, match=r"fault arc \(18b\): a device_fault soak over the "
                       "recording card verifier was not refused"):
        fault_arc(CpuBatchVerifier())
    with pytest.raises(RuntimeError, match="the simulation idled"):
        cs._step_expectation("idle (no peers / no balance)")
