"""Rehearsals of chip_smoke.py's phase 17 (the IRS demo with its rate
oracle, the network simulation, the SIMM demo, its web API and the SIMM
analytics) on the CPU at a small size, over CPU verifiers, and its
checks fed wrong answers."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import _RecordingCpu  # noqa: E402


def test_samples_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.phase_samples over a recording CpuBatchVerifier, the
    analytics at 4,096 portfolios on the CPU: 17a's fixings and refusals,
    17b's trace, 17c's valuation and 17d's web answers equal to a
    CpuBatchVerifier run's, the analytics within their tolerance; and the
    phase's last check, that ed_ladder launched, refuses a run in which
    no kernel did."""
    import torch

    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    monkeypatch.setattr(cs, "SIMM_PORTFOLIOS", 4096)
    with pytest.raises(RuntimeError, match="ed_ladder was not launched in the samples phase"):
        cs.phase_samples(torch.device("cpu"), "cpu rehearsal")
    out = capsys.readouterr().out
    for line in ("irs (17a): fixings [500, 507, 514] bp by the scheduler", "18 card calls, 4.67 "
                 "per fixing", "4 transaction ids and the final swap equal",
                 "\"wrong rate\": \"rate 9999 != fixing 500", "oracle only signs command",
                 "simulation (17b): 50 events, 50 trace lines equal", "13 card calls",
                 "simm (17c): 6 trades (one per family) agreed and valued at margin 37379020",
                 "21 card calls, 3.00 per recorded agreement", "simm_im on the host over both "
                 "books equal", "simm web (17d):", "6 card calls, margin 48586",
                 "estimate_margins_batch of 4096 seeded 4-swap portfolios",
                 "(held to 0.0001)"):
        assert line in out, line


def test_samples_checks_refuse_wrong_answers(monkeypatch):
    """17a refuses fixings at other rates, the phase refuses a card
    ledger that differs from the CPU's, and 17d's analytics refuse an
    error over their tolerance."""
    import torch

    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    monkeypatch.setattr(cs, "IRS_RATES", [500, 507, 515])
    with pytest.raises(RuntimeError, match=r"irs \(17a\): fixings \[500, 507, 514\]"):
        cs.irs_drive(CpuBatchVerifier())
    monkeypatch.undo()

    runs = iter(({"ledger": {"simm valuation": "00"}}, {"ledger": {"simm valuation": "01"}}))
    monkeypatch.setattr(cs, "samples_drive", lambda verifier: next(runs))
    monkeypatch.setattr(cs, "_recording_verifier", _RecordingCpu)
    with pytest.raises(RuntimeError, match="the card's simm valuation differ"):
        cs.phase_samples(torch.device("cpu"), "t")

    monkeypatch.setattr(cs, "SIMM_PORTFOLIOS", 512)
    monkeypatch.setattr(cs, "SIMM_RTOL", 1e-9)
    with pytest.raises(RuntimeError, match="simm analytics .17d.: max relative error"):
        cs.margins_batch_drive(torch.device("cpu"))
