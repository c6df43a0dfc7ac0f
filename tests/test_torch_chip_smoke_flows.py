"""A rehearsal of chip_smoke.py's phase 8 (drive 1 through the flows on
MockNetwork, the batching notary's flush, drive 1 again over
CpuBatchVerifier) on the CPU at a small size, with counted plain
versions standing in for the kernels. Apart from
test_torch_chip_smoke.py so that, under `--dist loadfile`, this slow
rehearsal holds a worker of its own."""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import (  # noqa: E402,F401 - one_thread is a fixture
    _counted_plain_versions, one_thread)


def test_flow_phase_rehearsed_on_the_cpu(monkeypatch, capsys, one_thread):
    """chip_smoke.phase_flows on the CPU: drive 1 (8a) in full, the
    batching notary's flush (8b) at 2 payers of one coin each for shards
    1 and 4, and 8a again over CpuBatchVerifier (8c), whose ledger must
    equal the device path's; the kernels' plain versions stand in for
    the kernels and count a launch each, so the phase's launch check of
    ed_ladder, wei_ladder_windowed and wei_ladder runs too."""
    import torch

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cs, "FLOW_PAYERS", 2)
    monkeypatch.setattr(cs, "FLOW_COINS", 1)
    monkeypatch.setattr(cs, "FLOW_BATCHES", (4,))
    launches = cs.phase_flows(torch.device("cpu"), "cpu rehearsal")
    assert launches["ed_ladder"] and launches["wei_ladder_windowed"] and launches["wei_ladder"]
    out = capsys.readouterr().out
    assert "flow drive (8a): 6 flows completed and 3 refused" in out
    assert "'double spend Alice -> Carol', 'NotaryException', 'conflict'" in out
    assert "flow flush (8b) shards=1: 2 payments" in out and "1 dispatch(es), 2 rows" in out
    assert "flow flush (8b) shards=4: 2 payments" in out
    assert "flow drive (8c) over CpuBatchVerifier" in out
