"""chip_smoke.py's process layout on the CPU: every phase runs once, in
one process, with the fixture it needs; the launch columns of the
kernel table come from the processes together; the card lock excludes
what it should; a lane that ends without its result fails the run."""

import fcntl
import io
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

ALL_PHASES = ["3 parity", "3 timing", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13",
              "14", "15", "16", "17"]


@pytest.fixture
def stub_phases(monkeypatch):
    """Every phase replaced by a recorder: (phase, the fixture it got);
    the phases with a launch column answer {"ed_ladder": 1}."""
    calls, built = [], []
    launches = {"ed_ladder": 1}

    def fixture():
        built.append(1)
        return "lane fixture"

    def rec(pid, out=None, takes_fx=False):
        def phase(device, card_or_report=None, fx=None):
            calls.append((pid, fx if takes_fx else None))
            return out
        return phase

    monkeypatch.setattr(cs, "notary_fixture", fixture)
    monkeypatch.setattr(cs, "phase_parity", rec("3 parity"))
    monkeypatch.setattr(cs, "phase_timing", rec("3 timing"))
    monkeypatch.setattr(cs, "phase_prologue", rec("4"))
    monkeypatch.setattr(cs, "phase_main", rec("5"))
    monkeypatch.setattr(cs, "phase_notary", rec("6", ({1: 1.0}, "phase-6 fixture")))
    monkeypatch.setattr(cs, "phase_schemes", rec("7", takes_fx=True))
    monkeypatch.setattr(cs, "phase_flows", rec("8"))
    monkeypatch.setattr(cs, "phase_pool", rec("9", takes_fx=True))
    monkeypatch.setattr(cs, "phase_clusters", rec("10", launches, takes_fx=True))
    monkeypatch.setattr(cs, "phase_nodes", rec("11", launches, takes_fx=True))
    monkeypatch.setattr(cs, "phase_drives", rec("12", launches))
    monkeypatch.setattr(cs, "phase_telemetry", rec("13", {"launches": launches}, takes_fx=True))
    monkeypatch.setattr(cs, "phase_planes", rec("14", {"launches": launches}, takes_fx=True))
    monkeypatch.setattr(cs, "phase_xshard", rec("15", {"launches": launches}, takes_fx=True))
    monkeypatch.setattr(cs, "phase_web", rec("16", {"launches": launches}))
    monkeypatch.setattr(cs, "phase_samples", rec("17", {"launches": launches}))
    return calls, built


def test_every_phase_runs_once_with_every_column(stub_phases):
    calls, built = stub_phases
    groups = [cs.QUIET, cs.HOME, *cs.LANES]
    flat = [p for g in groups for p in g]
    assert sorted(flat) == sorted(ALL_PHASES) and len(flat) == len(set(flat))
    columns, walls = {}, {}
    for ids in groups:
        w, c = cs.run_phases(ids, "cpu", "cpu rehearsal", {})
        assert list(w) == list(ids)
        assert not set(c) & set(columns)     # each column from one process
        walls.update(w)
        columns.update(c)
    assert [pid for pid, _ in calls] == flat
    assert set(columns) == set(cs.COLUMNS)
    assert all(v == {"ed_ladder": 1} for v in columns.values())
    # phase 14 takes phase 6's fixture; each lane that needs one builds it once
    fxs = dict(calls)
    assert fxs["14"] == "phase-6 fixture"
    assert {fxs[p] for p in ("7", "9", "10", "11", "13", "15")} == {"lane fixture"}
    needs = [g for g in cs.LANES if set(g) & {"7", "9", "10", "11", "13", "15"}]
    assert len(built) == len(needs)


def test_an_unknown_phase_raises(stub_phases):
    with pytest.raises(ValueError, match="no phase '18'"):
        cs.run_phases(["18"], "cpu", "cpu rehearsal", {})


def test_lane_main_writes_its_result_and_waits_for_stdin(stub_phases, monkeypatch, tmp_path):
    import torch

    stdin = io.StringIO("")
    monkeypatch.setattr(sys, "stdin", stdin)
    out = str(tmp_path / "lane1.json")
    assert cs.lane_main(["12", "17"], out, torch.device("cpu"), "cpu rehearsal") == 0
    with open(out) as f:
        result = json.load(f)
    assert list(result["walls"]) == ["12", "17"]
    assert set(result["columns"]) == {"drives_launches", "samples_launches"}
    assert stdin.tell() == 0 and not os.path.exists(out + ".tmp")


def test_card_lock_excludes_and_is_idle_without_its_file(monkeypatch, tmp_path):
    path = tmp_path / "card.lock"
    monkeypatch.delenv(cs.CARD_LOCK_ENV, raising=False)
    with cs.card_processes(exclusive=True):
        assert not path.exists()
    monkeypatch.setenv(cs.CARD_LOCK_ENV, str(path))
    for exclusive, blocked in ((True, fcntl.LOCK_SH), (False, fcntl.LOCK_EX)):
        with cs.card_processes(exclusive=exclusive), open(path) as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, blocked | fcntl.LOCK_NB)
    with cs.card_processes(exclusive=False), open(path) as other:
        fcntl.flock(other, fcntl.LOCK_SH | fcntl.LOCK_NB)   # readers share
        fcntl.flock(other, fcntl.LOCK_UN)
    with open(path) as other:
        fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)   # released on exit


def test_a_lane_without_its_result_fails_the_run(tmp_path):
    """Here there is no card: the lane exits 2 before any phase, and
    waiting for it raises with its words."""
    lane = cs.Lane(("7",), str(tmp_path), 1)
    try:
        with pytest.raises(RuntimeError, match="exited 2 before its result") as err:
            cs.wait_lanes([lane], timeout=120)
        assert "torch.cuda.is_available() is false" in str(err.value)
    finally:
        lane.kill()
    assert lane.proc.returncode == 2 and lane.wall is None
