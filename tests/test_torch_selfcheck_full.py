"""The port's full-width parity record (`selfcheck.run_full` and the
`--full` CLI) on the CPU, held against the reference's tpu_selfcheck.

`run_full(24, device="cpu", batch_size=32)` runs both ladder
generations' plain versions, once, as chip_smoke.py's phase 20 runs it
(the plain versions counting a launch each, as the kernels would on the
card): each generation's answer to each row, and so its tallies, equal
the reference's CpuBatchVerifier over the reference's
`build_requests(24)`, every one of the eight kernels' plain versions
runs, and its record holds every key of the reference's
record, with the card and the launches beside them (none and empty on
the CPU). The CLI refuses to
write KERNEL_PARITY_FULL_TORCH.json from a reduced or a CPU run; a row
the verifier answers wrongly, and a kernel that never launched, make
`run_full` raise. The comparison with the reference's own
`run_full(allow_cpu=True)`, whose XLA compile costs ~80 s a curve, is
slow.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

pytest.importorskip("torch")

from corda_tpu_torch.testing import selfcheck  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from test_torch_chip_smoke import _counted_plain_versions  # noqa: E402

N, BATCH = 24, 32
REFERENCE_KEYS = {"check", "generated_by", "utc", "n", "runs", "cpu_reference_wall_s",
                  "backend", "result"}            # tpu_selfcheck.run_full's record
REFERENCE_RUN_KEYS = {"windowed", "accepts", "rejects", "device_wall_s"}


@pytest.fixture(scope="module")
def full():
    """chip_smoke's phase 20 at N rows and batch BATCH on the CPU: one
    plain run of both generations, the plain versions counted, each
    generation's answers row by row under "answers"."""
    import torch

    from corda_tpu_torch.crypto import batch_verifier

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    run_full = selfcheck.run_full
    verify_batch = batch_verifier.CudaBatchVerifier.verify_batch
    answers = []

    def recorded(self, requests):
        answers.append(verify_batch(self, requests))
        return answers[-1]

    try:
        with pytest.MonkeyPatch.context() as mp:
            _counted_plain_versions(mp)
            mp.setattr(batch_verifier.CudaBatchVerifier, "verify_batch", recorded)
            mp.setattr(cs, "PARITY_FULL_N", N)
            mp.setattr(selfcheck, "run_full",
                       lambda n, **kw: run_full(n, **{**kw, "batch_size": BATCH}))
            return {**cs.phase_parity_full(torch.device("cpu"), "cpu rehearsal"),
                    "answers": answers}
    finally:
        torch.set_num_threads(saved)


def _reference_answers(n: int) -> list:
    from corda_tpu.crypto.batch_verifier import CpuBatchVerifier
    from corda_tpu.testing import tpu_selfcheck

    return CpuBatchVerifier().verify_batch(tpu_selfcheck.build_requests(n))


def test_answers_equal_the_references_cpu_verifier(full):
    """Each generation's answer to each row is the reference's
    CpuBatchVerifier's over the reference's rows; the tallies follow."""
    record = full["record"]
    ref = _reference_answers(N)
    assert full["answers"] == [ref, ref]          # the windowed, then the bit ladders
    accepts = sum(ref)
    assert [r["windowed"] for r in record["runs"]] == [True, False]
    for run in record["runs"]:
        assert (run["accepts"], run["rejects"]) == (accepts, N - accepts)
        assert run["launches"] == {}             # no kernel runs on the CPU
    assert 0 < accepts < N
    assert (record["backend"], record["card"], record["result"]) == ("cpu", None, "bit-exact")
    # phase 20's launches: every kernel's plain version ran, in both runs
    assert set(full["launches"]) == set(cs.COUNTERS)
    assert all(v >= 1 for v in full["launches"].values())


def test_record_holds_every_key_of_the_references(full):
    record = full["record"]
    assert REFERENCE_KEYS <= set(record)
    assert {"card", "batch_size"} <= set(record)
    for run in record["runs"]:
        assert REFERENCE_RUN_KEYS | {"launches"} == set(run)
    assert (record["n"], record["batch_size"]) == (N, BATCH)
    assert record["generated_by"] == "chip_smoke.py phase 20"


def test_record_written_by_default(monkeypatch, tmp_path):
    """Answers right by construction (the CPU reference's): the record
    as written, under the CLI's provenance."""
    from corda_tpu_torch.crypto import batch_verifier

    monkeypatch.setattr(batch_verifier.CudaBatchVerifier, "verify_batch", _cpu_answers())
    path = tmp_path / "parity.json"
    record = selfcheck.run_full(N, device="cpu", out_path=str(path), batch_size=BATCH)
    assert record["generated_by"] == f"python -m corda_tpu_torch.testing.selfcheck --full --n {N}"
    assert json.loads(path.read_text()) == record
    assert path.read_text().endswith("}\n")


@pytest.mark.parametrize("argv", [["--full", "--n", "100"],
                                  ["--full", "--allow-cpu"],
                                  ["--full", "--n", "24", "--allow-cpu"]])
def test_cli_refuses_the_default_file_from_a_reduced_or_cpu_run(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(selfcheck, "run_full", lambda *a, **kw: pytest.fail("ran"))
    with pytest.raises(SystemExit, match="refusing to write KERNEL_PARITY_FULL_TORCH.json"):
        selfcheck.main(argv)
    assert not (tmp_path / selfcheck.FULL_OUT).exists()


def test_cli_passes_its_arguments_to_run_full(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(selfcheck, "run_full",
                        lambda *a, **kw: calls.append((a, kw)) or {"result": "bit-exact"})
    assert selfcheck.main(["--full", "--n", "24", "--allow-cpu", "--out", "x.json"]) == 0
    assert calls == [((24, "cpu", "x.json"), {})]   # at run_full's batch of 4,096
    assert json.loads(capsys.readouterr().out) == {"result": "bit-exact"}
    with pytest.raises(SystemExit):
        selfcheck.main(["--allow-cpu"])           # the plain check refuses the CPU


def _cpu_answers(flip: int | None = None):
    from corda_tpu_torch.crypto.batch_verifier import CpuBatchVerifier

    def verify_batch(self, requests):
        got = CpuBatchVerifier().verify_batch(requests)
        if flip is not None:
            got[flip] = not got[flip]
        return got

    return verify_batch


def test_a_wrong_row_raises(monkeypatch):
    from corda_tpu_torch.crypto import batch_verifier

    monkeypatch.setattr(batch_verifier.CudaBatchVerifier, "verify_batch", _cpu_answers(flip=3))
    with pytest.raises(RuntimeError, match=r"windowed=True: device != CPU at rows \[3\]"):
        selfcheck.run_full(N, device="cpu", batch_size=BATCH)


def test_a_kernel_that_never_launched_raises(monkeypatch):
    """On the card every kernel of a generation must launch: answers that
    are right but came from no kernel are refused."""
    import torch

    from corda_tpu_torch.crypto import batch_verifier, build

    builds = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "build_all", lambda: builds.append(1) or {})
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: None)   # no CUDA context here
    monkeypatch.setattr(selfcheck, "card_line", lambda device: "a card, 700.00 W")
    monkeypatch.setattr(batch_verifier.CudaBatchVerifier, "__init__",
                        lambda self, **kw: None)
    monkeypatch.setattr(batch_verifier.CudaBatchVerifier, "verify_batch", _cpu_answers())
    with pytest.raises(RuntimeError, match=r"windowed=True: \['wei_ladder_windowed', "
                                           r"'ed_ladder_windowed', 'ed_prologue'"):
        selfcheck.run_full(N, device="cuda", batch_size=BATCH)
    assert builds == [1]          # the kernels built before the first run


@pytest.mark.slow
def test_equals_the_references_run_full(full):
    """The reference's own run_full on the CPU (its XLA path, one run)
    gives the tallies of each of the port's generations, under the same
    keys."""
    from corda_tpu.testing import tpu_selfcheck

    record = full["record"]
    ref = tpu_selfcheck.run_full(N, allow_cpu=True)
    assert set(ref) <= set(record)
    (ref_run,) = ref["runs"]
    for run in record["runs"]:
        assert set(ref_run) <= set(run)
        assert (run["accepts"], run["rejects"]) == (ref_run["accepts"], ref_run["rejects"])
    assert ref["result"] == record["result"] == "bit-exact"
