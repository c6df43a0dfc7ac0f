"""The Raft core and the Raft notary cluster in both packages, held
against the reference.

Every case of the reference's tests/test_raft.py (16) and
tests/test_raft_notary.py (3; its real-node case runs in
test_torch_persistence.py)
runs in corda_tpu and, with its imports read as corda_tpu_torch, in the
port, on the same seed over CpuBatchVerifier. Each run must pass its own
assertions, and the two runs must record equal frames (RequestVote,
AppendEntries, InstallSnapshot chunks and the notary flows' frames),
equal vault pages, equal Raft maps and equal sqlite rows (the Raft log,
meta and snapshot tables); test_torch_persistence.py holds the
recording. A flow case also runs over CudaBatchVerifier(device="cpu").
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_chip_smoke import _counted_plain_versions  # noqa: E402
from test_torch_persistence import cases_of, check_case, device_path_verifier  # noqa: E402


@pytest.mark.parametrize("name,case,param",
                         cases_of("test_raft") + cases_of("test_raft_notary"))
def test_case_equals_the_reference(name, case, param, tmp_path):
    check_case(name, case, param, tmp_path)


def test_case_count():
    assert [len(cases_of(n)) for n in ("test_raft", "test_raft_notary")] == [16, 3]


def test_raft_notary_on_the_device_path_equals_the_reference(tmp_path, monkeypatch):
    """Cash through the Raft cluster (the reference case's, non-validating) over
    CudaBatchVerifier(device="cpu"): the same frames and maps."""
    from corda_tpu_torch.crypto import cuda_ec

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cuda_ec, "ed_ladder_launches", 0)
    port = check_case("test_raft_notary", "test_cash_through_raft_notary", None, tmp_path,
                      device_path_verifier)
    assert port["frames"] and port["maps"] and cuda_ec.ed_ladder_launches
