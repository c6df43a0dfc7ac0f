"""The PBFT replica and the BFT notary cluster in both packages, held
against the reference.

Every case of the reference's tests/test_bft.py (17; its real-node and
node-config cases run in test_torch_persistence.py) runs in
corda_tpu and, with its imports read as corda_tpu_torch, in the port,
on the same seed over CpuBatchVerifier. Each run must pass its own
assertions, and the two runs must record equal frames (requests,
pre-prepares, prepares with their signed attestations, commits, view
changes, new views, checkpoints, catch-up and replies), equal vault
pages and equal replica maps; test_torch_persistence.py holds the
recording. A flow case also runs over CudaBatchVerifier(device="cpu"),
the composite-key answer checked on the device path.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_chip_smoke import _counted_plain_versions  # noqa: E402
from test_torch_persistence import cases_of, check_case, device_path_verifier  # noqa: E402


@pytest.mark.parametrize("name,case,param", cases_of("test_bft"))
def test_case_equals_the_reference(name, case, param, tmp_path):
    check_case(name, case, param, tmp_path)


def test_case_count():
    assert len(cases_of("test_bft")) == 17


def test_bft_notary_on_the_device_path_equals_the_reference(tmp_path, monkeypatch):
    """Cash through the BFT cluster over CudaBatchVerifier(device="cpu"):
    the same frames and replica maps."""
    from corda_tpu_torch.crypto import cuda_ec

    _counted_plain_versions(monkeypatch)
    monkeypatch.setattr(cuda_ec, "ed_ladder_launches", 0)
    port = check_case("test_bft", "test_cash_through_bft_notary", None, tmp_path,
                      device_path_verifier)
    assert port["frames"] and port["maps"] and cuda_ec.ed_ladder_launches
