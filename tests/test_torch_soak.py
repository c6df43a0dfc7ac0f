"""Disruption soak on the port: batching notary + verifier + load test
(tests/test_soak_batching.py on corda_tpu_torch).

Cross-cash traffic through the port's Driver with a kill -9 and restart
of a traffic node and of the batching notary. Every node verifies on the
card where there is one (the kernels built here first, so the children
load them instead of building them inside their flow timeout: the port's
counterpart of the reference's compile-cache prewarm), else on the CPU
(`verifier_backend="cpu"`). No command may fail, and the model must
equal the reference's for the seed (test_torch_loadtest.command_stream).

Ring-4: every node is a separate OS process. Slow-marked, as the
reference's soak is.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_loadtest import STREAMS, command_stream  # noqa: E402

from corda_tpu_torch.node.vault_query import VaultQueryCriteria  # noqa: E402
from corda_tpu_torch.testing.driver import driver  # noqa: E402
from corda_tpu_torch.testing.loadtest import (  # noqa: E402
    CrossCashLoadTest,
    Disruption,
    kill_and_restart,
)


def _notary_backend() -> str:
    """The card if there is one (kernels built now), else the CPU."""
    if not torch.cuda.is_available():
        return "cpu"
    from corda_tpu_torch.crypto import build

    build.build_all()
    return "tpu"


@pytest.mark.slow
def test_batching_notary_survives_disruptions(tmp_path):
    """Cross-cash traffic with a kill -9 + restart of BOTH a traffic
    node and the batching notary itself still reconciles, and every
    node's vault total agrees with the model."""
    backend = _notary_backend()
    with driver(str(tmp_path)) as d:
        hub = d.start_node(
            "Hub", notary="batching", verifier_backend=backend,
            notary_batch_wait_micros=50_000,
            timeout=600.0,
        )
        alice = d.start_node("Alice", verifier_backend=backend)
        bob = d.start_node("Bob", verifier_backend=backend)
        d.wait_for_network(3)

        lt = CrossCashLoadTest(d, [alice, bob], d.notary_identity(), seed=31)
        result = lt.run(
            count=16,
            disruptions=(
                Disruption("kill+restart traffic node", 0.35, kill_and_restart),
                Disruption(
                    "kill+restart notary", 0.65, kill_and_restart, target=hub
                ),
            ),
            timeout_per_flow=600.0,
        )
        assert result.failed == 0, (
            result.expected,
            result.actual,
            d.nodes["Hub"].stderr_tail(),
        )
        assert result.reconciled, (result.expected, result.actual)
        assert result.throughput > 0
        assert result.expected == command_stream("corda_tpu", *STREAMS["soak"])["expected"]

        for node in (alice, bob):
            page = d.wait(d.rpc(node).vault_query_by(VaultQueryCriteria()))
            total = sum(s.state.data.amount.quantity for s in page.states)
            assert total == result.expected[node.name]
