"""The Driver DSL and the load test over real node processes
(testing/driver.py, testing/loadtest.py) in the port.

The reference's four tests/test_driver.py cases, on the port's Driver:
every node a `python -m corda_tpu_torch.node` process with
`verifier_backend="cpu"` (the port's Driver defaults to the card, D8),
so each passes its own assertions here. The cross-cash runs' models and
reconciled vault totals must also equal the reference's model for the
same seed and shape (test_torch_loadtest.command_stream, the
reference's load test against a stub driver).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_loadtest import STREAMS, command_stream  # noqa: E402

from corda_tpu_torch.finance.cash import CashIssueFlow, CashPaymentFlow  # noqa: E402
from corda_tpu_torch.node.vault_query import VaultQueryCriteria  # noqa: E402
from corda_tpu_torch.testing.driver import driver  # noqa: E402
from corda_tpu_torch.testing.loadtest import (  # noqa: E402
    CrossCashLoadTest,
    Disruption,
    EmptyFlowLoadTest,
    kill_and_restart,
)

CPU = {"verifier_backend": "cpu"}


@pytest.fixture
def net(tmp_path):
    with driver(str(tmp_path)) as d:
        d.start_node("Hub", notary="validating", **CPU)
        alice = d.start_node("Alice", **CPU)
        bob = d.start_node("Bob", **CPU)
        d.wait_for_network(3)
        yield d, alice, bob


def test_driver_spins_up_and_pays(net):
    d, alice, bob = net
    assert alice.config.verifier_backend == "cpu"
    notary = d.notary_identity()
    cli = d.rpc(alice)
    me = d.identity_of(alice)
    handle = d.wait(cli.start_flow(CashIssueFlow(1_000, "USD", me, notary)))
    d.wait(handle.result)
    bob_party = d.identity_of(bob)
    handle = d.wait(cli.start_flow(CashPaymentFlow(400, "USD", bob_party)))
    d.wait(handle.result)

    page = d.wait(d.rpc(bob).vault_query_by(VaultQueryCriteria()))
    assert sum(s.state.data.amount.quantity for s in page.states) == 400


def test_cross_cash_loadtest_reconciles(net):
    d, alice, bob = net
    lt = CrossCashLoadTest(
        d, [alice, bob], d.notary_identity(), seed=9
    )
    result = lt.run(count=12)
    assert result.failed == 0, (result.expected, result.actual)
    assert result.reconciled, (result.expected, result.actual)
    assert result.throughput > 0
    assert result.actual == command_stream("corda_tpu", *STREAMS["cross-cash"])["expected"]


def test_loadtest_survives_kill_and_restart(net):
    """Traffic interleaved with a kill -9 + restart of a random node
    still reconciles (CrossCashTest under Disruption)."""
    d, alice, bob = net
    lt = CrossCashLoadTest(d, [alice, bob], d.notary_identity(), seed=10)
    result = lt.run(
        count=10,
        disruptions=(
            Disruption("kill+restart", 0.5, kill_and_restart),
        ),
        timeout_per_flow=180.0,
    )
    assert result.reconciled, (result.expected, result.actual)
    if result.failed == 0:
        assert result.actual == command_stream(
            "corda_tpu", *STREAMS["kill-and-restart"])["expected"]


def test_empty_flow_throughput_probe(net):
    d, alice, _bob = net
    stats = EmptyFlowLoadTest(d, alice).run(count=10)
    assert stats["flows_per_s"] > 0
    assert stats["avg_latency_ms"] > 0
