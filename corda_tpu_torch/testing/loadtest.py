"""Load test harness: command generators, injectors, disruptions, reconciliation.

Reference: `tools/loadtest` (LoadTest.kt:40-70 — generate random
commands from a seeded Generator, apply via RPC, gather node state,
reconcile against the expected model) with `Disruption`s
(Disruption.kt:17-73 — SIGSTOP hangs, restarts, kills interleaved with
traffic) and the fixed-rate/tight-loop injectors of
testing/performance/{Injectors,Rate}.kt (NodePerformanceTests.kt uses
them for the empty-flow and self-pay rates).

The harness drives real node processes through the Driver DSL; the
model is the expected per-node cash position, reconciled via vault
queries at the end (CrossCashTest.kt's invariant).

Port of corda_tpu/testing/loadtest.py: the same seed gives the same
command stream (kind, node, amount, peer) and the same model."""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..finance.cash import CashIssueFlow, CashPaymentFlow
from ..node.vault_query import FungibleAssetQueryCriteria, PageSpecification
from .driver import Driver, NodeHandle


@dataclass
class LoadResult:
    submitted: int
    succeeded: int
    failed: int
    elapsed_s: float
    reconciled: bool
    expected: dict
    actual: dict

    @property
    def throughput(self) -> float:
        return self.succeeded / self.elapsed_s if self.elapsed_s else 0.0


@dataclass
class Disruption:
    """One fault injected mid-run (Disruption.kt). `action(d, handle)`
    runs at `at_fraction` of the way through the command stream.

    `target` pins the victim (e.g. the notary — Disruption.kt's
    `isNetworkMap`/notary-targeted variants pick specific nodes); None
    picks a random traffic node."""

    name: str
    at_fraction: float
    action: Callable[[Driver, NodeHandle], Optional[NodeHandle]]
    target: Optional[NodeHandle] = None


def kill_and_restart(d: Driver, handle: NodeHandle) -> NodeHandle:
    """SIGKILL, then boot a replacement over the same state dir
    (Disruption.kt 'restart' + StabilityTest crash-restart). The spawn
    timeout matches the slow-boot budget soak targets use: a child's
    CUDA context and kernel load, or an nvcc build if the kernel
    libraries are missing from the build directory, can take minutes,
    not the default 120 s."""
    handle.kill()
    return d.restart_node(handle, timeout=600.0)


def sigstop_for(seconds: float):
    def action(d: Driver, handle: NodeHandle) -> None:
        handle.sigstop()
        time.sleep(seconds)
        handle.sigcont()
        return None

    return action


class CrossCashLoadTest:
    """Self-issue + cross-pay traffic over a driver network, with an
    expected-balance model (CrossCashTest.kt):

      - issue: node mints `amount` of its own currency to itself
      - pay: node pays a random peer from its balance

    Reconciliation: every node's vault total per (issuer, currency)
    must equal the model's once traffic quiesces."""

    def __init__(
        self,
        d: Driver,
        nodes: list[NodeHandle],
        notary_party,
        seed: int = 0,
        currency: str = "USD",
    ):
        self.d = d
        self.nodes = nodes
        self.notary = notary_party
        self.rng = random.Random(seed)
        self.currency = currency
        self.identities = {n.name: d.identity_of(n) for n in nodes}
        # model: node name -> expected total balance (its own view)
        self.expected: dict[str, int] = {n.name: 0 for n in nodes}

    # -- command stream ------------------------------------------------------

    def _commands(self, count: int):
        for _ in range(count):
            node = self.rng.choice(self.nodes)
            balance = self.expected[node.name]
            if balance < 100 or self.rng.random() < 0.4:
                amount = self.rng.randint(500, 2_000)
                yield ("issue", node, amount, None)
            else:
                peer = self.rng.choice(
                    [n for n in self.nodes if n.name != node.name]
                )
                amount = self.rng.randint(1, balance)
                yield ("pay", node, amount, peer)

    def run(
        self,
        count: int = 30,
        rate_per_s: Optional[float] = None,
        disruptions: tuple[Disruption, ...] = (),
        timeout_per_flow: float = 120.0,
    ) -> LoadResult:
        """Apply `count` commands (optionally rate-limited — the
        FixedRateInjector; None = tight loop, the TightLoopInjector),
        interleaving disruptions, then reconcile."""
        submitted = succeeded = failed = 0
        pending_disruptions = sorted(
            disruptions, key=lambda di: di.at_fraction
        )
        t0 = time.monotonic()
        for i, (kind, node, amount, peer) in enumerate(
            self._commands(count)
        ):
            while (
                pending_disruptions
                and i >= pending_disruptions[0].at_fraction * count
            ):
                di = pending_disruptions.pop(0)
                target = di.target or self.rng.choice(self.nodes)
                replacement = di.action(self.d, target)
                if replacement is not None:
                    self.nodes = [
                        replacement if n.name == target.name else n
                        for n in self.nodes
                    ]
            if rate_per_s is not None:
                target_t = t0 + i / rate_per_s
                now = time.monotonic()
                if now < target_t:
                    time.sleep(target_t - now)
            submitted += 1
            try:
                self._apply(kind, node, amount, peer, timeout_per_flow)
                succeeded += 1
            except Exception:
                failed += 1
        elapsed = time.monotonic() - t0
        actual = self.gather()
        return LoadResult(
            submitted, succeeded, failed, elapsed,
            actual == self.expected, dict(self.expected), actual,
        )

    def _apply(self, kind, node, amount, peer, timeout) -> None:
        cli = self.d.rpc(node)
        me = self.identities[node.name]
        if kind == "issue":
            handle = self.d.wait(
                cli.start_flow(
                    CashIssueFlow(amount, self.currency, me, self.notary)
                ),
                timeout,
            )
            self.d.wait(handle.result, timeout)
            self.expected[node.name] += amount
        else:
            handle = self.d.wait(
                cli.start_flow(
                    CashPaymentFlow(
                        amount, self.currency, self.identities[peer.name]
                    )
                ),
                timeout,
            )
            self.d.wait(handle.result, timeout)
            self.expected[node.name] -= amount
            self.expected[peer.name] += amount

    # -- reconciliation ------------------------------------------------------

    def gather(self) -> dict[str, int]:
        """Each node's actual unconsumed total (CrossCashTest's state
        gathering via RPC vault queries)."""
        out = {}
        for node in self.nodes:
            cli = self.d.rpc(node)
            fut = cli.vault_query_by(
                FungibleAssetQueryCriteria(product=self.currency),
                PageSpecification(page_size=10_000),
            )
            page = self.d.wait(fut)
            out[node.name] = sum(
                s.state.data.amount.quantity for s in page.states
            )
        return out


class EmptyFlowLoadTest:
    """The NodePerformanceTests 'empty flow' rate measurement
    (NodePerformanceTests.kt:59-87): round-trip N no-op flows and
    report throughput + average latency."""

    def __init__(self, d: Driver, node: NodeHandle):
        self.d = d
        self.node = node

    def run(self, count: int = 50) -> dict:
        from .flows import NoOpFlow

        cli = self.d.rpc(self.node)
        latencies = []
        t0 = time.monotonic()
        for _ in range(count):
            s = time.monotonic()
            handle = self.d.wait(cli.start_flow(NoOpFlow()))
            self.d.wait(handle.result)
            latencies.append(time.monotonic() - s)
        elapsed = time.monotonic() - t0
        return {
            "count": count,
            "elapsed_s": elapsed,
            "flows_per_s": count / elapsed,
            "avg_latency_ms": 1000 * sum(latencies) / len(latencies),
        }
