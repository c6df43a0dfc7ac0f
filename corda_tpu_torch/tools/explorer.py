"""Ledger explorer: a terminal dashboard over one node's RPC feeds.

Reference: tools/explorer/ — the JavaFX/TornadoFX ledger GUI (views for
dashboard, cash states, transactions, network; driven by the client/jfx
models) plus `ExplorerSimulation`, the traffic generator that keeps a
demo network busy with random issue/pay/exit flows. The
frontend is terminal-rendered (the framework is headless-first); the
model layer (tools/models.py) is the part GUIs would bind to.

    python -m corda_tpu_torch.tools.explorer --help   (via demobench nodes)

Port of corda_tpu/tools/explorer.py: the same panes, and the same
simulation for the same seed. A node's flows verify where its verifier
runs (the card, for a node with the default `verifier_backend`).
"""

from __future__ import annotations

import random
import time
from typing import Any, Optional

from .models import NodeMonitorModel


class _AlreadyRunning:
    """Stand-in process handle for a node this tool did not spawn."""

    def poll(self):
        return None

    def terminate(self):
        pass

    def wait(self, timeout=None):
        pass

    def kill(self):
        pass


class Explorer:
    """Render the four explorer panes as text (Dashboard / Cash /
    Transactions / Network in the reference GUI)."""

    def __init__(self, ops):
        self.model = NodeMonitorModel(ops)

    def render(self) -> str:
        m = self.model
        lines = [
            f"=== {m.identity.legal_identity.name} — ledger explorer ===",
            "",
            "-- network --",
        ]
        for name in sorted(m.network.nodes):
            info = m.network.nodes[name]
            tags = ",".join(info.advertised_services)
            lines.append(f"  {name}{'  [' + tags + ']' if tags else ''}")
        lines += ["", "-- balances --"]
        balances = m.vault.balances()
        if not balances:
            lines.append("  (empty vault)")
        for product in sorted(balances):
            lines.append(f"  {product:8s} {balances[product]:>14,d}")
        lines += ["", f"-- unconsumed states: {len(m.vault.states)} --"]
        lines += ["", f"-- transactions: {len(m.transactions.transactions)} --"]
        for stx in m.transactions.transactions[-8:]:
            wtx = stx.wtx
            lines.append(
                f"  {stx.id.prefix_chars()}  "
                f"in={len(wtx.inputs)} out={len(wtx.outputs)}"
            )
        in_flight = m.state_machines.in_flight
        lines += ["", f"-- flows in flight: {len(in_flight)} --"]
        for fid in list(in_flight)[:8]:
            lines.append(f"  {fid}  {in_flight[fid].flow_tag}")
        return "\n".join(lines)

    def close(self) -> None:
        self.model.close()


class ExplorerSimulation:
    """Random traffic generator (tools/explorer ExplorerSimulation):
    repeatedly fires issue / payment / exit cash flows between the
    parties visible on the network map, over RPC."""

    def __init__(
        self,
        ops,
        currencies: tuple[str, ...] = ("USD", "GBP", "CHF"),
        seed: int = 0,
        notary_name: Optional[str] = None,
    ):
        self.ops = ops
        self.currencies = currencies
        self.rng = random.Random(seed)
        self.model = NodeMonitorModel(ops)
        self.notary_name = notary_name
        self.handles: list = []

    def _counterparties(self) -> list:
        us = self.model.identity.legal_identity.name
        out = []
        for info in self.model.network.nodes.values():
            if info.legal_identity.name == us:
                continue
            if any(
                "notary" in s or "network_map" in s
                for s in info.advertised_services
            ):
                continue
            out.append(info.legal_identity)
        return out

    def step(self) -> str:
        """Fire one random flow; returns a description of it."""
        from ..finance.cash import CashIssueFlow, CashPaymentFlow

        currency = self.rng.choice(self.currencies)
        peers = self._counterparties()
        # issuance may target any party including ourselves (the
        # reference sim seeds every participant with cash)
        issue_targets = peers + [self.model.identity.legal_identity]
        balances = self.model.vault.balances()
        can_pay = balances.get(currency, 0) > 0 and peers
        if not can_pay or self.rng.random() < 0.4:
            amount = self.rng.randrange(1_000, 10_000)
            recipient = self.rng.choice(issue_targets)
            notaries = self.ops.notary_identities()
            notaries = notaries.get() if hasattr(notaries, "get") else notaries
            handle = self.ops.start_flow(
                CashIssueFlow,
                quantity=amount,
                currency=currency,
                recipient=recipient,
                notary=notaries[0],
                nonce=self.rng.getrandbits(32),
            )
            self.handles.append(handle)
            return f"issue {amount} {currency} -> {recipient.name}"
        if can_pay:
            amount = self.rng.randrange(
                1, min(balances[currency], 5_000) + 1
            )
            recipient = self.rng.choice(peers)
            handle = self.ops.start_flow(
                CashPaymentFlow,
                quantity=amount,
                currency=currency,
                recipient=recipient,
            )
            self.handles.append(handle)
            return f"pay {amount} {currency} -> {recipient.name}"
        return "idle (no peers / no balance)"

    def run(self, steps: int, delay: float = 0.0) -> list[str]:
        log = []
        for _ in range(steps):
            log.append(self.step())
            if delay:
                time.sleep(delay)
        return log

    def close(self) -> None:
        self.model.close()


def main(argv=None) -> int:
    """Attach to a node spawned by demobench (or any deployment dir
    with compatible naming) and render the dashboard."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.explorer",
        description="Terminal ledger explorer over a node's RPC",
    )
    parser.add_argument("bench_dir", help="demobench directory")
    parser.add_argument("node", help="node name to attach to")
    parser.add_argument("--port", type=int, required=True,
                        help="the node's p2p port")
    parser.add_argument(
        "--watch", type=float, default=0.0,
        help="re-render every N seconds (0 = render once)",
    )
    parser.add_argument(
        "--simulate", type=int, default=0,
        help="fire N random traffic steps first (ExplorerSimulation)",
    )
    args = parser.parse_args(argv)

    from .demobench import BenchNode, DemoBench, _PumpedOps
    from ..node.config import NodeConfig

    bench = DemoBench(args.bench_dir)
    cfg = NodeConfig(
        name=args.node,
        base_dir=f"{args.bench_dir}/{args.node}",
        p2p_port=args.port,
    )
    bench.nodes[args.node] = BenchNode(
        args.node, cfg, _AlreadyRunning(), args.port,
        f"{cfg.base_dir}/node.log",
    )
    client = _PumpedOps(bench, args.node)
    explorer = Explorer(client)
    try:
        if args.simulate:
            sim = ExplorerSimulation(client)
            for line in sim.run(args.simulate, delay=0.1):
                print(f"[sim] {line}")
            sim.close()
        while True:
            print(explorer.render())
            if not args.watch:
                return 0
            time.sleep(args.watch)
            # feeds only deliver while the console fabric pumps; a
            # cheap RPC round-trip drains pending updates into the
            # models before the next render
            client.current_node_time()
            print("\033[2J\033[H", end="")
    except KeyboardInterrupt:
        return 0
    finally:
        explorer.close()


if __name__ == "__main__":
    raise SystemExit(main())
