"""Transaction-graph rendering as graphviz dot.

Reference: tools/graphs/ — graphviz tooling over the ledger. Here:
walk a set of SignedTransactions (e.g. `verified_transactions_snapshot`
over RPC, or a tx storage directly) and emit a dot digraph: one node
per transaction, one edge per consumed StateRef, annotated with the
contract + output index it spends.

Port of corda_tpu/tools/graphs.py: the same dot text for the same
transactions.
"""

from __future__ import annotations

from typing import Iterable


def transactions_to_dot(
    stxs: Iterable,
    title: str = "ledger",
) -> str:
    """Render SignedTransactions as a dot digraph. Edges point from the
    producing tx to the consuming tx (value flow)."""
    stxs = list(stxs)
    by_id = {stx.id: stx for stx in stxs}
    lines = [
        f'digraph "{title}" {{',
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
    ]
    for stx in stxs:
        wtx = stx.wtx
        label = (
            f"{stx.id.prefix_chars()}\\n"
            f"in={len(wtx.inputs)} out={len(wtx.outputs)} "
            f"sigs={len(stx.sigs)}"
        )
        lines.append(f'  "{stx.id.prefix_chars()}" [label="{label}"];')
    for stx in stxs:
        for ref in stx.wtx.inputs:
            src = ref.txhash
            if src in by_id:
                producer = by_id[src]
                contract = ""
                if ref.index < len(producer.wtx.outputs):
                    contract = producer.wtx.outputs[
                        ref.index
                    ].contract.rsplit(".", 1)[-1]
                lines.append(
                    f'  "{src.prefix_chars()}" -> '
                    f'"{stx.id.prefix_chars()}" '
                    f'[label="{contract}[{ref.index}]"];'
                )
            else:
                # spend of an off-graph (unresolved) transaction
                lines.append(
                    f'  "ext:{src.prefix_chars()}" '
                    f"[shape=ellipse, style=dashed];"
                )
                lines.append(
                    f'  "ext:{src.prefix_chars()}" -> '
                    f'"{stx.id.prefix_chars()}" '
                    f'[label="[{ref.index}]", style=dashed];'
                )
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.graphs",
        description="Dump a node's verified-transaction graph as dot",
    )
    parser.add_argument("bench_dir")
    parser.add_argument("node")
    parser.add_argument("--port", type=int, required=True)
    args = parser.parse_args(argv)

    from .demobench import DemoBench, BenchNode, _PumpedOps
    from .explorer import _AlreadyRunning
    from ..node.config import NodeConfig

    bench = DemoBench(args.bench_dir)
    cfg = NodeConfig(
        name=args.node, base_dir=f"{args.bench_dir}/{args.node}",
        p2p_port=args.port,
    )
    bench.nodes[args.node] = BenchNode(
        args.node, cfg, _AlreadyRunning(), args.port,
        f"{cfg.base_dir}/node.log",
    )
    ops = _PumpedOps(bench, args.node)
    print(transactions_to_dot(ops.verified_transactions_snapshot()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
