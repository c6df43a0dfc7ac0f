"""CLI entry point: `python -m corda_tpu_torch.node --config node.toml`.

Port of corda_tpu/node/__main__.py: `python -m corda_tpu_torch.node
--config node.toml [--log-level L] [--print-port]`. The node verifies
on the card unless its config sets `verifier_backend = "cpu"`.
`--initial-registration` (node/registration.py) is not ported: it
raises NotImplementedError naming ROADMAP Queue 1 #3.6.

Reference: NodeStartup.main (node/.../internal/NodeStartup.kt:44-99) —
banner, config load, logging init, node.start() + run().
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

from .config import ConfigError, load_config
from .node import Node, banner


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.node", description="Run a corda_tpu_torch node"
    )
    parser.add_argument("--config", required=True, help="path to node.toml")
    parser.add_argument(
        "--log-level", default="INFO",
        choices=["DEBUG", "INFO", "WARNING", "ERROR"],
    )
    parser.add_argument(
        "--print-port", action="store_true",
        help="print the bound p2p port on stdout after start (for a launcher)",
    )
    parser.add_argument(
        "--initial-registration", action="store_true",
        help="not ported (node/registration.py, ROADMAP Queue 1 #3.6)",
    )
    args = parser.parse_args(argv)
    if args.initial_registration:
        raise NotImplementedError(
            "--initial-registration: node/registration.py is not ported "
            "(ROADMAP Queue 1 #3.6)"
        )

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)-7s %(name)s - %(message)s",
    )
    try:
        config = load_config(args.config)
    except (ConfigError, OSError) as e:
        print(f"bad config: {e}", file=sys.stderr)
        return 1

    print(banner(config))
    node = Node(config).start()

    def shutdown(signum, frame):
        node.running = False

    # handlers must be live before the port is announced: a launcher
    # may signal the instant it reads the line
    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    if args.print_port:
        print(f"P2P_PORT={node.messaging.listen_port}", flush=True)
    try:
        node.run()
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
