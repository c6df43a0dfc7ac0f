"""CLI entry point: `python -m corda_tpu_torch.node --config node.toml`.

Port of corda_tpu/node/__main__.py: `python -m corda_tpu_torch.node
--config node.toml [--log-level L] [--print-port]
[--initial-registration]`. The node verifies on the card unless its
config sets `verifier_backend = "cpu"`. `--initial-registration`
registers with the doorman named by `registration_server`
(node/registration.py), stores the certificates under `base_dir` and
exits; the node boots on them next time.

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
        help="register with the permissioning server named by "
        "registration_server in the config, store certificates, and exit "
        "(NodeStartup's --initial-registration)",
    )
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)-7s %(name)s - %(message)s",
    )
    try:
        config = load_config(args.config)
    except (ConfigError, OSError) as e:
        print(f"bad config: {e}", file=sys.stderr)
        return 1

    if args.initial_registration:
        from .registration import (
            CertificateRequestException,
            HttpRegistrationService,
            NetworkRegistrationHelper,
        )

        if not config.registration_server:
            print(
                "bad config: --initial-registration needs "
                "registration_server", file=sys.stderr,
            )
            return 1
        root_pem = None
        if config.network_root_file:
            try:
                with open(config.network_root_file, "rb") as f:
                    root_pem = f.read()
            except OSError as e:
                print(f"bad network_root_file: {e}", file=sys.stderr)
                return 1
        helper = NetworkRegistrationHelper(
            config.base_dir, config.name,
            HttpRegistrationService(config.registration_server),
            email=config.email,
            network_root_pem=root_pem,
        )
        try:
            helper.build_keystore()
        except CertificateRequestException as e:
            print(str(e), file=sys.stderr)
            print(
                "Please make sure the details in the configuration file "
                "are correct and try again.", file=sys.stderr,
            )
            return 1
        return 0

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
    if node.web is not None:
        print(f"WEB_PORT={node.web.port} (/web/explorer/)", flush=True)
    try:
        node.run()
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
