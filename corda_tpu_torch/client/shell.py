"""Interactive shell: drive a node over RPC from a console.

Port of corda_tpu/client/shell.py: `Shell`, `connect_remote` (the
remote shell over the TCP fabric with TLS) and `main` (`python -m
corda_tpu_torch.client.shell`). Flows are named by the reference's tags
(client/common.py), so one command line starts the same flow in either
package.

Reference: the embedded CRaSH SSH shell (node/.../shell/
InteractiveShell.kt) — start flows from strings (`flow start CashIssue
quantity: 100`), watch running flows, run RPC ops by name, with
`StringToMethodCallParser` doing the argument binding and
ANSIProgressRenderer painting flow progress.

`Shell.run_command(line)` is the testable core; `Shell.repl()` wraps it
in a stdin loop. The shell talks pure RPC — it has no more power than
any other client (the reference's shell runs through CordaRPCOps the
same way)."""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from ..node import rpc as rpclib
from . import json_support as js
from .common import FLOW_SEARCH_PACKAGES, FlowLookupError, find_flow_class, wait_rpc

HELP = """\
commands:
  flow start <FlowClass> [name: value, ...]   start a flow, wait for result
  flow list                                   registered responder protocols
  flow watch                                  live state-machine feed (10s)
  flow watch <FlowClass> [name: value, ...]   start + live progress render
  run <rpc-method> [json-args...]             call any RPC method
  peers                                       network map snapshot
  notaries                                    notary identities
  vault [ContractTag]                         unconsumed states
  time                                        node clock
  help                                        this text
  quit                                        leave
"""

class Shell:
    def __init__(
        self,
        client: rpclib.RPCClient,
        pump: Callable[[], None],
        timeout: float = 90.0,
    ):
        """`pump` drives message delivery while the shell waits (the
        node loopback passes node.pump; a remote console pumps its own
        endpoint)."""
        self.client = client
        self.pump = pump
        self.timeout = timeout
        # live-repaint sink for `flow watch` (the repl sets it to print;
        # embedded/test use reads the returned final frame instead)
        self.echo: Optional[Callable[[str], None]] = None

    # -- plumbing ------------------------------------------------------------

    def wait(self, fut, timeout: Optional[float] = None):
        return wait_rpc(fut, self.pump, timeout or self.timeout)

    def _party_resolver(self):
        """One snapshot fetch per command, however many bare-word
        party arguments it has."""
        cache: dict = {}

        def resolve(name: str):
            if not cache:
                for info in self.wait(self.client.network_map_snapshot()):
                    cache[info.legal_identity.name] = info.legal_identity
                for party in self.wait(self.client.notary_identities()):
                    cache.setdefault(party.name, party)
            return cache.get(name)

        return resolve

    # -- commands ------------------------------------------------------------

    def run_command(self, line: str) -> str:
        line = line.strip()
        if not line or line == "help":
            return HELP
        try:
            if line.startswith("flow start "):
                return self._flow_start(line[len("flow start "):])
            if line == "flow list":
                flows = self.wait(self.client.registered_flows())
                return "\n".join(flows)
            if line.startswith("flow watch "):
                return self._flow_watch_one(line[len("flow watch "):])
            if line == "flow watch":
                return self._flow_watch()
            if line.startswith("run "):
                return self._run_rpc(line[len("run "):])
            if line == "peers":
                infos = self.wait(self.client.network_map_snapshot())
                return "\n".join(
                    f"{i.legal_identity.name:<20} {i.address}"
                    f"{' [notary]' if any(s.startswith('corda.notary') for s in i.advertised_services) else ''}"
                    for i in infos
                )
            if line == "notaries":
                return "\n".join(
                    p.name for p in self.wait(self.client.notary_identities())
                )
            if line.startswith("vault"):
                return self._vault(line[len("vault"):].strip())
            if line == "time":
                return str(self.wait(self.client.current_node_time()))
            return f"unknown command {line.split()[0]!r}; try 'help'"
        except (js.CallParseError, FlowLookupError, TimeoutError, rpclib.RpcError) as e:
            return f"error: {e}"

    def _flow_start(self, rest: str) -> str:
        parts = rest.split(None, 1)
        flow_tag = find_flow_class(parts[0])
        args = js.parse_flow_args(
            parts[1] if len(parts) > 1 else "", self._party_resolver()
        )
        handle = self.wait(self.client.call("start_flow", flow_tag, args))
        try:
            result = self.wait(handle.result)
        except rpclib.RpcError as e:
            return f"flow failed: {e}"
        return f"flow completed: {_render(result)}"

    def _flow_watch(self, duration: float = 10.0) -> str:
        feed = self.wait(self.client.state_machines_feed())
        lines = [
            f"  {info.flow_id.hex()[:8]} {info.flow_tag}"
            for info in feed.snapshot
        ]
        events: list[str] = []
        feed.updates.subscribe(
            lambda u: events.append(
                f"  [{u.kind}] {u.info.flow_id.hex()[:8]} {u.info.flow_tag}"
            )
        )
        deadline = time.monotonic() + duration
        while time.monotonic() < deadline and not events:
            self.pump()
            time.sleep(0.05)
        feed.close()
        return "\n".join(
            ["running:"] + (lines or ["  (none)"]) + ["events:"]
            + (events or ["  (none)"])
        )

    def _flow_watch_one(self, rest: str, echo=None) -> str:
        """`flow watch <FlowClass> [args]`: start the flow and live-
        render its progress-step tree from the RPC progress feed
        (InteractiveShell flow watch + ANSIProgressRenderer.kt /
        FlowWatchPrintingSubscriber.kt). `echo` receives each repaint in
        the repl; the final frame + result is the return value."""
        from ..flows.api import ProgressTracker
        from ..utils.progress_render import render

        parts = rest.split(None, 1)
        flow_tag = find_flow_class(parts[0])
        args = js.parse_flow_args(
            parts[1] if len(parts) > 1 else "", self._party_resolver()
        )
        echo = echo if echo is not None else self.echo
        handle = self.wait(self.client.call("start_flow", flow_tag, args))
        # declared steps (pending rows in the render) come from the
        # progress feed's snapshot; live labels from the handle's
        # replayed stream, which missed nothing since flow start
        try:
            feed = self.wait(self.client.flow_progress_feed(handle.flow_id))
            mirror = ProgressTracker(*feed.snapshot.steps)
            feed.close()
        except (rpclib.RpcError, TimeoutError):
            mirror = ProgressTracker()

        def on_label(label: str) -> None:
            mirror.current = label
            mirror.history.append(label)
            if echo is not None:
                echo(render(mirror, ansi=True))

        unsub = (
            handle.progress.subscribe(on_label)
            if handle.progress is not None
            else lambda: None
        )
        try:
            result = self.wait(handle.result)
            outcome = f"flow completed: {_render(result)}"
        except rpclib.RpcError as e:
            outcome = f"flow failed: {e}"
        finally:
            unsub()
        tree = render(mirror, ansi=False)
        return (tree + "\n" if tree else "") + outcome

    def _run_rpc(self, rest: str) -> str:
        parts = rest.split(None, 1)
        method = parts[0]
        args = ()
        if len(parts) > 1:
            import json as _json

            parsed = _json.loads(f"[{parts[1]}]")
            args = tuple(js.from_jsonable(a) for a in parsed)
        result = self.wait(self.client.call(method, *args))
        return _render(result)

    def _vault(self, contract_tag: str) -> str:
        from ..node.vault_query import VaultQueryCriteria

        criteria = (
            VaultQueryCriteria(contract_state_types=(contract_tag,))
            if contract_tag
            else VaultQueryCriteria()
        )
        page = self.wait(self.client.vault_query_by(criteria))
        if not page.states:
            return "(vault empty)"
        out = []
        for sar in page.states:
            out.append(f"  {sar.ref}: {sar.state.data}")
        out.append(f"total: {page.total_states_available}")
        return "\n".join(out)

    # -- interactive ---------------------------------------------------------

    def repl(self, prompt: str = ">>> ") -> None:
        print("corda_tpu_torch shell — 'help' for commands")
        if self.echo is None:
            self.echo = print   # live progress repaints
        while True:
            try:
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                return
            if line.strip() in ("quit", "exit"):
                return
            out = self.run_command(line)
            if out:
                print(out)


def _render(value) -> str:
    try:
        return js.dumps(value, indent=2)
    except ValueError:
        return repr(value)


# -- remote login ------------------------------------------------------------


def connect_remote(
    host: str,
    port: int,
    node: str,
    fingerprint: bytes,
    user: str,
    password: str,
    console_name: Optional[str] = None,
    db_path: Optional[str] = None,
    timeout: float = 90.0,
):
    """Open a remote shell session against a live node — the
    remote-login story (reference: the embedded CRaSH SSH shell,
    node/.../shell/InteractiveShell.kt). Instead of running an SSH
    server in the node, the operator connects over the node's OWN
    authenticated transport: the TLS fabric with certificate pinning
    (`fingerprint` is the node's TLS cert fingerprint, printed at boot
    and held by the operator) plus the RPC user login — so the shell
    has exactly an RPC client's power and the node grows no second
    remote-access surface. See docs/node-administration.md for the
    SSH-protocol descope rationale.

    Returns (shell, close): a ready Shell and the cleanup callable.
    """
    import secrets
    import shutil
    import tempfile

    from ..crypto import schemes
    from ..node.fabric import FabricEndpoint, PeerAddress
    from ..node.persistence import NodeDatabase

    name = console_name or f"console-{secrets.token_hex(4)}"
    tmp_dir = None
    if db_path is None:
        tmp_dir = tempfile.mkdtemp(prefix="corda_shell_")
        db_path = os.path.join(tmp_dir, "console.db")
    db = NodeDatabase(db_path)
    ep = None

    def close() -> None:
        if ep is not None:
            ep.stop()
        db.close()
        if tmp_dir is not None:   # only remove what THIS call created
            shutil.rmtree(tmp_dir, ignore_errors=True)

    try:
        kp = schemes.generate_keypair(seed=secrets.randbits(128))
        target = PeerAddress(host, port, bytes(fingerprint))
        ep = FabricEndpoint(
            name, kp, db, resolve=lambda peer: target if peer == node else None
        )
        ep.start()
        client = rpclib.RPCClient(ep, node, user, password)
    except Exception:
        close()
        raise
    shell = Shell(client, pump=ep.pump, timeout=timeout)
    return shell, close


def main(argv=None) -> int:
    import argparse
    import getpass

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.client.shell",
        description=(
            "remote node shell: connects over the node's TLS fabric "
            "(certificate-pinned) and authenticates as an RPC user"
        ),
    )
    parser.add_argument("--host", required=True, help="node p2p host")
    parser.add_argument(
        "--port", type=int, required=True, help="node p2p port"
    )
    parser.add_argument(
        "--node", required=True, help="the node's legal/peer name"
    )
    parser.add_argument(
        "--fingerprint", required=True,
        help="node TLS certificate fingerprint, hex (printed at boot)",
    )
    parser.add_argument("--user", required=True, help="RPC username")
    parser.add_argument(
        "--password", default=None,
        help="RPC password (prompted when omitted)",
    )
    parser.add_argument(
        "--timeout", type=float, default=90.0, help="per-command seconds"
    )
    args = parser.parse_args(argv)
    try:
        fingerprint = bytes.fromhex(args.fingerprint)
    except ValueError:
        parser.error("--fingerprint must be hex")
    password = args.password or getpass.getpass(f"{args.user}@{args.node}: ")
    shell, close = connect_remote(
        args.host, args.port, args.node, fingerprint,
        args.user, password, timeout=args.timeout,
    )
    try:
        shell.repl(prompt=f"{args.user}@{args.node}> ")
    finally:
        close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
