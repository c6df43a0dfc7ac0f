"""DemoBench: interactively assemble a local demo network.

Reference: tools/demobench/ — the desktop app that spawns local node
processes one at a time (first node hosts the network map), shows each
node's terminal pane, and lets the user open an explorer against any of
them. Here it is a terminal REPL + a programmatic API; panes are log
files under the bench directory (`tail -f` is the pane).

    python -m corda_tpu_torch.tools.demobench ./bench
      bench> add Notary notary=validating
      bench> add Alice
      bench> add Bob
      bench> status
      bench> explorer Alice
      bench> quit

Port of corda_tpu/tools/demobench.py. Each node is a `python -m
corda_tpu_torch.node` process whose `verifier_backend` keeps the
NodeConfig default, "tpu", the port's name for the card: every node
verifies on its own CudaBatchVerifier. Pass `verifier_backend="cpu"`
to `add_node` (or `add NAME verifier_backend=cpu` at the prompt) to run
the nodes without a card.
"""

from __future__ import annotations

import os
import selectors
import subprocess
import sys
import threading
import time
from typing import Optional

from ..crypto import schemes
from ..node import rpc as rpclib
from ..node.config import NodeConfig, RpcUserConfig, write_config
from ..node.fabric import FabricEndpoint, PeerAddress, TlsIdentity
from ..node.persistence import NodeDatabase, PersistentKVStore

BENCH_USER = RpcUserConfig("user1", "password", ("ALL",))


def read_tls_fingerprint(base_dir: str) -> Optional[bytes]:
    """Read a booted node's pinned TLS cert fingerprint from its DB
    (what the reference gets from the node's certificates directory)."""
    path = os.path.join(base_dir, "node.db")
    if not os.path.exists(path):
        return None
    db = NodeDatabase(path)
    try:
        store = PersistentKVStore(db, "node_tls")
        cert = store.get(b"cert")
        key = store.get(b"key")
        if cert is None:
            return None
        return TlsIdentity(bytes(cert), bytes(key)).fingerprint
    finally:
        db.close()


class BenchNode:
    """One spawned node process + its pane (log file)."""

    def __init__(self, name, config, process, port, log_path):
        self.name = name
        self.config = config
        self.process = process
        self.port = port
        self.log_path = log_path
        # keep draining stdout into the pane AFTER boot: the port
        # handshake reader stops at P2P_PORT=, but later announcements
        # (WEB_PORT=, runtime prints) must reach the pane — and an
        # undrained pipe would eventually block a chatty node.
        # (explorer/graphs wrap already-running processes in a
        # stand-in with no stdout: nothing to drain there)
        if getattr(process, "stdout", None) is not None:
            threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        stdout = self.process.stdout
        try:
            os.set_blocking(stdout.fileno(), True)
            # read1, not read: read(n) on a buffered pipe blocks until
            # n bytes accumulate — a short announcement line would sit
            # invisible until the next flush filled the buffer
            for chunk in iter(lambda: stdout.read1(4096), b""):
                with open(self.log_path, "ab") as pane:
                    pane.write(chunk)
        except (OSError, ValueError):
            pass   # process gone / fd closed: pane is complete

    @property
    def alive(self) -> bool:
        return self.process.poll() is None

    def stop(self) -> None:
        if self.alive:
            self.process.terminate()
            try:
                self.process.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.process.kill()


class DemoBench:
    """Spawn/stop local nodes; first added node hosts the network map
    (DemoBench adds the network-map/notary node first the same way)."""

    def __init__(self, bench_dir: str, base_port: int = 10_000):
        self.bench_dir = os.path.abspath(bench_dir)
        os.makedirs(self.bench_dir, exist_ok=True)
        self.base_port = base_port
        self.nodes: dict[str, BenchNode] = {}
        self._order: list[str] = []
        self._ports_used = 0
        self._console = None
        self._console_db = None
        self._clients: dict[str, rpclib.RPCClient] = {}

    # -- lifecycle -----------------------------------------------------------

    def add_node(
        self,
        name: str,
        notary: str = "",
        timeout: float = 120.0,
        register_lock=None,
        **config_kw,
    ) -> BenchNode:
        """`register_lock`: held around the COMPLETION mutation (nodes
        dict, _order, client invalidation) so a launcher whose readers
        take the same lock (web_demobench status/pane) can never
        observe a half-registered node. The slow boot itself runs
        outside it."""
        if name in self.nodes and self.nodes[name].alive:
            raise ValueError(f"node {name!r} already running")
        # monotonic allocation: a stop/re-add cycle must never hand a
        # port that a later add would also compute
        port = self.base_port + self._ports_used
        self._ports_used += 1
        map_host = self._map_host()
        if map_host is not None:
            config_kw.setdefault("network_map_peer", map_host.name)
            config_kw.setdefault("network_map_host", "127.0.0.1")
            config_kw.setdefault("network_map_port", map_host.port)
            config_kw.setdefault(
                "network_map_fingerprint",
                read_tls_fingerprint(map_host.config.base_dir),
            )
        cfg = NodeConfig(
            name=name,
            base_dir=os.path.join(self.bench_dir, name),
            p2p_port=port,
            notary=notary,
            rpc_users=(BENCH_USER,),
            key_seed=_stable_seed(name),
            **config_kw,
        )
        os.makedirs(cfg.base_dir, exist_ok=True)
        config_path = os.path.join(cfg.base_dir, "node.toml")
        write_config(cfg, config_path)
        log_path = os.path.join(cfg.base_dir, "node.log")
        log = open(log_path, "ab")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "corda_tpu_torch.node",
                "--config", config_path, "--print-port",
            ],
            stdout=subprocess.PIPE,
            stderr=log,
            env={**os.environ, "PYTHONUNBUFFERED": "1"},
        )
        bound = self._await_port(proc, log_path, name, timeout)
        node = BenchNode(name, cfg, proc, bound, log_path)
        import contextlib

        with register_lock or contextlib.nullcontext():
            self.nodes[name] = node
            if name not in self._order:
                self._order.append(name)
            self._clients = {
                k: v for k, v in self._clients.items()
                if k.split(":", 1)[0] != name
            }
        return node

    @staticmethod
    def _await_port(proc, log_path, name, timeout) -> int:
        """Wait for the P2P_PORT= handshake line (node __main__
        --print-port), echoing other stdout into the pane log."""
        sel = selectors.DefaultSelector()
        os.set_blocking(proc.stdout.fileno(), False)
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + timeout
        buf, port = "", None
        try:
            while port is None and time.monotonic() < deadline:
                if not sel.select(timeout=0.2):
                    if proc.poll() is not None:
                        break
                    continue
                chunk = os.read(proc.stdout.fileno(), 4096).decode(
                    errors="replace"
                )
                if not chunk and proc.poll() is not None:
                    break
                buf += chunk
                while "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    if line.startswith("P2P_PORT="):
                        port = int(line.strip().split("=")[1])
                        break
                    with open(log_path, "ab") as pane:
                        pane.write((line + "\n").encode())
        finally:
            sel.close()
            if buf:
                # anything read past the handshake line belongs to the
                # pane (e.g. a WEB_PORT= announcement sharing the chunk)
                with open(log_path, "ab") as pane:
                    pane.write(buf.encode())
        if port is None:
            proc.kill()
            raise RuntimeError(
                f"node {name} failed to start; see {log_path}"
            )
        return port

    def _map_host(self) -> Optional[BenchNode]:
        for name in self._order:
            node = self.nodes.get(name)
            if node is not None:
                return node
        return None

    def stop_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node is not None:
            node.stop()

    def shutdown(self) -> None:
        # reverse order: the map host goes down last
        for name in reversed(self._order):
            self.stop_node(name)
        if self._console is not None:
            self._console.stop()
            self._console_db.close()
            self._console = None

    def status(self) -> str:
        lines = []
        for name in self._order:
            node = self.nodes.get(name)
            if node is None:
                lines.append(f"  {name:16s} stopped")
            else:
                state = "up" if node.alive else "DEAD"
                mark = " [map host]" if node is self._map_host() else ""
                lines.append(
                    f"  {name:16s} {state}  port={node.port}  "
                    f"pane={node.log_path}{mark}"
                )
        return "\n".join(lines) or "  (no nodes)"

    # -- RPC console ---------------------------------------------------------

    def _ensure_console(self):
        if self._console is None:
            self._console_db = NodeDatabase(
                os.path.join(self.bench_dir, "bench-console.db")
            )
            self._console = FabricEndpoint(
                "bench-console",
                schemes.generate_keypair(seed=0xBE7C4),
                self._console_db,
                resolve=self._resolve,
            )
            self._console.start()
        return self._console

    def _resolve(self, peer: str) -> Optional[PeerAddress]:
        node = self.nodes.get(peer)
        if node is None:
            return None
        return PeerAddress(
            "127.0.0.1", node.port,
            read_tls_fingerprint(node.config.base_dir),
        )

    def rpc(self, name: str) -> rpclib.RPCClient:
        console = self._ensure_console()
        key = f"{name}:{BENCH_USER.username}"
        if key not in self._clients:
            self._clients[key] = rpclib.RPCClient(
                console, name, BENCH_USER.username, BENCH_USER.password
            )
        return self._clients[key]

    def pump(self) -> None:
        self._ensure_console().pump()

    def wait(self, fut, timeout: float = 90.0):
        deadline = time.monotonic() + timeout
        while not fut.done and time.monotonic() < deadline:
            self.pump()
            time.sleep(0.01)
        if not fut.done:
            raise TimeoutError("RPC future did not resolve")
        return fut.get()


def _stable_seed(name: str) -> int:
    import hashlib

    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big") + 1


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.demobench",
        description="Assemble a local demo network interactively",
    )
    parser.add_argument("bench_dir")
    parser.add_argument("--base-port", type=int, default=10_000)
    args = parser.parse_args(argv)

    bench = DemoBench(args.bench_dir, args.base_port)
    print("demobench — commands: add NAME [notary=validating] | "
          "stop NAME | status | explorer NAME | quit")
    try:
        while True:
            try:
                line = input("bench> ").strip()
            except EOFError:
                break
            if not line:
                continue
            cmd, *rest = line.split()
            try:
                if cmd == "add":
                    name = rest[0]
                    kw = dict(kv.split("=", 1) for kv in rest[1:])
                    node = bench.add_node(name, **kw)
                    print(f"{name} up on port {node.port}")
                elif cmd == "stop":
                    bench.stop_node(rest[0])
                elif cmd == "status":
                    print(bench.status())
                elif cmd == "explorer":
                    from .explorer import Explorer

                    ex = Explorer(_PumpedOps(bench, rest[0]))
                    print(ex.render())
                    ex.close()
                elif cmd in ("quit", "exit"):
                    break
                else:
                    print(f"unknown command {cmd!r}")
            except Exception as e:   # REPL resilience
                print(f"error: {e}")
    finally:
        bench.shutdown()
    return 0


def _PumpedOps(bench: DemoBench, name: str):
    """Bench RPC client whose calls pump to resolution (models.PumpedOps
    over the bench console)."""
    from .models import PumpedOps

    return PumpedOps(bench.rpc(name), bench.pump)


if __name__ == "__main__":
    raise SystemExit(main())
