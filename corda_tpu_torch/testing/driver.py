"""Driver DSL: spawn real node processes, drive them over RPC, tear down.

Reference: the Driver DSL (test-utils/.../testing/driver/Driver.kt:
64-70) — spawns actual node JVMs (ProcessUtilities.kt), starts the
network-map node first, waits on handshakes, allocates ports, and tears
everything down via a ShutdownManager; `startNodesInProcess` exists for
debugging. Specialised drivers (RPCDriver, VerifierDriver) build on it.

Usage:
    with driver(base_dir) as d:
        notary = d.start_node("Notary", notary="validating")
        alice = d.start_node("Alice")
        cli = d.rpc(alice)
        handle = d.wait(cli.start_flow(...))
        d.wait(handle.result)

Nodes run `python -m corda_tpu_torch.node` as real OS processes; the
driver holds one console fabric endpoint that can reach every node (TLS
fingerprints read from each node's database after boot).

Port of corda_tpu/testing/driver.py. One difference: a node's
`verifier_backend` defaults to "tpu", the port's name for the card
(each node process verifies on its own CudaBatchVerifier), where the
reference's driver defaults to its CPU verifier. Pass
`verifier_backend="cpu"` to run the nodes without a card. The
`node.toml` both drivers write for the same arguments is otherwise
byte-equal.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Optional

from ..crypto import schemes
from ..node import rpc as rpclib
from ..node.config import NodeConfig, RpcUserConfig, write_config
from ..node.fabric import FabricEndpoint, PeerAddress, TlsIdentity
from ..node.persistence import NodeDatabase, PersistentKVStore

DEFAULT_USER = RpcUserConfig("driver", "driver-pw", ("ALL",))


def _stable_seed(name: str) -> int:
    """Process-independent (PYTHONHASHSEED-proof) dev key seed: a new
    driver session over an existing base_dir must regenerate the SAME
    config a previous session wrote."""
    import hashlib

    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big") + 1


@dataclass
class NodeHandle:
    """One spawned node process (Driver.kt NodeHandle)."""

    name: str
    config: NodeConfig
    process: subprocess.Popen
    p2p_port: int
    tls_fingerprint: Optional[bytes]
    stderr_path: str

    @property
    def address(self) -> PeerAddress:
        return PeerAddress("127.0.0.1", self.p2p_port, self.tls_fingerprint)

    def kill(self) -> None:
        """SIGKILL — the crash-test move (Disruption.kt 'kill')."""
        if self.process.poll() is None:
            self.process.kill()
            self.process.wait(timeout=10)

    def sigstop(self) -> None:
        """Hang the process without killing it (Disruption.kt:17)."""
        self.process.send_signal(signal.SIGSTOP)

    def sigcont(self) -> None:
        self.process.send_signal(signal.SIGCONT)

    def terminate(self) -> int:
        if self.process.poll() is None:
            self.process.send_signal(signal.SIGTERM)
            try:
                return self.process.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.process.kill()
                return self.process.wait(timeout=5)
        return self.process.returncode

    @property
    def alive(self) -> bool:
        return self.process.poll() is None

    def stderr_tail(self, n: int = 2000) -> str:
        try:
            with open(self.stderr_path) as f:
                return f.read()[-n:]
        except OSError:
            return ""


class DriverTimeout(AssertionError):
    pass


class Driver:
    """The running driver session (use via the `driver()` context
    manager). Starts a map-host first; later nodes register with it."""

    def __init__(self, base_dir: str, env_overrides: Optional[dict] = None):
        self.base_dir = str(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.nodes: dict[str, NodeHandle] = {}
        self.map_host: Optional[NodeHandle] = None
        self._env = dict(os.environ)
        self._env["PYTHONPATH"] = (
            os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
            + ":" + self._env.get("PYTHONPATH", "")
        )
        if env_overrides:
            self._env.update(env_overrides)
        # the console endpoint (created lazily: needs no node)
        self._console_db = NodeDatabase(
            os.path.join(self.base_dir, "driver-console.db")
        )
        self._console = FabricEndpoint(
            "driver-console",
            schemes.generate_keypair(seed=0xD214E2),
            self._console_db,
            resolve=self._resolve,
        )
        self._console.start()
        self._clients: dict[str, rpclib.RPCClient] = {}

    # -- node lifecycle ------------------------------------------------------

    def start_node(
        self,
        name: str,
        timeout: float = 120.0,
        **config_kw,
    ) -> NodeHandle:
        """Spawn one node process; the first node becomes the network
        map host, later ones register with it (Driver.kt starts the
        map node first the same way)."""
        if self.map_host is not None and "network_map_peer" not in config_kw:
            config_kw.update(
                network_map_peer=self.map_host.name,
                network_map_host="127.0.0.1",
                network_map_port=self.map_host.p2p_port,
                network_map_fingerprint=self.map_host.tls_fingerprint,
            )
        cfg = NodeConfig(
            name=name,
            base_dir=os.path.join(self.base_dir, name),
            rpc_users=config_kw.pop("rpc_users", (DEFAULT_USER,)),
            key_seed=config_kw.pop("key_seed", _stable_seed(name)),
            # the card by default, as every entry point of the port:
            # each node process builds its own CudaBatchVerifier at its
            # first signature check (pass "cpu" to run without a card)
            verifier_backend=config_kw.pop("verifier_backend", "tpu"),
            **config_kw,
        )
        conf_path = os.path.join(self.base_dir, f"{name}.toml")
        write_config(cfg, conf_path)
        return self._spawn(cfg, conf_path, timeout)

    def restart_node(self, handle: NodeHandle, timeout: float = 120.0) -> NodeHandle:
        """Boot a replacement process over the same base_dir (state
        recovery drills — StabilityTest.kt's crash-restart soak). The
        replacement re-binds the SAME port: peers (and, for a restarted
        map host, statically-configured clients) keep routing to it."""
        import dataclasses

        if handle.alive:
            handle.terminate()
        cfg = dataclasses.replace(handle.config, p2p_port=handle.p2p_port)
        conf_path = os.path.join(self.base_dir, f"{handle.name}.toml")
        write_config(cfg, conf_path)
        replacement = self._spawn(cfg, conf_path, timeout)
        if self.map_host is not None and self.map_host.name == handle.name:
            self.map_host = replacement
        return replacement

    def _spawn(self, cfg: NodeConfig, conf_path: str, timeout: float) -> NodeHandle:
        stderr_path = os.path.join(self.base_dir, f"{cfg.name}.stderr")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "corda_tpu_torch.node",
                "--config", conf_path, "--print-port",
            ],
            stdout=subprocess.PIPE,   # binary: read raw, never block
            stderr=open(stderr_path, "a"),
            env=self._env,
        )
        import selectors

        port = None
        deadline = time.monotonic() + timeout
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        buf = ""
        try:
            while time.monotonic() < deadline:
                # poll, never block: a node wedged WITHOUT printing must
                # still hit the startup deadline
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
                while port is None and "\n" in buf:
                    line, buf = buf.split("\n", 1)
                    if line.startswith("P2P_PORT="):
                        port = int(line.strip().split("=")[1])
                if port is not None:
                    break
        finally:
            sel.close()
        if port is None:
            proc.kill()
            raise DriverTimeout(
                f"node {cfg.name} failed to start; stderr: "
                + open(stderr_path).read()[-2000:]
            )
        handle = NodeHandle(
            cfg.name, cfg, proc, port,
            self._read_tls_fingerprint(cfg), stderr_path,
        )
        self.nodes[cfg.name] = handle
        if self.map_host is None:
            self.map_host = handle
        for key in [
            k for k in self._clients if k.split(":", 1)[0] == cfg.name
        ]:
            del self._clients[key]   # stale clients after restart
        return handle

    @staticmethod
    def _read_tls_fingerprint(cfg: NodeConfig) -> Optional[bytes]:
        if not cfg.use_tls:
            return None
        db = NodeDatabase(os.path.join(cfg.base_dir, "node.db"))
        try:
            store = PersistentKVStore(db, "node_tls")
            cert = store.get(b"cert")
            key = store.get(b"key")
            if cert is None:
                return None
            return TlsIdentity(bytes(cert), bytes(key)).fingerprint
        finally:
            db.close()

    def _resolve(self, peer: str) -> Optional[PeerAddress]:
        handle = self.nodes.get(peer)
        return handle.address if handle else None

    # -- RPC -----------------------------------------------------------------

    def rpc(
        self,
        node: NodeHandle,
        username: str = DEFAULT_USER.username,
        password: str = DEFAULT_USER.password,
    ) -> rpclib.RPCClient:
        key = f"{node.name}:{username}"
        if key not in self._clients:
            self._clients[key] = rpclib.RPCClient(
                self._console, node.name, username, password
            )
        return self._clients[key]

    def wait(self, fut, timeout: float = 90.0):
        """Pump the console until the RPC future resolves."""
        deadline = time.monotonic() + timeout
        while not fut.done and time.monotonic() < deadline:
            self._console.pump()
            time.sleep(0.01)
        if not fut.done:
            raise DriverTimeout("RPC future did not resolve")
        return fut.get()

    def wait_until(self, predicate, timeout: float = 90.0, poll: float = 0.05):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._console.pump()
            if predicate():
                return True
            time.sleep(poll)
        raise DriverTimeout("condition not reached")

    def wait_for_network(self, n: int, timeout: float = 90.0) -> None:
        """Wait until some node's map shows n nodes (registration
        settled — Driver.kt's networkMapStartStrategy wait)."""
        any_node = next(iter(self.nodes.values()))
        cli = self.rpc(any_node)

        def settled():
            fut = cli.network_map_snapshot()
            try:
                self.wait(fut, timeout=10)
            except DriverTimeout:
                return False
            return len(fut.get()) >= n

        self.wait_until(settled, timeout=timeout)

    def identity_of(self, node: NodeHandle):
        """The node's legal identity Party, via RPC."""
        return self.wait(self.rpc(node).node_identity()).legal_identity

    def notary_identity(self, name: Optional[str] = None):
        any_node = next(iter(self.nodes.values()))
        ids = self.wait(self.rpc(any_node).notary_identities())
        if name is not None:
            ids = [p for p in ids if p.name == name]
        if not ids:
            raise DriverTimeout("no notary identity visible")
        return ids[0]

    # -- teardown ------------------------------------------------------------

    def shutdown(self) -> None:
        for handle in self.nodes.values():
            try:
                handle.terminate()
            except Exception:
                pass
        self._console.stop()
        self._console_db.close()


class driver:
    """Context manager entry point (the `driver { ... }` DSL)."""

    def __init__(self, base_dir: str, **kw):
        self._driver = Driver(base_dir, **kw)

    def __enter__(self) -> Driver:
        return self._driver

    def __exit__(self, exc_type, exc, tb) -> None:
        self._driver.shutdown()
