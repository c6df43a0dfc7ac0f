"""DCN message fabric: durable, ordered, authenticated P2P queues.

Port of corda_tpu/node/fabric.py: `FabricEndpoint`, `PeerAddress`,
`TlsIdentity` with fingerprint pinning, the nonce handshake, the
outbound and inbound sqlite journals (the reference's DDL, frame bytes
and uid mapping, so a journal written by either package drains in the
other), the per-peer bridges, the trace and deadline headers, parked
topics, `pump` and `wire_depths`, and the wire-telemetry seam
(`telemetry`: codec walls split native vs Python, journal append and
commit latency, frames per link, redeliveries and dedupe hits).
Like the reference's, this fabric has no ingest-ring seam
(`add_ring` raises), so ring consumers use the handler path.

Reference: the Artemis messaging layer — an embedded broker per node
with store-and-forward queues and per-peer TLS bridges deployed on
demand (node/.../messaging/ArtemisMessagingServer.kt:90,300-401,
cert-pinning connector :471), consumed through the `MessagingService`
API (Messaging.kt) by `NodeMessagingClient` (NodeMessagingClient.kt:71)
with JDBC-backed redelivery (`messagesToRedeliver` :110) and dedupe.

Not a broker translation (SURVEY §2.5): an asyncio TCP fabric where
each node owns
  * an outbound journal (sqlite): per-peer FIFO, survives restarts,
    drained by one bridge task per peer with exponential-backoff
    reconnects; rows delete only on peer ack (at-least-once),
  * an inbound journal: frames land durably BEFORE they are acked,
    dedup by (sender, uid) primary key, and are dispatched to handlers
    exactly once — handler effects and the processed-flag update share
    one database transaction (the reference's bufferUntilDatabaseCommit
    discipline),
  * channel security: optional TLS with certificate pinning by SHA-256
    fingerprint (the VerifyingNettyConnectorFactory move) plus
    application-layer mutual authentication — each side signs the
    other's nonce with its node identity key, so trust roots in ledger
    identities rather than a CA hierarchy (X509Utilities' role).

The card's work stays out of this layer: it runs inside the
verification kernels; the fabric moves ledger data between hosts. The
wire envelope is canonical CTS bytes; uids are stable across restarts
so replayed sends dedupe at the receiver.
"""

from __future__ import annotations

import asyncio
import hashlib
import ssl
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from ..core import serialization as ser
from ..crypto import schemes
from .messaging import (
    DEDUPE_KEEP,
    FabricFaults,
    Handler,
    Message,
    MessagingService,
)

_FABRIC_SCHEMA = """
CREATE TABLE IF NOT EXISTS fabric_out (
    seq     INTEGER PRIMARY KEY AUTOINCREMENT,
    peer    TEXT NOT NULL,
    topic   TEXT NOT NULL,
    payload BLOB NOT NULL,
    uid     INTEGER NOT NULL,
    headers BLOB,
    UNIQUE (peer, uid) ON CONFLICT IGNORE
);
CREATE INDEX IF NOT EXISTS fabric_out_peer ON fabric_out (peer, seq);
CREATE TABLE IF NOT EXISTS fabric_in (
    sender    TEXT NOT NULL,
    uid       INTEGER NOT NULL,
    arrival   INTEGER NOT NULL,
    topic     TEXT NOT NULL,
    payload   BLOB NOT NULL,
    processed INTEGER NOT NULL DEFAULT 0,
    headers   BLOB,
    PRIMARY KEY (sender, uid)
);
CREATE INDEX IF NOT EXISTS fabric_in_pending ON fabric_in (processed, arrival);
CREATE TABLE IF NOT EXISTS fabric_meta (
    k TEXT PRIMARY KEY,
    v INTEGER NOT NULL
);
"""

# databases from before the headers column lack it; CREATE IF NOT
# EXISTS won't add it, so migrate in place — idempotent, and a journal
# written before the upgrade simply carries NULL headers
_FABRIC_MIGRATIONS = (
    "ALTER TABLE fabric_out ADD COLUMN headers BLOB",
    "ALTER TABLE fabric_in ADD COLUMN headers BLOB",
)


def _encode_headers(trace, deadline) -> Optional[bytes]:
    """Wire/journal form of the optional message headers: None when
    there is nothing to carry (the common case costs zero bytes), else
    one canonical blob of [trace, deadline]."""
    if trace is None and deadline is None:
        return None
    return ser.encode([list(trace) if trace is not None else None, deadline])


def _decode_headers(blob) -> tuple[Optional[tuple], Optional[int]]:
    """Best-effort header decode: headers are QoS/observability
    metadata, so a malformed blob degrades to no-headers rather than
    poisoning delivery."""
    if not blob:
        return None, None
    try:
        trace, deadline = ser.decode(bytes(blob))
        if trace is not None:
            trace = tuple(int(x) for x in trace)
        if deadline is not None:
            deadline = int(deadline)
        return trace, deadline
    except Exception:
        return None, None


def _to_db_uid(uid: int) -> int:
    """Message uids are unsigned 64-bit (the SMM's hashed ids set the
    top bit); sqlite INTEGER is signed 64-bit — map through two's
    complement at the storage boundary."""
    return uid - 2**64 if uid >= 2**63 else uid


def _from_db_uid(uid: int) -> int:
    return uid + 2**64 if uid < 0 else uid


# processed fabric_in rows are the durable dedupe table; the prune in
# `_prune_dedupe` bounds them to the newest messaging.DEDUPE_KEEP per
# sender, checked once every this many ingests
_DEDUPE_PRUNE_EVERY = 256


# ---------------------------------------------------------------------------
# framing


async def _read_frame(reader: asyncio.StreamReader, telemetry=None) -> list:
    try:
        header = await reader.readexactly(4)
        length = int.from_bytes(header, "big")
        if length > 64 * 1024 * 1024:
            raise ConnectionError("frame too large")
        body = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("peer closed mid-frame") from e
    t0 = time.perf_counter() if telemetry is not None else 0.0
    try:
        frame = ser.decode(body)
    except ser.SerializationError as e:
        raise ConnectionError(f"undecodable frame: {e}") from e
    if not isinstance(frame, list) or not frame:
        raise ConnectionError("malformed frame")
    if telemetry is not None and frame[0] == "msg" and len(frame) >= 3:
        telemetry.record_codec(
            "decode", ser._native_codec() is not None, str(frame[2]),
            time.perf_counter() - t0, len(body),
        )
    return frame


def _write_frame(
    writer: asyncio.StreamWriter, frame: list, telemetry=None
) -> None:
    t0 = time.perf_counter() if telemetry is not None else 0.0
    body = ser.encode(frame)
    if telemetry is not None and frame[0] == "msg":
        telemetry.record_codec(
            "encode", ser._native_codec() is not None, str(frame[2]),
            time.perf_counter() - t0, len(body),
        )
    writer.write(len(body).to_bytes(4, "big") + body)


# ---------------------------------------------------------------------------
# transport security


@dataclass
class PeerAddress:
    host: str
    port: int
    tls_fingerprint: Optional[bytes] = None   # pinned server-cert sha256


class TlsIdentity:
    """Self-signed TLS material for one node. Peers authenticate the
    *channel* by pinning this cert's SHA-256 fingerprint (advertised
    through the network map, like the reference's cert-pinning bridge)
    — node *identity* is proven separately by the key-signed nonce
    handshake, so the cert needs no chain."""

    def __init__(self, cert_pem: bytes, key_pem: bytes):
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.fingerprint = _cert_fingerprint(cert_pem)

    @staticmethod
    def generate(common_name: str) -> "TlsIdentity":
        # one certificate-construction recipe for the whole codebase
        # (utils.x509 owns it; the identity-hierarchy path and this
        # self-signed TLS path must not silently diverge)
        from ..utils.x509 import create_self_signed

        pair = create_self_signed(common_name)
        return TlsIdentity(pair.cert_pem, pair.key_pem)

    def server_context(self) -> ssl.SSLContext:
        import tempfile

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        with tempfile.NamedTemporaryFile(suffix=".pem") as f:
            f.write(self.cert_pem + self.key_pem)
            f.flush()
            ctx.load_cert_chain(f.name)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        return ctx


def client_context() -> ssl.SSLContext:
    """Chain validation is OFF — trust is the pinned fingerprint checked
    after the handshake (self-signed certs have no chain to validate)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx


def _cert_fingerprint(cert_pem: bytes) -> bytes:
    der = ssl.PEM_cert_to_DER_cert(cert_pem.decode())
    return hashlib.sha256(der).digest()


# ---------------------------------------------------------------------------
# the endpoint


class FabricEndpoint(MessagingService):
    """One node's fabric endpoint: server + per-peer bridges + journals.

    Threading model: asyncio IO runs on a dedicated loop thread; handler
    dispatch happens on whichever thread calls `pump()` — the node's
    single "server thread" (AffinityExecutor.kt role), keeping the SMM
    single-threaded. `send()` is safe from the pump thread.
    """

    def __init__(
        self,
        name: str,
        keypair: schemes.KeyPair,
        db,                                    # NodeDatabase
        resolve: Callable[[str], Optional[PeerAddress]],
        host: str = "127.0.0.1",
        port: int = 0,
        tls: Optional[TlsIdentity] = None,
        advertise_host: Optional[str] = None,
        faults: Optional[FabricFaults] = None,
        dedupe_keep: int = DEDUPE_KEEP,
        telemetry=None,
    ):
        self._name = name
        self._keypair = keypair
        self._db = db
        self._resolve = resolve
        self._host = host
        self._port = port
        self._tls = tls
        # first-class fault-injection seam (messaging.FabricFaults):
        # consulted at bridge-connect, accept and per-frame ingest time.
        # Durability does the heavy lifting — a blocked/dropped frame
        # stays journaled and redelivers on heal, a duplicated ingest is
        # absorbed by the (sender, uid) PRIMARY KEY — so chaos tests
        # exercise the SAME recovery paths a real outage would. None
        # (production default) costs one attribute check per frame.
        self.faults = faults
        # wire-telemetry seam (utils.wire_telemetry.WireAccounting):
        # mutable like `faults` — node.py attaches a WirePlane after
        # construction; None costs one attribute check per frame.
        # Recorded at: send (journal append/commit wall),
        # _write_frame/_read_frame (codec wall per topic), _drain_loop
        # (frames out + redelivery), _ingest (frames in + dedupe hits).
        self.telemetry = telemetry
        # per-sender bound on retained processed dedupe rows
        self.dedupe_keep = int(dedupe_keep)
        self._ingests_since_prune = 0
        # per-peer bridge high-water seq: a drained row at or below it
        # is a redelivery (rows delete on ack, seqs never reuse)
        self._sent_seq_hw: dict[str, int] = {}
        # the address peers should dial back (differs from the bind
        # host behind NAT or when bound to 0.0.0.0)
        self.advertise_host = advertise_host or host
        db.execute_script(_FABRIC_SCHEMA)
        import sqlite3

        for migration in _FABRIC_MIGRATIONS:
            try:
                db.execute(migration)
            except sqlite3.OperationalError as e:
                # only the expected already-migrated case is benign; a
                # locked/full/corrupt database must fail HERE, not as a
                # missing-column error on every later send()
                if "duplicate column" not in str(e).lower():
                    raise
        self._handlers: dict[str, list[Handler]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._bridges: dict[str, asyncio.Event] = {}
        self._pump_wake = threading.Event()
        self._parked: deque = deque()   # undispatchable (no handler yet)
        self.running = False
        # peers that advertised their listen address at auth time
        # (ad-hoc clients: RPC consoles, verifier workers); consulted
        # after the injected resolver
        self.learned_peers: dict[str, PeerAddress] = {}
        self.advertise_listen_port = True
        self._arrival_counter = self._load_arrival_counter()

    # -- MessagingService ---------------------------------------------------

    @property
    def my_address(self) -> str:
        return self._name

    @property
    def listen_port(self) -> int:
        return self._port

    def send(
        self,
        topic: str,
        payload: bytes,
        target: str,
        unique_id: Optional[int] = None,
        trace: Optional[tuple] = None,
        deadline: Optional[int] = None,
    ) -> None:
        """Durably journal, then wake the peer's bridge. uid None mints
        an id from a persistent monotonic counter — NEVER reused, even
        after rows ack away, because the receiver's dedupe key
        (sender, uid) lives forever: a recycled uid would be silently
        swallowed as a duplicate.

        The optional `trace` / `deadline` headers journal alongside the
        frame and cross the wire in a separate headers blob, so cross-
        process traces connect end-to-end and the receiver can shed an
        expired request pre-decode (node/qos.py). Both are metadata:
        dedupe, ordering and ack semantics key on (peer, uid, payload)
        exactly as before. Wire-format note: a frame CARRYING headers
        is a 6-element msg frame, which a pre-headers receiver rejects
        — both ends of a bridge must run this fabric version before
        senders attach headers (header-less sends keep the old
        5-element frame, so the upgrade order is receivers first)."""
        headers = _encode_headers(trace, deadline)
        tel = self.telemetry
        t0 = time.perf_counter() if tel is not None else 0.0
        t1 = t0
        with self._db.transaction():
            if unique_id is None:
                unique_id = self._next_uid()
            self._db.execute(
                "INSERT INTO fabric_out (peer, topic, payload, uid, headers)"
                " VALUES (?,?,?,?,?)",
                (target, topic, payload, _to_db_uid(unique_id), headers),
            )
            if tel is not None:
                t1 = time.perf_counter()
        if tel is not None:
            # append = the journaled INSERT, commit = the transaction
            # exit (WAL-mode fsync lands there)
            tel.record_journal(t1 - t0, time.perf_counter() - t1)
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._wake_bridge, target)

    def _next_uid(self) -> int:
        row = self._db.query(
            "SELECT v FROM fabric_meta WHERE k='next_uid'"
        )
        nxt = row[0][0] if row else 1
        self._db.execute(
            "INSERT OR REPLACE INTO fabric_meta (k, v) VALUES ('next_uid', ?)",
            (nxt + 1,),
        )
        return nxt

    def add_handler(self, topic: str, handler: Handler) -> None:
        self._handlers.setdefault(topic, []).append(handler)
        self._pump_wake.set()   # parked messages may now be deliverable

    def remove_handler(self, topic: str, handler: Handler) -> None:
        handlers = self._handlers.get(topic, [])
        if handler in handlers:
            handlers.remove(handler)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        started = threading.Event()
        self._thread = threading.Thread(
            target=self._run_loop, args=(started,), daemon=True,
            name=f"fabric-{self._name}",
        )
        self.running = True
        self._thread.start()
        started.wait(timeout=10)
        if self._loop is None or self._server is None:
            self.running = False
            raise RuntimeError("fabric loop failed to start")
        # wake bridges for any journal left over from a previous run
        for (peer,) in self._db.query(
            "SELECT DISTINCT peer FROM fabric_out"
        ):
            self._loop.call_soon_threadsafe(self._wake_bridge, peer)

    def stop(self) -> None:
        self.running = False
        if self._loop is not None:
            loop = self._loop

            def _shutdown():
                for task in asyncio.all_tasks(loop):
                    task.cancel()

            loop.call_soon_threadsafe(_shutdown)
            self._thread.join(timeout=5)
            self._loop = None

    def _run_loop(self, started: threading.Event) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def main():
            ssl_ctx = self._tls.server_context() if self._tls else None
            self._server = await asyncio.start_server(
                self._on_connection, self._host, self._port, ssl=ssl_ctx
            )
            self._port = self._server.sockets[0].getsockname()[1]
            started.set()
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

        try:
            loop.run_until_complete(main())
        except Exception:
            started.set()
        finally:
            try:
                pending = asyncio.all_tasks(loop)
                for t in pending:
                    t.cancel()
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            except Exception:
                pass
            loop.close()

    # -- outbound bridges ---------------------------------------------------

    def _wake_bridge(self, peer: str) -> None:
        ev = self._bridges.get(peer)
        if ev is None:
            ev = asyncio.Event()
            self._bridges[peer] = ev
            asyncio.ensure_future(self._bridge_task(peer, ev))
        ev.set()

    async def _bridge_task(self, peer: str, wake: asyncio.Event) -> None:
        """Drain the peer's outbound journal over one long-lived
        connection (re-auth only on reconnect); exponential backoff on
        failure (ArtemisMessagingServer deployBridge +
        messagesToRedeliver semantics)."""
        backoff = 0.05
        while self.running:
            if not self._db.query(
                "SELECT 1 FROM fabric_out WHERE peer=? LIMIT 1", (peer,)
            ):
                wake.clear()
                try:
                    await asyncio.wait_for(wake.wait(), timeout=30)
                except asyncio.TimeoutError:
                    continue
            if self.faults is not None and self.faults.blocked(
                self._name, peer
            ):
                # partitioned / peer down: hold the journal and retry —
                # the SAME backoff loop an unreachable peer exercises,
                # without burning a connect attempt
                await asyncio.sleep(min(backoff, 5.0))
                backoff = min(backoff * 2, 5.0)
                continue
            addr = self._resolve(peer) or self.learned_peers.get(peer)
            if addr is None:
                await asyncio.sleep(min(backoff, 5.0))
                backoff = min(backoff * 2, 5.0)
                continue
            try:
                reader, writer = await self._connect(addr)
                try:
                    await self._auth_client(reader, writer, addr)
                    backoff = 0.05
                    await self._drain_loop(peer, wake, reader, writer)
                finally:
                    writer.close()
                    try:
                        await writer.wait_closed()
                    except Exception:
                        pass
            except (OSError, ConnectionError, asyncio.TimeoutError, ssl.SSLError):
                await asyncio.sleep(min(backoff, 5.0))
                backoff = min(backoff * 2, 5.0)

    async def _drain_loop(self, peer, wake, reader, writer) -> None:
        """Pump batches over one authenticated connection until idle
        for 30s (then close to free the socket) or an error."""
        while self.running:
            rows = self._db.query(
                "SELECT seq, topic, payload, uid, headers FROM fabric_out"
                " WHERE peer=? ORDER BY seq LIMIT 256",
                (peer,),
            )
            if not rows:
                wake.clear()
                try:
                    await asyncio.wait_for(wake.wait(), timeout=30)
                    continue
                except asyncio.TimeoutError:
                    return   # idle: close connection, journal is empty
            tel = self.telemetry
            for seq, topic, payload, uid, headers in rows:
                frame = ["msg", seq, topic, bytes(payload), _from_db_uid(uid)]
                if headers is not None:
                    # headers ride as a 6th element; pre-headers peers
                    # never see it (their journals carry NULL)
                    frame.append(bytes(headers))
                _write_frame(writer, frame, tel)
                if seq <= self._sent_seq_hw.get(peer, 0):
                    # this row already crossed the wire on an earlier
                    # connection and was never acked — at-least-once
                    # redelivery, counted per peer
                    if tel is not None:
                        tel.record_redelivery(peer)
                else:
                    self._sent_seq_hw[peer] = seq
                if tel is not None:
                    tel.record_frame("out", peer, topic, len(payload))
            await writer.drain()
            for _ in rows:
                frame = await asyncio.wait_for(_read_frame(reader), timeout=30)
                if frame[0] != "ack":
                    raise ConnectionError(f"expected ack, got {frame[0]!r}")
                self._db.execute(
                    "DELETE FROM fabric_out WHERE seq=? AND peer=?",
                    (frame[1], peer),
                )

    async def _connect(self, addr: PeerAddress):
        ctx = None
        if addr.tls_fingerprint is not None:
            ctx = client_context()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(addr.host, addr.port, ssl=ctx),
            timeout=10,
        )
        if addr.tls_fingerprint is not None:
            der = writer.get_extra_info("ssl_object").getpeercert(
                binary_form=True
            )
            if hashlib.sha256(der).digest() != addr.tls_fingerprint:
                writer.close()
                raise ConnectionError("TLS certificate fingerprint mismatch")
        return reader, writer

    async def _auth_client(self, reader, writer, addr: PeerAddress) -> None:
        """Mutual nonce-signing handshake (client side): prove we hold
        our identity key; no secrets on the wire."""
        hello = await asyncio.wait_for(_read_frame(reader), timeout=10)
        if hello[0] != "challenge":
            raise ConnectionError("bad handshake")
        nonce = bytes(hello[1])
        sig = self._keypair.private.sign(b"fabric-auth" + nonce)
        _write_frame(
            writer,
            [
                "auth",
                self._name,
                self._keypair.public.scheme_id,
                self._keypair.public.data,
                sig,
                self.advertise_host,
                self._port if self.advertise_listen_port else 0,
                self._tls.fingerprint if self._tls else b"",
            ],
        )
        await writer.drain()
        ok = await asyncio.wait_for(_read_frame(reader), timeout=10)
        if ok[0] != "ok":
            raise ConnectionError(f"auth rejected: {ok!r}")

    # -- inbound ------------------------------------------------------------

    async def _on_connection(self, reader, writer) -> None:
        try:
            sender = await self._auth_server(reader, writer)
            faults = self.faults
            if faults is not None and faults.blocked(sender, self._name):
                # inbound partition: refuse the authenticated peer —
                # its journal holds the frames for redelivery on heal
                raise ConnectionError("fault: partitioned")
            while True:
                frame = await _read_frame(reader, self.telemetry)
                if frame[0] != "msg":
                    raise ConnectionError(f"unexpected frame {frame[0]!r}")
                if len(frame) not in (5, 6):
                    raise ConnectionError("malformed msg frame")
                seq, topic, payload, uid = frame[1:5]
                headers = bytes(frame[5]) if len(frame) == 6 else None
                faults = self.faults
                if faults is not None:
                    if faults.blocked(sender, self._name):
                        # partition landed mid-stream: sever BEFORE the
                        # ack so the sender's journal keeps the row
                        raise ConnectionError("fault: partitioned")
                    delay = faults.delay_micros(sender, self._name)
                    if delay:
                        # slow peer: real seconds on the real fabric
                        await asyncio.sleep(delay / 1e6)
                    if faults.should_drop(sender, self._name):
                        # frame lost on the wire: unacked, so the
                        # bridge re-sends it after reconnect/backoff —
                        # at-least-once does the healing
                        raise ConnectionError("fault: frame dropped")
                self._ingest(sender, topic, bytes(payload), uid, headers)
                if faults is not None and faults.should_duplicate(
                    sender, self._name
                ):
                    # wire duplication: the (sender, uid) PRIMARY KEY
                    # swallows the copy before it can re-dispatch
                    self._ingest(sender, topic, bytes(payload), uid, headers)
                _write_frame(writer, ["ack", seq])
                await writer.drain()
        except (
            OSError,
            ConnectionError,
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            ser.SerializationError,
        ):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    async def _auth_server(self, reader, writer) -> str:
        """Server side of the nonce handshake: challenge, verify the
        signature against the sender's claimed identity key, and check
        that key against the network map (resolve) so a peer cannot
        impersonate another name."""
        import os

        nonce = os.urandom(32)
        _write_frame(writer, ["challenge", nonce])
        await writer.drain()
        frame = await asyncio.wait_for(_read_frame(reader), timeout=10)
        if frame[0] != "auth" or len(frame) not in (5, 8):
            raise ConnectionError("bad auth frame")
        name, scheme_id, key_data, sig = frame[1:5]
        pub = schemes.PublicKey(scheme_id, bytes(key_data))
        if not schemes.verify_one(pub, bytes(sig), b"fabric-auth" + nonce):
            _write_frame(writer, ["reject", "bad signature"])
            raise ConnectionError("auth signature invalid")
        expected = self._expected_key(name)
        if expected is not None and expected != pub:
            _write_frame(writer, ["reject", "identity key mismatch"])
            raise ConnectionError("auth key does not match network map")
        if len(frame) == 8 and frame[6]:
            # the peer advertised its own dial-back address + TLS pin
            # (RPC consoles and verifier workers are reachable but not
            # map-registered; the node learns the return route at auth
            # time). Only honoured for names the map does not govern: a
            # map-known name must route via its registered NodeInfo, or
            # any key-holder could redirect it.
            if expected is None:
                fp = bytes(frame[7]) or None
                self.learned_peers[name] = PeerAddress(
                    str(frame[5]), int(frame[6]), fp
                )
        _write_frame(writer, ["ok"])
        await writer.drain()
        return name

    def _expected_key(self, peer_name: str) -> Optional[schemes.PublicKey]:
        """Hook: subclass/NodeFabric wires this to the network map. A
        None result admits the peer on signature alone (pre-registration
        window, like the reference's network-map bootstrap)."""
        resolver = getattr(self, "expected_identity_key", None)
        return resolver(peer_name) if resolver else None

    def _load_arrival_counter(self) -> int:
        row = self._db.query("SELECT MAX(arrival) FROM fabric_in")
        return (row[0][0] or 0) + 1

    def _ingest(
        self,
        sender: str,
        topic: str,
        payload: bytes,
        uid: int,
        headers: Optional[bytes] = None,
    ) -> None:
        """Durable + deduped BEFORE ack: the PRIMARY KEY swallows
        duplicates so redelivered frames ack without re-dispatch.
        Headers land durably too — a frame redelivered after a crash
        keeps its trace link and (crucially) its deadline."""
        self._arrival_counter += 1
        cur = self._db.execute(
            "INSERT OR IGNORE INTO fabric_in"
            " (sender, uid, arrival, topic, payload, headers)"
            " VALUES (?,?,?,?,?,?)",
            (
                sender, _to_db_uid(uid), self._arrival_counter,
                topic, payload, headers,
            ),
        )
        tel = self.telemetry
        if tel is not None:
            if cur.rowcount == 0:
                # IGNOREd: the (sender, uid) dedupe key swallowed it
                tel.record_dedupe_hit(sender)
            else:
                tel.record_frame("in", sender, topic, len(payload))
        self._ingests_since_prune += 1
        if self._ingests_since_prune >= _DEDUPE_PRUNE_EVERY:
            self._ingests_since_prune = 0
            self._prune_dedupe()
        self._pump_wake.set()

    def _prune_dedupe(self) -> None:
        """Bound the durable dedupe table: keep the newest
        `dedupe_keep` DISPATCHED rows per sender (by arrival
        watermark), delete older ones. processed=0 rows are the live
        inbound queue and processed=2 the dead-letter forensics —
        neither is touched. Safe because the sender deletes acked
        journal rows: only an explicit `unique_id=` replay could carry
        a uid older than the watermark."""
        for (sender,) in self._db.query(
            "SELECT DISTINCT sender FROM fabric_in WHERE processed=1"
        ):
            row = self._db.query(
                "SELECT arrival FROM fabric_in"
                " WHERE sender=? AND processed=1"
                " ORDER BY arrival DESC LIMIT 1 OFFSET ?",
                (sender, self.dedupe_keep - 1),
            )
            if row:
                self._db.execute(
                    "DELETE FROM fabric_in"
                    " WHERE sender=? AND processed=1 AND arrival<?",
                    (sender, row[0][0]),
                )

    def wire_depths(self) -> dict:
        """The WirePlane's per-tick depth pull (attach_fabric adopts
        it): outbound journal depth total and per peer (the unacked
        backlog) plus the retained dedupe-table depth — COUNT queries
        paid once per tick, never on the send path."""
        backlog = {
            peer: n for peer, n in self._db.query(
                "SELECT peer, COUNT(*) FROM fabric_out GROUP BY peer"
            )
        }
        dedupe = self._db.query(
            "SELECT COUNT(*) FROM fabric_in WHERE processed=1"
        )[0][0]
        return {
            "journal_depth": sum(backlog.values()),
            "dedupe_depth": dedupe,
            "backlog": backlog,
        }

    # -- dispatch (server thread) -------------------------------------------

    def pump(self, block: bool = False, timeout: float = 1.0) -> int:
        """Deliver unprocessed inbound messages to handlers on the
        calling thread. Handler effects + the processed flag share one
        DB transaction; a handler exception dead-letters the message
        (processed=2) rather than wedging the queue. Messages for
        topics with no handler yet stay parked (processed=0) without
        blocking other topics. Returns count delivered."""
        if block and not self._pending_rows():
            self._pump_wake.wait(timeout)
        self._pump_wake.clear()
        delivered = 0
        while True:
            rows = self._pending_rows()
            if not rows:
                break
            for sender, uid, topic, payload, headers in rows:
                trace, deadline = _decode_headers(headers)
                msg = Message(
                    topic, bytes(payload), sender, _from_db_uid(uid),
                    trace, deadline,
                )
                try:
                    with self._db.transaction():
                        for h in list(self._handlers.get(topic, ())):
                            h(msg)
                        self._db.execute(
                            "UPDATE fabric_in SET processed=1"
                            " WHERE sender=? AND uid=?",
                            (sender, uid),
                        )
                except Exception:
                    import logging

                    logging.getLogger("corda_tpu_torch.fabric").exception(
                        "handler failed; dead-lettering %s from %s",
                        topic,
                        sender,
                    )
                    self._db.execute(
                        "UPDATE fabric_in SET processed=2"
                        " WHERE sender=? AND uid=?",
                        (sender, uid),
                    )
                delivered += 1
        return delivered

    def _pending_rows(self):
        """Unprocessed rows for topics we can dispatch right now —
        parked topics never head-of-line-block handled ones."""
        topics = [t for t, hs in self._handlers.items() if hs]
        if not topics:
            return []
        placeholders = ",".join("?" * len(topics))
        return self._db.query(
            "SELECT sender, uid, topic, payload, headers FROM fabric_in"
            f" WHERE processed=0 AND topic IN ({placeholders})"
            " ORDER BY arrival LIMIT 64",
            tuple(topics),
        )

    @property
    def pending_inbound(self) -> int:
        return self._db.query(
            "SELECT COUNT(*) FROM fabric_in WHERE processed=0"
        )[0][0]

    @property
    def pending_outbound(self) -> int:
        return self._db.query("SELECT COUNT(*) FROM fabric_out")[0][0]
