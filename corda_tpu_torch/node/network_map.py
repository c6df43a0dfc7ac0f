"""Network map service: the node directory protocol.

Port of corda_tpu/node/network_map.py: `NodeRegistration`,
`sign_registration`, the wire messages (the reference's class tags, so
registrations and map updates are byte-equal), `NetworkMapService`,
`NetworkMapClient` with TTL re-registration, and
`advertise_network_map`.

Reference: node/.../services/network/NetworkMapService.kt:62 — a
register/fetch/subscribe/push protocol over messaging topics
(FETCH_TOPIC/QUERY_TOPIC/REGISTER_TOPIC/SUBSCRIPTION_TOPIC/PUSH_TOPIC/
PUSH_ACK_TOPIC, `:64-75`), with signed `NodeRegistration`s carrying a
monotonically-increasing serial and an expiry, an in-memory
(InMemoryNetworkMapService) and a persistent (PersistentNetworkMapService)
implementation, and subscriber eviction after too many unacknowledged
pushes.

Design notes vs the reference:
- Registrations are signed over the canonical (CTS) encoding of the
  registration record and verified with the registering party's identity
  key — same trust model as the reference's `WireNodeRegistration`
  (NodeRegistration.toWire / verified in processRegistrationChangeRequest).
- The map service is just another topic handler on the fabric; any node
  can host it (the reference advertises it as `corda.network_map`).
- Clients keep their `NetworkMapCache` + `IdentityService` in sync from
  fetch responses and pushes (AbstractNode.registerWithNetworkMap:593).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..core import serialization as ser
from ..core.identity import Party
from ..crypto import schemes
from .messaging import Message, MessagingService
from .services import NetworkMapCache, NodeInfo, SERVICE_NETWORK_MAP

TOPIC_NM_REGISTER = "platform.network_map.register"
TOPIC_NM_FETCH = "platform.network_map.fetch"
TOPIC_NM_SUBSCRIBE = "platform.network_map.subscribe"
TOPIC_NM_PUSH = "platform.network_map.push"
TOPIC_NM_PUSH_ACK = "platform.network_map.push_ack"
TOPIC_NM_REPLY = "platform.network_map.reply"

ADD = "add"
REMOVE = "remove"

# Subscribers that fall this many un-acked pushes behind are dropped
# (reference: NetworkMapService maxUnacknowledgedUpdates = 10).
MAX_UNACKED_UPDATES = 10


@dataclass(frozen=True)
class NodeRegistration:
    """A signed-over change request: add/remove one node (reference:
    NetworkMapService.kt NodeRegistration — serial guards replay,
    expires bounds validity)."""

    info: NodeInfo
    serial: int
    op: str                 # ADD | REMOVE
    expires_micros: int


@dataclass(frozen=True)
class WireNodeRegistration:
    """Canonical bytes of a NodeRegistration + identity-key signature."""

    raw: bytes
    signature: bytes

    def verified(self) -> NodeRegistration:
        reg = ser.decode(self.raw)
        if not isinstance(reg, NodeRegistration):
            raise ValueError("registration payload is not a NodeRegistration")
        key = reg.info.legal_identity.owning_key
        if not schemes.verify_one(key, self.signature, self.raw):
            raise ValueError(f"bad registration signature for {reg.info.legal_identity}")
        return reg


def sign_registration(reg: NodeRegistration, priv: schemes.PrivateKey) -> WireNodeRegistration:
    raw = ser.encode(reg)
    return WireNodeRegistration(raw, priv.sign(raw))


@dataclass(frozen=True)
class RegistrationRequest:
    wire: WireNodeRegistration
    req_id: int


@dataclass(frozen=True)
class RegistrationResponse:
    req_id: int
    error: Optional[str]


@dataclass(frozen=True)
class FetchMapRequest:
    req_id: int
    subscribe: bool
    if_changed_since: Optional[int]    # map version, None = always send


@dataclass(frozen=True)
class FetchMapResponse:
    req_id: int
    version: int
    registrations: Optional[tuple]     # of WireNodeRegistration; None if unchanged


@dataclass(frozen=True)
class MapUpdate:
    wire: WireNodeRegistration
    version: int


@dataclass(frozen=True)
class MapUpdateAck:
    version: int


for _cls in (
    NodeRegistration,
    WireNodeRegistration,
    RegistrationRequest,
    RegistrationResponse,
    FetchMapRequest,
    FetchMapResponse,
    MapUpdate,
    MapUpdateAck,
):
    ser.serializable(_cls)


class NetworkMapService:
    """The directory server side (InMemory/PersistentNetworkMapService).

    Pass a NodeDatabase to persist registrations across restarts — they
    are reloaded (and re-verified) at construction, mirroring
    PersistentNetworkMapService's JDBC-backed registration map.
    """

    def __init__(self, messaging: MessagingService, clock, db=None, services=None):
        """`services`: the hosting node's ServiceHub — accepted
        registrations mirror into its own NetworkMapCache/IdentityService
        so the host can route back to registrants (the reference's map
        node shares the node's cache the same way)."""
        self._messaging = messaging
        self._clock = clock
        self._services = services
        self._registry: dict[str, WireNodeRegistration] = {}
        # Replay + hijack protection. The latest registration per name is
        # persisted even for REMOVE (a tombstone), so neither the serial
        # high-water mark nor the name->key binding resets on restart:
        self._serials: dict[str, int] = {}
        self._bindings: dict[str, bytes] = {}   # name -> key fingerprint
        self._version = 0
        # subscriber address -> un-acked push count
        self._subscribers: dict[str, int] = {}
        self._store = self._meta = None
        if db is not None:
            from .persistence import PersistentKVStore

            self._store = PersistentKVStore(db, "network_map")
            self._meta = PersistentKVStore(db, "network_map_meta")
            for key, blob in self._store.items():
                try:
                    wire = ser.decode(blob)
                    reg = wire.verified()
                except (ValueError, ser.SerializationError):
                    continue
                name = reg.info.legal_identity.name
                self._serials[name] = reg.serial
                self._bindings[name] = (
                    reg.info.legal_identity.owning_key.fingerprint()
                )
                if reg.op == ADD:
                    self._registry[name] = wire
                    self._mirror(reg)
            stored_version = self._meta.get(b"version")
            if stored_version is not None:
                self._version = ser.decode(stored_version)
        messaging.add_handler(TOPIC_NM_REGISTER, self._on_register)
        messaging.add_handler(TOPIC_NM_FETCH, self._on_fetch)
        messaging.add_handler(TOPIC_NM_SUBSCRIBE, self._on_subscribe)
        messaging.add_handler(TOPIC_NM_PUSH_ACK, self._on_push_ack)

    # -- request processing --------------------------------------------------

    @staticmethod
    def _decoded(msg: Message, expected: type):
        """Decode a request, dropping malformed payloads instead of
        letting them crash the message pump (an unauthenticated peer
        must not be able to DoS the directory with garbage bytes)."""
        try:
            req = ser.decode(msg.payload)
        except ser.SerializationError:
            return None
        return req if isinstance(req, expected) else None

    def _on_register(self, msg: Message) -> None:
        req = self._decoded(msg, RegistrationRequest)
        if req is None:
            return
        error = None
        try:
            self._process_registration(req.wire)
        except (ValueError, ser.SerializationError) as e:
            error = str(e)
        self._reply(msg.sender, RegistrationResponse(req.req_id, error))

    def _process_registration(self, wire: WireNodeRegistration) -> None:
        reg = wire.verified()
        name = reg.info.legal_identity.name
        if reg.op not in (ADD, REMOVE):
            raise ValueError(f"unknown registration op {reg.op!r}")
        if reg.expires_micros <= self._clock.now_micros():
            raise ValueError("registration has expired")
        # Key continuity: the first registration binds name -> key; later
        # changes must be signed by that same key (verified() has already
        # checked the signature against the in-payload key, so equality of
        # fingerprints makes it a check against the bound key). Without
        # this, anyone could re-register a peer's name under their own key
        # and hijack its address + identity at every subscriber.
        fp = reg.info.legal_identity.owning_key.fingerprint()
        bound = self._bindings.get(name)
        if bound is not None and fp != bound:
            raise ValueError(f"identity key mismatch for {name!r}")
        prev = self._serials.get(name)
        if prev is not None and reg.serial <= prev:
            raise ValueError(
                f"serial {reg.serial} is not newer than {prev} (replay?)"
            )
        self._serials[name] = reg.serial
        self._bindings[name] = fp
        if reg.op == ADD:
            self._registry[name] = wire
        else:
            self._registry.pop(name, None)
        if self._store is not None:
            # REMOVE persists as a tombstone: it carries the serial and
            # binding forward across restarts so the old ADD can't be
            # replayed to resurrect a deregistered node.
            self._store.put(name.encode(), ser.encode(wire))
        self._version += 1
        if self._meta is not None:
            self._meta.put(b"version", ser.encode(self._version))
        self._mirror(reg)
        self._push(wire)

    def _mirror(self, reg: NodeRegistration) -> None:
        """Reflect an accepted registration into the host's own cache."""
        if self._services is None:
            return
        if reg.op == ADD:
            self._services.network_map_cache.add_node(reg.info)
            self._services.identity.register(reg.info.legal_identity)
        else:
            self._services.network_map_cache.remove_node(reg.info)

    def _push(self, wire: WireNodeRegistration) -> None:
        update = ser.encode(MapUpdate(wire, self._version))
        for address in list(self._subscribers):
            self._subscribers[address] += 1
            if self._subscribers[address] > MAX_UNACKED_UPDATES:
                # slow consumer: drop; it will re-fetch on reconnect
                del self._subscribers[address]
                continue
            self._messaging.send(TOPIC_NM_PUSH, update, address)

    def _on_fetch(self, msg: Message) -> None:
        req = self._decoded(msg, FetchMapRequest)
        if req is None:
            return
        if req.subscribe:
            self._subscribers[msg.sender] = 0
        unchanged = (
            req.if_changed_since is not None
            and req.if_changed_since == self._version
        )
        regs = None if unchanged else tuple(self._registry.values())
        self._reply(msg.sender, FetchMapResponse(req.req_id, self._version, regs))

    def _on_subscribe(self, msg: Message) -> None:
        self._subscribers[msg.sender] = 0

    def _on_push_ack(self, msg: Message) -> None:
        if msg.sender in self._subscribers:
            self._subscribers[msg.sender] = 0

    def _reply(self, address: str, response) -> None:
        self._messaging.send(TOPIC_NM_REPLY, ser.encode(response), address)

    # -- introspection -------------------------------------------------------

    @property
    def version(self) -> int:
        return self._version

    def registered_names(self) -> list[str]:
        return sorted(self._registry)

    def subscriber_count(self) -> int:
        return len(self._subscribers)


class NetworkMapClient:
    """Client side: registers this node, mirrors the map into the local
    NetworkMapCache/IdentityService (AbstractNode.registerWithNetworkMap).
    """

    DEFAULT_TTL_MICROS = 365 * 24 * 3600 * 1_000_000   # 1 year, like the ref
    # periodic re-registration: the map's last-seen stamp is the
    # explorer network view's liveness signal, and without renewal it
    # would freeze at boot time. Re-ADDs are tiny
    # signed deltas; subscribers re-stamp on the push.
    RENEW_MICROS = 60 * 1_000_000

    def __init__(
        self,
        services,
        messaging: MessagingService,
        map_address: str,
        identity_priv: schemes.PrivateKey,
    ):
        self._services = services
        self._messaging = messaging
        self._map_address = map_address
        self._priv = identity_priv
        self._next_req = 0
        self._pending: dict[int, Callable] = {}
        self.registration_error: Optional[str] = None
        # mirror of the service's replay/continuity guards, so a stale or
        # forged push can't roll this client's view backwards:
        self._serials: dict[str, int] = {}
        self._bindings: dict[str, bytes] = {}
        self._known: set[str] = set()   # names this client learned from the map
        self.registered = False
        self.map_version: Optional[int] = None
        self._last_renewal = 0
        messaging.add_handler(TOPIC_NM_REPLY, self._on_reply)
        messaging.add_handler(TOPIC_NM_PUSH, self._on_push)

    # -- outbound ------------------------------------------------------------

    def register(
        self,
        op: str = ADD,
        on_done: Optional[Callable] = None,
        on_error: Optional[Callable[[str], None]] = None,
    ) -> None:
        """Publish our own NodeInfo (serial = clock micros: monotone
        across restarts, the reference uses Instant serials). Rejection
        is reported via `on_error`/`registration_error`, never raised —
        the reply handler runs inside the message pump, and a throw
        there would abort delivery of unrelated traffic."""
        reg = NodeRegistration(
            info=self._services.my_info,
            serial=self._services.clock.now_micros(),
            op=op,
            expires_micros=self._services.clock.now_micros() + self.DEFAULT_TTL_MICROS,
        )
        self._last_renewal = self._services.clock.now_micros()
        wire = sign_registration(reg, self._priv)
        req_id = self._fresh_req_id()

        def handle(resp: RegistrationResponse):
            if resp.error is not None:
                self.registration_error = resp.error
                if on_error is not None:
                    on_error(resp.error)
                else:
                    import logging

                    logging.getLogger("corda_tpu_torch.network_map").warning(
                        "network map rejected registration: %s", resp.error
                    )
                return
            self.registration_error = None
            self.registered = True
            if on_done is not None:
                on_done(resp)

        self._pending[req_id] = handle
        self._messaging.send(
            TOPIC_NM_REGISTER,
            ser.encode(RegistrationRequest(wire, req_id)),
            self._map_address,
        )

    def fetch(self, subscribe: bool = True) -> None:
        """Pull the whole map (and subscribe to future deltas)."""
        req_id = self._fresh_req_id()
        self._pending[req_id] = self._apply_fetch
        self._messaging.send(
            TOPIC_NM_FETCH,
            ser.encode(FetchMapRequest(req_id, subscribe, self.map_version)),
            self._map_address,
        )

    def deregister(self, on_done: Optional[Callable] = None) -> None:
        self.register(op=REMOVE, on_done=on_done)

    def tick(self, now: Optional[int] = None) -> None:
        """Heartbeat renewal (called from the node pump): re-register
        every RENEW_MICROS so the map's last-seen stays a liveness
        signal — a node that stops ticking ages visibly in every
        peer's network view."""
        if not self.registered:
            return
        now = now if now is not None else self._services.clock.now_micros()
        if now - self._last_renewal >= self.RENEW_MICROS:
            self.register()

    # -- inbound -------------------------------------------------------------

    def _on_reply(self, msg: Message) -> None:
        if msg.sender != self._map_address:
            return   # replies are only trusted from our map service
        try:
            resp = ser.decode(msg.payload)
        except ser.SerializationError:
            return
        handler = self._pending.pop(resp.req_id, None)
        if handler is not None:
            handler(resp)

    def _apply_fetch(self, resp: FetchMapResponse) -> None:
        self.map_version = resp.version
        if resp.registrations is None:
            return
        live: set[str] = set()
        for wire in resp.registrations:
            applied = self._apply_wire(wire)
            if applied is not None:
                live.add(applied)
        # A full fetch is authoritative: any node we previously learned
        # from the map that is absent now has deregistered — drop it, or
        # its stale address would be routed to forever.
        cache: NetworkMapCache = self._services.network_map_cache
        for name in self._known - live:
            info = cache.node_by_name(name)
            if info is not None:
                cache.remove_node(info)
        self._known = live

    def _on_push(self, msg: Message) -> None:
        if msg.sender != self._map_address:
            return   # only the map service may push to us
        try:
            update = ser.decode(msg.payload)
        except ser.SerializationError:
            return
        self._apply_wire(update.wire)
        self.map_version = update.version
        self._messaging.send(
            TOPIC_NM_PUSH_ACK,
            ser.encode(MapUpdateAck(update.version)),
            self._map_address,
        )

    def _apply_wire(self, wire: WireNodeRegistration) -> Optional[str]:
        """Apply one registration; returns the node name if it is (still)
        live after this wire, None if rejected or removed."""
        try:
            reg = wire.verified()
        except ValueError:
            return None   # a bad registration from the service is ignored
        name = reg.info.legal_identity.name
        fp = reg.info.legal_identity.owning_key.fingerprint()
        bound = self._bindings.get(name)
        if bound is not None and fp != bound:
            return None   # name hijack attempt: key changed mid-stream
        prev = self._serials.get(name)
        if prev is not None and reg.serial < prev:
            return None   # stale replayed registration
        self._serials[name] = reg.serial
        self._bindings[name] = fp
        cache: NetworkMapCache = self._services.network_map_cache
        if reg.op == ADD:
            cache.add_node(reg.info)
            self._services.identity.register(reg.info.legal_identity)
            self._known.add(name)
            return name
        cache.remove_node(reg.info)
        self._known.discard(name)
        return None

    def _fresh_req_id(self) -> int:
        self._next_req += 1
        return self._next_req


def advertise_network_map(info: NodeInfo) -> NodeInfo:
    """Return a copy of `info` advertising the network-map service."""
    return NodeInfo(
        info.address,
        info.legal_identity,
        info.advertised_services + (SERVICE_NETWORK_MAP,),
    )
