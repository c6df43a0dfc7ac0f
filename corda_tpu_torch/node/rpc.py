"""RPC: the node's client-facing API over the message fabric.

Port of corda_tpu/node/rpc.py: `CordaRPCOpsImpl`, `RPCServer`,
the wire types (the reference's class tags), `RPCUserService`
permissions (flow tags are the reference's paths, flows/api.py
`class_tag`, so one rpc_users table serves both packages), `RpcFuture`,
`ReplayObservable` and `RPCClient`.

Reference: `CordaRPCOps` (core/.../messaging/CordaRPCOps.kt:38-284) —
flow start, vault queries, snapshot+feed pairs; served by `RPCServer`
(node/.../messaging/RPCServer.kt:46-80: per-call dispatch, subscription
registry with reaping) and consumed through `CordaRPCClient` /
`RPCClientProxyHandler` (client/rpc/.../RPCClientProxyHandler.kt:37-68),
whose signature move is **Observables as first-class RPC results**: the
server captures returned feeds and streams tagged notifications; the
client rematerialises them. Wire protocol: node-api/.../RPCApi.kt
(ClientToServer/ServerToClient). Authentication/authorization:
`RPCUserService` (node/.../services/RPCUserService.kt) — config-defined
users with per-flow start permissions.

Design notes:
- Requests ride the fabric on `rpc.requests` addressed to the node;
  replies and observations return to the *caller's* fabric address —
  the same durable per-peer queue machinery as P2P (the reference
  multiplexes RPC onto the same Artemis broker with JAAS roles).
- A reply always precedes any observation for handles it carries
  (per-peer FIFO gives this for free), so the client never sees an
  observation for an unknown observable.
- Flow results stream as a one-shot observation hung off the SMM's
  lifecycle observers; feeds stream until the client unsubscribes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..core import serialization as ser
from ..flows.api import FlowLogic
from ..flows.api import class_tag as _class_tag
from ..flows.statemachine import (
    FlowStateMachine,
    StateMachineManager,
    construct_logic,
)
from .messaging import Message, MessagingService
from .services import DataFeed, Observable, ServiceHub
from .vault_query import PageSpecification, QueryCriteria, Sort

TOPIC_RPC_REQUEST = "rpc.requests"
TOPIC_RPC_REPLY = "rpc.replies"
TOPIC_RPC_OBSERVATION = "rpc.observations"
TOPIC_RPC_UNSUBSCRIBE = "rpc.unsubscribe"


class RpcError(Exception):
    """A server-side failure surfaced to the RPC caller."""

    def __init__(self, error_tag: str, message: str):
        self.error_tag = error_tag
        super().__init__(f"{error_tag}: {message}")


class RpcPermissionError(Exception):
    pass


# ---------------------------------------------------------------------------
# users & permissions


@dataclass(frozen=True)
class RpcUser:
    """One RPC login (reference: RPCUserService.kt User). Permissions:
    "ALL", or "StartFlow.<flow tag>" per startable flow."""

    username: str
    password: str
    permissions: tuple[str, ...] = ()


def start_flow_permission(flow_cls) -> str:
    return f"StartFlow.{_class_tag(flow_cls)}"


class RPCUserService:
    def __init__(self, *users: RpcUser):
        self._users = {u.username: u for u in users}

    def authenticate(self, username: str, password: str) -> Optional[RpcUser]:
        u = self._users.get(username)
        if u is None or u.password != password:
            return None
        return u

    @staticmethod
    def can_start_flow(user: RpcUser, flow_tag: str) -> bool:
        return "ALL" in user.permissions or (
            f"StartFlow.{flow_tag}" in user.permissions
        )


# ---------------------------------------------------------------------------
# wire protocol (RPCApi.kt ClientToServer / ServerToClient)


@dataclass(frozen=True)
class RpcRequest:
    req_id: int
    username: str
    password: str
    method: str
    args: tuple


@dataclass(frozen=True)
class RpcReply:
    req_id: int
    ok: bool
    value: Any                      # result tree (may contain handles)
    error_tag: Optional[str]
    error_message: Optional[str]


@dataclass(frozen=True)
class FeedHandle:
    """Marker for a DataFeed in a reply: snapshot + stream id."""

    observable_id: int
    snapshot: Any


@dataclass(frozen=True)
class FlowHandleWire:
    """Marker for a started flow: its id, the one-shot result stream,
    and the progress-step stream captured from the moment the flow
    started (CordaRPCOps FlowProgressHandle — capture must begin at
    start or synchronously-completing flows lose every label)."""

    flow_id: bytes
    result_observable_id: int
    progress_observable_id: Optional[int] = None


@dataclass(frozen=True)
class RpcObservation:
    observable_id: int
    item: Any


@dataclass(frozen=True)
class RpcUnsubscribe:
    observable_id: int


@dataclass(frozen=True)
class StateMachineInfo:
    """One running flow, as reported over RPC (CordaRPCOps.kt
    StateMachineInfo)."""

    flow_id: bytes
    flow_tag: str


@dataclass(frozen=True)
class StateMachineUpdate:
    """added/removed delta on the state-machines feed."""

    kind: str                       # "added" | "removed"
    info: StateMachineInfo


@dataclass(frozen=True)
class FlowProgressSnapshot:
    """A flow's progress-tracker state at subscription time: declared
    steps, the labels already announced, and the current one (CordaRPCOps
    FlowProgressHandle — what ANSIProgressRenderer consumes)."""

    flow_id: bytes
    steps: tuple[str, ...]
    history: tuple[str, ...]
    current: Optional[str]


for _cls in (
    RpcRequest,
    RpcReply,
    FeedHandle,
    FlowHandleWire,
    RpcObservation,
    RpcUnsubscribe,
    StateMachineInfo,
    StateMachineUpdate,
    FlowProgressSnapshot,
):
    ser.serializable(_cls)


# ---------------------------------------------------------------------------
# ops — the server-side API surface


def rpc_method(fn):
    """Mark a method as RPC-exposed (the dispatch allowlist — only
    marked methods are callable over the wire)."""
    fn._rpc_exposed = True
    return fn


def _subscribe_list(observers: list, cb) -> Callable[[], None]:
    """Append cb to a raw observer list, returning the unsubscriber
    (what Observable.subscribe gives for Observable sources)."""
    observers.append(cb)

    def unsubscribe():
        if cb in observers:
            observers.remove(cb)

    return unsubscribe


class CordaRPCOpsImpl:
    """The node-side implementation bridging to SMM/vault/storage
    (reference: node/.../internal/CordaRPCOpsImpl.kt)."""

    def __init__(self, services: ServiceHub, smm: StateMachineManager):
        self.services = services
        self.smm = smm

    # -- identity & time ----------------------------------------------------

    @rpc_method
    def node_identity(self):
        return self.services.my_info

    @rpc_method
    def current_node_time(self) -> int:
        return self.services.clock.now_micros()

    @rpc_method
    def notary_identities(self):
        return list(self.services.network_map_cache.notary_identities())

    # -- network map --------------------------------------------------------

    @rpc_method
    def network_map_snapshot(self):
        return list(self.services.network_map_cache.all_nodes())

    @rpc_method
    def network_map_last_seen(self) -> dict:
        """name -> micros of each peer's last map sighting (the
        explorer network view's liveness column)."""
        return dict(self.services.network_map_cache.last_seen)

    @rpc_method
    def network_map_feed(self) -> DataFeed:
        cache = self.services.network_map_cache
        updates = Observable()
        unsub = _subscribe_list(cache.observers, updates.emit)
        return DataFeed(list(cache.all_nodes()), updates, dispose=unsub)

    # -- vault --------------------------------------------------------------

    @rpc_method
    def vault_query_by(
        self,
        criteria: QueryCriteria,
        paging: Optional[PageSpecification] = None,
        sorting: Optional[Sort] = None,
    ):
        return self.services.vault.query_by(criteria, paging, sorting)

    @rpc_method
    def vault_track_by(
        self,
        criteria: QueryCriteria,
        paging: Optional[PageSpecification] = None,
        sorting: Optional[Sort] = None,
    ) -> DataFeed:
        return self.services.vault.track_by(criteria, paging, sorting)

    # -- transactions -------------------------------------------------------

    @rpc_method
    def verified_transactions_snapshot(self):
        return list(self.services.validated_transactions.all())

    @rpc_method
    def verified_transactions_count(self) -> int:
        """Count without copying the store over the wire (the explorer
        dashboard polls this every refresh)."""
        return self.services.validated_transactions.count()

    @rpc_method
    def transaction_by_id(self, tx_id):
        """One verified transaction (or None) without copying the
        store — the explorer's detail view resolves a transaction and
        its inputs' source transactions this way."""
        return self.services.validated_transactions.get(tx_id)

    @rpc_method
    def verified_transactions_feed(self) -> DataFeed:
        store = self.services.validated_transactions
        updates = Observable()
        unsub = _subscribe_list(store.observers, updates.emit)
        return DataFeed(list(store.all()), updates, dispose=unsub)

    # -- attachments --------------------------------------------------------

    @rpc_method
    def upload_attachment(self, data: bytes):
        return self.services.attachments.import_attachment(data)

    @rpc_method
    def attachment_exists(self, att_id) -> bool:
        return att_id in self.services.attachments

    @rpc_method
    def open_attachment(self, att_id) -> Optional[bytes]:
        att = self.services.attachments.open_attachment(att_id)
        return None if att is None else att.data

    # -- flows --------------------------------------------------------------

    @rpc_method
    def registered_flows(self) -> list[str]:
        from ..flows.api import registered_initiated_flows

        return sorted(registered_initiated_flows())

    @rpc_method
    def state_machines_snapshot(self):
        return [
            StateMachineInfo(fsm.id, fsm.root_tag)
            for fsm in self.smm.flows.values()
            if not fsm.done
        ]

    @rpc_method
    def state_machines_feed(self) -> DataFeed:
        updates = Observable()

        def on_change(kind: str, fsm: FlowStateMachine) -> None:
            updates.emit(
                StateMachineUpdate(kind, StateMachineInfo(fsm.id, fsm.root_tag))
            )

        unsub = _subscribe_list(self.smm.lifecycle, on_change)
        return DataFeed(self.state_machines_snapshot(), updates, dispose=unsub)

    @rpc_method
    def flow_progress_feed(self, flow_id: bytes) -> DataFeed:
        """Snapshot + live stream of one flow's progress-step labels
        (CordaRPCOps FlowProgressHandle; the shell's `flow watch`
        renders it with utils/progress_render)."""
        fsm = self.smm.flows.get(flow_id)
        tracker = (
            getattr(fsm.logic, "progress_tracker", None)
            if fsm is not None
            else None
        )
        snapshot = FlowProgressSnapshot(
            flow_id,
            tuple(tracker.steps) if tracker else (),
            tuple(tracker.history) if tracker else (),
            tracker.current if tracker else None,
        )
        updates = Observable()

        def on_step(changed_fsm, label: str) -> None:
            if changed_fsm.id == flow_id:
                updates.emit(label)

        unsub = _subscribe_list(self.smm.changes, on_step)
        return DataFeed(snapshot, updates, dispose=unsub)

    # start_flow is special-cased by the server (permissioning + flow
    # handle wiring); it is not a plain @rpc_method.
    def start_flow(self, flow_tag: str, kwargs: dict) -> FlowStateMachine:
        logic = construct_logic(flow_tag, kwargs)
        return self.smm.start_flow(logic)


# ---------------------------------------------------------------------------
# server


class RPCServer:
    """Dispatches RpcRequests onto the ops object; captures returned
    feeds/flows and streams them as observations (RPCServer.kt:46-80)."""

    # a client whose outbound journal backs up past this many frames is
    # presumed dead and reaped (the Artemis-notification reaping role,
    # RPCServer.kt:67-73 — our fabric has no disconnect signal, so
    # backlog pressure is the detector)
    MAX_CLIENT_BACKLOG = 10_000
    _BACKLOG_PROBE_EVERY = 64

    def __init__(
        self,
        ops: CordaRPCOpsImpl,
        messaging: MessagingService,
        user_service: RPCUserService,
        client_backlog: Optional[Callable[[str], int]] = None,
    ):
        self._ops = ops
        self._messaging = messaging
        self._users = user_service
        self._backlog = client_backlog
        self._next_obs = 0
        # (client_address, observable_id) -> dispose fn
        self._subs: dict[tuple[str, int], Callable[[], None]] = {}
        self._deferred: list[Callable[[], None]] = []
        self._obs_since_probe: dict[str, int] = {}
        messaging.add_handler(TOPIC_RPC_REQUEST, self._on_request)
        messaging.add_handler(TOPIC_RPC_UNSUBSCRIBE, self._on_unsubscribe)

    # -- request dispatch ----------------------------------------------------

    def _on_request(self, msg: Message) -> None:
        try:
            req = ser.decode(msg.payload)
        except Exception:
            # Malformed payloads (or argument objects whose validation
            # raises during decode) must not crash the message pump; with
            # no decodable req_id there is nothing to correlate a reply
            # to, so log and drop.
            import logging

            logging.getLogger("corda_tpu_torch.rpc").warning(
                "dropping undecodable RPC request from %s", msg.sender
            )
            return
        if not isinstance(req, RpcRequest):
            return
        try:
            value = self._dispatch(req, msg.sender)
            reply = RpcReply(req.req_id, True, value, None, None)
        except Exception as e:
            reply = RpcReply(
                req.req_id, False, None, type(e).__name__, str(e)
            )
        self._messaging.send(TOPIC_RPC_REPLY, ser.encode(reply), msg.sender)
        # flow results for already-finished flows must trail the reply
        flush, self._deferred = self._deferred, []
        for fn in flush:
            fn()

    def _dispatch(self, req: RpcRequest, client: str) -> Any:
        user = self._users.authenticate(req.username, req.password)
        if user is None:
            raise RpcPermissionError("unknown user or bad password")
        if req.method == "start_flow":
            flow_tag, snapshot = req.args
            if not self._users.can_start_flow(user, flow_tag):
                raise RpcPermissionError(
                    f"user {user.username!r} may not start {flow_tag}"
                )
            # capture progress from BEFORE the flow is created: the
            # state machine may run it to completion inline, and labels
            # emitted during that run must still reach the client
            buffered: list[tuple[Any, str]] = []
            capture = lambda fsm, label: buffered.append((fsm, label))  # noqa: E731
            self._ops.smm.changes.append(capture)
            try:
                fsm = self._ops.start_flow(flow_tag, dict(snapshot))
            finally:
                self._ops.smm.changes.remove(capture)
            return self._flow_handle(
                fsm,
                client,
                early_labels=[lb for f, lb in buffered if f.id == fsm.id],
            )
        fn = getattr(self._ops, req.method, None)
        if fn is None or not getattr(fn, "_rpc_exposed", False):
            raise RpcPermissionError(f"no such RPC method {req.method!r}")
        result = fn(*req.args)
        if isinstance(result, DataFeed):
            return self._feed_handle(result, client)
        return result

    # -- handle wiring -------------------------------------------------------

    def _fresh_obs_id(self) -> int:
        self._next_obs += 1
        return self._next_obs

    def _client_backpressure(self, client: str) -> bool:
        """True if the client's outbound queue says it stopped consuming
        (probed every _BACKLOG_PROBE_EVERY observations)."""
        if self._backlog is None:
            return False
        n = self._obs_since_probe.get(client, 0) + 1
        self._obs_since_probe[client] = n
        if n % self._BACKLOG_PROBE_EVERY:
            return False
        return self._backlog(client) > self.MAX_CLIENT_BACKLOG

    def _feed_handle(self, feed: DataFeed, client: str) -> FeedHandle:
        obs_id = self._fresh_obs_id()

        def forward(item: Any) -> None:
            if self._client_backpressure(client):
                import logging

                logging.getLogger("corda_tpu_torch.rpc").warning(
                    "reaping subscriptions of backed-up client %s", client
                )
                self.close_client(client)
                return
            self._messaging.send(
                TOPIC_RPC_OBSERVATION,
                ser.encode(RpcObservation(obs_id, item)),
                client,
            )

        unsub = feed.updates.subscribe(forward)

        def dispose():
            unsub()
            feed.close()

        self._subs[(client, obs_id)] = dispose
        return FeedHandle(obs_id, feed.snapshot)

    def _flow_handle(
        self,
        fsm: FlowStateMachine,
        client: str,
        early_labels: Optional[list[str]] = None,
    ) -> FlowHandleWire:
        obs_id = self._fresh_obs_id()
        prog_id = self._fresh_obs_id()

        def send_label(label: str) -> None:
            self._messaging.send(
                TOPIC_RPC_OBSERVATION,
                ser.encode(RpcObservation(prog_id, label)),
                client,
            )

        for label in early_labels or []:
            # labels from the inline run flush after the reply so the
            # client has the handle before observations arrive
            self._deferred.append(lambda lb=label: send_label(lb))
        if not fsm.done:
            def on_step(step_fsm, label: str) -> None:
                if step_fsm.id == fsm.id:
                    send_label(label)

            unsub_prog = _subscribe_list(self._ops.smm.changes, on_step)
            self._subs[(client, prog_id)] = unsub_prog

        def send_result() -> None:
            if fsm.exception is not None:
                item = [
                    "err",
                    type(fsm.exception).__name__,
                    str(fsm.exception),
                ]
            else:
                item = ["ok", fsm.result]
            self._messaging.send(
                TOPIC_RPC_OBSERVATION,
                ser.encode(RpcObservation(obs_id, item)),
                client,
            )

        if fsm.done:
            # already finished (flows can complete synchronously during
            # start): stream the result right after the reply goes out
            self._deferred.append(send_result)
        else:

            def on_change(kind: str, done_fsm: FlowStateMachine) -> None:
                if kind == "removed" and done_fsm.id == fsm.id:
                    send_result()
                    unsub()
                    self._subs.pop((client, obs_id), None)
                    dispose_prog = self._subs.pop((client, prog_id), None)
                    if dispose_prog is not None:
                        dispose_prog()

            unsub = _subscribe_list(self._ops.smm.lifecycle, on_change)
            self._subs[(client, obs_id)] = unsub
        return FlowHandleWire(fsm.id, obs_id, prog_id)

    # -- unsubscription ------------------------------------------------------

    def _on_unsubscribe(self, msg: Message) -> None:
        try:
            req = ser.decode(msg.payload)
        except Exception:
            return   # malformed: drop, never crash the pump
        if not isinstance(req, RpcUnsubscribe):
            return
        dispose = self._subs.pop((msg.sender, req.observable_id), None)
        if dispose is not None:
            dispose()

    def close_client(self, client: str) -> None:
        """Drop every subscription a disconnected client holds (the
        reference reaps via Artemis management notifications)."""
        for key in [k for k in self._subs if k[0] == client]:
            self._subs.pop(key)()

    @property
    def subscription_count(self) -> int:
        return len(self._subs)


# ---------------------------------------------------------------------------
# client


class RpcFuture:
    """Pump-driven future: resolves when the reply/observation arrives
    (delivery happens inside the caller's pump loop)."""

    def __init__(self):
        self._done = False
        self._value: Any = None
        self._error: Optional[RpcError] = None

    def _resolve(self, value: Any) -> None:
        self._done = True
        self._value = value

    def _fail(self, err: RpcError) -> None:
        self._done = True
        self._error = err

    @property
    def done(self) -> bool:
        return self._done

    def get(self) -> Any:
        if not self._done:
            raise RuntimeError("RPC call still pending — pump the fabric")
        if self._error is not None:
            raise self._error
        return self._value


def _ctor_kwargs_of(logic) -> dict:
    """Read a flow instance's constructor arguments back off its
    attributes; loud error when __init__ doesn't store a parameter
    under its own name (the server re-runs the constructor)."""
    import inspect

    init = type(logic).__init__
    if init is object.__init__:
        return {}   # no explicit constructor: a no-arg flow
    sig = inspect.signature(init)
    kwargs = {}
    for name, param in list(sig.parameters.items())[1:]:
        if param.kind in (
            inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD
        ):
            raise TypeError(
                f"{type(logic).__name__}.__init__ uses *args/**kwargs; "
                f"start it via start_flow(FlowClass, **kwargs) instead"
            )
        if not hasattr(logic, name):
            raise TypeError(
                f"{type(logic).__name__} does not store __init__ param "
                f"{name!r} as an attribute; start it via "
                f"start_flow(FlowClass, **kwargs) instead"
            )
        kwargs[name] = getattr(logic, name)
    return kwargs


class ReplayObservable(Observable):
    """Observable that replays everything already emitted to late
    subscribers — progress labels often arrive in the same pump round
    as the flow handle itself, before the caller can subscribe."""

    def __init__(self):
        super().__init__()
        self._history: list = []

    def subscribe(self, cb):
        for item in list(self._history):
            cb(item)
        return super().subscribe(cb)

    def emit(self, item) -> None:
        self._history.append(item)
        super().emit(item)


@dataclass
class FlowHandle:
    """Client-side handle: flow id + result future + progress-label
    stream (CordaRPCOps FlowHandle / FlowProgressHandle)."""

    flow_id: bytes
    result: RpcFuture
    progress: Optional[Observable] = None


class RPCClient:
    """Client endpoint: proxy-style method calls + observable demux
    (RPCClientProxyHandler.kt). One instance per (endpoint, server)."""

    def __init__(
        self,
        messaging: MessagingService,
        server_address: str,
        username: str,
        password: str,
    ):
        self._messaging = messaging
        self._server = server_address
        self._username = username
        self._password = password
        self._next_req = 0
        self._pending: dict[int, RpcFuture] = {}
        self._observables: dict[int, Observable] = {}
        self._flow_futures: dict[int, RpcFuture] = {}
        self._flow_progress: dict[int, int] = {}   # result obs -> prog obs
        messaging.add_handler(TOPIC_RPC_REPLY, self._on_reply)
        messaging.add_handler(TOPIC_RPC_OBSERVATION, self._on_observation)

    # -- calls ---------------------------------------------------------------

    def call(self, method: str, *args) -> RpcFuture:
        self._next_req += 1
        req = RpcRequest(
            self._next_req, self._username, self._password, method, tuple(args)
        )
        fut = RpcFuture()
        self._pending[req.req_id] = fut
        self._messaging.send(TOPIC_RPC_REQUEST, ser.encode(req), self._server)
        return fut

    def start_flow(self, logic_or_class, **kwargs) -> RpcFuture:
        """Start a flow; resolves to a FlowHandle. Accepts a flow CLASS
        (or tag string) plus constructor kwargs, or a flow INSTANCE —
        decomposed into (class tag, constructor kwargs) by reading each
        __init__ parameter back off the instance (the FlowLogicRef
        move, FlowLogicRef.kt: the server re-runs the constructor, so
        flows started this way must store parameters under their own
        names — the standard pattern)."""
        if isinstance(logic_or_class, str):
            return self.call("start_flow", logic_or_class, kwargs)
        if isinstance(logic_or_class, type):
            return self.call(
                "start_flow", _class_tag(logic_or_class), kwargs
            )
        logic = logic_or_class
        if kwargs:
            raise TypeError("pass kwargs with a class/tag, not an instance")
        return self.call(
            "start_flow", _class_tag(type(logic)), _ctor_kwargs_of(logic)
        )

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def method(*args) -> RpcFuture:
            return self.call(name, *args)

        return method

    # -- inbound -------------------------------------------------------------

    def _on_reply(self, msg: Message) -> None:
        if msg.sender != self._server:
            return
        reply = ser.decode(msg.payload)
        fut = self._pending.pop(reply.req_id, None)
        if fut is None:
            return
        if not reply.ok:
            fut._fail(RpcError(reply.error_tag, reply.error_message))
            return
        fut._resolve(self._materialise(reply.value))

    def _materialise(self, value: Any) -> Any:
        if isinstance(value, FeedHandle):
            updates = Observable()
            self._observables[value.observable_id] = updates
            obs_id = value.observable_id
            return DataFeed(
                value.snapshot,
                updates,
                dispose=lambda: self._unsubscribe(obs_id),
            )
        if isinstance(value, FlowHandleWire):
            fut = RpcFuture()
            self._flow_futures[value.result_observable_id] = fut
            progress = None
            if value.progress_observable_id is not None:
                progress = ReplayObservable()
                self._observables[value.progress_observable_id] = progress
                self._flow_progress[value.result_observable_id] = (
                    value.progress_observable_id
                )
            return FlowHandle(value.flow_id, fut, progress)
        return value

    def _unsubscribe(self, obs_id: int) -> None:
        self._observables.pop(obs_id, None)
        self._messaging.send(
            TOPIC_RPC_UNSUBSCRIBE,
            ser.encode(RpcUnsubscribe(obs_id)),
            self._server,
        )

    def _on_observation(self, msg: Message) -> None:
        if msg.sender != self._server:
            return
        obs = ser.decode(msg.payload)
        flow_fut = self._flow_futures.pop(obs.observable_id, None)
        if flow_fut is not None:
            # the flow is over: drop its progress stream too, or a
            # long-lived client leaks one ReplayObservable per flow
            prog_id = self._flow_progress.pop(obs.observable_id, None)
            if prog_id is not None:
                self._observables.pop(prog_id, None)
            status = obs.item[0]
            if status == "ok":
                flow_fut._resolve(obs.item[1])
            else:
                flow_fut._fail(RpcError(obs.item[1], obs.item[2]))
            return
        stream = self._observables.get(obs.observable_id)
        if stream is not None:
            stream.emit(obs.item)
